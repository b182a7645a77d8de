"""Train the basin-confidence head on a trained CoordNet checkpoint
(counterpart of `scripts/train_basin_head.py`).

    python -m captra_tpu_torch.cli.train_basin_head \\
        --coord <coord exp>/ckpt/model_0000 --out <dir> [--category 1] \\
        [--steps 1500] [--dtype float32 --norm bn]

The frame-0 orientation search's basin scorer (`track_cfg/
init_search_scorer=basin`) reads a small head on the pooled, detached
backbone features (`network/basin_head`, `models/coordnet.py`); this CLI
trains it, and nothing else: the checkpoint is the input CoordNet plus the
head, so its seg and NPCS outputs are the input net's bit for bit.

1. The checkpoint's parameters and statistics are merged into a CoordNet
   with a fresh head (lecun-normal kernels and zero biases, drawn from a
   CPU generator seeded 0 after every other layer), so a checkpoint
   without `basin_fc1/2` loads.
2. The pool: `pool_trajs` x `pool_frames` clouds of `make_trajectory`
   seeds 5000+ with their GT root rotations.  A step draws `batch` pool
   indices, then for each an offset angle (uniform, a quarter of the mass
   below 30 degrees, the rest up to 180) and a random axis, all from one
   generator on the device seeded 7; `make_inputs` canonicalizes each cloud
   by the offset composed with its GT rotation (translation the cloud's
   mean, scale the covering radius over `data_radius`) and labels it with
   the observable orientation error (the y axis's angle for a symmetric
   category, the offset otherwise).
3. The loss is the sigmoid cross-entropy against clip(1 - angle / 90, 0,
   1), written as optax's `sigmoid_binary_cross_entropy`.  Adam with
   optax's defaults (b1 0.9, b2 0.999, eps 1e-8, bias-corrected; the
   trainer's `Optimizer` over the head's flat buffer) at `--lr` updates
   the head's parameters alone.  The JAX script's Adam runs over
   every parameter, but every other leaf's gradient is zero there (the
   head reads stop_gradient features, and nothing else enters the loss),
   so its moments and updates stay zero and only the head moves there too.
4. The held-out report: the mean logit of clouds of seeds 9000+ (8
   trajectories x 4 frames) canonicalized at each theta of PROBE_THETAS
   about a random axis (a generator seeded theta), then the checkpoint
   (`<out>/ckpt/model_0000`, the JAX package's pickle layout, the head's
   Adam moments as its optimizer state) and `<out>/REPORT.json`.

Flags, defaults and printed lines are the JAX script's; its `jax.random`
streams (keys 0, 7 and theta) cannot be reproduced.  `main(argv,
device="cpu")` runs on the CPU; without it the card is required.  Returns
the report with the checkpoint's path under "checkpoint".
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from captra_tpu_torch.config import get_config
from captra_tpu_torch.data.synthetic import batch_trajectories, make_trajectory
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.eval import quality
from captra_tpu_torch.models.coordnet import CoordNet, canonicalize
from captra_tpu_torch.pose import rotations as rot
from captra_tpu_torch.pose.part_dof import Pose, tree_root
from captra_tpu_torch.training import checkpoint as ckpt
from captra_tpu_torch.training.convert import (
    flax_variables, load_flax_variables, optimizer_tree,
)
from captra_tpu_torch.training.trainer import (
    Optimizer, TrainState, flatten_parameters,
)

HEAD = ("basin_fc1", "basin_fc2")
HEAD_SEED = 0               # the fresh head's draw (the script's PRNGKey(0))
TRAIN_SEED = 7              # the steps' draws (the script's PRNGKey(7))
POOL_SEED_BASE = 5000
HELD_OUT_SEED_BASE = 9000
HELD_OUT_TRAJS = 8
HELD_OUT_FRAMES = 4
PROBE_THETAS = (0, 10, 20, 30, 45, 60, 90, 135, 180)
LOG_EVERY = 100


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("captra-tpu-torch train_basin_head")
    ap.add_argument("--coord", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--obj_config", default="obj_info_nocs.yml")
    ap.add_argument("--category", default="1")
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--pool_trajs", type=int, default=32)
    ap.add_argument("--pool_frames", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--norm", default="gn", choices=["bn", "gn"])
    return ap.parse_args(argv)


def config(args: argparse.Namespace):
    return get_config("config_track.yml", overrides={
        "obj_config": args.obj_config, "obj_category": args.category,
        "network/compute_dtype": args.dtype, "network/norm": args.norm,
        "network/basin_head": True})


def merged_coordnet(cfg, path: str, device) -> CoordNet:
    """A CoordNet with a basin head holding the checkpoint at `path`: its
    parameters (a head too, when it has one) over a fresh net's, its
    statistics.  Every parameter but the head's stops requiring grad."""
    loaded = ckpt.load_checkpoint(path)
    quality.check_norm(cfg, loaded, path)
    coord = CoordNet(cfg, device=device,
                     generator=torch.Generator().manual_seed(HEAD_SEED))
    params = dict(flax_variables(coord)["params"])
    params.update(loaded["params"])
    missing = [k for k in HEAD if k not in params]
    if missing:
        raise ValueError(f"head params missing after merge: {missing}")
    load_flax_variables(coord, {"params": params,
                                "batch_stats": loaded["batch_stats"]})
    for name, p in coord.named_parameters():
        p.requires_grad_(name.split(".")[0] in HEAD)
    return coord.eval()


def make_pool(obj, trajs: int, frames: int, num_points: int,
              seed_base: int) -> tuple[np.ndarray, np.ndarray]:
    """(clouds [S, N, 3], GT root rotations [S, 3, 3]) of `trajs`
    trajectories of `frames` frames, trajectory-major, numpy."""
    data = batch_trajectories([
        make_trajectory(seed=seed_base + s, obj=obj, num_frames=frames,
                        num_points=num_points) for s in range(trajs)])
    root = tree_root(obj.tree)
    pts = np.asarray(data["points"])                     # [T, B, N, 3]
    rgt = np.asarray(data["rotation"])[:, :, root]       # [T, B, 3, 3]
    S = trajs * frames
    return (pts.transpose(1, 0, 2, 3).reshape(S, num_points, 3),
            rgt.transpose(1, 0, 2, 3).reshape(S, 3, 3))


def draw(generator: torch.Generator, batch: int, pool_size: int
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A step's draws on the generator's device: (pool indices [M], the
    offset's uniform draw u [M], its axis [M, 3], unnormalised)."""
    dev = generator.device
    idx = torch.randint(0, pool_size, (batch,), generator=generator,
                        device=dev)
    u = torch.rand(batch, generator=generator, device=dev)
    axis = torch.randn(batch, 3, generator=generator, device=dev)
    return idx, u, axis


def canonical_clouds(pts: torch.Tensor, rc: torch.Tensor,
                     data_radius: float) -> torch.Tensor:
    """Clouds [M, N, 3] canonicalized by rotation rc [M, 3, 3], their mean
    and the scale at which the crop ball covers them (the GT-less init's
    translation and scale)."""
    mean = torch.mean(pts, dim=1)                           # [M, 3]
    ctr = pts - mean[:, None]
    r = torch.amax(torch.linalg.norm(ctr, dim=-1), dim=1)
    pose = Pose(rotation=rc, translation=mean[..., None],
                scale=r / data_radius)
    return canonicalize(ctr, mean, pose)


def make_inputs(pool_pts: torch.Tensor, pool_rgt: torch.Tensor,
                idx: torch.Tensor, u: torch.Tensor, axis: torch.Tensor,
                sym: bool, data_radius: float):
    """Canonicalize pool clouds `idx` by their GT rotation composed with
    an offset of angle theta(u) about `axis`: (canonical points [M, N, 3],
    the label angle in degrees [M])."""
    p = pool_pts[idx]
    rg = pool_rgt[idx]
    # a dense low-angle band: ranking near the basin's edge is what the
    # selection needs
    theta = torch.where(u < 0.25, u * 4.0 * 30.0, (u - 0.25) / 0.75 * 180.0)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    q = rot.axis_theta_to_matrix(axis, torch.deg2rad(theta))
    rc = torch.einsum("mij,mjk->mik", q, rg)                # candidate rot
    if sym:
        ang = torch.rad2deg(torch.arccos(torch.clamp(
            torch.sum(rc[:, :, 1] * rg[:, :, 1], -1), -1.0, 1.0)))
    else:
        ang = theta
    return canonical_clouds(p, rc, data_radius), ang


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's `sigmoid_binary_cross_entropy`, elementwise."""
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)


def loss_fn(coord: CoordNet, canon: torch.Tensor, ang: torch.Tensor):
    """(mean BCE of the basin logits against clip(1 - ang / 90, 0, 1), the
    logits [M])."""
    logit = coord(canon)["basin"]
    target = torch.clamp(1.0 - ang / 90.0, 0.0, 1.0)
    return torch.mean(sigmoid_bce(logit, target)), logit


def head_state(cfg, coord: CoordNet, lr: float
               ) -> tuple[TrainState, Optimizer]:
    """(the head's parameters as a train state: flat buffers that the
    head's parameters and gradients are views of, `trainer.
    flatten_parameters`; the trainer's optimizer as optax.adam(lr): no
    clipping, no weight decay, a constant rate)."""
    head = nn.ModuleDict({name: getattr(coord, name) for name in HEAD})
    params, grads, layout = flatten_parameters(head)
    tx = Optimizer(cfg.replace(optim=dataclasses.replace(
        cfg.optim, optimizer="adam", learning_rate=lr, lr_gamma=1.0,
        lr_clip=0.0, weight_decay=0.0, grad_clip=0.0)), steps_per_epoch=1)
    return TrainState(module=head, params=params, grads=grads,
                      opt_state=tx.init(params), layout=layout), tx


def train_step(coord: CoordNet, state: TrainState, tx: Optimizer,
               pool_pts, pool_rgt, draws, sym: bool, data_radius: float):
    """One update of the head (`state`, in place) on a step's draws:
    (loss, mean logit of the offsets within 30 degrees, of those beyond
    45), on the device."""
    canon, ang = make_inputs(pool_pts, pool_rgt, *draws, sym, data_radius)
    state.grads.zero_()
    loss, logit = loss_fn(coord, canon, ang)
    loss.backward()
    state.opt_state = tx.step(state.opt_state, state.params, state.grads)
    state.step += 1
    logit = logit.detach()
    inside, outside = ang <= 30.0, ang > 45.0
    lo_in = torch.sum(torch.where(inside, logit, 0.0)) / torch.clamp(
        torch.sum(inside), min=1)
    lo_out = torch.sum(torch.where(outside, logit, 0.0)) / torch.clamp(
        torch.sum(outside), min=1)
    return loss.detach(), lo_in, lo_out


@torch.no_grad()
def separation(coord: CoordNet, cfg, device) -> dict:
    """{theta: the held-out clouds' mean basin logit at that offset,
    rounded to 3 digits}."""
    num_points = cfg.num_points
    hp, hr = make_pool(cfg.obj, HELD_OUT_TRAJS, HELD_OUT_FRAMES, num_points,
                       HELD_OUT_SEED_BASE)
    hp = torch.from_numpy(hp).to(device)
    hr = torch.from_numpy(hr).to(device)
    Sh = hp.shape[0]
    sep = {}
    for th in PROBE_THETAS:
        gen = torch.Generator(device).manual_seed(th)
        axis = torch.randn(Sh, 3, generator=gen, device=device)
        axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
        q = rot.axis_theta_to_matrix(axis, torch.full(
            (Sh,), float(np.deg2rad(np.float32(th))), device=device))
        rc = torch.einsum("mij,mjk->mik", q, hr)
        logits = coord(canonical_clouds(hp, rc, float(cfg.data_radius)))[
            "basin"]
        sep[th] = round(float(torch.mean(logits)), 3)
        print(f"held-out theta={th:3d}: mean logit {sep[th]:+.3f}",
              flush=True)
    return sep


def main(argv=None, device=None) -> dict:
    device = resolve_device(device)
    args = parse(argv)
    cfg = config(args)
    obj = cfg.obj
    coord = merged_coordnet(cfg, args.coord, device)

    pts, rgt = make_pool(obj, args.pool_trajs, args.pool_frames,
                         cfg.num_points, POOL_SEED_BASE)
    S = pts.shape[0]
    pool_pts = torch.from_numpy(pts).to(device)
    pool_rgt = torch.from_numpy(rgt).to(device)
    print(f"pool: {S} clouds, {cfg.num_points} points, sym={obj.sym}",
          flush=True)

    data_radius = float(cfg.data_radius)
    state, tx = head_state(cfg, coord, args.lr)
    gen = torch.Generator(device).manual_seed(TRAIN_SEED)
    t0 = time.time()
    for i in range(args.steps):
        loss, li, lo = train_step(coord, state, tx, pool_pts, pool_rgt,
                                  draw(gen, args.batch, S), obj.sym,
                                  data_radius)
        if i % LOG_EVERY == 0 or i == args.steps - 1:
            print(f"step {i}: bce={float(loss):.4f} "
                  f"logit(in<=30)={float(li):.2f} "
                  f"logit(out>45)={float(lo):.2f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({dt / max(args.steps, 1) * 1e3:.0f} ms/step)", flush=True)

    report = {"sep": separation(coord, cfg, device)}
    path = ckpt.save_checkpoint(os.path.join(args.out, "ckpt"), 0,
                                flax_variables(coord),
                                optimizer_tree(state), step=state.step)
    with open(os.path.join(args.out, "REPORT.json"), "w") as f:
        json.dump({"args": vars(args), **report}, f, indent=1)
    print("saved", path, flush=True)
    return {**report, "checkpoint": path}


if __name__ == "__main__":
    main()
