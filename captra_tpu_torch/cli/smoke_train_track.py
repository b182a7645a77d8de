"""End-to-end learning smoke (counterpart of `scripts/smoke_train_track.py`):
train a tiny CoordNet and RotNet on synthetic single-part data, then track
trajectories with the trained nets and compare against the untrained nets
and the frozen init pose.

    python -m captra_tpu_torch.cli.smoke_train_track [--steps 300] [--cpu] \\
        [--num_points 256]

The configuration is the script's, built in code (`configs`): a tiny
PointNet++ (sa1 64 centroids at radii 0.1 / 0.2 with 16 / 32 samples, sa2
16 at 0.4 with 16), one rigid part, batch 8, a 64-wide backbone and NOCS
head, GT init.  Each net (`canon_coord`, then `rot`) is drawn
xavier-uniform from a CPU generator seeded 0 (the script's one
`PRNGKey(0)` for both) and trained for `--steps` steps on
`make_frame_batch(i % 37, batch=8)` with a step's draws from a generator on
the device seeded 0 (fresh for each net, as the script restarts its key
split).  The untrained nets are copies taken before the first step.  Then 4
trajectories of 15 frames (`make_trajectory(seed=100 + s)`) are tracked
from the GT frame-0 pose with the trained nets and with the untrained
nets, and held against the frozen init; `evaluate_track(..., sym=False)`.

Flags, defaults and printed lines are the JAX script's, plus one line with
the device.  Like the script, it exits with an error when the trained
tracker's tdiff is not below the frozen init's.  `--cpu` (or `main(argv,
device="cpu")`) runs on the CPU; without it the card is required.  Returns
the report: the three rows' means, each net's seconds and ms a step.
"""
from __future__ import annotations

import argparse
import time

import torch

from captra_tpu_torch.config.schema import (
    Config, NetworkCfg, ObjCfg, PointNetCfg, SAMsgCfg, TrackCfg,
)
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.eval import quality
from captra_tpu_torch.training.trainer import Trainer, to_device

NETS = ("canon_coord", "rot")
TRACK_NET = "rot_coord_track"
BATCH = 8
DISTINCT_BATCHES = 37       # make_frame_batch(i % 37)
STEPS_PER_EPOCH = 100
LOG_EVERY = 50
INIT_SEED = 0               # both nets' draw (the script's PRNGKey(0))
DRAW_SEED = 0               # a net's train-step draws
TRACK_TRAJS = 4
TRACK_FRAMES = 15
TRACK_SEED_BASE = 100       # make_trajectory(seed=100 + s)
ROWS = ("trained", "untrained", "frozen-init")


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("captra-tpu-torch smoke_train_track")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--num_points", type=int, default=256)
    return ap.parse_args(argv)


def configs(num_points: int) -> dict:
    """{network type: Config} of the two trained nets and the tracker: the
    script's tiny PointNet++, one rigid part, batch 8, GT init."""
    pn = PointNetCfg(
        sa1=SAMsgCfg(npoint=64, radius_list=(0.1, 0.2), nsample_list=(16, 32),
                     mlp_list=((16, 32), (16, 32))),
        sa2=SAMsgCfg(npoint=16, radius_list=(0.4,), nsample_list=(16,),
                     mlp_list=((32, 64),)),
        sa3_mlp=(64, 128), fp3_mlp=(64,), fp2_mlp=(64,), fp1_mlp=(64,),
    )
    obj = ObjCfg(num_parts=1, num_joints=0, tree=(-1,), extra_dims=0)
    base = Config(obj=obj, pointnet=pn, num_points=num_points,
                  batch_size=BATCH, track=TrackCfg(init_frame_gt=True))
    return {net: base.replace(network=NetworkCfg(
        type=net, backbone_out_dim=64, nocs_head_dims=(64,)))
        for net in NETS + (TRACK_NET,)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(trainer: Trainer, state, net_type: str, steps: int, batch_of,
          draws_of):
    """`steps` train steps of `state` (in place): batch i is
    `batch_of(i)`, its draws `draws_of(i, batch)`; the script's line every
    LOG_EVERY steps.  Returns (state, every step's {losses and metrics} on
    the device)."""
    log = []
    for i in range(steps):
        batch = batch_of(i)
        state, loss, metrics = trainer.train_step(
            state, batch, draws=draws_of(i, batch))
        log.append({**loss, **metrics})
        if i % LOG_EVERY == 0:
            print(f"[{net_type}] step {i}: "
                  f"total={float(loss['total_loss']):.4f} "
                  f"5d5cm={float(metrics['5deg5cm']):.3f}", flush=True)
    return state, log


def train_net(cfg, steps: int, device: torch.device) -> dict:
    """Train one net as the script does: {"untrained", "trained" (train
    states), "sec"}."""
    from captra_tpu_torch.data.synthetic import make_frame_batch
    net_type = cfg.network.type
    trainer = Trainer(cfg, steps_per_epoch=STEPS_PER_EPOCH, device=device)
    state = trainer.init_state(
        generator=torch.Generator().manual_seed(INIT_SEED))
    # train_step updates the state in place: keep a copy of the draw
    untrained = trainer.copy_state(state)
    gen = torch.Generator(device).manual_seed(DRAW_SEED)
    cache = {}

    def batch_of(i):
        ci = i % DISTINCT_BATCHES
        if ci not in cache:
            cache[ci] = to_device(make_frame_batch(
                ci, cfg.obj, batch=BATCH, num_points=cfg.num_points), device)
        return cache[ci]

    _sync(device)
    t0 = time.time()
    state, _ = train(trainer, state, net_type, steps, batch_of,
                     lambda i, batch: trainer.draw(batch, gen))
    _sync(device)
    dt = time.time() - t0
    print(f"[{net_type}] {steps} steps in {dt:.1f}s")
    return {"untrained": untrained, "trained": state, "sec": dt}


def track_data(cfg, num_points: int) -> dict:
    """The tracked trajectories: `batch_trajectories` of
    `make_trajectory(seed=100 + s)` for s < 4, 15 frames each."""
    return quality.eval_set(cfg.obj, TRACK_TRAJS, TRACK_FRAMES, num_points,
                            seed_base=TRACK_SEED_BASE)


def print_rows(rows: dict) -> None:
    print(f"\n=== tracking results (mean over {TRACK_TRAJS} trajs x "
          f"{TRACK_FRAMES - 1} frames) ===")
    for name in ROWS:
        d = rows[name]
        print(f"{name:12s} rdiff={d['rdiff']:7.3f}deg "
              f"tdiff={d['tdiff']:.4f} sdiff={d['sdiff']:.4f} "
              f"5d5cm={d['5deg5cm']:.3f}")


def run(args: argparse.Namespace, device) -> tuple[dict, dict]:
    """Train both nets and track: (the report, {net type: `train_net`'s
    dict})."""
    device = resolve_device("cpu" if args.cpu else device)
    cfgs = configs(args.num_points)
    legs = {net: train_net(cfgs[net], args.steps, device) for net in NETS}

    cfg = cfgs[TRACK_NET]
    data = track_data(cfg, args.num_points)
    gt = data["pose"].to(device)
    rows = {}
    for name in ROWS[:2]:
        coord, rotn = quality.nets_of(
            cfg, legs["canon_coord"][name].module.state_dict(),
            legs["rot"][name].module.state_dict(), device)
        # the object is not symmetric: the script's sym=False
        rows[name] = quality.track_means(cfg, coord, rotn, gt[0],
                                         data["points"], gt, device)[1]
    rows["frozen-init"] = quality.frozen_init(gt, cfg.obj.sym)
    print_rows(rows)
    label = quality.device_label(device)
    print(f"(on {label})", flush=True)
    report = {**rows, "device": label, "steps": args.steps,
              "train": {net: {"sec": leg["sec"],
                              "ms_per_step": leg["sec"] * 1e3
                              / max(args.steps, 1)}
                        for net, leg in legs.items()}}
    return report, legs


def check(report: dict) -> None:
    """The script's gate: exit with an error unless the trained tracker's
    tdiff is below the frozen init's."""
    if not report["trained"]["tdiff"] < report["frozen-init"]["tdiff"]:
        raise SystemExit(
            f"training did not help tdiff: trained "
            f"{report['trained']['tdiff']:.4f}, frozen-init "
            f"{report['frozen-init']['tdiff']:.4f}")
    print("OK: trained tracker beats the frozen-init baseline")


def main(argv=None, device=None) -> dict:
    """Run the smoke as the command line says; returns the report."""
    report = run(parse(argv), device)[0]
    check(report)
    return report


if __name__ == "__main__":
    main()
