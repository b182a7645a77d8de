"""Diagnose the frame-0 orientation search's scorers against ground truth
(counterpart of `scripts/init_search_scorer_diag.py`).

    python -m captra_tpu_torch.cli.init_search_scorer_diag \\
        --coord <coord exp>/ckpt/model_0000 --rot <rot exp>/ckpt/model_0000 \\
        [--trajs 8] [--offsets 0,10,20,30,60,90,120,180] [--perturb_j 4] \\
        [--perturb_deg 12] [--steps 2] [--dtype bfloat16 --norm gn]

On a trained CoordNet (`--coord`, a checkpoint either package wrote;
`--rot` is read by nothing and kept so that argument lists stay the
script's), this measures how each candidate scorer of the search varies
with the candidate's true angular offset from GT:

  resid(v1) -- the camera-space fit residual after the descent passes
  drift     -- the angle between a candidate's rotation and its final fit
  drift1    -- the same against the pose entering the last pass
  spread    -- the mean pairwise angle between the fits of the J
               re-canonicalizations of a candidate by known in-basin
               rotations (the first the identity)
  err->GT   -- the final fit's angle to GT (does the descent converge?)

Angles are geodesic, or between the rotated y axes for a symmetric
category.  The inputs: frame 0 of `--trajs` synthetic trajectories (seeds
1000+, 2 frames); for trajectory b and offset k the candidate Q_bk R_gt
with Q_bk `--offsets[k]` degrees about a random axis, then J - 1
perturbations of `--perturb_deg` (`axis_angle`, all drawn from
`RandomState(11)` in the script's order, bit for bit); translation and
scale from `init_pose_from_cloud`.  The B x K x J candidate clouds go
through `--steps` passes of canonicalize -> CoordNet -> labels ->
`similarity_fit` -> `filter_valid`, CoordNet in chunks of at most
`tracking.tracker.INIT_SEARCH_CHUNK` clouds as `search_init_orientation`
runs it (in eval mode a cloud's output does not depend on its chunk).

Prints the table of the scorers' means by offset (the identity
perturbation's) and which offset each scorer's argmin picks a trajectory,
as the script does.  A checkpoint trained with other norm layers than
`--norm` raises, naming both.  `main(argv, device="cpu")` runs on the CPU;
without it the card is required.  Returns the report: the rows, the picks
and the fitted root rotations [B, K, J, 3, 3] (numpy).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from captra_tpu_torch.config import get_config
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.eval import quality
from captra_tpu_torch.models.coordnet import canonicalize
from captra_tpu_torch.pose.part_dof import Pose, tree_root
from captra_tpu_torch.pose.pose_fit import filter_valid, labels_to_part_mask
from captra_tpu_torch.pose.procrustes import similarity_fit
from captra_tpu_torch.tracking import tracker

TRAJ_SEED_BASE = 1000       # make_trajectory(seed=1000 + s)
TRAJ_FRAMES = 2
DRAW_SEED = 11              # the script's RandomState(11)
COLUMNS = ("resid", "drift", "drift1", "spread", "err_gt")
# (printed name, column) of each scorer whose argmin is reported; the
# last adds 100 x the residual to the spread
SCORERS = (("resid(v1)", "resid"), ("drift", "drift"),
           ("drift1", "drift1"), ("spread", "spread"),
           ("spread+resid", None))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("captra-tpu-torch init_search_scorer_diag")
    ap.add_argument("--coord", required=True)
    ap.add_argument("--rot", required=True)  # unused; kept arg-compatible
    ap.add_argument("--obj_config", default="obj_info_nocs.yml")
    ap.add_argument("--category", default="1")
    ap.add_argument("--trajs", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--norm", default="gn", choices=["bn", "gn"])
    ap.add_argument("--offsets", default="0,10,20,30,60,90,120,180")
    ap.add_argument("--perturb_j", type=int, default=4)
    ap.add_argument("--perturb_deg", type=float, default=12.0)
    ap.add_argument("--steps", type=int, default=2)
    return ap.parse_args(argv)


def config(args: argparse.Namespace):
    return get_config("config_track.yml", overrides={
        "obj_config": args.obj_config, "obj_category": args.category,
        "network/compute_dtype": args.dtype, "network/norm": args.norm})


def axis_angle(rng: np.random.RandomState, theta_deg: float) -> np.ndarray:
    """A rotation of `theta_deg` degrees about an axis drawn as
    `rng.randn(3)` (Rodrigues in float64, then float32): the script's
    `_axis_angle`, bit for bit."""
    ax = rng.randn(3)
    ax = ax / np.linalg.norm(ax)
    th = np.deg2rad(theta_deg)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    return (np.eye(3) + np.sin(th) * K +
            (1 - np.cos(th)) * (K @ K)).astype(np.float32)


def draw_candidates(gt_rotation: np.ndarray, offsets, J: int,
                    perturb_deg: float, rng: np.random.RandomState):
    """The script's draws from `rng`, in its order: first, trajectory by
    trajectory and offset by offset, the candidate rotations Q R_gt
    [B, K, P, 3, 3] (gt_rotation [B, P, 3, 3], float32); then the J
    perturbations [J, 3, 3], the identity first."""
    B, P = gt_rotation.shape[:2]
    cand_R = np.zeros((B, len(offsets), P, 3, 3), np.float32)
    for b in range(B):
        for k, off in enumerate(offsets):
            Q = axis_angle(rng, off)
            cand_R[b, k] = np.einsum("ij,pjk->pik", Q, gt_rotation[b])
    perts = np.stack([np.eye(3, dtype=np.float32)] + [
        axis_angle(rng, perturb_deg) for _ in range(J - 1)])
    return cand_R, perts


@torch.no_grad()
def descend(coord, cfg, points: torch.Tensor, pose: Pose, steps: int
            ) -> dict:
    """`steps` passes of canonicalize -> CoordNet -> argmax labels ->
    `similarity_fit` -> `filter_valid` on clouds points [M, N, 3] from
    poses [M, P], CoordNet over chunks of at most INIT_SEARCH_CHUNK clouds:
    {"fitted" (the final poses), "prev" (the poses entering the last
    pass), "resid" [M] (the last pass's residual score, inf where at most
    3 points are valid)}."""
    obj = cfg.obj
    P, root = obj.num_parts, tree_root(obj.tree)
    M, N, _ = points.shape
    chunk = tracker.INIT_SEARCH_CHUNK
    out = {"fitted": [], "prev": [], "resid": []}
    for c0 in range(0, M, chunk):
        pts = points[c0:c0 + chunk]
        m = pts.shape[0]
        mean = torch.mean(pts, dim=1)
        centered = pts - mean[:, None]
        cam = pts[:, None]                                   # [m, 1, N, 3]
        p = pose[c0:c0 + chunk]
        prev, score = p, None
        for _ in range(steps):
            rp = Pose(rotation=p.rotation[:, root],
                      translation=p.translation[:, root],
                      scale=p.scale[:, root])
            net = coord(canonicalize(centered, mean, rp))
            labels = torch.argmax(net["seg"], dim=-1)
            pn = net["nocs"].reshape(m, N, P, 3).movedim(2, 1)
            mask = labels_to_part_mask(labels, P)
            r_f, s_f, t_f = similarity_fit(pn, cam, mask, sym=obj.sym)
            fitted = Pose(rotation=r_f, translation=t_f, scale=s_f)
            valid = filter_valid(fitted, torch.sum(mask, -1) > 3,
                                 min_scale=1e-4)
            prev = p
            p = tracker._where_pose(valid, fitted, p)
            posed = s_f[..., None, None] * (pn @ r_f.transpose(-1, -2)) \
                + t_f.transpose(-1, -2)
            resid = torch.sum((posed - cam) ** 2, dim=-1)
            w = mask * valid[..., None].to(mask.dtype)
            tot = torch.sum(w, dim=(-1, -2))
            score = torch.sum(resid * w, dim=(-1, -2)) / torch.clamp(
                tot, min=1.0)
            score = torch.where(tot > 3, score, torch.inf)
        out["fitted"].append(p)
        out["prev"].append(prev)
        out["resid"].append(score)

    def cat(poses):
        return Pose(*(torch.cat([getattr(q, f) for q in poses])
                      for f in ("rotation", "translation", "scale")))
    return {"fitted": cat(out["fitted"]), "prev": cat(out["prev"]),
            "resid": torch.cat(out["resid"])}


def geo_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    tr = torch.einsum("...ij,...ij->...", Ra, Rb)
    c = torch.clamp((tr - 1) / 2, -1, 1)
    return torch.rad2deg(torch.arccos(c))


def yaxis_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """The angle between the rotated canonical y axes (the only observable
    rotation of a symmetric category)."""
    c = torch.clamp(torch.sum(Ra[..., :, 1] * Rb[..., :, 1], -1), -1, 1)
    return torch.rad2deg(torch.arccos(c))


def diagnose(coord, cfg, points: torch.Tensor, gt0: Pose,
             cand_R: np.ndarray, perts: np.ndarray, steps: int,
             device) -> dict:
    """The scorers of the B x K x J candidates on frame-0 clouds points
    [B, N, 3] with GT poses gt0 [B, P]: {"resid", "drift", "drift1",
    "spread", "err_gt"} each [B, K] numpy (the identity perturbation's,
    spread over the J), and "fitted" the final root rotations
    [B, K, J, 3, 3]."""
    obj = cfg.obj
    P, root = obj.num_parts, tree_root(obj.tree)
    B, K = cand_R.shape[:2]
    J = perts.shape[0]
    BKJ = B * K * J
    N = points.shape[1]
    guess = tracker.init_pose_from_cloud(points, P, cfg.data_radius,
                                         device=device)
    R0 = torch.from_numpy(np.einsum("jac,bkpcd->bkjpad", perts, cand_R)
                          .reshape(BKJ, P, 3, 3)).to(device)
    t0 = guess.translation[:, None, None].expand(
        B, K, J, P, 3, 1).reshape(BKJ, P, 3, 1)
    s0 = guess.scale[:, None, None].expand(B, K, J, P).reshape(BKJ, P)
    pts = points[:, None, None].expand(B, K, J, N, 3).reshape(BKJ, N, 3)
    res = descend(coord, cfg, pts, Pose(R0, t0, s0), steps)

    ang = yaxis_deg if obj.sym else geo_deg
    fitted, prev = res["fitted"], res["prev"]
    drift = ang(R0[:, root], fitted.rotation[:, root]).reshape(B, K, J)
    drift1 = ang(R0[:, root], prev.rotation[:, root]).reshape(B, K, J)
    fr = fitted.rotation.reshape(B, K, J, P, 3, 3)[:, :, :, root]
    pairs = [ang(fr[:, :, a], fr[:, :, b])
             for a in range(J) for b in range(a + 1, J)]
    spread = torch.mean(torch.stack(pairs), dim=0)             # [B, K]
    gtR = gt0.rotation[:, None, None, root].expand(B, K, J, 3, 3)
    err_gt = ang(fr, gtR)
    resid = res["resid"].reshape(B, K, J)

    def np_(x):
        return x.cpu().numpy()
    return {"resid": np_(resid[:, :, 0]), "drift": np_(drift[:, :, 0]),
            "drift1": np_(drift1[:, :, 0]), "spread": np_(spread),
            "err_gt": np_(err_gt[:, :, 0]), "fitted": np_(fr)}


def table(scores: dict, offsets) -> list[dict]:
    """One row an offset: each column's mean over the trajectories (NaNs
    left out)."""
    return [{"offset": float(off),
             **{c: float(np.nanmean(scores[c][:, k])) for c in COLUMNS}}
            for k, off in enumerate(offsets)]


def picks(scores: dict, offsets) -> dict:
    """{scorer: the offset its argmin picks for each trajectory}."""
    offs = np.asarray(offsets)
    out = {}
    for name, col in SCORERS:
        sc = (scores["spread"] + 100.0 * scores["resid"] if col is None
              else scores[col])
        out[name] = offs[np.nanargmin(sc, axis=1)].tolist()
    return out


def print_report(rows: list[dict], chosen: dict, sym: bool) -> None:
    print(f"(angle metric: {'y-axis' if sym else 'geodesic'})")
    print(f"\n{'offset':>8} {'resid(v1)':>12} {'drift':>8} {'drift1':>8} "
          f"{'spread':>8} {'err->GT':>8}")
    for r in rows:
        print(f"{r['offset']:8.0f} {r['resid']:12.6f} {r['drift']:8.2f} "
              f"{r['drift1']:8.2f} {r['spread']:8.2f} {r['err_gt']:8.2f}")
    for name, _ in SCORERS:
        c = chosen[name]
        print(f"argmin[{name:>12}] chooses offsets: {c} "
              f"(mean {np.mean(c):.0f} deg)")


def main(argv=None, device=None) -> dict:
    """Run the diagnosis as the command line says; returns the report."""
    from captra_tpu_torch.data.synthetic import (
        batch_trajectories, make_trajectory,
    )
    from captra_tpu_torch.training import checkpoint as ckpt
    from captra_tpu_torch.training.convert import coordnet_from_flax
    device = resolve_device(device)
    args = parse(argv)
    cfg = config(args)
    payload = ckpt.load_checkpoint(args.coord)
    variables = {"params": payload["params"],
                 "batch_stats": payload.get("batch_stats", {})}
    quality.check_norm(cfg, variables, args.coord)
    coord = coordnet_from_flax(cfg, variables, device=device).eval()

    offsets = [float(x) for x in args.offsets.split(",")]
    base = batch_trajectories([
        make_trajectory(seed=TRAJ_SEED_BASE + s, obj=cfg.obj,
                        num_frames=TRAJ_FRAMES, num_points=cfg.num_points)
        for s in range(args.trajs)])
    gt0 = base["pose"][0]
    cand_R, perts = draw_candidates(
        gt0.rotation.numpy(), offsets, args.perturb_j, args.perturb_deg,
        np.random.RandomState(DRAW_SEED))
    t0 = time.time()
    scores = diagnose(coord, cfg, torch.from_numpy(base["points"][0]).to(
        device), gt0.to(device), cand_R, perts, args.steps, device)
    rows, chosen = table(scores, offsets), picks(scores, offsets)
    print_report(rows, chosen, cfg.obj.sym)
    label = quality.device_label(device)
    print(f"({time.time() - t0:.1f}s for {scores['fitted'].shape[0]} x "
          f"{len(offsets)} x {args.perturb_j} candidates on {label})",
          flush=True)
    return {"angle_metric": "y-axis" if cfg.obj.sym else "geodesic",
            "rows": rows, "picks": chosen, "device": label,
            "fitted": scores["fitted"]}


if __name__ == "__main__":
    main()
