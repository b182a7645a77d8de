"""The quality harness's shared pieces (counterpart of what
`scripts/eval_checkpoint_track.py`, `scripts/tpu_flagship_demo.py`,
`scripts/gtless_init_probe.py` and `scripts/train_basin_head.py` each
write inline): the seeded synthetic eval set, the GT frame-0 init, the
frozen-init baseline, the frame-1 and full-scan means of `evaluate_track`,
the printed rows that `scripts/summarize_q4.py::ROW` parses, checkpoint
loading with the norm check, and a numpy copy of the probe's
`repose_to_theta` with its `RandomState` draw order.

The JAX scripts draw the frame-0 noise from `jax.random.PRNGKey(0)` and
the tracking step's RANSAC draws from `PRNGKey(13)`; here they come from
`torch.Generator`s seeded 0 and 13 (`GT_INIT_SEED`, `STEP_SEED`), whose
streams are not JAX's.  With the GT init (the scripts' default) no draw
is made.
"""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from captra_tpu_torch.data.synthetic import batch_trajectories, make_trajectory
from captra_tpu_torch.models.coordnet import CoordNet
from captra_tpu_torch.models.rotnet import RotNet
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking.tracker import (
    evaluate_track, init_pose_from_gt, make_track_step, track_trajectory,
)

EVAL_SEED_BASE = 1000       # the eval set: make_trajectory(seed=1000 + s)
GT_INIT_SEED = 0            # frame-0 noise (the scripts' PRNGKey(0))
STEP_SEED = 13              # the step's RANSAC draws (tracker.py's key 13)
REPOSE_SEED = 7             # the probe's RandomState(7)
# the eval harness's printed row labels, padded as the script prints them
ROW_LABELS = {"frame-1": "frame-1    ", "full-scan": "full-scan  ",
              "frozen-init": "frozen-init"}


def eval_set(obj, trajs: int, frames: int, num_points: int,
             seed_base: int = EVAL_SEED_BASE) -> dict:
    """`batch_trajectories` of `make_trajectory(seed=seed_base + s)` for s
    in range(trajs): points [T, B, N, 3] (numpy), "pose" a `Pose` [T, B, P]
    of CPU tensors, ..."""
    return batch_trajectories([
        make_trajectory(seed=seed_base + s, obj=obj, num_frames=frames,
                        num_points=num_points) for s in range(trajs)])


def gt_init(gt: Pose, cfg) -> Pose:
    """Frame 0's pose from the GT poses [T, B, P]: the GT itself with
    `init_frame/gt`, else the GT perturbed by `cfg.perturb` with draws from
    a generator on the poses' device seeded `GT_INIT_SEED`."""
    gen = torch.Generator(gt.scale.device).manual_seed(GT_INIT_SEED)
    return init_pose_from_gt(gt[0], cfg, generator=gen)


def means(errs: dict) -> tuple[dict, dict]:
    """(frame-1 means, full-scan means) of `evaluate_track`'s per-frame
    errors [T - 1, B, P], as floats."""
    return ({k: float(torch.mean(v[0])) for k, v in errs.items()},
            {k: float(torch.mean(v)) for k, v in errs.items()})


def frozen_init(gt: Pose, sym: bool) -> dict:
    """Full-scan means of holding frame 0's GT pose for every later frame
    (the baseline a tracker must beat)."""
    T = gt.scale.shape[0]
    frozen = gt.map(lambda x: x[:1].expand((T - 1,) + x.shape[1:]))
    return means(evaluate_track(frozen, gt.map(lambda x: x[1:]), sym))[1]


def nets_of(cfg, coord_sd: dict, rot_sd: dict, device):
    """A CoordNet and a RotNet of the tracking config holding the given
    state dicts, in eval mode."""
    coord = CoordNet(cfg, device=device)
    coord.load_state_dict(coord_sd)
    rotn = RotNet(cfg, device=device)
    rotn.load_state_dict(rot_sd)
    return coord.eval(), rotn.eval()


def track(cfg, coord, rotn, init_pose: Pose, points, device) -> Pose:
    """The tracked poses [T - 1, B, P] of `points` [T, B, N, 3] from
    `init_pose` with the nets in eval mode, without autograd; the step's
    RANSAC draws from a generator seeded `STEP_SEED`."""
    coord.eval()
    rotn.eval()
    step = make_track_step(cfg, coord, rotn, device=device,
                           generator=torch.Generator(device).manual_seed(
                               STEP_SEED))
    with torch.no_grad():
        _, aux = track_trajectory(step, init_pose,
                                  {"points": torch.as_tensor(points)},
                                  device=device)
    return aux.pose


def track_means(cfg, coord, rotn, init_pose: Pose, points, gt: Pose,
                device) -> tuple[dict, dict]:
    """(frame-1, full-scan) means of tracking `points` against the GT poses
    [T, B, P] (frame 0's is the given init's)."""
    pose = track(cfg, coord, rotn, init_pose, points, device)
    gt_rest = gt.map(lambda x: x[1:].to(device))
    return means(evaluate_track(pose, gt_rest, sym=cfg.obj.sym))


def rounded(values: dict, digits: int = 4) -> dict:
    return {k: round(v, digits) for k, v in values.items()}


def row(kind: str, values: dict, tag: str = "") -> str:
    """One printed row of the eval harness, as `summarize_q4.py::ROW`
    parses it: "[tag] frame-1     {...}" (no tag: no brackets)."""
    return (f"[{tag}] " if tag else "") + ROW_LABELS[kind] + " " + str(
        rounded(values))


def checkpoint_norm(variables: dict) -> str:
    """The norm layers a flax variable tree was trained with: "bn" when it
    holds BatchNorm statistics, else "gn"."""
    def leaves(tree):
        if hasattr(tree, "items"):
            return sum((leaves(v) for v in tree.values()), 0)
        return 1
    return "bn" if leaves(variables.get("batch_stats", {})) else "gn"


def check_norm(cfg, variables: dict, path: str) -> None:
    """Raise `ValueError` when the checkpoint at `path` was trained with
    other norm layers than `cfg.network.norm`, naming both."""
    found = checkpoint_norm(variables)
    if found != cfg.network.norm:
        raise ValueError(
            f"{path} holds a net trained with network/norm={found}, and "
            f"the run asks for network/norm={cfg.network.norm}: pass "
            f"--norm {found}")


def load_nets(cfg, coord_path: str, rot_path: str, device):
    """(CoordNet, RotNet) of `cfg` on `device` holding the checkpoints at
    the two paths (either package's pickle files), after `check_norm`."""
    from captra_tpu_torch.training import checkpoint as ckpt
    from captra_tpu_torch.training.convert import (
        coordnet_from_flax, rotnet_from_flax,
    )
    cv, rv = ckpt.load_track_variables(coord_path, rot_path)
    check_norm(cfg, cv, coord_path)
    check_norm(cfg, rv, rot_path)
    return (coordnet_from_flax(cfg, cv, device=device),
            rotnet_from_flax(cfg, rv, device=device))


def device_label(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` gives them (the name alone where
    nvidia-smi does not run), or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
        if out:
            return out
    except (OSError, subprocess.SubprocessError):
        pass
    return torch.cuda.get_device_name(index)


def _axis_angle(axis, theta) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(theta) * K +
            (1 - np.cos(theta)) * (K @ K)).astype(np.float32)


def repose_to_theta(data: dict, theta_deg: float,
                    rng: np.random.RandomState) -> dict:
    """Rigidly re-pose the whole scan (camera frame, pivot = frame 0's root
    translation) so that frame 0's root rotation sits exactly `theta_deg`
    degrees from identity: R' = Q R, t' = Q (t - t0) + t0, points
    likewise.  One random axis a trajectory from `rng` (`rng.randn(3)`, in
    trajectory order), as the probe script draws it.  data: {"points" [T,
    B, N, 3], "pose" a `Pose` [T, B, P]}; returns {"points" (numpy),
    "pose" (CPU tensors)}."""
    gt = data["pose"]
    R = np.asarray(gt.rotation)          # [T, B, P, 3, 3]
    t = np.asarray(gt.translation)       # [T, B, P, 3, 1]
    pts = np.asarray(data["points"])     # [T, B, N, 3]
    T, B, P = R.shape[:3]
    root = 0
    R2, t2, pts2 = R.copy(), t.copy(), pts.copy()
    for b in range(B):
        R0 = R[0, b, root]
        ax = rng.randn(3)
        target = _axis_angle(ax, np.deg2rad(theta_deg))
        Q = target @ R0.T                # frame-0 root -> exactly theta
        pivot = t[0, b, root, :, 0]
        R2[:, b] = np.einsum("ij,tpjk->tpik", Q, R[:, b])
        t2[:, b] = np.einsum(
            "ij,tpjk->tpik", Q, t[:, b] - pivot[None, None, :, None]) \
            + pivot[None, None, :, None]
        pts2[:, b] = (pts[:, b] - pivot) @ Q.T + pivot
    pose = Pose(rotation=torch.from_numpy(R2),
                translation=torch.from_numpy(t2),
                scale=torch.as_tensor(np.asarray(gt.scale)))
    return {"points": pts2, "pose": pose}
