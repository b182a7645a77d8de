"""Frame-recurrent tracking loop (counterpart of
`captra_tpu/tracking/tracker.py`).

One step = canonicalize by the carried root pose -> CoordNet -> per-part
canonicalize -> RotNet -> compose the rotation delta + fit s/t.  The JAX
`lax.scan` becomes a Python loop over frames; frame 0's pose is the given
init and frames[1:] are tracked.

The step is parameterized by two callables (the nets themselves, or test
oracles):
    coord_fn(canon_points [B,N,3]) -> {"seg": [B,N,S], "nocs": [B,N,3P]}
    rot_fn(canon_parts [B,P,N,3], labels [B,N]) -> {"rtvec", "point_rtvec"}

This slice carries the default `TrackCfg` plus `gt_label`; every other
tracking opt-in raises `NotImplementedError` naming its field.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from captra_tpu_torch.config.schema import Config
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.models.coordnet import canonicalize
from captra_tpu_torch.models.rotnet import (
    canonicalize_per_part, compose_track_pose, decode_rotation,
)
from captra_tpu_torch.pose.part_dof import Pose, tree_root


@dataclass
class TrackAux:
    """Per-frame outputs, stacked over tracked frames by
    `track_trajectory`."""
    pose: Pose                  # [B, P] fitted pose
    pred_labels: torch.Tensor   # [B, N]
    seg: torch.Tensor           # [B, N, S]
    nocs: torch.Tensor          # [B, N, 3P]


def check_track_supported(cfg: Config) -> None:
    """Raise for tracking options this slice of the port does not carry."""
    t = cfg.track
    unported = {
        "nocs_otf": t.nocs_otf,
        "track_cfg/motion_model": t.motion_model != "none",
        "track_cfg/refine_iters": t.refine_iters > 1,
        "track_cfg/conf_weighted_delta": t.conf_weighted_delta,
        "track_cfg/rot_fit": t.rot_fit != "delta",
        "track_cfg/delta_gain": t.delta_gain != 1.0,
        "track_cfg/scale_clamp": t.scale_clamp > 0.0,
        "track_cfg/fit_ransac": t.fit_ransac > 0,
        "track_cfg/nocs2d_label": t.nocs2d_label,
    }
    for field, asked in unported.items():
        if asked:
            raise NotImplementedError(f"{field} is not ported to "
                                      "captra_tpu_torch yet")


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def make_track_step(cfg: Config, coord_fn: Callable, rot_fn: Callable,
                    device=None):
    """Build the step: (pose [B, P], frame dict with points [B, N, 3] raw
    camera and optional labels [B, N]) -> (new pose, TrackAux).  Frame
    arrays are moved to `device` (CUDA unless given)."""
    device = resolve_device(device)
    check_track_supported(cfg)
    obj = cfg.obj
    root = tree_root(obj.tree)
    P = obj.num_parts

    @torch.no_grad()
    def step(pose: Pose, frame: dict):
        points_raw = _on(frame["points"], device)
        points_mean = torch.mean(points_raw, dim=1)          # [B, 3]
        points = points_raw - points_mean[:, None]

        # CoordNet in the root part's previous frame
        root_pose = Pose(rotation=pose.rotation[:, root],
                         translation=pose.translation[:, root],
                         scale=pose.scale[:, root])
        coord_out = coord_fn(canonicalize(points, points_mean, root_pose))
        seg, nocs = coord_out["seg"], coord_out["nocs"]
        pred_labels = torch.argmax(seg, dim=-1)              # [B, N]
        # gt_label: the frame's mask-derived labels drive the s/t fit
        if cfg.track.gt_label and "labels" in frame:
            labels = _on(frame["labels"], device)
        else:
            labels = pred_labels

        # RotNet in each part's previous frame
        canon_parts = canonicalize_per_part(points, points_mean, pose)
        delta, _ = decode_rotation(rot_fn(canon_parts, labels), obj.sym)

        B, N = labels.shape
        pred_npcs = nocs.reshape(B, N, P, 3).movedim(2, 1)   # [B, P, N, 3]
        new_pose = compose_track_pose(pose, delta, labels, pred_npcs,
                                      points, points_mean, num_parts=P,
                                      sym=obj.sym)
        return new_pose, TrackAux(pose=new_pose, pred_labels=pred_labels,
                                  seg=seg, nocs=nocs)

    return step


def track_trajectory(step: Callable, init_pose: Pose, frames: dict,
                     device=None):
    """Run the step over frames with leading time axis [T, B, ...].

    Frame 0's pose is the given init (the reference skips inference on
    frame 0 too); frames[1:] are tracked.  Returns (final pose, TrackAux
    stacked over the T-1 tracked frames)."""
    device = resolve_device(device)
    frames = {k: _on(v, device) for k, v in frames.items()}
    pose = init_pose.map(lambda x: _on(x, device))
    T = next(iter(frames.values())).shape[0]
    auxs = []
    for t in range(1, T):
        pose, aux = step(pose, {k: v[t] for k, v in frames.items()})
        auxs.append(aux)
    return pose, TrackAux(
        pose=Pose(*(torch.stack([getattr(a.pose, f) for a in auxs])
                    for f in ("rotation", "translation", "scale"))),
        pred_labels=torch.stack([a.pred_labels for a in auxs]),
        seg=torch.stack([a.seg for a in auxs]),
        nocs=torch.stack([a.nocs for a in auxs]))
