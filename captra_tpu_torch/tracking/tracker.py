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

With `nocs_otf` the frames carry raw sensor data instead of points --
depth [B, H, W], mask [B, H, W], optionally the NOCS-2D detections
(`nocs2d_label`) -- and the step backprojects and ball-crops them on the
step's device from the carried pose (`data/preprocess.py`).  The crop's one
random input, a cyclic shift per cloud, comes from frame["shift"] [B] when
the frame carries it, else from the `generator` given to `make_track_step`
(the JAX step draws it from `jax.random`, which torch cannot reproduce).

This slice carries the default `TrackCfg` plus `gt_label`, `nocs_otf` and
`nocs2d_label`; every other tracking opt-in raises `NotImplementedError`
naming its field.  Line references (tracker.py:N) are to the JAX package's
`captra_tpu/tracking/tracker.py`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from captra_tpu_torch.config.schema import Config
from captra_tpu_torch.data.preprocess import (
    NOCS_REAL_INTRINSICS, backproject_depth_planes, crop_ball_batch_planes,
    intrinsics_tensor, select_detection_mask, unpack_detection_masks,
)
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
        "track_cfg/motion_model": t.motion_model != "none",
        "track_cfg/refine_iters": t.refine_iters > 1,
        "track_cfg/conf_weighted_delta": t.conf_weighted_delta,
        "track_cfg/rot_fit": t.rot_fit != "delta",
        "track_cfg/delta_gain": t.delta_gain != 1.0,
        "track_cfg/scale_clamp": t.scale_clamp > 0.0,
        "track_cfg/fit_ransac": t.fit_ransac > 0,
    }
    for field, asked in unported.items():
        if asked:
            raise NotImplementedError(f"{field} is not ported to "
                                      "captra_tpu_torch yet")


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def make_track_step(cfg: Config, coord_fn: Callable, rot_fn: Callable,
                    device=None, intrinsics=None,
                    generator: torch.Generator | None = None):
    """Build the step: (pose [B, P], frame dict) -> (new pose, TrackAux).

    A frame carries points [B, N, 3] (raw camera) and optional labels
    [B, N]; with `cfg.track.nocs_otf` it carries depth [B, H, W] (integer
    mm) and mask [B, H, W] instead, plus optional "shift" [B] (the crop's
    cyclic shifts, in [0, H*W)) and, for `nocs2d_label`, det_masks
    [B, K, H, ceil(W/8)] uint8 (bit-packed), det_boxes [B, K, 4] and
    det_valid [B, K].  Frame arrays are moved to `device` (CUDA unless
    given).  `intrinsics` [3, 3] defaults to the NOCS real camera;
    `generator` (on `device`) draws the shifts of frames that carry none."""
    device = resolve_device(device)
    check_track_supported(cfg)
    obj = cfg.obj
    root = tree_root(obj.tree)
    P = obj.num_parts
    track = cfg.track
    K = intrinsics_tensor(NOCS_REAL_INTRINSICS if intrinsics is None
                          else intrinsics, device)

    def otf_points(pose: Pose, frame: dict):
        """Raw depth -> cropped points [B, N, 3], mask labels [B, N] and
        frame_ok [B] (tracker.py:366-429)."""
        depth = _on(frame["depth"], device)
        B = depth.shape[0]
        image_hw = tuple(depth.shape[-2:])
        center = pose.translation[:, root, :, 0]              # [B, 3]
        radius = cfg.data_radius * pose.scale[:, root]        # [B]
        if "shift" in frame:
            shift = _on(frame["shift"], device)
        elif generator is not None:
            shift = torch.randint(0, image_hw[0] * image_hw[1], (B,),
                                  generator=generator, device=device)
        else:
            raise ValueError("an OTF frame needs frame['shift'] or a "
                             "generator given to make_track_step")

        if track.nocs2d_label and "det_masks" in frame:
            # mask-free tracking: select the detection in the step; a frame
            # with no valid detection keeps its instance mask, or, with
            # none, labels every cropped point object (tracker.py:381-413).
            # The selection indexes the packed masks, and only the chosen
            # one is unpacked.
            packed, found = select_detection_mask(
                _on(frame["det_masks"], device),
                _on(frame["det_boxes"], device),
                _on(frame["det_valid"], device), center, radius, K,
                image_hw)
            picked = unpack_detection_masks(packed, image_hw)
            prior = (_on(frame["mask"], device).bool() if "mask" in frame
                     else torch.ones_like(picked))
            masks = torch.where(found[:, None, None], picked, prior)
        else:
            masks = _on(frame["mask"], device)

        pts3, valid = backproject_depth_planes(depth, K)
        points3, idx = crop_ball_batch_planes(
            shift, pts3, valid, center, radius, cfg.num_points,
            work_factor=track.otf_work_factor, fps_mode=track.otf_fps_mode)
        labels = 1 - torch.gather(masks.reshape(B, -1), 1, idx).long()
        # total sensor dropout: the step freezes the carried pose
        frame_ok = valid.any(-1)
        return points3.transpose(1, 2), labels, frame_ok

    @torch.no_grad()
    def step(pose: Pose, frame: dict):
        frame_ok = None
        frame_labels = frame.get("labels")
        if track.nocs_otf:
            points_raw, frame_labels, frame_ok = otf_points(pose, frame)
        else:
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
        # gt_label / nocs2d_label: the frame's mask-derived labels drive the
        # s/t fit (tracker.py:460-464)
        if (track.gt_label or track.nocs2d_label) \
                and frame_labels is not None:
            labels = _on(frame_labels, device)
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
        if frame_ok is not None:
            # a frame with no valid depth carries the previous pose through
            # (tracker.py:535-545)
            new_pose = Pose(*(
                torch.where(frame_ok.reshape((B,) + (1,) * (n.dim() - 1)),
                            n, o)
                for n, o in ((new_pose.rotation, pose.rotation),
                             (new_pose.translation, pose.translation),
                             (new_pose.scale, pose.scale))))
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
