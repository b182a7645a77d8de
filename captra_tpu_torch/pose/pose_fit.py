"""Per-part scale/translation fit from predicted NPCS + labels (counterpart
of `captra_tpu/pose/pose_fit.py`, without the opt-in RANSAC path).

The rotation is given, so no 3D SVD runs here: only the closed-form 2D
y-axis refinement for symmetric categories.
"""
from __future__ import annotations

import torch

from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.pose.procrustes import similarity_fit
from captra_tpu_torch.utils.precision import f32_precision


def labels_to_part_mask(labels: torch.Tensor, num_parts: int) -> torch.Tensor:
    """labels [..., N] in [0, P + extra) -> float mask [..., P, N].  Labels
    >= num_parts (background / extra seg channels) select no part."""
    part_ids = torch.arange(num_parts, device=labels.device)
    mask = labels[..., None, :] == part_ids[:, None]  # [..., P, N]
    return mask.float()


def _all_finite(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x).all(dim=-1).all(dim=-1)


def filter_valid(pose: Pose, valid: torch.Tensor,
                 min_scale: float | None = None) -> torch.Tensor:
    """AND `valid` with finiteness of every pose component and, when
    `min_scale` is given, with scale > min_scale (the tracking-only floor:
    a ~zero fitted scale is always a degenerate fit and would divide the
    next frame's canonicalization to inf)."""
    valid = valid & torch.isfinite(pose.scale)
    if min_scale is not None:
        valid = valid & (pose.scale > min_scale)
    valid = valid & _all_finite(pose.translation)
    valid = valid & _all_finite(pose.rotation)
    return valid


@f32_precision
def part_fit_st(labels: torch.Tensor, source: torch.Tensor,
                target: torch.Tensor, rotation: torch.Tensor,
                num_parts: int, sym: bool,
                given_scale: torch.Tensor | None = None,
                min_scale: float | None = None):
    """Fit per-part scale + translation given rotation.

    labels [B, N]; source (pred NPCS per part) [B, P, N, 3]; target (camera
    points) [B, P, N, 3]; rotation [B, P, 3, 3].  Returns (Pose [B, P],
    valid [B, P] bool): valid needs > 3 in-part points and a finite fit.
    The sym-refined rotation only serves the s/t fit; the returned pose
    keeps the given rotation."""
    mask = labels_to_part_mask(labels, num_parts)  # [B, P, N]
    valid = torch.sum(mask, dim=-1) > 3
    _, scale, translation = similarity_fit(
        source, target, mask, given_scale=given_scale, rotation=rotation,
        sym=sym)
    pose = Pose(rotation=rotation, translation=translation, scale=scale)
    return pose, filter_valid(pose, valid, min_scale=min_scale)
