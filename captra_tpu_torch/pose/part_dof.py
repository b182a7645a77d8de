"""Per-part 9-DoF pose algebra over a `Pose` of tensors (counterpart of
`captra_tpu/pose/part_dof.py`).

A pose is (R in SO(3), t in R^3, s > 0) per part; articulated objects carry
one pose per part plus a kinematic `tree` (parent indices, -1 = root).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from captra_tpu_torch.utils.precision import f32_precision


@dataclass
class Pose:
    """Batch of per-part similarity poses.

    rotation:    [..., 3, 3]
    translation: [..., 3, 1]
    scale:       [...]
    Leading dims are typically [B, P] (batch, parts).
    """
    rotation: torch.Tensor
    translation: torch.Tensor
    scale: torch.Tensor

    @classmethod
    def identity(cls, shape: Sequence[int] = (), dtype=torch.float32,
                 device=None) -> "Pose":
        shape = tuple(shape)
        return cls(
            rotation=torch.eye(3, dtype=dtype, device=device).expand(
                shape + (3, 3)).clone(),
            translation=torch.zeros(shape + (3, 1), dtype=dtype,
                                    device=device),
            scale=torch.ones(shape, dtype=dtype, device=device),
        )

    def __getitem__(self, idx) -> "Pose":
        return Pose(self.rotation[idx], self.translation[idx], self.scale[idx])

    def map(self, fn) -> "Pose":
        return Pose(fn(self.rotation), fn(self.translation), fn(self.scale))

    def to(self, *args, **kwargs) -> "Pose":
        return self.map(lambda x: x.to(*args, **kwargs))


# ---------------------------------------------------------------------------
# kinematic tree helpers
# ---------------------------------------------------------------------------

def tree_root(tree: Sequence[int]) -> int:
    """Root part index of a parent list."""
    roots = [p for p, parent in enumerate(tree) if parent == -1]
    if len(roots) != 1:
        raise ValueError(f"tree {tree} must have exactly one root")
    return roots[0]


# ---------------------------------------------------------------------------
# applying poses
# ---------------------------------------------------------------------------

@f32_precision
def apply_pose(pose: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Pose canonical points into camera space: s * (pts @ R.T) + t.
    pose leading dims [..., P]; pts [..., P, N, 3] (rows)."""
    est = pts @ pose.rotation.transpose(-1, -2)
    est = est * pose.scale[..., None, None]
    return est + pose.translation.transpose(-1, -2)


@f32_precision
def inverse_apply_pose(pose: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Camera -> canonical: R.T (pts - t) / s, row layout."""
    est = pts - pose.translation.transpose(-1, -2)
    est = est @ pose.rotation  # rows (R^T x)^T
    return est / pose.scale[..., None, None]


@f32_precision
def canonicalize_columns(pose: Pose, pts_c3n: torch.Tensor) -> torch.Tensor:
    """Camera -> canonical for column layout [..., 3, N] (the network input
    path)."""
    cam = pts_c3n - pose.translation
    cam = pose.rotation.transpose(-1, -2) @ cam
    return cam / pose.scale[..., None, None]


# ---------------------------------------------------------------------------
# pose composition
# ---------------------------------------------------------------------------

@f32_precision
def merge_delta_pose(base: Pose, delta_rotation: torch.Tensor | None = None,
                     delta_scale: torch.Tensor | None = None,
                     delta_trans: torch.Tensor | None = None) -> Pose:
    """Compose a canonical-frame delta onto a base pose:

        R <- R_base @ R_delta
        s <- s_delta * s_base
        t <- t_base + s_base * R_base @ t_delta
    """
    rotation, translation, scale = base.rotation, base.translation, base.scale
    if delta_rotation is not None:
        rotation = base.rotation @ delta_rotation
    if delta_scale is not None:
        scale = delta_scale * base.scale
    if delta_trans is not None:
        translation = base.translation + base.scale[..., None, None] * (
            base.rotation @ delta_trans)
    return Pose(rotation=rotation, translation=translation, scale=scale)

