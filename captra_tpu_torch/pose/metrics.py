"""Pose-error metrics (counterpart of `captra_tpu/pose/metrics.py`)."""
from __future__ import annotations

import math

import torch

from captra_tpu_torch.utils.precision import f32_precision


@f32_precision
def rot_diff_rad(rot1: torch.Tensor, rot2: torch.Tensor,
                 yaxis_only: bool = False) -> torch.Tensor:
    """Geodesic rotation distance in radians; for symmetric categories only
    the angle between the y columns counts."""
    if yaxis_only:
        y1, y2 = rot1[..., 1], rot2[..., 1]
        d = torch.clamp(torch.sum(y1 * y2, dim=-1), -1.0, 1.0)
        return torch.arccos(d)
    mat_diff = rot1 @ rot2.transpose(-1, -2)
    tr = mat_diff[..., 0, 0] + mat_diff[..., 1, 1] + mat_diff[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))


def rot_diff_degree(rot1, rot2, yaxis_only: bool = False) -> torch.Tensor:
    return rot_diff_rad(rot1, rot2, yaxis_only=yaxis_only) / math.pi * 180.0


def trans_diff(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """L2 translation error; t [..., 3, 1]."""
    return torch.linalg.norm((t1 - t2)[..., 0], dim=-1)


def scale_diff(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    return torch.abs(s1 - s2)


def theta_diff(theta1: torch.Tensor, theta2: torch.Tensor) -> torch.Tensor:
    return torch.abs(theta1 - theta2)
