"""3D bounding boxes and IoU (counterpart of `captra_tpu/pose/bbox.py`).

Plain torch: the JAX package leaves this to XLA, and so does the port to
PyTorch's own kernels.  The oriented-box IoU samples a 50^3 grid over the
pair's joint extent (`iou_3d`); the symmetric categories' 20-way y-rotation
sweep is a loop with a running max (`eval_single_part_iou`), so a sweep
over the grid IoU holds one sweep step's grid at a time.

Every sum of three products is written out left to right as separate
multiplies and adds, so the CPU and the card round each grid point alike.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from captra_tpu_torch.device import constant
from captra_tpu_torch.pose.part_dof import Pose, apply_pose
from captra_tpu_torch.utils.precision import f32_precision

# corner index convention: corner i has x = corners[(i % 4) // 2, 0],
# y = corners[i // 4, 1], z = corners[i % 2, 2] with corners [2, 3] = (min,
# max) rows
_CORNER_SEL = np.array([[(i % 4) // 2, i // 4, i % 2] for i in range(8)])


def bbox_from_corners(corners: torch.Tensor) -> torch.Tensor:
    """[..., 2, 3] (min/max) -> 8 box vertices [..., 8, 3]."""
    sel = constant(tuple(map(tuple, _CORNER_SEL.tolist())), torch.int64,
                   corners.device)
    dims = constant((0, 1, 2), torch.int64, corners.device)
    return corners[..., sel, dims]


def yaxis_from_corners(corners: torch.Tensor) -> torch.Tensor:
    """Keep only the y extent (symmetric categories supervise only the y
    axis)."""
    return corners * constant((0.0, 1.0, 0.0), corners.dtype, corners.device)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) over 3 components, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


@f32_precision
def pts_inside_box(pts: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """pts [..., M, 3], bbox [..., 8, 3] -> bool [..., M]: strictly inside
    along the three box edges from vertex 0 (1 / 2 / 4 differ from it in
    z / x / y, the JAX package's edge choice)."""
    u1 = bbox[..., 2, :] - bbox[..., 0, :]  # x edge
    u2 = bbox[..., 4, :] - bbox[..., 0, :]  # y edge
    u3 = bbox[..., 1, :] - bbox[..., 0, :]  # z edge
    up = pts - bbox[..., 0:1, :]
    inside = torch.ones(up.shape[:-1], dtype=torch.bool, device=pts.device)
    for u in (u1, u2, u3):
        p = _dot3(up, u[..., None, :])
        inside &= (p > 0) & (p < _dot3(u, u)[..., None])
    return inside


@functools.lru_cache(maxsize=None)
def _unit_grid(nres: int) -> np.ndarray:
    """The [nres^3, 3] grid over the unit cube, axes in "ij" order, built
    from the values of `jnp.linspace(0, 1, nres)` (float32 i times the
    float32 reciprocal of nres - 1, the last value exactly 1)."""
    lin = np.arange(nres, dtype=np.float32) * (
        np.float32(1.0) / np.float32(max(nres - 1, 1)))
    lin[-1] = 1.0
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1)
    return np.ascontiguousarray(g.reshape(-1, 3))


def iou_3d(bbox1: torch.Tensor, bbox2: torch.Tensor,
           nres: int = 50) -> torch.Tensor:
    """Grid-sampled oriented-box IoU; bbox [..., 8, 3] -> [...] (an empty
    union gives 1)."""
    both = torch.cat([bbox1, bbox2], dim=-2)
    bmin = torch.amin(both, dim=-2)
    bmax = torch.amax(both, dim=-2)
    grid = torch.from_numpy(_unit_grid(nres)).to(bbox1.device)
    pts = bmin[..., None, :] + grid * (bmax - bmin)[..., None, :]
    f1 = pts_inside_box(pts, bbox1)
    f2 = pts_inside_box(pts, bbox2)
    inter = torch.sum(f1 & f2, dim=-1).float()
    union = torch.sum(f1 | f2, dim=-1).float()
    return torch.where(union == 0, 1.0, inter / torch.clamp(union, min=1.0))


def aabb_iou_3d(bbox1: torch.Tensor, bbox2: torch.Tensor) -> torch.Tensor:
    """Axis-aligned IoU of the boxes' extents (the rigid NOCS protocol)."""
    mx1, mn1 = torch.amax(bbox1, dim=-2), torch.amin(bbox1, dim=-2)
    mx2, mn2 = torch.amax(bbox2, dim=-2), torch.amin(bbox2, dim=-2)
    overlap = torch.minimum(mx1, mx2) - torch.maximum(mn1, mn2)
    inter = torch.where(torch.amin(overlap, dim=-1) < 0, 0.0,
                        torch.prod(overlap, dim=-1))
    vol1 = torch.prod(mx1 - mn1, dim=-1)
    vol2 = torch.prod(mx2 - mn2, dim=-1)
    return inter / (vol1 + vol2 - inter)


def pred_nocs_corners(pred_labels: torch.Tensor, pred_nocs: torch.Tensor,
                      num_parts: int) -> torch.Tensor:
    """Symmetric NPCS corners per part from predicted seg + coords.

    pred_labels [B, N], pred_nocs [B, N, 3] -> [B, P, 2, 3] as
    (-size, +size) with size = max |coord| over the part's points; an
    empty part gives zeros."""
    part_ids = torch.arange(num_parts, device=pred_labels.device)
    mask = pred_labels[:, None, :] == part_ids[None, :, None]  # [B, P, N]
    absn = torch.abs(pred_nocs)[:, None]                         # [B, 1, N, 3]
    size = torch.amax(torch.where(mask[..., None], absn, 0.0), dim=-2)
    return torch.stack([-size, size], dim=-2)


@f32_precision
def posed_bbox_from_part(pose: Pose, corners: torch.Tensor) -> torch.Tensor:
    """corners [B, P, 2, 3] + pose [B, P] -> posed box vertices
    [B, P, 8, 3]."""
    return apply_pose(pose, bbox_from_corners(corners))


def _y_rotation_matrices(n: int, device=None) -> torch.Tensor:
    """n rotations about y by 2 pi k / n, [n, 3, 3] float32."""
    theta = 2.0 * math.pi * torch.arange(n, dtype=torch.float32,
                                         device=device) / n
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    m = torch.stack([c, zero, s, zero, one, zero, -s, zero, c], dim=-1)
    return m.reshape(n, 3, 3)


@f32_precision
def eval_single_part_iou(gt_corners: torch.Tensor,
                         pred_corners: torch.Tensor, gt_pose: Pose,
                         pred_pose: Pose, nocs: bool = False,
                         sym: bool = False, n_sym: int = 20) -> dict:
    """npcs_iou / iou / gt_bbox_iou per (batch, part).

    gt_corners, pred_corners: [B, P, 2, 3].  `nocs` takes the axis-aligned
    IoU, else the grid IoU.  For symmetric categories the posed-box IoUs take
    the max over `n_sym` rotations of the GT pose about its y axis, one
    rotation at a time."""
    iou_fn = aabb_iou_3d if nocs else iou_3d
    gt_npcs_bbox = bbox_from_corners(gt_corners)
    pred_npcs_bbox = bbox_from_corners(pred_corners)

    pred_posed = posed_bbox_from_part(pred_pose, pred_corners)
    pred_posed_gt = posed_bbox_from_part(pred_pose, gt_corners)

    if sym:
        iou = gt_bbox_iou = None
        for rot in _y_rotation_matrices(n_sym, gt_corners.device):
            gt_posed = posed_bbox_from_part(
                Pose(rotation=gt_pose.rotation @ rot,
                     translation=gt_pose.translation, scale=gt_pose.scale),
                gt_corners)
            a = iou_fn(gt_posed, pred_posed)
            b = iou_fn(gt_posed, pred_posed_gt)
            iou = a if iou is None else torch.maximum(iou, a)
            gt_bbox_iou = b if gt_bbox_iou is None else torch.maximum(
                gt_bbox_iou, b)
    else:
        gt_posed = posed_bbox_from_part(gt_pose, gt_corners)
        iou = iou_fn(gt_posed, pred_posed)
        gt_bbox_iou = iou_fn(gt_posed, pred_posed_gt)

    npcs_iou = iou_fn(gt_npcs_bbox, pred_npcs_bbox)
    return {"npcs_iou": npcs_iou, "iou": iou, "gt_bbox_iou": gt_bbox_iou}
