"""Synthetic raw depth video for the OTF tracking step, in numpy: the
port's copy of `make_depth_frames` / `make_det_frames` and the init pose of
`scripts/bench_otf.py` (:32-66, :117-124), draw for draw the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from captra_tpu_torch.data.preprocess import (
    NOCS_REAL_INTRINSICS, backproject_depth,
)
from captra_tpu_torch.pose.part_dof import Pose


def make_depth_frames(T: int, B: int, H: int = 480, W: int = 640,
                      seed: int = 0):
    """Flat background at 1.5 m + a moving 90-pixel square object blob at
    about 1.0 m -> (depths int32 [T, B, H, W] in mm, masks bool
    [T, B, H, W])."""
    rng = np.random.RandomState(seed)
    depths = np.full((T, B, H, W), 1500, np.int32)
    masks = np.zeros((T, B, H, W), bool)
    for b in range(B):
        ox, oy = rng.randint(200, 360), rng.randint(150, 260)
        for t in range(T):
            m = np.zeros((H, W), bool)
            m[oy + t:oy + t + 90, ox + t:ox + t + 90] = True
            depths[t, b][m] = 1000 + rng.randint(-20, 20)
            masks[t, b] = m
    return depths, masks


def make_det_frames(depths: np.ndarray, masks: np.ndarray, K: int = 8):
    """Detection results for the mask-free path: per frame, detection 0 is
    the object blob, bit-packed along W (little bit order); the others are
    invalid.  -> {"det_masks" uint8 [T, B, K, H, ceil(W/8)], "det_boxes"
    float32 [T, B, K, 4] (y1, x1, y2, x2), "det_valid" bool [T, B, K]}."""
    T, B, H, W = depths.shape
    m = np.asarray(masks)
    packed = np.packbits(m, axis=-1, bitorder="little")
    det_masks = np.zeros((T, B, K) + packed.shape[-2:], np.uint8)
    det_masks[:, :, 0] = packed
    det_boxes = np.zeros((T, B, K, 4), np.float32)
    for t in range(T):
        for b in range(B):
            ys, xs = np.nonzero(m[t, b])
            det_boxes[t, b, 0] = (ys.min(), xs.min(), ys.max(), xs.max())
    det_valid = np.zeros((T, B, K), bool)
    det_valid[:, :, 0] = True
    return {"det_masks": det_masks, "det_boxes": det_boxes,
            "det_valid": det_valid}


def otf_init_pose(depth0: np.ndarray, mask0: np.ndarray, B: int,
                  num_parts: int, intrinsics=NOCS_REAL_INTRINSICS,
                  scale: float = 0.3) -> Pose:
    """Frame-0 pose of every trajectory: identity rotation, the mean of the
    masked points of one depth frame [H, W], and a fixed scale (CPU
    tensors)."""
    H, W = depth0.shape
    pts, _ = backproject_depth(torch.from_numpy(np.asarray(depth0)),
                               intrinsics)
    c0 = pts.numpy().reshape(H, W, 3)[np.asarray(mask0)].mean(0)
    P = num_parts
    return Pose(
        rotation=torch.eye(3).expand(B, P, 3, 3).clone(),
        translation=torch.from_numpy(c0).reshape(1, 1, 3, 1).expand(
            B, P, 3, 1).clone(),
        scale=torch.full((B, P), scale))
