"""Offline sim-to-real preprocessing: BMVC laptop frames and robot-captured
real trajectories (counterpart of `captra_tpu/data/preproc_arti.py`).

Line references are to the reference's datasets/arti_data/
(preproc_laptop_bmvc.py: depth + per-part masks + info files -> frames;
preproc_real_arti.py: capture pickles -> per-frame cloud npz with the
camera-axis permutation).  Host numpy; the RGB frames are written by
`data/image_io.write_png` (no OpenCV).
"""
from __future__ import annotations

import os
import pickle
from os.path import join as pjoin

import numpy as np

from captra_tpu_torch.data.image_io import write_png
from captra_tpu_torch.data.real_arti import REAL_AXIS_PERMUTATION
from captra_tpu_torch.data.sapien import get_obj2norm_pose, inv_pose, pose2srt


def point_cloud_from_depth(depth: np.ndarray,
                           intrinsics: np.ndarray) -> np.ndarray:
    """Dense backprojection with the BMVC conventions (y-up pixel grid, z
    negated; preproc_laptop_bmvc.py:24-43): metric depth [H, W] -> points
    [M, 3] of the depth > 0 pixels."""
    H, W = depth.shape
    px, py = np.meshgrid(np.arange(W, dtype=np.float64),
                         np.arange(H, dtype=np.float64))
    py = H - 1 - py
    x = (px - intrinsics[0, 2]) * depth / intrinsics[0, 0]
    y = (py - intrinsics[1, 2]) * depth / intrinsics[1, 1]
    z = -depth
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    return pts[depth.reshape(-1) > 0]


def bmvc_frame(depth_m: np.ndarray, part_masks: list[np.ndarray],
               pose_mats: dict, model_info: dict, intrinsics: np.ndarray,
               num_points_per_part: int | None = None, rng=None) -> dict:
    """One BMVC frame -> {points, labels, nocs, nocs2camera}
    (preproc_laptop_bmvc.py:47-120).

    depth_m: metric depth [H, W]; part_masks: binary [H, W] a part;
    pose_mats: {part: 4x4 canon -> camera}; model_info: corner / factor a
    part.  A part's cloud above `num_points_per_part` is cut by
    `rng.permutation`, part by part."""
    rng = rng or np.random
    num_parts = len(part_masks)
    pts_list, seg_list = [], []
    for p in range(num_parts):
        cloud = point_cloud_from_depth(depth_m * part_masks[p], intrinsics)
        if num_points_per_part and len(cloud) > num_points_per_part:
            cloud = cloud[rng.permutation(len(cloud))[:num_points_per_part]]
        pts_list.append(cloud.astype(np.float32))
        seg_list.append(np.full(len(cloud), p, np.int64))
    points = np.concatenate(pts_list)
    seg = np.concatenate(seg_list)

    # canon -> camera pose a part becomes nocs2camera through the part's
    # normalization (corner, factor)
    nocs = np.zeros_like(points)
    npcs2cam = []
    for p in range(num_parts):
        obj2npcs = get_obj2norm_pose(model_info["corner"][p],
                                     model_info["factor"][p])
        cam2npcs = obj2npcs @ inv_pose(np.asarray(pose_mats[p], np.float64))
        npcs2cam.append(pose2srt(inv_pose(cam2npcs)))
        m = seg == p
        hom = np.concatenate([points[m],
                              np.ones_like(points[m][:, :1])], axis=-1)
        cur = hom @ cam2npcs.T
        nocs[m] = (cur[:, :3] / cur[:, 3:]).astype(np.float32)
    return {"points": points, "labels": seg, "nocs": nocs,
            "nocs2camera": npcs2cam}


def process_capture_pickle(pkl_path: str, output_path: str,
                           save_rgb: bool = True) -> int:
    """Robot-capture pickle {point_cloud: [T x [H, W, 3]], image: [T]} ->
    cloud/<i>.npz (camera axes permuted) and, with `save_rgb`, rgb/<i>.png
    of each frame that has an image (BGR, as OpenCV writes it)
    (preproc_real_arti.py:20-35).  Returns the number of frames."""
    os.makedirs(pjoin(output_path, "cloud"), exist_ok=True)
    if save_rgb:
        os.makedirs(pjoin(output_path, "rgb"), exist_ok=True)
    with open(pkl_path, "rb") as f:
        all_dict = pickle.load(f)
    points_list = all_dict["point_cloud"]
    image_list = all_dict.get("image", [None] * len(points_list))
    for i, raw in enumerate(points_list):
        raw = np.asarray(raw).reshape(-1, 3)
        point = raw @ np.asarray(REAL_AXIS_PERMUTATION).T
        np.savez_compressed(pjoin(output_path, "cloud", f"{i}.npz"),
                            point=point.astype(np.float32))
        if save_rgb and image_list[i] is not None:
            write_png(pjoin(output_path, "rgb", f"{i}.png"),
                      np.asarray(image_list[i]))
    return len(points_list)
