"""NOCS-2D detection-mask selection for mask-free real tracking
(counterpart of `captra_tpu/data/nocs2d.py`).

Line references (nocs_data_process.py:N) are to the reference's
datasets/nocs_data/nocs_data_process.py (compute_2d_bbox_iou :166-179; the
detection-selection loop inside full_data_from_depth_image :206-229).
When tracking without GT instance masks (`track_cfg.nocs2d_label`), each
frame's object mask comes from a pre-computed 2D detector result: the
detection of the right class whose 2D box best overlaps the projection of
the tracked 3D ball.
"""
from __future__ import annotations

import os
import pickle
from os.path import join as pjoin

import numpy as np

# NOCS real-camera intrinsics (reference nocs_data_process.py:20)
REAL_INTRINSICS = np.array([[591.0125, 0, 322.525],
                            [0, 590.16775, 244.11084], [0, 0, 1]])


def _project(pts, intrinsics, scale=1000.0):
    """Camera points [N, 3] -> pixel (x, y) [N, 2] (reference project,
    nocs_utils.py:37-41)."""
    pts = pts * scale
    pts = -pts / pts[:, -1:]
    pts[:, -1] = -pts[:, -1]
    return (intrinsics @ pts.T).T[:, :2]


def compute_2d_bbox_iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """box [4] (y1, x1, y2, x2) vs boxes [K, 4] -> IoU [K]
    (reference compute_2d_bbox_iou, nocs_data_process.py:166-179)."""
    y1 = np.maximum(box[0], boxes[:, 0])
    y2 = np.minimum(box[2], boxes[:, 2])
    x1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[3], boxes[:, 3])

    def area(x1, x2, y1, y2):
        return np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)

    inter = area(x1, x2, y1, y2)
    union = (area(box[1], box[3], box[0], box[2]) +
             area(boxes[:, 1], boxes[:, 3], boxes[:, 0], boxes[:, 2]) -
             inter)
    return inter / np.maximum(union, 1e-9)


def projected_track_bbox(image_hw, center: np.ndarray, radius: float,
                         intrinsics=REAL_INTRINSICS) -> np.ndarray:
    """Project the tracked ball's axis-aligned cube to a 2D (y1,x1,y2,x2)
    window (reference get_proj_corners, nocs_data_process.py:133-145)."""
    h, w = image_hw
    radius = max(float(radius), 0.05)
    corners = np.array(
        [[cx, cy, cz] for cx in (center[0] - radius, center[0] + radius)
         for cy in (center[1] - radius, center[1] + radius)
         for cz in (center[2] - radius, center[2] + radius)])
    proj = _project(corners, np.asarray(intrinsics)).astype(
        np.int64)[:, [1, 0]]
    proj[:, 0] = h - proj[:, 0]
    lo = np.maximum(proj.min(0), 0)
    hi = np.minimum(proj.max(0), np.array([h - 1, w - 1]))
    return np.array([lo[0], lo[1], hi[0], hi[1]])


def select_nocs2d_mask(result: dict, category: int, image_hw,
                       center: np.ndarray, radius: float,
                       intrinsics=REAL_INTRINSICS,
                       min_iou: float = 0.05, max_radius: float = 0.5):
    """Pick the detection mask tracking should use this frame
    (reference nocs_data_process.py:206-229): same-class detections ranked
    by 2D IoU against the projected tracked box, growing the projection
    radius x1.2 until a hit or `max_radius`.  Returns mask [H, W] or None.
    """
    pred_class_ids = np.asarray(result["pred_class_ids"])
    pred_bboxes = np.asarray(result["pred_bboxes"])
    same = pred_class_ids == int(category)
    if same.sum() == 0:
        return None
    r = float(radius)
    while True:
        track_box = projected_track_bbox(image_hw, center, r, intrinsics)
        ious = compute_2d_bbox_iou(track_box, pred_bboxes) * same
        if np.max(ious) > min_iou or r > max_radius:
            break
        r *= 1.2
    best = int(np.argmax(ious))
    return np.asarray(result["pred_masks"])[..., best]


def load_nocs2d_result(nocs2d_path: str, depth_path: str) -> dict | None:
    """results_test_<scene>_<frame>.pkl lookup from a depth path
    (reference nocs_data_process.py:207-212)."""
    scene_name, frame_file = depth_path.split("/")[-2:]
    frame_num = frame_file[:4]
    path = pjoin(nocs2d_path, f"results_test_{scene_name}_{frame_num}.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)
