"""Tracking results saved for the offline evaluator (counterpart of
`captra_tpu/tracking/results.py`).

One pickle per trajectory holding the predicted and GT pose arrays, the
NPCS-derived corners and the frame numbers.  The pickle holds numpy arrays
only, never tensors, so the JAX package's evaluator reads the port's files
and the port's evaluator reads the JAX package's.
"""
from __future__ import annotations

import os
import pickle
from os.path import join as pjoin

import numpy as np
import torch

from captra_tpu_torch.pose.bbox import pred_nocs_corners
from captra_tpu_torch.pose.part_dof import Pose


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pose_to_numpy(pose: Pose) -> dict:
    return {"rotation": _numpy(pose.rotation),
            "translation": _numpy(pose.translation),
            "scale": _numpy(pose.scale)}


def corners_from_track_aux(aux, num_parts: int) -> np.ndarray:
    """Per-frame predicted NPCS corners from the tracked seg + nocs.
    aux: TrackAux stacked [T, B, ...]; returns [T, B, P, 2, 3] (index
    [:, b] for one trajectory)."""
    labels, nocs = aux.pred_labels, aux.nocs
    T, B, N = labels.shape
    idx = torch.clamp(labels, 0, num_parts - 1)[..., None, None].expand(
        T, B, N, 1, 3)
    own = torch.gather(nocs.reshape(T, B, N, num_parts, 3), -2, idx)[..., 0, :]
    corners = pred_nocs_corners(labels.reshape(T * B, N),
                                own.reshape(T * B, N, 3), num_parts)
    return _numpy(corners.reshape(T, B, num_parts, 2, 3))


def save_track_result(out_dir: str, name: str, pred_poses: Pose,
                      gt_poses: Pose | None, pred_corners,
                      gt_corners, frame_nums: list | None = None) -> str:
    """Write <out_dir>/data/<name>.pkl.  Pose leading dims [T, P]; corners
    [T, P, 2, 3] (pred) and [P, 2, 3] (GT).  gt_poses None (a GT-less
    capture) saves the predictions only."""
    data_dir = pjoin(out_dir, "data")
    os.makedirs(data_dir, exist_ok=True)
    payload = {
        "pred": {"poses": pose_to_numpy(pred_poses),
                 "corners": _numpy(pred_corners)},
        "gt": (None if gt_poses is None else
               {"poses": pose_to_numpy(gt_poses),
                "corners": _numpy(gt_corners)}),
        "frame_nums": frame_nums or [],
    }
    path = pjoin(data_dir, f"{name}.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path
