"""Offline evaluation: per-frame pose errors, 3D IoU and joint states
(counterpart of `captra_tpu/eval/evaluator.py`).

Reads the per-trajectory pickles of `tracking.results.save_track_result`
(the port's or the JAX package's) and writes err.pkl and err.csv, with the
JAX package's keys, header and row order, then prints the averages.  A
whole trajectory evaluates in one batch of tensor calls on `device` (CUDA
unless given).
"""
from __future__ import annotations

import csv
import os
import pickle
from os.path import join as pjoin

import numpy as np
import torch

from captra_tpu_torch.config.schema import ObjCfg
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.pose.bbox import eval_single_part_iou
from captra_tpu_torch.pose.metrics import rot_diff_degree
from captra_tpu_torch.pose.part_dof import Pose, eval_part_full
from captra_tpu_torch.utils.precision import f32_precision


@f32_precision
def get_joint_state(obj: ObjCfg, pose: Pose) -> torch.Tensor:
    """Per-joint state [..., J]: revolute = the relative rotation angle
    (degrees) between child and parent; prismatic = the child-parent
    displacement along `main_axis` in the parent frame.  pose has the part
    axis last: [..., P]."""
    states = []
    for c, p in enumerate(obj.tree):
        if p == -1:
            continue
        if obj.joint_type == "revolute":
            state = rot_diff_degree(pose.rotation[..., c, :, :],
                                    pose.rotation[..., p, :, :])
        else:
            p_rot = pose.rotation[..., p, :, :]
            rel = p_rot.transpose(-1, -2) @ (
                pose.translation[..., c, :, :] -
                pose.translation[..., p, :, :])
            axis_index = obj.main_axis[len(states)]
            state = rel[..., axis_index, 0]
        states.append(state)
    if states:
        return torch.stack(states, dim=-1)
    return torch.zeros(pose.scale.shape[:-1] + (0,),
                       device=pose.scale.device)


def eval_trajectory(pred_poses: Pose, gt_poses: Pose,
                    pred_corners: torch.Tensor, gt_corners: torch.Tensor,
                    obj: ObjCfg, eval_iou: bool = True) -> dict:
    """Per-frame errors over a trajectory (frame 0, whose pose is given, is
    left out by the caller).  Poses [T, P]; corners [T, P, 2, 3] (pred) and
    [P, 2, 3] (GT), all on one device.  Returns {metric: [T] or [T, P]}
    numpy arrays."""
    rigid = obj.num_parts == 1
    out = {}
    diffs = eval_part_full(gt_poses, pred_poses, yaxis_only=obj.sym)
    for k, v in diffs.items():
        out[k] = v.cpu().numpy()  # [T, P]

    if eval_iou:
        gt_c = torch.broadcast_to(gt_corners, pred_corners.shape)
        iou = eval_single_part_iou(gt_c, pred_corners, gt_poses, pred_poses,
                                   nocs=rigid, sym=obj.sym)
        for k, v in iou.items():
            out[k] = v.cpu().numpy()

    if not rigid:
        js = get_joint_state(obj, pred_poses)
        gt_js = get_joint_state(obj, gt_poses)
        out["theta_diff"] = torch.abs(js - gt_js).cpu().numpy()  # [T, J]
    return out


def flatten_per_frame(name: str, traj_metrics: dict) -> dict:
    """-> {f'{name}_{frame}': {metric_part: float}}, frames from 1: one csv
    row a tracked frame, one column a metric and part (or joint)."""
    rows = {}
    T = next(iter(traj_metrics.values())).shape[0]
    for t in range(T):
        row = {}
        for metric, arr in traj_metrics.items():
            vals = np.atleast_1d(arr[t])
            for j, v in enumerate(vals.reshape(-1)):
                row[f"{metric}_{j}"] = float(v)
        rows[f"{name}_{t + 1}"] = row
    return rows


def summarize(error_dict: dict) -> dict:
    """Every metric averaged over the rows."""
    sums: dict[str, float] = {}
    counts: dict[str, int] = {}
    for row in error_dict.values():
        for k, v in row.items():
            sums[k] = sums.get(k, 0.0) + v
            counts[k] = counts.get(k, 0) + 1
    return {k: sums[k] / counts[k] for k in sums}


def write_outputs(error_dict: dict, out_dir: str, stem: str = "err") -> str:
    """<stem>.pkl and <stem>.csv (a name column, then the metrics in sorted
    order; rows sorted by name)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(pjoin(out_dir, f"{stem}.pkl"), "wb") as f:
        pickle.dump(error_dict, f)
    keys = sorted({k for row in error_dict.values() for k in row})
    with open(pjoin(out_dir, f"{stem}.csv"), "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["name"] + keys)
        for name in sorted(error_dict):
            row = error_dict[name]
            writer.writerow([name] + [row.get(k, "") for k in keys])
    return pjoin(out_dir, f"{stem}.pkl")


def _pose_on(poses: dict, device: torch.device) -> Pose:
    return Pose(**{k: torch.as_tensor(np.asarray(v)).to(device)
                   for k, v in poses.items()})


def evaluate_results_dir(results_dir: str, obj: ObjCfg,
                         eval_iou: bool = True, verbose: bool = True,
                         device=None):
    """Evaluate every saved trajectory pickle under results_dir/data on
    `device` (CUDA unless given); artifacts without GT are skipped.  Writes
    err.pkl / err.csv into results_dir and returns (rows, averages)."""
    device = resolve_device(device)
    data_dir = pjoin(results_dir, "data")
    error_dict = {}
    for raw in sorted(os.listdir(data_dir)):
        if not raw.endswith(".pkl"):
            continue
        name = raw[:-4]
        with open(pjoin(data_dir, raw), "rb") as f:
            data = pickle.load(f)
        pred, gt = data["pred"], data["gt"]
        if gt is None:
            continue              # a GT-less capture: nothing to score
        tm = eval_trajectory(
            _pose_on(pred["poses"], device), _pose_on(gt["poses"], device),
            torch.as_tensor(np.asarray(pred["corners"])).to(device),
            torch.as_tensor(np.asarray(gt["corners"])).to(device), obj,
            eval_iou=eval_iou)
        error_dict.update(flatten_per_frame(name, tm))
    write_outputs(error_dict, results_dir)
    avg = summarize(error_dict)
    if verbose:
        for k in sorted(avg):
            print(f"{k}: {avg[k]:.6f}")
    return error_dict, avg
