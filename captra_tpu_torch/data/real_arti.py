"""Sim-to-real articulated datasets: BMVC laptop + captured real drawers
(counterpart of `captra_tpu/data/real_arti.py`).

Line references (bmvc_dataset.py:13-37, real_arti_dataset.py:33-120) are
to the reference's datasets/arti_data/.  Both serve preprocessed per-frame
data; the real-capture variant applies the camera-axis permutation and
derives normalized per-part corners from the annotated extents; its FPS
pre-subsample draws from the reader's `np.random.RandomState(seed)`.
"""
from __future__ import annotations

import json
import os
import pickle
from os.path import join as pjoin

import numpy as np

from captra_tpu_torch.data import numpy_ops as nops

# camera-axis permutation for the real capture rig
# (reference real_arti_dataset.py:74)
REAL_AXIS_PERMUTATION = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]],
                                 np.float64)

# part naming for the captured drawers (real_arti_dataset.py:66-68)
DRAWERS_NAME2NUM = {"drawer3": 0, "drawer2": 1, "drawer1": 2, "body": 3}


class BMVCDataset:
    """Preprocessed BMVC laptop trajectories (instance '0'); frames are
    pickles of {points, labels, nocs, nocs2camera}
    (reference bmvc_dataset.py:13-37)."""

    def __init__(self, root_dset: str, obj_category: str, track: int = 0,
                 truncate_length: int | None = None):
        self.data_path = pjoin(root_dset, "preproc", obj_category, "0",
                               str(track))
        self.len = len([f for f in os.listdir(self.data_path)
                        if f.endswith(".pkl")])
        if truncate_length is not None:
            self.len = min(self.len, truncate_length)

    def __len__(self):
        return self.len

    def __getitem__(self, i: int):
        path = pjoin(self.data_path, f"{i:05d}.pkl")
        with open(path, "rb") as f:
            full_data = pickle.load(f)
        pose = full_data.pop("nocs2camera")
        meta = {"path": path, "pose": pose}
        if "nocs_corners" in full_data:
            meta["nocs_corners"] = full_data.pop("nocs_corners")
        return {"data": full_data, "meta": meta}

    def track_index(self):
        return {"0/0": list(range(self.len))}


def real_pose_and_corners(all_pose: dict | list, meta: dict, frame_i: int,
                          name2num: dict = DRAWERS_NAME2NUM):
    """Annotated JSON pose + extents -> (per-part sRt list, corners [P,2,3])
    (reference real_arti_dataset.py:60-80): scale = extent diagonal, corners
    normalized by it, camera axes permuted."""
    num_parts = len(name2num)
    num2name = {v: k for k, v in name2num.items()}
    extents = np.stack([np.asarray(meta[num2name[p]]["size"])
                        for p in range(num_parts)])
    radius = np.linalg.norm(extents, axis=-1)
    extents = extents / radius[:, None]
    corners = np.stack([-extents * 0.5, extents * 0.5], axis=1)

    poses = []
    for p in range(num_parts):
        entry = all_pose[int(frame_i)][num2name[p]]
        R = REAL_AXIS_PERMUTATION @ np.asarray(entry["R"]).reshape(3, 3)
        t = REAL_AXIS_PERMUTATION @ np.asarray(entry["t"]).reshape(3, 1)
        poses.append({"rotation": R.astype(np.float32),
                      "translation": t.astype(np.float32),
                      "scale": np.float32(radius[p])})
    return poses, corners.astype(np.float32)


class SAPIENRealDataset:
    """Captured real trajectories: raw clouds + optional annotated GT poses
    (reference SAPIENRealDataset, real_arti_dataset.py:33-120)."""

    def __init__(self, root_dset: str, obj_category: str,
                 num_points: int = 4096, truncate_length: int | None = None,
                 seed: int = 0, downsampling: int | None = None):
        self.root_dset = root_dset
        self.obj_category = obj_category
        self.num_points = num_points
        self.rng = np.random.RandomState(seed)
        render = pjoin(root_dset, "render", obj_category)
        self.file_list = []
        for instance in sorted(os.listdir(render)):
            for track in sorted(os.listdir(pjoin(render, instance))):
                cdir = pjoin(render, instance, track, "cloud")
                if not os.path.isdir(cdir):
                    continue
                frames = sorted(os.listdir(cdir),
                                key=lambda s: int(s.split(".")[0]))
                self.file_list += [pjoin(cdir, f) for f in frames]
        if downsampling:
            self.file_list = self.file_list[::downsampling]
        if truncate_length:
            self.file_list = self.file_list[:truncate_length]

    def __len__(self):
        return len(self.file_list)

    def frame_meta(self, index: int):
        path = self.file_list[index]
        parts = path.split("/")
        instance, track = parts[-4], parts[-3]
        frame_i = parts[-1].split(".")[0]
        return path, instance, track, frame_i

    def __getitem__(self, index: int):
        path, instance, track, frame_i = self.frame_meta(index)
        points = np.load(path, allow_pickle=True)["point"]
        while len(points) < self.num_points:
            points = np.concatenate([points, points])
        fps_idx = nops.farthest_point_sample(points, self.num_points,
                                             self.rng)
        points = points[fps_idx].astype(np.float32)

        data = {"points": points}
        meta = {"path": path}
        pose_path = pjoin(self.root_dset, "real_pose", self.obj_category,
                          instance, f"{track}.json")
        meta_path = pjoin(self.root_dset, "real_pose", self.obj_category,
                          instance, "meta.json")
        if os.path.exists(pose_path) and os.path.exists(meta_path):
            with open(pose_path) as f:
                all_pose = json.load(f)
            with open(meta_path) as f:
                meta_json = json.load(f)
            poses, corners = real_pose_and_corners(all_pose, meta_json,
                                                   frame_i)
            meta["pose"] = poses
            meta["nocs_corners"] = corners
        return {"data": data, "meta": meta}

    def track_index(self):
        tracks: dict[str, list[int]] = {}
        for i in range(len(self)):
            _, instance, track, _ = self.frame_meta(i)
            tracks.setdefault(f"{instance}/{track}", []).append(i)
        return tracks
