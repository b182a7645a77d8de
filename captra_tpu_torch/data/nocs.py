"""NOCS-REAL275 / CAMERA dataset reader (counterpart of
`captra_tpu/data/nocs.py`).

Data layout on disk (the reference's preprocessed output,
nocs_dataset.py:18-35):

    <root>/render/<mode>/<category>/<instance>/<track>/data/<frame>.npz
        each npz holds all_dict = {points [M,3], labels [M] (1=object),
                                   pose {rotation, translation, scale}, path}
    <root>/model_corners/<instance>.npy       # [2, 3] NPCS corners
    <root>/splits/<category>/<num_expr>/<mode>.txt

Per frame it perturbs the crop center/scale, ball-crops to `radius *
scale`, FPS-downsamples to num_points and derives NPCS from the GT pose
(read_cloud + base_generate_data, nocs_data_process.py:23-50).  Labels use
the NOCS convention 0 = object, 1 = background (`1 - seg`).  Real-mode
frames also carry the raw depth and instance mask (and, for mask-free
tracking, NOCS-2D detections) for the on-the-fly crop; the PNGs are read by
`data/image_io.py`, and an unreadable one raises.  Every random draw comes
from the reader's `np.random.RandomState(seed)`, in the JAX reader's order.
Line references (nocs_dataset.py:N, nocs_data_process.py:N) are to the
reference's datasets/nocs_data/.
"""
from __future__ import annotations

import glob
import os
from copy import deepcopy
from os.path import join as pjoin

import numpy as np

from captra_tpu_torch.config.schema import ObjCfg, PerturbCfg
from captra_tpu_torch.data import image_io
from captra_tpu_torch.data import numpy_ops as nops
from captra_tpu_torch.utils.misc import written_whole

# real_test sub-splits keyed by category keyword (nocs_data_process.py:57-66)
_EXTRA_SPLITS = {"bottle": ["shampoo_norm/scene_4"], "can": ["lotte"]}


def split_nocs_dataset(root_dset: str, obj_category: str, num_expr: str,
                       mode: str, bad_ins=()) -> list[str]:
    """Enumerate frame files for a split, writing
    splits/<cat>/<expr>/<mode>.txt
    (reference split_nocs_dataset, nocs_data_process.py:53-89)."""
    output_path = pjoin(root_dset, "splits", obj_category, num_expr)
    os.makedirs(output_path, exist_ok=True)
    if mode in ("real_test_can", "real_test_bottle"):
        extra, mode_dir = mode[10:], "real_test"
    else:
        extra, mode_dir = None, mode

    path = pjoin(root_dset, "render", mode_dir, obj_category)
    data_list = []
    for instance in sorted(os.listdir(path)):
        if instance.startswith(".") or instance in bad_ins:
            continue
        for track_dir in sorted(glob.glob(pjoin(path, instance, "*"))):
            frames = [f for f in glob.glob(pjoin(track_dir, "data", "*"))
                      if f.endswith(".npz")]
            frames.sort(key=lambda s: int(s.split(".")[-2].split("/")[-1]))
            data_list += frames
    if extra is not None:
        keywords = _EXTRA_SPLITS[extra]
        data_list = [f for f in data_list
                     if any(k in f for k in keywords)]
    with written_whole(pjoin(output_path, f"{mode}.txt")) as f:
        f.writelines(item + "\n" for item in data_list)
    return data_list


def read_cloud(cloud_dict: dict, num_points: int, radius_factor: float,
               perturb: PerturbCfg | None,
               rng: np.random.RandomState) -> tuple:
    """Crop + downsample one stored frame (reference read_cloud,
    nocs_data_process.py:23-40)."""
    cam = cloud_dict["points"]
    if len(cam) == 0:
        return None, None, None
    seg = cloud_dict["labels"]
    pose = deepcopy(cloud_dict["pose"])
    center = np.asarray(pose["translation"]).reshape(3).copy()
    scale = float(pose["scale"])
    if perturb is not None:
        center += nops.random_translation(perturb.t, (), perturb.kind,
                                          rng).reshape(3)
        scale += float(nops.random_vector(perturb.s, (1,), perturb.kind,
                                          rng)[0])
    crop_pose = {"translation": center.reshape(3, 1), "scale": scale}
    radius = scale * radius_factor
    idx = nops.crop_ball_from_pts(cam, center, radius, num_points, rng)
    return cam[idx], seg[idx], crop_pose


def base_generate_data(cam_points: np.ndarray, seg: np.ndarray, pose: dict):
    """NPCS labels from the GT pose (reference base_generate_data,
    nocs_data_process.py:43-50): nocs = R^T (x - t) / s for object points;
    labels = 1 - seg."""
    nocs = np.zeros_like(cam_points)
    obj = np.where(seg == 1)[0]
    t = np.asarray(pose["translation"]).reshape(1, 3)
    nocs[obj] = ((cam_points[obj] - t) / pose["scale"]) @ pose["rotation"]
    return {"points": cam_points.astype(np.float32),
            "labels": (1 - seg).astype(np.int64),
            "nocs": nocs.astype(np.float32)}


class NOCSDataset:
    """Single-frame NOCS dataset (reference NOCSDataset,
    nocs_dataset.py:103-230)."""

    def __init__(self, root_dset: str, obj_category: str, obj_cfg: ObjCfg,
                 num_expr: str = "exp", num_points: int = 4096,
                 mode: str = "train", truncate_length: int | None = None,
                 radius: float = 0.6, perturb: PerturbCfg | None = None,
                 downsampling: int | None = None, seed: int = 0,
                 nocs2d_path: str | None = None, max_dets: int = 16):
        self.root_dset = root_dset
        self.obj_category = obj_category
        self.obj_cfg = obj_cfg
        self.num_points = num_points
        self.mode = mode
        self.radius = radius
        self.perturb = perturb
        self.rng = np.random.RandomState(seed)
        # mask-free tracking: per-frame NOCS-2D detection results pre-fetched
        # alongside depth/mask (reference loads them per frame on the CPU
        # inside the tracking loop, nocs_data_process.py:206-229; here they
        # become fixed-K device arrays selected in-graph)
        self.nocs2d_path = nocs2d_path or None
        self.max_dets = max_dets
        self.file_list = self._collect(num_expr, truncate_length,
                                       downsampling)
        self.nocs_corner_cache: dict[str, np.ndarray] = {}
        self.invalid: set[int] = set()

    def _collect(self, num_expr, truncate_length, downsampling):
        idx_txt = pjoin(self.root_dset, "splits", self.obj_category, num_expr,
                        f"{self.mode}.txt")
        if not os.path.exists(idx_txt):
            split_nocs_dataset(self.root_dset, self.obj_category, num_expr,
                               self.mode, self.obj_cfg.bad_ins)
        with open(idx_txt, errors="replace") as f:
            file_list = [line.strip() for line in f if line.strip()]
        if downsampling:
            file_list = file_list[::downsampling]
        if truncate_length:
            file_list = file_list[:truncate_length]
        return file_list

    def __len__(self):
        return len(self.file_list)

    def _corners(self, instance: str) -> np.ndarray:
        if instance not in self.nocs_corner_cache:
            path = pjoin(self.root_dset, "model_corners", f"{instance}.npy")
            self.nocs_corner_cache[instance] = np.load(path).reshape(1, 2, 3)
        return self.nocs_corner_cache[instance]

    def frame_meta(self, index: int):
        path = self.file_list[index]
        instance, track_num, _, frame_i = path.split(".")[-2].split("/")[-4:]
        return path, instance, track_num, frame_i

    def __getitem__(self, index: int):
        path, instance, track_num, frame_i = self.frame_meta(index)
        if index not in self.invalid:
            cloud_dict = np.load(path, allow_pickle=True)["all_dict"].item()
            cam, seg, crop_pose = read_cloud(cloud_dict, self.num_points,
                                             self.radius, self.perturb,
                                             self.rng)
            if cam is None:
                self.invalid.add(index)
        if index in self.invalid:  # redraw (reference dataset.py:120-132)
            return self[(index + 1) % len(self)]

        data = base_generate_data(cam, seg, cloud_dict["pose"])
        pose = cloud_dict["pose"]
        meta = {
            "path": path,
            "ori_path": cloud_dict.get("path", ""),
            "pose": {"rotation": np.asarray(pose["rotation"], np.float32),
                     "translation": np.asarray(pose["translation"],
                                               np.float32).reshape(3, 1),
                     "scale": np.float32(pose["scale"])},
            "crop_pose": crop_pose,
            "nocs_corners": self._corners(instance).astype(np.float32),
        }
        if "real" in self.mode:
            meta["depth_path"] = cloud_dict.get("path", "")
            pre = self._pre_fetch(meta["depth_path"], instance)
            if pre is not None:
                meta["pre_fetched"] = pre
        return {"data": data, "meta": meta}

    def _pre_fetch(self, depth_path: str, instance: str):
        """Depth + instance mask for the OTF tracking path (reference
        nocs_dataset.py:74-89): mask pixels equal the instance's meta.txt
        number in the mask image's red channel.  None when the frame names
        no depth image or the file does not exist; a file that exists but
        cannot be read raises."""
        if not depth_path or not os.path.exists(depth_path):
            return None
        depth = image_io.read_png(depth_path, unchanged=True)
        meta_path = depth_path.replace("depth.png", "meta.txt")
        inst_num = -1
        with open(meta_path) as f:
            for line in f:
                inst_num = int(line.split()[0])
                if line.split()[-1] == instance:
                    break
        # the mask's name is the depth image's with "depth" -> "mask" (the
        # JAX reader renames the whole path, directories too)
        folder, name = os.path.split(depth_path)
        mask_img = image_io.read_png(pjoin(folder,
                                           name.replace("depth", "mask")))
        mask = mask_img[:, :, 2] == inst_num
        pre = {"depth": depth.astype(np.int32), "mask": mask}
        if self.nocs2d_path:
            pre.update(self._pre_fetch_dets(depth_path, depth.shape))
        return pre

    def _pre_fetch_dets(self, depth_path: str, image_hw) -> dict:
        """Fixed-K detection arrays for in-graph NOCS-2D mask selection:
        det_masks [K, H, ceil(W/8)] uint8 (bit-packed along W, little
        bit-order — unpacked in-graph by preprocess.unpack_detection_masks),
        det_boxes [K, 4] (y1,x1,y2,x2) float32, det_valid [K] bool.

        Only same-class detections are kept (reference filters with
        `pred_class_ids == int(category)`, nocs_data_process.py:215-217),
        so K bounds the per-class count, not the raw detector output.
        Missing result pickles / no same-class detections yield all-invalid
        frames (the tracker then keeps the prior mask, matching the
        reference's fallthrough)."""
        from captra_tpu_torch.data.nocs2d import load_nocs2d_result
        K = self.max_dets
        H, W = image_hw
        W8 = -(-W // 8)
        masks = np.zeros((K, H, W8), np.uint8)
        boxes = np.zeros((K, 4), np.float32)
        valid = np.zeros((K,), bool)
        result = load_nocs2d_result(self.nocs2d_path, depth_path)
        if result is not None:
            cls = np.asarray(result["pred_class_ids"])
            sel_all = np.where(cls == int(self.obj_category))[0]
            if len(sel_all) > K:
                # reference considers every same-class detection; a frame
                # exceeding the fixed budget is worth knowing about
                print(f"nocs2d: {len(sel_all)} same-class detections in "
                      f"{depth_path}, keeping first {K}")
            sel = sel_all[:K]
            n = len(sel)
            if n:
                pm = np.moveaxis(np.asarray(result["pred_masks"]),
                                 -1, 0)[sel].astype(bool)
                pad = W8 * 8 - W
                if pad:
                    pm = np.pad(pm, ((0, 0), (0, 0), (0, pad)))
                masks[:n] = np.packbits(pm, axis=-1, bitorder="little")
                boxes[:n] = np.asarray(result["pred_bboxes"],
                                       np.float32)[sel]
                valid[:n] = True
        return {"det_masks": masks, "det_boxes": boxes,
                "det_valid": valid}

    def track_index(self) -> dict[str, list[int]]:
        """Group frame indices by (instance, track) in order — the sequence
        structure for tracking (reference SequenceData, dataset.py:135-194)."""
        tracks: dict[str, list[int]] = {}
        for i in range(len(self)):
            _, instance, track_num, _ = self.frame_meta(i)
            tracks.setdefault(f"{instance}/{track_num}", []).append(i)
        return tracks
