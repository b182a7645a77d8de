"""SAPIEN articulated dataset reader (counterpart of
`captra_tpu/data/sapien.py`).

Disk layout (the reference's rendered output):
    <root>/render[_seq]/<category>/<instance>/<track>/cloud/<frame>.npz
        all_dict = {depth (OpenGL), seg, camera_matrix, near, far}
    <root>/render[_seq]/<category>/<instance>/<track>/gt/<frame>.pkl
        {camera_pose: (p, q), link_pose: {part: (p, q)}}
    <root>/urdf/<category>/<instance>/mobility.urdf  (offline info only)
    <root>/model_info/<category>/<instance>.pkl      (precomputed info)
    <root>/preproc[_seq]/...: two-tier pickle cache (cloud + full), in the
        JAX package's layout and contents, so each package reads the
        other's cache.

Every random draw (the FPS pre-subsample, the per-part coverage fix-up)
comes from the reader's own `np.random.RandomState(seed)`, in the JAX
reader's order.  Depth-sensor perturbation (`read_cloud(perturb=True)`,
training augmentation) draws from the caller's `rng` in the JAX function's
order with OpenCV present, and blurs with `data/blur.py` (no OpenCV).
Line references (arti_data_process.py:N, data_utils.py:N) are to the
reference's datasets/.
"""
from __future__ import annotations

import os
import pickle
from os.path import join as pjoin

import numpy as np

from captra_tpu_torch.config.schema import ObjCfg
from captra_tpu_torch.data import numpy_ops as nops
from captra_tpu_torch.data.blur import gaussian_blur
from captra_tpu_torch.utils.misc import written_whole


# ---------------------------------------------------------------------------
# pose-chain helpers (reference data_utils.py:206-258)
# ---------------------------------------------------------------------------

def pose_pq_to_mat(pq) -> np.ndarray:
    """(position [3], quaternion wxyz [4]) -> 4x4 homogeneous matrix."""
    p, q = np.asarray(pq[0]), np.asarray(pq[1])
    w, x, y, z = q / np.linalg.norm(q)
    mat = np.eye(4)
    mat[:3, :3] = np.array([
        [1 - 2*y*y - 2*z*z, 2*x*y - 2*z*w, 2*x*z + 2*y*w],
        [2*x*y + 2*z*w, 1 - 2*x*x - 2*z*z, 2*y*z - 2*x*w],
        [2*x*z - 2*y*w, 2*y*z + 2*x*w, 1 - 2*x*x - 2*y*y]])
    mat[:3, 3] = p
    return mat


def multiply_pose(a, b):
    """Compose 4x4 poses; either side may be a per-part dict
    (reference multiply_pose, data_utils.py:218-230)."""
    keys_a = list(a.keys()) if isinstance(a, dict) else None
    keys_b = list(b.keys()) if isinstance(b, dict) else None
    keys = keys_b if keys_a is None else keys_a
    if keys is None:
        return a @ b
    return {k: (a if keys_a is None else a[k]) @
               (b if keys_b is None else b[k]) for k in keys}


def inv_pose(pose):
    if isinstance(pose, dict):
        return {k: np.linalg.inv(v) for k, v in pose.items()}
    return np.linalg.inv(pose)


def pose2srt(pose):
    """Scaled-homogeneous 4x4 -> {rotation, translation, scale}
    (reference pose2srt, data_utils.py:240-248)."""
    if isinstance(pose, dict):
        return [pose2srt(pose[p]) for p in range(len(pose))]
    scale = 1.0 / pose[3, 3]
    return {"rotation": pose[:3, :3].astype(np.float32),
            "translation": (pose[:3, 3:] * scale).astype(np.float32),
            "scale": np.float32(scale)}


def get_obj2norm_pose(corner, factor) -> np.ndarray:
    """Mesh frame -> normalized part coordinate frame
    (reference get_obj2norm_pose, data_utils.py:251-258)."""
    scaling = np.eye(4)
    scaling[3, 3] = 1.0 / factor
    center = (np.asarray(corner[0]) + np.asarray(corner[1])) * 0.5
    trans = np.eye(4)
    trans[:3, 3] = -center * factor
    return trans @ scaling


# ---------------------------------------------------------------------------
# depth -> cloud (reference arti_data_process.read_cloud :33-91)
# ---------------------------------------------------------------------------

_PERMUTATION = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)


def perturb_depth(depth: np.ndarray, mask: np.ndarray,
                  rng: np.random.RandomState, sigma: float = 0.000075,
                  noise_prob: float = 0.5, max_ksize: int = 6) -> np.ndarray:
    """Depth-sensor noise simulation (reference gaussian_noise /
    gaussian_blur, arti_data_process.py:16-30): Gaussian noise of a std
    drawn in [0, sigma) on a random half of the masked pixels, then a
    Gaussian blur (sigma 0.2) of a drawn odd size in [3, 2 * (max_ksize //
    2) + 1].  Draws from `rng`: the pixel mask, the std, a full image of
    normals, the kernel size.  Points displaced > 5 cm get relabelled as
    clutter by the caller (arti_data_process.py:53-58)."""
    depth = depth.copy()
    prob_mask = rng.uniform(size=depth.shape) < noise_prob
    m = np.bitwise_and(prob_mask, mask)
    std = rng.uniform(0, sigma)
    depth[m] += rng.normal(0, std, size=depth.shape)[m]
    ksize = 2 * rng.randint(1, max_ksize // 2 + 1) + 1
    return gaussian_blur(depth, ksize, 0.2)


def opengl_depth_to_points(cloud_dict: dict, pixel_mask=None):
    """OpenGL depth buffer -> camera points + per-pixel seg labels of the
    pixels with depth < 1, or of `pixel_mask` (which pins the pixel set
    when perturbed depth is read again, so the points stay aligned,
    arti_data_process.py:44-58)."""
    depth = np.asarray(cloud_dict["depth"])
    seg_img = np.asarray(cloud_dict["seg"])
    camera_matrix = np.asarray(cloud_dict["camera_matrix"])
    near, far = cloud_dict["near"], cloud_dict["far"]
    y, x = np.where((depth < 1) if pixel_mask is None else pixel_mask)
    z = near * far / (far + depth[y, x] * (near - far))
    uv1 = np.stack([x, y, np.ones_like(x)], axis=0) * z
    pts = (_PERMUTATION @ (np.linalg.inv(camera_matrix) @ uv1)).T
    return pts.astype(np.float32), seg_img[y, x]


def read_cloud(cloud_dict: dict, num_points: int,
               rng: np.random.RandomState, min_dis: float = 2.0,
               synthetic: bool = False, num_parts: int | None = None,
               perturb: bool = False):
    """Depth -> FPS-downsampled cloud with per-part minimum-coverage fixup
    (reference read_cloud, arti_data_process.py:33-91).  With `perturb`,
    sensor noise is simulated (`perturb_depth`) and points displaced > 5 cm
    are relabelled as clutter (arti_data_process.py:53-58)."""
    cam_points, seg = opengl_depth_to_points(cloud_dict)
    if perturb:
        depth = np.asarray(cloud_dict["depth"])
        pert = dict(cloud_dict)
        pert["depth"] = perturb_depth(depth.astype(np.float64),
                                      depth < 1, rng)
        pert_points, _ = opengl_depth_to_points(pert, pixel_mask=depth < 1)
        displaced = np.linalg.norm(cam_points - pert_points, axis=-1) > 0.05
        seg = seg.copy()
        seg[displaced] = seg.max() - 1
        cam_points = pert_points
    if not synthetic:
        keep = cam_points[:, 0] < min_dis
        cam_points, seg = cam_points[keep], seg[keep]
    while len(cam_points) < num_points:
        cam_points = np.concatenate([cam_points, cam_points])
        seg = np.concatenate([seg, seg])
    fps_idx = nops.farthest_point_sample(cam_points, num_points, rng)
    if num_parts is not None:
        # ensure >= 10 points per part (arti_data_process.py:68-79)
        threshold = 10
        tmp_seg = seg[fps_idx]
        extra = []
        for p in range(num_parts):
            deficit = threshold - np.count_nonzero(tmp_seg == p)
            if deficit > 0:
                cand = np.where(seg == p)[0]
                if len(cand):
                    extra.append(cand[rng.permutation(len(cand))[:threshold]])
        if extra:
            extra = np.concatenate(extra)
            slots = rng.permutation(len(fps_idx))[:len(extra)]
            fps_idx[slots] = extra
    return cam_points[fps_idx], seg[fps_idx]


def base_generate_data(model_info: dict, cam_points: np.ndarray,
                       seg: np.ndarray, cam2world: np.ndarray,
                       link2world: dict):
    """Per-frame GT: NPCS coordinates + per-part nocs2camera sRt
    (reference base_generate_data, arti_data_process.py:113-126)."""
    obj2link = model_info["obj2link"]
    factors, corners = model_info["factor"], model_info["corner"]
    num_parts = len(corners)
    obj2npcs = {p: get_obj2norm_pose(corners[p], factors[p])
                for p in range(num_parts)}
    obj2cam = multiply_pose(inv_pose(cam2world),
                            multiply_pose(link2world, obj2link))
    cam2npcs = multiply_pose(obj2npcs, inv_pose(obj2cam))
    npcs2cam = pose2srt(inv_pose(cam2npcs))

    cam_h = np.concatenate([cam_points,
                            np.ones_like(cam_points[..., :1])], axis=-1)
    nocs = np.zeros_like(cam_points)
    for p in range(num_parts):
        idx = np.where(seg == p)[0]
        if len(idx):
            cur = cam_h[idx] @ cam2npcs[p].T
            nocs[idx] = cur[..., :3] / cur[..., 3:]
    return {"points": cam_points.astype(np.float32),
            "labels": seg.astype(np.int64),
            "nocs": nocs.astype(np.float32),
            "nocs2camera": npcs2cam}


class SAPIENDataset:
    """Articulated single-frame dataset with the reference's two-tier pickle
    cache (reference SAPIENDataset, sapien_dataset.py:86-162)."""

    def __init__(self, root_dset: str, obj_category: str, obj_cfg: ObjCfg,
                 num_expr: str = "exp", num_points: int = 4096,
                 mode: str = "train", truncate_length: int | None = None,
                 synthetic: bool = True, seed: int = 0,
                 model_info_loader=None, downsampling: int | None = None):
        self.root_dset = root_dset
        self.obj_category = obj_category
        self.obj_cfg = obj_cfg
        self.num_points = num_points
        self.mode = mode
        self.syn_seq = mode in ("train_seq", "test_seq")
        self.suffix = "_seq" if self.syn_seq else ""
        self.synthetic = synthetic
        self.rng = np.random.RandomState(seed)
        self.model_info_loader = model_info_loader or self._load_model_info
        self.model_info_cache: dict[str, dict] = {}
        self.file_list = self._collect(num_expr, truncate_length,
                                       downsampling)

    # -- file enumeration ---------------------------------------------------
    def _collect(self, num_expr, truncate_length, downsampling=None):
        render = pjoin(self.root_dset, f"render{self.suffix}",
                       self.obj_category)
        file_list = []
        test_set = set(self.obj_cfg.test_list)
        for instance in sorted(os.listdir(render)):
            if instance.startswith("."):
                continue
            is_test = instance in test_set
            if (self.mode.startswith("train") and is_test) or \
               (self.mode.startswith("test") and not is_test):
                continue
            for track in sorted(os.listdir(pjoin(render, instance))):
                cdir = pjoin(render, instance, track, "cloud")
                if not os.path.isdir(cdir):
                    continue
                frames = sorted(os.listdir(cdir),
                                key=lambda s: int(s.split(".")[0]))
                file_list += [pjoin(render, instance, track, "cloud", f)
                              for f in frames]
        if downsampling:
            file_list = file_list[::downsampling]
        if truncate_length:
            file_list = file_list[:truncate_length]
        return file_list

    def _load_model_info(self, instance: str) -> dict:
        """Precomputed pickle if present, else parse the URDF + meshes
        (reference generate_instance_info, arti_data_process.py:129-148)."""
        path = pjoin(self.root_dset, "model_info", self.obj_category,
                     f"{instance}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        from captra_tpu_torch.data.urdf import generate_instance_info
        return generate_instance_info(self.root_dset, self.obj_category,
                                      instance)

    def model_info(self, instance: str) -> dict:
        if instance not in self.model_info_cache:
            self.model_info_cache[instance] = self.model_info_loader(instance)
        return self.model_info_cache[instance]

    def __len__(self):
        return len(self.file_list)

    def frame_meta(self, index: int):
        path = self.file_list[index]
        parts = path.split("/")
        instance, track, _, fname = parts[-4:]
        return path, instance, track, fname.split(".")[0]

    def __getitem__(self, index: int):
        path, instance, track, frame_i = self.frame_meta(index)
        base = os.path.dirname(os.path.dirname(path))

        # two-tier cache: full > cloud > raw (sapien_dataset.py:41-71)
        preproc = base.replace(f"render{self.suffix}",
                               f"preproc{self.suffix}")
        full_path = pjoin(preproc, "full", f"{frame_i}.pkl")
        if os.path.exists(full_path):
            with open(full_path, "rb") as f:
                full_data = pickle.load(f)
        else:
            cloud_cache = pjoin(preproc, "cloud", f"{frame_i}.pkl")
            if os.path.exists(cloud_cache):
                with open(cloud_cache, "rb") as f:
                    cd = pickle.load(f)
                cam_points, seg = cd["cam"], cd["seg"]
            else:
                cloud_dict = np.load(path, allow_pickle=True)[
                    "all_dict"].item()
                cam_points, seg = read_cloud(
                    cloud_dict, self.num_points, self.rng,
                    synthetic=self.synthetic,
                    num_parts=(self.obj_cfg.num_parts if self.synthetic
                               else None))
                os.makedirs(os.path.dirname(cloud_cache), exist_ok=True)
                with written_whole(cloud_cache, "wb") as f:
                    pickle.dump({"cam": cam_points, "seg": seg}, f)
            with open(pjoin(base, "gt", f"{frame_i}.pkl"), "rb") as f:
                gt = pickle.load(f)
            cam2world = pose_pq_to_mat(gt["camera_pose"])
            link2world = {k: pose_pq_to_mat(pq)
                          for k, pq in gt["link_pose"].items()}
            full_data = base_generate_data(self.model_info(instance),
                                           cam_points, seg, cam2world,
                                           link2world)
            os.makedirs(os.path.dirname(full_path), exist_ok=True)
            with written_whole(full_path, "wb") as f:
                pickle.dump(full_data, f)

        info = self.model_info(instance)
        corners = np.stack([np.asarray(c, np.float32).reshape(2, 3)
                            for c in info["norm_corner"]]) \
            if "norm_corner" in info else _norm_corners(info)
        meta = {"path": path,
                "pose": full_data["nocs2camera"],
                "nocs_corners": corners}
        data = {k: full_data[k] for k in ("points", "labels", "nocs")}
        return {"data": data, "meta": meta}

    def track_index(self) -> dict[str, list[int]]:
        tracks: dict[str, list[int]] = {}
        for i in range(len(self)):
            _, instance, track, _ = self.frame_meta(i)
            tracks.setdefault(f"{instance}/{track}", []).append(i)
        return tracks


def _norm_corners(model_info: dict) -> np.ndarray:
    """Normalized per-part NPCS corners from mesh corners + factors
    (the normalized analogue of data_transforms.py:22-29)."""
    out = []
    for corner, factor in zip(model_info["corner"], model_info["factor"]):
        corner = np.asarray(corner, np.float64).reshape(2, 3)
        center = corner.mean(0)
        out.append(((corner - center) * factor).astype(np.float32))
    return np.stack(out)
