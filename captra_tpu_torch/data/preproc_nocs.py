"""Offline NOCS preprocessing: GT-pose recovery, instance lists, per-instance
frame gathering (counterpart of `captra_tpu/data/preproc_nocs.py`).

Host numpy, an offline batch job fanned out over processes by
`run_parallel`; the RANSAC draws and the SVDs are the JAX package's own
numpy calls in its order, so both packages recover the same poses bit for
bit.  The raw PNGs are read by `data/image_io.py` (no OpenCV), which gives
OpenCV's BGR layout, and the backprojection of a masked frame runs in the
host core (`data/native.py`).  Line references (get_gt_poses.py:N,
gather_instance_data.py:N, ...) are to the reference's
datasets/nocs_data/preproc_nocs/.
"""
from __future__ import annotations

import multiprocessing
import os
from os.path import join as pjoin

import numpy as np
import torch

from captra_tpu_torch.data import image_io, native
from captra_tpu_torch.pose.bbox import bbox_from_corners

# float64, as the JAX package's: NOCS_REAL_INTRINSICS of data/preprocess.py
# is float32, and its inverse would move every backprojected point
SYNTHETIC_INTRINSICS = np.array([[577.5, 0, 319.5], [0., 577.5, 239.5],
                                 [0., 0., 1.]])
REAL_INTRINSICS = np.array([[591.0125, 0, 322.525],
                            [0, 590.16775, 244.11084], [0, 0, 1]])

EPS = 1e-6


# ---------------------------------------------------------------------------
# numpy Umeyama + RANSAC (align_pose.py:49-93)
# ---------------------------------------------------------------------------

def umeyama(source: np.ndarray, target: np.ndarray):
    """Batched similarity fit target ~= s R source + t; src/tgt [..., N, 3]
    -> (R [..., 3, 3], s [...], t [..., 3, 1])."""
    src_c = source - source.mean(-2, keepdims=True)
    tgt_c = target - target.mean(-2, keepdims=True)
    M = np.swapaxes(tgt_c, -1, -2) @ src_c
    U, _, Vh = np.linalg.svd(M, full_matrices=True)
    d = np.linalg.det(U @ Vh)
    mid = np.zeros_like(U)
    mid[..., 0, 0] = 1.0
    mid[..., 1, 1] = 1.0
    mid[..., 2, 2] = d
    R = U @ mid @ Vh
    rotated = src_c @ np.swapaxes(R, -1, -2)
    s = (np.sum(rotated * tgt_c, axis=(-1, -2)) /
         (np.sum(src_c * src_c, axis=(-1, -2)) + EPS))
    t = np.mean(target - s[..., None, None] *
                (source @ np.swapaxes(R, -1, -2)), axis=-2)[..., None]
    return R, s, t


def umeyama_ransac(source: np.ndarray, target: np.ndarray,
                   num_hyps: int = 64, inlier_th: float = 1e-3,
                   rng=None):
    """RANSAC similarity fit: `num_hyps` 3-point hypotheses (3 distinct
    indices each, from one `rng.rand` draw), the best's inliers refit.
    Returns {rotation, scale, translation}, or None when there are fewer
    than 3 points or 3 inliers."""
    rng = rng or np.random
    n = len(source)
    if n < 3:
        return None
    sample_idx = np.argpartition(rng.rand(num_hyps, n), 2, axis=-1)[:, :3]
    R, s, t = umeyama(source[sample_idx], target[sample_idx])

    posed = s[:, None, None] * (source[None] @ np.swapaxes(R, -1, -2)) + \
        np.swapaxes(t, -1, -2)  # [H, N, 3]
    err = np.linalg.norm(target[None] - posed, axis=-1)  # [H, N]
    score = (err < inlier_th).sum(-1)
    best = int(np.argmax(score))
    inliers = np.where(err[best] < inlier_th)[0]
    if len(inliers) < 3:
        return None
    R, s, t = umeyama(source[inliers], target[inliers])
    return {"rotation": R, "scale": float(s), "translation": t}


# ---------------------------------------------------------------------------
# raw-frame IO
# ---------------------------------------------------------------------------

def read_depth(path: str) -> np.ndarray:
    """A raw depth PNG -> uint16 [H, W]: a grey PNG as stored, a 3-channel
    one (CAMERA's composed depth) as G * 256 + R."""
    depth = image_io.read_png(path, unchanged=True)
    if depth.ndim == 3:
        depth = (np.uint16(depth[:, :, 1]) * 256 +
                 np.uint16(depth[:, :, 2])).astype(np.uint16)
    return depth


def backproject(depth, intrinsics, mask=None, scale=0.001):
    """Depth [H, W] -> (camera points [M, 3] of the valid pixels, their
    (rows, cols)) with the NOCS conventions (v = H - row, z negated): in
    the host core (float32 points) when `mask` is given, as the JAX package
    does whenever its core is built; else in numpy (float64)."""
    if mask is not None:
        pts, valid = native.backproject(depth.astype(np.uint16), intrinsics,
                                        mask.astype(np.uint8), scale)
        idxs = np.where(valid.reshape(depth.shape))
        return pts.reshape(depth.shape + (3,))[idxs], idxs
    h, w = depth.shape
    idxs = np.where(depth > 0)
    uv1 = np.stack([idxs[1], h - idxs[0], np.ones_like(idxs[1])], 0)
    xyz = (np.linalg.inv(intrinsics) @ uv1).T
    z = depth[idxs].astype(np.float32)
    pts = xyz * (z / xyz[:, 2])[:, None]
    pts[:, 2] = -pts[:, 2]
    return pts * scale, idxs


def read_coord_map(path: str, flip: bool) -> np.ndarray:
    """NOCS coord PNG -> coordinates in [-0.5, 0.5] (RGB / 255 - 0.5),
    mirrored back when `flip`, z negated when not (get_gt_poses.py:70-74)."""
    coord = image_io.read_png(path)
    if flip:
        coord = coord[:, ::-1]
    coord = coord[:, :, (2, 1, 0)] / 255.0 - 0.5
    if not flip:
        coord[..., 2] = -coord[..., 2]
    return coord


def frame_poses(depth, coord, mask, num_instances, intrinsics, rng=None,
                inlier_th: float = 1e-3):
    """Per-instance similarity poses {instance number: pose} from one
    frame's depth and NOCS coord map (get_gt_poses.py:20-34)."""
    poses = {}
    for i in range(1, num_instances + 1):
        m = mask == i
        if m.sum() < 3:
            continue
        pts, idxs = backproject(depth, intrinsics, m)
        if len(pts) < 3:
            continue
        coord_pts = coord[idxs[0], idxs[1]]
        pose = umeyama_ransac(coord_pts, pts, rng=rng, inlier_th=inlier_th)
        if pose is not None:
            poses[i] = pose
    return poses


# ---------------------------------------------------------------------------
# instance occurrence lists (get_instance_list.py:16-49)
# ---------------------------------------------------------------------------

def instance_occurrences(root_path: str, folders, real: bool,
                         min_points: int = 50) -> dict:
    """{class_id: {instance: [frame prefixes]}} of the instances with at
    least `min_points` mask pixels in a frame."""
    out: dict = {cls_id: {} for cls_id in range(1, 7)}
    for sub in sorted(folders):
        fdir = pjoin(root_path, sub)
        if not os.path.isdir(fdir):
            continue
        prefixes = sorted(f[:4] for f in os.listdir(fdir)
                          if f.endswith("color.png"))
        for prefix in prefixes:
            mask_path = pjoin(fdir, f"{prefix}_mask.png")
            meta_path = pjoin(fdir, f"{prefix}_meta.txt")
            if not (os.path.exists(mask_path) and os.path.exists(meta_path)):
                continue
            mask = image_io.read_png(mask_path)[:, :, 2]
            with open(meta_path) as f:
                for line in f:
                    parts = line.split()
                    inst_num, cls_id = int(parts[0]), int(parts[1])
                    if real:
                        inst_id = parts[2].split(".")[0].replace("/", "_")
                    else:
                        inst_id = parts[3]
                    if cls_id == 0 or np.sum(mask == inst_num) < min_points:
                        continue
                    out[cls_id].setdefault(inst_id, []).append(
                        f"{sub}/{prefix}")
    return out


# ---------------------------------------------------------------------------
# per-instance gathering (gather_instance_data.py:44-110)
# ---------------------------------------------------------------------------

def _box(corners: np.ndarray) -> np.ndarray:
    """`bbox_from_corners` of corners rounded to float32, as the JAX
    package's `jnp.asarray` rounds them (x64 off) -> float32 numpy."""
    return bbox_from_corners(torch.from_numpy(
        np.asarray(corners, np.float32))).numpy()


def crop_instance_frame(depth, mask, inst_num, pose, corners, intrinsics):
    """The model box x1.4 posed -> a ball around it -> its 2D window ->
    backproject -> the points in the ball.  Returns {points float32,
    labels int64 (1 on the instance)} or None."""
    bbox = _box(corners * 1.4)
    posed = (bbox @ pose["rotation"].T) * pose["scale"] + \
        pose["translation"].reshape(1, 3)
    center = posed.mean(0)
    radius = float(np.linalg.norm(posed[0] - center)) + 0.1

    # project the axis-aligned ball bbox to a 2D window
    h, w = depth.shape
    aa = np.stack([center - radius, center + radius])
    aabb = _box(aa[None])[0]
    proj = _project(aabb, intrinsics).astype(np.int64)[:, [1, 0]]
    proj[:, 0] = h - proj[:, 0]
    lo = np.maximum(proj.min(0), 0)
    hi = np.minimum(proj.max(0), np.array([h - 1, w - 1]))
    window = np.zeros_like(depth)
    window[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1] = 1

    raw_pts, raw_idx = backproject(depth, intrinsics, window)
    if len(raw_pts) == 0:
        return None
    obj = (mask == inst_num)[raw_idx[0], raw_idx[1]]
    dist = np.linalg.norm(raw_pts - center, axis=-1)
    keep = dist <= radius
    return {"points": raw_pts[keep].astype(np.float32),
            "labels": obj[keep].astype(np.int64)}


def _project(pts, intrinsics, scale=1000.0):
    """Camera points (metres) -> pixel (u, v) (nocs_utils.py:37-41)."""
    pts = pts * scale
    pts = -pts / pts[:, -1:]
    pts[:, -1] = -pts[:, -1]
    return (intrinsics @ pts.T).T[:, :2]


def run_parallel(fn, items, num_proc: int = 1):
    """`fn(items)` in this process, or `fn(chunk)` for `num_proc` chunks of
    `items` in forked processes (`fn` may be a closure), all joined.  A
    worker that does not exit with 0 raises `RuntimeError` naming its
    chunk, once every worker has ended.  The workers run host code only:
    they must not touch CUDA, which the parent may have initialised."""
    if num_proc <= 1:
        fn(items)
        return
    ctx = multiprocessing.get_context("fork")
    per = (len(items) + num_proc - 1) // num_proc
    procs = []
    for k in range(num_proc):
        chunk = items[k * per:(k + 1) * per]
        if chunk:
            p = ctx.Process(target=fn, args=(chunk,))
            p.start()
            procs.append((k, chunk, p))
    failed = []
    for k, chunk, p in procs:
        p.join()
        if p.exitcode != 0:
            failed.append(f"chunk {k} ({len(chunk)} items, {chunk[0]!r} .. "
                          f"{chunk[-1]!r}): exit code {p.exitcode}")
    if failed:
        raise RuntimeError("run_parallel: a worker failed: "
                           + "; ".join(failed))
