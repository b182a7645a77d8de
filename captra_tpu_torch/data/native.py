"""The host data core, bound with ctypes (counterpart of
`captra_tpu/data/native.py`): exact farthest-point sampling and PNG
scanline unfiltering in C++ for the dataset readers, which run on the
host, and the depth backprojection, squared distances and ball indices of
the offline preprocessing (`data/preproc_nocs.py`).

`csrc/pointops_host.cpp` is compiled with g++ at first use into the
git-ignored `_build/` by `ops/cuda_build.py`.  A failed build or load
raises, with the compiler's output: there is no numpy fallback on the
readers' path (`numpy_ops._fps_numpy` is the plain twin the tests hold the
core to).
"""
from __future__ import annotations

import ctypes

import numpy as np

from captra_tpu_torch.ops import cuda_build

SOURCE = "pointops_host.cpp"
_LIB: ctypes.CDLL | None = None


def lib() -> ctypes.CDLL:
    """The loaded host core, built first if needed."""
    global _LIB
    if _LIB is None:
        core = cuda_build.load(SOURCE)
        i64 = ctypes.c_int64
        core.captra_host_fps.argtypes = [ctypes.c_void_p, i64, i64, i64,
                                         ctypes.c_void_p]
        core.captra_host_fps.restype = None
        core.captra_host_png_unfilter.argtypes = [ctypes.c_void_p, i64, i64,
                                                  i64, ctypes.c_void_p]
        core.captra_host_png_unfilter.restype = i64
        core.captra_host_dist_to_center.argtypes = [ctypes.c_void_p, i64,
                                                    ctypes.c_void_p,
                                                    ctypes.c_void_p]
        core.captra_host_dist_to_center.restype = None
        core.captra_host_ball_indices.argtypes = [ctypes.c_void_p, i64,
                                                  ctypes.c_float,
                                                  ctypes.c_void_p, i64]
        core.captra_host_ball_indices.restype = i64
        core.captra_host_backproject.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, i64, i64, ctypes.c_void_p,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p]
        core.captra_host_backproject.restype = i64
        _LIB = core
    return _LIB


def fps(xyz: np.ndarray, npoint: int, start: int = 0) -> np.ndarray:
    """Exact iterative FPS: xyz [N, 3] (as float32) -> [npoint] int64
    indices, first pick `start`."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    if xyz.ndim != 2 or xyz.shape[1] != 3 or len(xyz) == 0 or npoint < 1:
        raise ValueError(f"fps: xyz must be [N > 0, 3] and npoint >= 1, got "
                         f"{xyz.shape} -> {npoint}")
    out = np.empty(npoint, np.int64)
    lib().captra_host_fps(xyz.ctypes.data, len(xyz), npoint, start,
                          out.ctypes.data)
    return out


def png_unfilter(raw: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters of `raw`, H rows of a filter byte and
    `stride` bytes (at least that many bytes) -> uint8 [H, stride]; `bpp`
    bytes a pixel.  A filter byte other than 0-4 raises `ValueError`."""
    rows = np.frombuffer(raw, np.uint8)
    if len(rows) < H * (stride + 1) or bpp < 1:
        raise ValueError(f"PNG image data too short: {len(rows)} bytes for "
                         f"{H} rows of {stride} bytes, {bpp} a pixel")
    out = np.empty((H, stride), np.uint8)
    bad = lib().captra_host_png_unfilter(rows.ctypes.data, H, stride, bpp,
                                         out.ctypes.data)
    if bad >= 0:
        kind = rows[bad * (stride + 1)]
        raise ValueError(f"unknown PNG filter {kind} in row {bad}")
    return out


def dist_to_center(pts: np.ndarray, center) -> np.ndarray:
    """Squared distances of pts [N, 3] (as float32) to `center` [3] (as
    float32) -> float32 [N]."""
    pts = np.ascontiguousarray(pts, np.float32)
    center = np.ascontiguousarray(center, np.float32).reshape(-1)
    if pts.ndim != 2 or pts.shape[1] != 3 or center.shape != (3,):
        raise ValueError(f"dist_to_center: pts must be [N, 3] and center "
                         f"[3], got {pts.shape} and {center.shape}")
    out = np.empty(len(pts), np.float32)
    lib().captra_host_dist_to_center(pts.ctypes.data, len(pts),
                                     center.ctypes.data, out.ctypes.data)
    return out


def ball_indices(sq_dist: np.ndarray, r2: float) -> np.ndarray:
    """int64 indices, in order, of the entries of sq_dist [N] (as float32)
    at most `r2` (rounded to float32, as the core compares)."""
    sq_dist = np.ascontiguousarray(sq_dist, np.float32)
    if sq_dist.ndim != 1:
        raise ValueError(f"ball_indices: sq_dist must be [N], got "
                         f"{sq_dist.shape}")
    idx = np.empty(len(sq_dist), np.int64)
    cnt = lib().captra_host_ball_indices(sq_dist.ctypes.data, len(sq_dist),
                                         r2, idx.ctypes.data, len(idx))
    return idx[:cnt]


def backproject(depth: np.ndarray, intrinsics: np.ndarray,
                mask: np.ndarray | None = None, scale: float = 0.001):
    """Depth [H, W] (as uint16) -> (pts [H*W, 3] float32, valid [H*W]
    bool) with the NOCS conventions: pixel (row, col) is (u, v) = (col,
    H - row), the ray `inv(intrinsics) @ (u, v, 1)` in float64 scaled to
    the depth times `scale`, z negated; valid where depth > 0 and `mask`
    (as uint8 [H, W]) is set.  Points that are not valid are 0."""
    depth = np.ascontiguousarray(depth, np.uint16)
    if depth.ndim != 2:
        raise ValueError(f"backproject: depth must be [H, W], got "
                         f"{depth.shape}")
    H, W = depth.shape
    if mask is not None:
        mask = np.ascontiguousarray(mask, np.uint8)
        if mask.shape != depth.shape:
            raise ValueError(f"backproject: mask {mask.shape} is not the "
                             f"depth's {depth.shape}")
    k_inv = np.ascontiguousarray(np.linalg.inv(intrinsics), np.float64)
    pts = np.empty((H * W, 3), np.float32)
    valid = np.empty(H * W, np.uint8)
    lib().captra_host_backproject(
        depth.ctypes.data, None if mask is None else mask.ctypes.data, H, W,
        k_inv.ctypes.data, scale, pts.ctypes.data, valid.ctypes.data)
    return pts, valid.astype(bool)
