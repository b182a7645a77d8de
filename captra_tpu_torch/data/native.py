"""The host data core, bound with ctypes (counterpart of
`captra_tpu/data/native.py`): exact farthest-point sampling and PNG
scanline unfiltering in C++ for the dataset readers, which run on the
host.

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
