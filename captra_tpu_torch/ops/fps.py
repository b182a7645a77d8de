"""Farthest-point sampling: hand-written CUDA kernels + the plain version.

Counterpart of `captra_tpu/ops/fps_pallas.py`.  Two kernels, built from
`csrc/fps.cu` at first use:

  fps_cuda_batched  replaces `_fps_kernel` (entry `fps_pallas_t`): one CTA
                    per cloud, the batch on the grid.
  fps_cuda_wide     replaces `_fps_wide_kernel` (entry `fps_pallas_wide_t`):
                    one cloud per 1024-thread CTA, for B < 8 and N >= 1024.

All share one contract with the TPU kernels and with `fps_plain`: xyz rows
[B, N, 3] float32 -> int32 indices [B, npoint]; first pick 0; running min
initialised to 1e10; d = (x-cx)^2 + (y-cy)^2 + (z-cz)^2 left to right; each
pick the smallest index attaining the max.

`farthest_point_sample_indices` dispatches by device: a CPU tensor takes
`fps_plain`; a CUDA tensor launches a kernel (chosen as `fps_pallas_t`
chooses, fps_pallas.py:343) or raises.  There is no fallback.  Each kernel
wrapper counts its launches in `launch_counts`.
"""
from __future__ import annotations

import ctypes

import torch

from captra_tpu_torch.ops import cuda_build

SOURCE = "fps.cu"
WIDE_MIN_POINTS = 1024   # = SUBLANE * 128 in the TPU dispatch
WIDE_MAX_BATCH = 8       # wide below 8 clouds, batched from 8 up

launch_counts = {"fps_cuda_batched": 0, "fps_cuda_wide": 0}
_LIB: ctypes.CDLL | None = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load(SOURCE)
        for fn in (lib.captra_fps_batched, lib.captra_fps_wide):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.captra_fps_batched_max_points,
                   lib.captra_fps_wide_max_points):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        lib.captra_cuda_error_string.argtypes = [ctypes.c_int]
        lib.captra_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def max_points(kernel: str) -> int:
    """Largest N the named kernel takes (builds the library)."""
    lib = _lib()
    return {"fps_cuda_batched": lib.captra_fps_batched_max_points,
            "fps_cuda_wide": lib.captra_fps_wide_max_points}[kernel]()


def _check(xyz: torch.Tensor, npoint: int, kernel: str) -> None:
    if not xyz.is_cuda:
        raise ValueError(f"{kernel}: xyz must be a CUDA tensor, got "
                         f"{xyz.device}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"{kernel}: xyz must be float32, got {xyz.dtype}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"{kernel}: xyz must be [B, N, 3], got "
                         f"{tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError(f"{kernel}: xyz must be contiguous")
    if xyz.shape[0] < 1 or xyz.shape[1] < 1 or npoint < 1:
        raise ValueError(f"{kernel}: empty input {tuple(xyz.shape)} -> "
                         f"{npoint}")


def _launch(kernel: str, xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    _check(xyz, npoint, kernel)
    B, N, _ = xyz.shape
    bound = max_points(kernel)
    if N > bound:
        raise ValueError(f"{kernel} takes at most {bound} points per cloud, "
                         f"got {N}")
    lib = _lib()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    fn = {"fps_cuda_batched": lib.captra_fps_batched,
          "fps_cuda_wide": lib.captra_fps_wide}[kernel]
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xyz.data_ptr(), out.data_ptr(), B, N, npoint, stream)
    if err != 0:
        msg = lib.captra_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")
    launch_counts[kernel] += 1
    return out


def fps_cuda_batched(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """CUDA FPS, one CTA per cloud: xyz [B, N <= 8192, 3] -> int32
    [B, npoint]."""
    return _launch("fps_cuda_batched", xyz, npoint)


def fps_cuda_wide(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """CUDA FPS, one 1024-thread CTA per cloud: xyz [B, N <= 16384, 3] ->
    int32 [B, npoint]; raises above its bound."""
    return _launch("fps_cuda_wide", xyz, npoint)


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain PyTorch FPS with the kernels' contract: xyz [B, N, 3] -> int32
    [B, npoint].  torch.argmax returns the first maximal index."""
    B, N, _ = xyz.shape
    x, y, z = xyz.float().unbind(-1)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    far = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        dx = x - x[rows, far][:, None]
        dy = y - y[rows, far][:, None]
        dz = z - z[rows, far][:, None]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        far = torch.argmax(dist, dim=-1)
    return out


def farthest_point_sample_indices(xyz: torch.Tensor, npoint: int
                                  ) -> torch.Tensor:
    """Device dispatch: CPU -> `fps_plain`; CUDA -> the wide kernel for
    B < 8 and N >= 1024, else the batched kernel."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"no FPS for device {xyz.device}")
    B, N, _ = xyz.shape
    xyz = xyz.contiguous()
    if B < WIDE_MAX_BATCH and N >= WIDE_MIN_POINTS:
        return fps_cuda_wide(xyz, npoint)
    return fps_cuda_batched(xyz, npoint)
