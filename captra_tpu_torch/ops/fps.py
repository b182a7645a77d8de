"""Farthest-point sampling: hand-written CUDA kernels + the plain version.

Counterpart of `captra_tpu/ops/fps_pallas.py`.  Three kernels and a
cluster variant, built from `csrc/fps.cu` at first use:

  fps_cuda_batched  replaces `_fps_kernel` (entry `fps_pallas_t`): the
                    batch on the grid, for B >= 8 or N < 1024.
  fps_cuda_wide     replaces `_fps_wide_kernel` (entry `fps_pallas_wide_t`):
                    for B < 8 and N >= 1024.
  fps_cuda_blocked  replaces `_fps_blocked_kernel` (entry
                    `fps_pallas_blocked_t`): lazy-update FPS, one CTA per
                    cloud of up to 24576 points held on chip, a pick
                    updating only the rows of 256 contiguous points whose
                    box can hold a nearer point; opt-in with
                    CAPTRA_FPS_BLOCKED=1.

Both sweep a cloud of up to 512 points in one warp (4 clouds a CTA) and a
larger one in one CTA of 512 threads (1024 above 8192 points), points and
running minima in registers, one barrier a pick.  Above one CTA's shared
memory (8192 points batched, 16384 wide) they launch the cluster kernel: a
thread-block cluster of 4-16 CTAs per cloud, each CTA's winner pushed into
every peer's shared memory.
Those launches count under `fps_cuda_batched_cluster` /
`fps_cuda_wide_cluster`.

All share one contract with the TPU kernels and with `fps_plain`: xyz rows
[B, N, 3] float32 -> int32 indices [B, npoint]; first pick 0; running min
initialised to 1e10; d = (x-cx)^2 + (y-cy)^2 + (z-cz)^2 left to right; each
pick the smallest index attaining the max.

`farthest_point_sample_indices` dispatches by device: a CPU tensor takes
`fps_plain`; a CUDA tensor launches a kernel (chosen as `fps_pallas_t`
chooses, fps_pallas.py:340-344) or raises.  There is no fallback.  The
kernels launch through `cuda_build.Kernels`, which counts each launch in
the one registry; `launch_counts` is its view of the five FPS kernels.
"""
from __future__ import annotations

import os

import torch

from captra_tpu_torch.ops import cuda_build
from captra_tpu_torch.ops.cuda_build import INT, PTR

SOURCE = "fps.cu"
WIDE_MIN_POINTS = 1024   # = SUBLANE * 128 in the TPU dispatch
WIDE_MAX_BATCH = 8       # wide below 8 clouds, batched from 8 up
# the blocked kernel's opt-in range (fps_pallas.py:236-237): 8 TPU tiles of
# 8 x 128 points up to 24 tiles
BLOCKED_MIN_POINTS = 8 * 8 * 128
BLOCKED_MAX_POINTS = 24 * 8 * 128

# kernel name -> C entry point; the cluster entries are launched by the
# batched and wide wrappers above their single-CTA bound
_ENTRIES = {
    "fps_cuda_batched": "captra_fps_batched",
    "fps_cuda_wide": "captra_fps_wide",
    "fps_cuda_batched_cluster": "captra_fps_batched_cluster",
    "fps_cuda_wide_cluster": "captra_fps_wide_cluster",
    "fps_cuda_blocked": "captra_fps_blocked",
}
_KERNELS = cuda_build.Kernels(
    SOURCE, {name: (entry, PTR, PTR, INT, INT, INT)
             for name, entry in _ENTRIES.items()},
    error="captra_cuda_error_string",
    queries={**{f"{entry}_max_points": (INT,) for entry in _ENTRIES.values()},
             "captra_fps_batched_cluster_size": (INT, INT),
             "captra_fps_wide_cluster_size": (INT, INT),
             "captra_fps_cluster_threads": (INT,),
             "captra_fps_blocked_row_points": (INT,)})
launch_counts = _KERNELS.launch_counts


def use_blocked() -> bool:
    """The blocked kernel's opt-in, read at call time as the JAX package
    reads it (`fps_pallas._use_blocked`): CAPTRA_FPS_BLOCKED=1."""
    return os.environ.get("CAPTRA_FPS_BLOCKED") == "1"


def max_points(kernel: str) -> int:
    """Largest N the named wrapper takes (builds the library): for
    "fps_cuda_batched" and "fps_cuda_wide", their cluster's bound."""
    if kernel in ("fps_cuda_batched", "fps_cuda_wide"):
        kernel += "_cluster"
    return getattr(_KERNELS.lib, f"{_ENTRIES[kernel]}_max_points")()


def single_cta_points(kernel: str) -> int:
    """Largest N that "fps_cuda_batched" or "fps_cuda_wide" sweeps in one
    CTA per cloud; above it they launch their cluster."""
    return getattr(_KERNELS.lib, f"{_ENTRIES[kernel]}_max_points")()


def cluster_size(kernel: str, n: int) -> int:
    """CTAs per cluster that `kernel`'s cluster launch gives an n-point
    cloud (0 if it is beyond the cluster's bound)."""
    return getattr(_KERNELS.lib, f"{_ENTRIES[kernel + '_cluster']}_size")(n)


def cluster_threads() -> int:
    """Threads per CTA of the cluster launches."""
    return _KERNELS.lib.captra_fps_cluster_threads()


def blocked_row_points() -> int:
    """Points in a row of the blocked kernel: the contiguous points whose
    box its skip rule tests against their max."""
    return _KERNELS.lib.captra_fps_blocked_row_points()


def _check(xyz: torch.Tensor, npoint: int, kernel: str) -> None:
    cuda_build.check_operands(kernel, xyz)
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"{kernel}: xyz must be [B, N, 3], got "
                         f"{tuple(xyz.shape)}")
    if xyz.shape[0] < 1 or xyz.shape[1] < 1 or npoint < 1:
        raise ValueError(f"{kernel}: empty input {tuple(xyz.shape)} -> "
                         f"{npoint}")


def _launch(kernel: str, xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Launch `kernel` (a key of `_ENTRIES`) on a checked input and count
    the launch."""
    B, N, _ = xyz.shape
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    _KERNELS.launch(kernel, xyz.device, xyz.data_ptr(), out.data_ptr(), B, N,
                    npoint)
    return out


def _launch_routed(kernel: str, xyz: torch.Tensor, npoint: int
                   ) -> torch.Tensor:
    """One CTA per cloud up to the single-CTA bound, a cluster above (the
    blocked kernel's single-CTA bound is its bound)."""
    _check(xyz, npoint, kernel)
    N = xyz.shape[1]
    bound = max_points(kernel)
    if N > bound:
        raise ValueError(f"{kernel} takes at most {bound} points per cloud, "
                         f"got {N}")
    if N > single_cta_points(kernel):
        return _launch(kernel + "_cluster", xyz, npoint)
    return _launch(kernel, xyz, npoint)


def fps_cuda_batched(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """CUDA FPS: xyz [B, N, 3] -> int32 [B, npoint].  One warp per cloud
    for N <= 512, one CTA per cloud up to 8192, a cluster of 4 or 8 CTAs per
    cloud up to 65536; raises above."""
    return _launch_routed("fps_cuda_batched", xyz, npoint)


def fps_cuda_wide(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """CUDA FPS: xyz [B, N, 3] -> int32 [B, npoint].  The batched policy up
    to 8192 points, one 1024-thread CTA per cloud up to 16384, a cluster of
    4-16 CTAs per cloud up to 131072; raises above."""
    return _launch_routed("fps_cuda_wide", xyz, npoint)


def fps_cuda_blocked(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """CUDA lazy-update FPS: xyz [B, N <= 24576, 3] -> int32 [B, npoint];
    raises above its bound.  One CTA per cloud (512 threads, 256 above
    20480 points), x and the running minima in registers, y and z in shared
    memory; a pick skips every row of `blocked_row_points()` points whose
    box lies no nearer than the row's max (exact: see csrc/fps.cu)."""
    return _launch_routed("fps_cuda_blocked", xyz, npoint)


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


def route(B: int, N: int) -> str:
    """The wrapper a CUDA cloud batch [B, N] goes to, as `fps_pallas_t`
    chooses (fps_pallas.py:340-344): the blocked kernel under
    CAPTRA_FPS_BLOCKED=1 for B < 8 and 8192 <= N <= 24576, else the wide
    kernel for B < 8 and N >= 1024, else the batched kernel (the last two
    launching their cluster above one CTA)."""
    if (B < WIDE_MAX_BATCH and use_blocked()
            and BLOCKED_MIN_POINTS <= N <= BLOCKED_MAX_POINTS):
        return "fps_cuda_blocked"
    if B < WIDE_MAX_BATCH and N >= WIDE_MIN_POINTS:
        return "fps_cuda_wide"
    return "fps_cuda_batched"


def farthest_point_sample_indices(xyz: torch.Tensor, npoint: int
                                  ) -> torch.Tensor:
    """Device dispatch: CPU -> `fps_plain`; CUDA -> the kernel `route`
    names."""
    if xyz.device.type == "cpu":
        return fps_plain(xyz, npoint)
    if xyz.device.type != "cuda":
        raise ValueError(f"no FPS for device {xyz.device}")
    B, N, _ = xyz.shape
    return _launch_routed(route(B, N), xyz.contiguous(), npoint)
