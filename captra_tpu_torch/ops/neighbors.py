"""A backbone stage's neighbour search: a hand-written CUDA kernel and its
plain PyTorch twin.

A set-abstraction stage of `models/backbone.py` ball-queries its centres at
every radius of its scales; a propagation stage takes each fine point's
three nearest coarse points (counterparts of `ball_query` and `three_nn`
in `captra_tpu/ops/pointops.py`, which have no Pallas kernel).  A stage
computes its distance product once (`pointops.distance_terms`: the
library's product on the operands' own layouts, and the two squared-norm
vectors), then selects:

  ball_query_cuda / three_nn_cuda  the kernels of `csrc/neighbors.cu`,
                built at first use: one read of the product, every radius
                (or the three nearest) picked in the same scan, the
                distances formed as `square_distance` forms them (its note
                gives the design and the bound).
  ball_query_plain / three_nn_plain  the same functions in plain PyTorch:
                `pointops.distance_from_terms`, then `pointops.ball_select`
                a radius or `pointops.three_nn_select`, the chain's own
                calls, so they give its numbers bit for bit.

`ball_query_stage` and `three_nn_stage` route by the seam's one rule
(`cuda_build.takes_kernel`): float32 CUDA clouds that take no gradient go
to the kernel, any other input to the twin, on any device.  A ball query
detaches its clouds first: indices carry no gradient, so its route is the
kernel's in training too.  There is no fallback: the kernel's wrapper
raises on what it cannot take.  The kernels launch through
`cuda_build.Kernels`, which counts each launch in the one registry
(`launch_counts` is its view here) and in the tracer's `nbr_fused`
counter, one a stage.  `pointops.ball_query` a radius and
`pointops.three_nn`, the chain the kernels replaced, stay as the reference
the tests hold both to.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from captra_tpu_torch.ops import cuda_build, pointops

SOURCE = "neighbors.cu"
MAX_RADII = 4            # radii a stage (csrc/neighbors.cu: kMaxRadii)
ROWS_PER_CTA = 8         # query rows a CTA, one a warp


class _BallArgs(ctypes.Structure):
    _fields_ = [("prod", ctypes.c_void_p), ("row_sq", ctypes.c_void_p),
                ("col_sq", ctypes.c_void_p),
                ("out", ctypes.c_void_p * MAX_RADII),
                ("r2", ctypes.c_float * MAX_RADII),
                ("k", ctypes.c_int * MAX_RADII),
                *[(n, ctypes.c_int) for n in ("radii", "B", "S", "N", "vec")]]


class _NnArgs(ctypes.Structure):
    _fields_ = [("prod", ctypes.c_void_p), ("row_sq", ctypes.c_void_p),
                ("col_sq", ctypes.c_void_p), ("dist", ctypes.c_void_p),
                ("idx", ctypes.c_void_p),
                *[(n, ctypes.c_int) for n in ("B", "S", "N", "vec")]]


_KERNELS = cuda_build.Kernels(
    SOURCE, {"ball_query_cuda": ("captra_ball_query", cuda_build.PTR),
             "three_nn_cuda": ("captra_three_nn", cuda_build.PTR)},
    error="captra_nbr_error_string", counter="nbr_fused",
    expect={"captra_nbr_max_radii": MAX_RADII,
            "captra_nbr_rows_per_cta": ROWS_PER_CTA,
            "captra_nbr_ball_args_bytes": ctypes.sizeof(_BallArgs),
            "captra_nbr_nn_args_bytes": ctypes.sizeof(_NnArgs)})
launch_counts = _KERNELS.launch_counts


# ---------------------------------------------------------------------------
# the plain twins
# ---------------------------------------------------------------------------

def ball_query_plain(prod: torch.Tensor, row_sq: torch.Tensor,
                     col_sq: torch.Tensor, radii: Sequence[float],
                     nsamples: Sequence[int]) -> list[torch.Tensor]:
    """`pointops.distance_terms(new_xyz, xyz)`'s prod [B, S, N], row_sq
    [B, S, 1] and col_sq [B, N] -> `pointops.ball_query`'s int64 [B, S, K]
    for each (radius, K)."""
    dist = pointops.distance_from_terms(prod, row_sq, col_sq)
    return [pointops.ball_select(dist, r, k) for r, k in zip(radii, nsamples)]


def three_nn_plain(prod: torch.Tensor, row_sq: torch.Tensor,
                   col_sq: torch.Tensor):
    """`pointops.distance_terms(xyz1, xyz2)` -> `pointops.three_nn`'s
    (squared dists [B, N, 3], int64 idx [B, N, 3])."""
    return pointops.three_nn_select(
        pointops.distance_from_terms(prod, row_sq, col_sq))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(name: str, prod, row_sq, col_sq) -> tuple[int, int, int, int]:
    """Raise on terms the kernel does not take; return (B, S, N, vec)."""
    cuda_build.check_operands(name, prod, row_sq, col_sq)
    if prod.dim() != 3:
        raise ValueError(f"{name}: prod must be [B, S, N], got "
                         f"{tuple(prod.shape)}")
    B, S, N = prod.shape
    if row_sq.numel() != B * S or row_sq.shape[:2] != (B, S) \
            or col_sq.shape != (B, N):
        raise ValueError(f"{name}: prod {tuple(prod.shape)}, row_sq "
                         f"{tuple(row_sq.shape)}, col_sq "
                         f"{tuple(col_sq.shape)} do not agree")
    if B < 1 or S < 1 or N < 1 or N >= 2 ** 31 or B * S >= 2 ** 31:
        raise ValueError(f"{name}: B={B}, S={S}, N={N} out of range")
    vec = int(N % 4 == 0 and prod.data_ptr() % 16 == 0
              and col_sq.data_ptr() % 16 == 0)
    return B, S, N, vec


def ball_query_cuda(prod: torch.Tensor, row_sq: torch.Tensor,
                    col_sq: torch.Tensor, radii: Sequence[float],
                    nsamples: Sequence[int]) -> list[torch.Tensor]:
    """The kernel: `ball_query_plain`'s indices, every radius in one
    launch."""
    name = "ball_query_cuda"
    B, S, N, vec = _check(name, prod, row_sq, col_sq)
    if not 1 <= len(radii) == len(nsamples) <= MAX_RADII:
        raise ValueError(f"{name}: {len(radii)} radii and {len(nsamples)} "
                         f"sample counts; the kernel takes 1 to {MAX_RADII}")
    if not all(1 <= k <= N for k in nsamples):
        raise ValueError(f"{name}: sample counts {list(nsamples)} must lie "
                         f"in 1..N={N}")
    outs = [torch.empty((B, S, k), dtype=torch.int64, device=prod.device)
            for k in nsamples]
    args = _BallArgs(prod.data_ptr(), row_sq.data_ptr(), col_sq.data_ptr())
    for j, (r, k, o) in enumerate(zip(radii, nsamples, outs)):
        args.out[j] = o.data_ptr()
        args.r2[j] = pointops._f32_square(r)
        args.k[j] = k
    args.radii, args.B, args.S, args.N, args.vec = len(radii), B, S, N, vec
    _KERNELS.launch(name, prod.device, ctypes.byref(args))
    return outs


def three_nn_cuda(prod: torch.Tensor, row_sq: torch.Tensor,
                  col_sq: torch.Tensor):
    """The kernel: `three_nn_plain`'s (dists, idx) in one launch."""
    name = "three_nn_cuda"
    B, S, N, vec = _check(name, prod, row_sq, col_sq)
    dist = torch.empty((B, S, 3), dtype=torch.float32, device=prod.device)
    idx = torch.empty((B, S, 3), dtype=torch.int64, device=prod.device)
    args = _NnArgs(prod.data_ptr(), row_sq.data_ptr(), col_sq.data_ptr(),
                   dist.data_ptr(), idx.data_ptr(), B, S, N, vec)
    _KERNELS.launch(name, prod.device, ctypes.byref(args))
    return dist, idx


# ---------------------------------------------------------------------------
# the stages
# ---------------------------------------------------------------------------

def ball_query_stage(radii: Sequence[float], nsamples: Sequence[int],
                     xyz: torch.Tensor, new_xyz: torch.Tensor
                     ) -> list[torch.Tensor]:
    """`pointops.ball_query(r, k, xyz, new_xyz)` for every (r, k) of a
    stage: xyz [B, N, 3], centres new_xyz [B, S, 3] -> int64 [B, S, k] a
    radius."""
    xyz, new_xyz = xyz.detach(), new_xyz.detach()
    terms = pointops.distance_terms(new_xyz, xyz)
    if cuda_build.takes_kernel(xyz, new_xyz):
        return ball_query_cuda(*terms, radii, nsamples)
    return ball_query_plain(*terms, radii, nsamples)


def three_nn_stage(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """`pointops.three_nn(xyz1, xyz2)`: xyz1 [B, N, 3], xyz2 [B, M, 3] ->
    (squared dists [B, N, 3], int64 idx [B, N, 3])."""
    terms = pointops.distance_terms(xyz1, xyz2)
    if cuda_build.takes_kernel(xyz1, xyz2):
        return three_nn_cuda(*terms)
    return three_nn_plain(*terms)
