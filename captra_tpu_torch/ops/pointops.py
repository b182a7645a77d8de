"""Point-cloud ops on tensors: FPS, ball query, 3-NN interpolation,
gather/group (counterpart of `captra_tpu/ops/pointops.py`).

The port keeps the JAX package's exact reference semantics everywhere: its
TPU-only approximations ("bucket" grouping, "approx" ball query, "dense"
interpolation) are not carried over, so on CUDA the port computes what the
JAX package computes on the CPU (pointops.py:164-165, 243-245, 285-286).
FPS goes through `ops.fps`: hand-written CUDA kernels on the card, the plain
version on the CPU.  Index outputs are int64 (what `torch.gather` takes),
except FPS, which keeps int32 at its public boundary.
"""
from __future__ import annotations

import numpy as np
import torch

from captra_tpu_torch.ops.fps import farthest_point_sample_indices


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2: src [B, N, C], dst [B, M, C] -> [B, N, M].
    Same matmul + rank-1 form as the JAX op, so ball-query membership at
    the radius rounds the same way."""
    d = -2.0 * (src @ dst.transpose(-1, -2))
    d = d + torch.sum(src ** 2, dim=-1, keepdim=True)
    d = d + torch.sum(dst ** 2, dim=-1)[..., None, :]
    return d


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

GROUPS = 8


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          mode: str = "exact") -> torch.Tensor:
    """Iterative max-min sampling: xyz [B, N, 3] -> int32 [B, npoint],
    deterministic start at index 0.

    mode "grouped" is the stratified 8-way approximation: point i goes to
    stratum i % 8, each stratum takes npoint/8 exact picks, all strata in
    one batched launch (see `farthest_point_sample_grouped_t`)."""
    if mode == "grouped":
        B, N, _ = xyz.shape
        G = GROUPS
        if npoint < 2 * G:
            # one pick per stratum would be its deterministic start
            # (global points 0..G-1 whatever the geometry)
            return farthest_point_sample(xyz, npoint)
        strata = (xyz.reshape(B, N // G, G, 3).movedim(2, 1)
                  .reshape(B * G, N // G, 3))
        idx = farthest_point_sample_indices(strata.contiguous(), npoint // G)
        g = torch.arange(G, dtype=idx.dtype, device=idx.device)[None, :, None]
        return (idx.reshape(B, G, npoint // G) * G + g).reshape(B, npoint)
    if mode != "exact":
        raise ValueError(f"unknown fps mode {mode!r} (exact|grouped)")
    return farthest_point_sample_indices(xyz, npoint)


def farthest_point_sample_grouped_t(xyz_t: torch.Tensor, npoint: int,
                                    groups: int = GROUPS) -> torch.Tensor:
    """Grouped (stratified-approximate) FPS on planes input xyz_t [B, 3, N]
    -> int32 [B, npoint]: `groups` interleaved strata (point i -> group
    i % groups), npoint/groups exact picks from each."""
    B, _, N = xyz_t.shape
    if N % groups or npoint % groups:
        raise ValueError(f"N={N} and npoint={npoint} must divide groups="
                         f"{groups}")
    if npoint < 2 * groups:
        return farthest_point_sample(xyz_t.transpose(-1, -2), npoint)
    Ng = N // groups
    xg = xyz_t.reshape(B, 3, Ng, groups).movedim(-1, 1).reshape(
        B * groups, 3, Ng)
    idx = farthest_point_sample_indices(xg.transpose(-1, -2).contiguous(),
                                        npoint // groups)
    g = torch.arange(groups, dtype=idx.dtype,
                     device=idx.device)[None, :, None]
    flat = idx.reshape(B, groups, npoint // groups) * groups + g
    return flat.reshape(B, npoint)


# ---------------------------------------------------------------------------
# neighborhood queries
# ---------------------------------------------------------------------------

def _f32_square(radius: float) -> float:
    # the JAX op squares a traced float32 radius: round r to f32 first and
    # square in f32, not in double (exact in f32, so the comparison with a
    # float32 tensor sees the same bound, and no constant is copied to the
    # device)
    r = np.float32(radius)
    return float(r * r)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """The first `nsample` in-radius points in index order, slots padded
    with the first hit; queries with no hit return index 0.
    xyz [B, N, 3], new_xyz [B, S, 3] -> int64 [B, S, nsample]."""
    N = xyz.shape[1]
    in_ball = square_distance(new_xyz, xyz) <= _f32_square(radius)
    order = torch.arange(N, dtype=torch.int32, device=xyz.device)
    key = torch.where(in_ball, order, N)  # out-of-ball -> sentinel N
    del in_ball
    sel = torch.topk(key, nsample, dim=-1, largest=False, sorted=True)[0]
    del key
    sel = sel.long()
    first = sel[..., :1]
    first = torch.where(first < N, first, 0)
    return torch.where(sel < N, sel, first)


def knn(k: int, query: torch.Tensor, data: torch.Tensor):
    """k nearest neighbors of `query` [B, S, 3] among `data` [B, N, 3] ->
    (L2 dists [B, S, k], int64 idx [B, S, k]), nearest first: `topk` of the
    negated squared distances, then the root of their clamp at 0."""
    sqr = square_distance(query, data)
    neg, idx = torch.topk(-sqr, k, dim=-1)
    return torch.sqrt(torch.clamp(-neg, min=0.0)), idx


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """3 nearest neighbors of xyz1 [B, N, 3] among xyz2 [B, M, 3] ->
    (squared dists [B, N, 3], int64 idx [B, N, 3]); three successive
    first-index argmins, as the JAX op does."""
    sqr = square_distance(xyz1, xyz2)
    dists, idxs = [], []
    for _ in range(3):
        i = torch.argmin(sqr, dim=-1, keepdim=True)       # [B, N, 1]
        dists.append(torch.gather(sqr, -1, i))
        idxs.append(i)
        sqr.scatter_(-1, i, float("inf"))
    return torch.cat(dists, dim=-1), torch.cat(idxs, dim=-1)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-NN feature interpolation: points [B, C, M], idx [B, N, 3],
    weight [B, N, 3] -> [B, C, N]."""
    B, C, _ = points.shape
    N = idx.shape[1]
    flat = idx.long().reshape(B, 1, N * 3).expand(B, C, N * 3)
    gathered = torch.gather(points, 2, flat).reshape(B, C, N, 3)
    return torch.sum(gathered * weight[:, None], dim=-1)


def three_interp_rows(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Row-layout 3-NN interpolation ("gather" formulation): feats
    [B, M, C], idx/weight [B, N, 3] -> [B, N, C].  Features of a lower
    dtype times the float32 weights give float32, as in the JAX op
    (pointops.py:246-248)."""
    B, _, C = feats.shape
    N = idx.shape[1]
    flat = idx.long().reshape(B, N * 3, 1).expand(B, N * 3, C)
    g = torch.gather(feats, 1, flat).reshape(B, N, 3, C)
    return torch.sum(g * weight[..., None], dim=-2)


def ball_group(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor, feats: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Ball query + neighborhood grouping -> [B, S, nsample, D+3] of
    (features..., xyz - query_center): features FIRST, then the relative
    xyz (the JAX op's exact route, pointops.py:290-301).

    Features keep their dtype and xyz stays float32: the relative xyz is
    taken in float32 and cast to the features' dtype, the values the JAX
    op's float32 block takes once the next layer casts it (its bucket
    route, pointops.py:317-330, casts the same way)."""
    B, _, _ = xyz.shape
    S = new_xyz.shape[1]
    idx = ball_query(radius, nsample, xyz, new_xyz)
    flat = idx.reshape(B, S * nsample, 1)

    def group(values):
        C = values.shape[-1]
        return torch.gather(values, 1, flat.expand(B, S * nsample, C)
                            ).reshape(B, S, nsample, C)

    rel = group(xyz) - new_xyz[:, :, None]
    if feats is None:
        return rel
    return torch.cat([group(feats), rel.to(feats.dtype)], dim=-1)


# ---------------------------------------------------------------------------
# gather / group
# ---------------------------------------------------------------------------

def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [B, C, N], idx [B, M] -> [B, C, M]."""
    B, C, _ = features.shape
    return torch.gather(features, 2,
                        idx.long()[:, None, :].expand(B, C, idx.shape[1]))


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [B, C, N], idx [B, M, K] -> [B, C, M, K]."""
    B, C, _ = features.shape
    M, K = idx.shape[1:]
    flat = idx.long().reshape(B, 1, M * K).expand(B, C, M * K)
    return torch.gather(features, 2, flat).reshape(B, C, M, K)


def gather_xyz(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """xyz [B, N, 3], idx [B, M] -> [B, M, 3] (row-layout gather)."""
    B, M = idx.shape
    return torch.gather(xyz, 1, idx.long()[..., None].expand(B, M, 3))
