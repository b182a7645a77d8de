"""Masked / weighted Procrustes (similarity-transform) fitting on tensors
(counterpart of `captra_tpu/pose/procrustes.py`).

  * The 3D solve is a reflection-fixed Kabsch via `torch.linalg.svd` on the
    device.
  * The 2D (symmetric-category) solve is the closed-form SO(2) polar
    projection: for a 2x2 cross-covariance M the rotation maximizing
    trace(R^T M) has (cos, sin) proportional to (M00 + M11, M10 - M01).
  * `_NanGuard` zeroes non-finite gradients through the covariance, as the
    reference's backward hook does.

Layout: points are rows, `[..., N, 3]`; masks/weights are `[..., N]`.
Rotations act on columns (`y = R x`), so row layout poses as `pts @ R.T`.

`similarity_fit_ransac`'s one random input, the Gumbel scores that pick
each hypothesis's three points, is explicit: a given tensor first, else a
draw from a `torch.Generator`, else it raises (the JAX function draws them
from `jax.random`, which torch cannot reproduce).
"""
from __future__ import annotations

import torch

from captra_tpu_torch.utils.precision import f32_precision

EPS = 1e-6


class _NanGuard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


# ---------------------------------------------------------------------------
# rotation fits
# ---------------------------------------------------------------------------

def _eye_like(m: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=m.dtype, device=m.device).expand(m.shape)


@f32_precision
def kabsch_rotation(source: torch.Tensor, target: torch.Tensor
                    ) -> torch.Tensor:
    """Best rotation R with target ~= source @ R.T (both [..., N, 3], already
    centered and weighted); reflection-fixed."""
    M = _NanGuard.apply(target.transpose(-1, -2) @ source)  # [..., 3, 3]
    # non-finite covariances never reach the SVD; callers route such parts
    # to their fallbacks (pose_fit.filter_valid)
    finite = torch.isfinite(M).all(dim=-1, keepdim=True).all(
        dim=-2, keepdim=True)
    M_safe = torch.where(finite, M, _eye_like(M))
    U, _, Vh = torch.linalg.svd(M_safe, full_matrices=False)
    d = torch.linalg.det(U @ Vh)
    mid = torch.zeros_like(U)
    mid[..., 0, 0] = 1.0
    mid[..., 1, 1] = 1.0
    mid[..., 2, 2] = d
    R = U @ mid @ Vh
    return torch.where(finite, R, _eye_like(R))


@f32_precision
def rot2d_fit(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Best 2D rotation with target ~= source @ R.T ([..., N, 2], centered,
    weighted): R = [[c, -s], [s, c]] with (c, s) ∝ (M00+M11, M10-M01) for
    M = target^T source.  Degenerate (|M| ~ 0) inputs give identity.
    Gradients are stopped."""
    M = (target.transpose(-1, -2) @ source).detach()  # [..., 2, 2]
    c_raw = M[..., 0, 0] + M[..., 1, 1]
    s_raw = M[..., 1, 0] - M[..., 0, 1]
    r = torch.sqrt(c_raw ** 2 + s_raw ** 2)
    valid = (r > 1e-12) & torch.isfinite(r)
    r_safe = torch.clamp(r, min=1e-12)
    c = torch.where(valid, c_raw / r_safe, torch.ones_like(r))
    s = torch.where(valid, s_raw / r_safe, torch.zeros_like(r))
    row0 = torch.stack([c, -s], dim=-1)
    row1 = torch.stack([s, c], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def rot_around_yaxis_to_3d(rot_2d: torch.Tensor) -> torch.Tensor:
    """Embed a 2D rotation of the (x, z) plane as a 3D y-axis rotation."""
    xx, xz = rot_2d[..., 0, 0], rot_2d[..., 0, 1]
    zx, zz = rot_2d[..., 1, 0], rot_2d[..., 1, 1]
    one = torch.ones_like(xx)
    zero = torch.zeros_like(xx)
    m = torch.stack([xx, zero, xz, zero, one, zero, zx, zero, zz], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# masked moments
# ---------------------------------------------------------------------------

def masked_center(pts: torch.Tensor, mask: torch.Tensor,
                  detach_center: bool = False):
    """Masked centroid + centered-and-masked points.  pts [..., N, C]
    (broadcastable), mask [..., N] binary; the point count in the
    denominator is clamped to >= 1."""
    w = mask[..., None]
    denom = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1.0)
    center = torch.sum(pts * w, dim=-2, keepdim=True) / denom
    if detach_center:
        center = center.detach()
    return center, (pts - center) * w


def scale_fit(source: torch.Tensor, target: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Least-squares scale with target ~= s * source (both centered),
    w [..., N]."""
    ww = w[..., None]
    num = torch.sum(source * target * ww, dim=(-1, -2))
    den = torch.sum(source * source * ww, dim=(-1, -2)) + EPS
    return num / den


def translation_fit(source: torch.Tensor, target: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Weighted mean of (target - source) over points -> [..., 3, 1]."""
    denom = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    wn = (w / denom)[..., None]
    t = torch.sum((target - source) * wn, dim=-2)  # [..., 3]
    return t[..., None]


# ---------------------------------------------------------------------------
# full similarity solve
# ---------------------------------------------------------------------------

# the x and z columns of [..., 3], as a slice: indexing with a list would
# copy the index to the device and synchronise the host on every call
_XZ = slice(0, 3, 2)


@f32_precision
def similarity_fit(source: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor,
                   given_scale: torch.Tensor | None = None,
                   rotation: torch.Tensor | None = None,
                   sym: bool = False):
    """Masked similarity transform: target ~= s * (source @ R.T) + t.

    source, target: [..., N, 3] (broadcast against mask's leading dims,
    typically [B, P, N, 3] vs mask [B, P, N]); mask binary.  Returns
    (rotation [..., 3, 3], scale [...], translation [..., 3, 1]).  A given
    `rotation` (the tracking path) skips the 3D SVD; `sym` refines with a
    y-axis 2D rotation; `given_scale` skips the scale fit.
    """
    _, src_c = masked_center(source, mask)
    _, tgt_c = masked_center(target, mask)

    if rotation is None:
        w = torch.sqrt(mask + EPS)[..., None]
        rotation = kabsch_rotation(src_c * w, tgt_c * w)

    if sym:
        # residual rotation about the canonical y axis: source NPCS against
        # the target brought into the canonical frame by R^T
        canon_target = target @ rotation  # rows (R^T t_i)^T
        src2d = source[..., :, _XZ]
        tgt2d = canon_target[..., :, _XZ]
        _, src2d_c = masked_center(src2d, mask)
        _, tgt2d_c = masked_center(tgt2d, mask)
        rot2d = rot2d_fit(src2d_c, tgt2d_c)
        rotation = rotation @ rot_around_yaxis_to_3d(rot2d)

    if given_scale is not None:
        scale = given_scale
    else:
        scale = scale_fit(src_c @ rotation.transpose(-1, -2), tgt_c, mask)

    posed_src = scale[..., None, None] * (source @ rotation.transpose(-1, -2))
    translation = translation_fit(posed_src, target, mask)
    return rotation, scale, translation


def draw_gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws [shape] on the generator's device, made as
    `jax.random.gumbel` makes them: -log(-log(u)), u uniform in
    [float32 tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def gumbel_or_draw(gumbel: torch.Tensor | None, shape,
                   generator: torch.Generator | None,
                   what: str) -> torch.Tensor:
    """`gumbel` when given (its shape must be `shape`), else a draw from
    `generator`; with neither this raises, naming `what` needs them."""
    if gumbel is not None:
        if tuple(gumbel.shape) != tuple(shape):
            raise ValueError(f"{what}: Gumbel draws of shape "
                             f"{tuple(gumbel.shape)}, expected {tuple(shape)}")
        return gumbel
    if generator is None:
        raise ValueError(f"{what} needs its Gumbel draws [..., hyps, N] or "
                         "a torch.Generator to draw them")
    return draw_gumbel(tuple(shape), generator)


@f32_precision
def similarity_fit_ransac(source: torch.Tensor, target: torch.Tensor,
                          mask: torch.Tensor, num_hyps: int = 32,
                          inlier_th: float = 0.01, min_inliers: int = 4,
                          rotation: torch.Tensor | None = None,
                          sym: bool = False,
                          gumbel: torch.Tensor | None = None,
                          generator: torch.Generator | None = None):
    """RANSAC-robust masked similarity fit with fixed shapes.

    `similarity_fit`'s contract plus outlier rejection: `num_hyps` 3-point
    hypotheses drawn from the masked points (the three highest Gumbel
    scores of each hypothesis, ties to the lower index as `lax.top_k`
    breaks them), each fit in closed form and scored by its inliers
    (camera-space residual < `inlier_th`); the best one (the first of equal
    counts) gives the final least-squares refit on its inliers, or on the
    full mask when it has fewer than `min_inliers`.  With a given rotation
    and `sym`, the rotation is azimuth-refined on the full mask first.

    gumbel [..., num_hyps, N] are the draws (else drawn from `generator`).
    Returns (rotation [..., 3, 3], scale [...], translation [..., 3, 1],
    refit mask [..., N])."""
    lead = tuple(mask.shape[:-1])   # e.g. (B, P)
    N = mask.shape[-1]
    H = num_hyps
    src = source.expand(lead + (N, 3))
    tgt = target.expand(lead + (N, 3))

    if rotation is not None and sym:
        # the carried spin is free up to azimuth: refine it before scoring,
        # or every point would miss whenever the spin is off
        rotation, _, _ = similarity_fit(source, target, mask,
                                        rotation=rotation, sym=True)

    g = gumbel_or_draw(gumbel, lead + (H, N), generator,
                       "similarity_fit_ransac")
    scores = torch.where(mask[..., None, :] > 0, g, -torch.inf)
    idx3 = torch.sort(scores, dim=-1, descending=True,
                      stable=True)[1][..., :3]              # [..., H, 3]

    def take(pts):                                          # [..., H, 3, 3]
        return torch.gather(pts[..., None, :, :].expand(lead + (H, N, 3)),
                            -2, idx3[..., None].expand(lead + (H, 3, 3)))

    s3, t3 = take(src), take(tgt)
    s3_c = s3 - torch.mean(s3, dim=-2, keepdim=True)
    t3_c = t3 - torch.mean(t3, dim=-2, keepdim=True)
    if rotation is None:
        R_h = kabsch_rotation(s3_c, t3_c)                   # [..., H, 3, 3]
    else:
        R_h = rotation[..., None, :, :].expand(lead + (H, 3, 3))
    R_hT = R_h.transpose(-1, -2)
    scale_h = (torch.sum((s3_c @ R_hT) * t3_c, dim=(-1, -2)) /
               torch.clamp(torch.sum(s3_c * s3_c, dim=(-1, -2)), min=EPS))
    trans_h = torch.mean(t3 - scale_h[..., None, None] * (s3 @ R_hT),
                         dim=-2)                            # [..., H, 3]

    posed = (scale_h[..., None, None] * (src[..., None, :, :] @ R_hT)
             + trans_h[..., None, :])                       # [..., H, N, 3]
    err = torch.linalg.norm(tgt[..., None, :, :] - posed, dim=-1)
    inl = (err < inlier_th) & (mask[..., None, :] > 0)      # [..., H, N]
    counts = torch.sum(inl, dim=-1)                         # [..., H]
    best = torch.argmax(counts, dim=-1)                     # [...]
    best_inl = torch.gather(inl, -2, best[..., None, None].expand(
        lead + (1, N)))[..., 0, :]
    best_count = torch.gather(counts, -1, best[..., None])[..., 0]

    ok = best_count >= min_inliers
    refit_mask = torch.where(ok[..., None], best_inl.to(mask.dtype), mask)
    R, s, t = similarity_fit(source, target, refit_mask, rotation=rotation,
                             sym=sym)
    return R, s, t, refit_mask
