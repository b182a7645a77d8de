"""Host-side (numpy) data-prep ops for the dataset readers (counterpart of
`captra_tpu/data/numpy_ops.py`).

They run per item inside the readers, on the host:
  * FPS with the reference's random pre-subsample to 5 x npoint, the exact
    sweep in the host C++ core (`data/native.py`);
  * the ball crop with radius growth and duplicate-to-num_points;
  * perturbation vectors.

Every random draw comes from the `rng` (a `np.random.RandomState`) the
caller passes; it is required, so a reader's draws follow its own seed in
the JAX reader's order and never the global numpy stream.
"""
from __future__ import annotations

import numpy as np

from captra_tpu_torch.data import native


def farthest_point_sample(xyz: np.ndarray, npoint: int,
                          rng: np.random.RandomState,
                          presample_factor: int = 5) -> np.ndarray:
    """Exact iterative FPS on [N, 3] -> [npoint] indices, after a random
    pre-subsample to presample_factor * npoint points when N is larger."""
    n = len(xyz)
    if n > presample_factor * npoint:
        pre = rng.permutation(n)[:presample_factor * npoint]
        return pre[native.fps(xyz[pre], npoint)]
    return native.fps(xyz, npoint)


def _fps_numpy(xyz: np.ndarray, npoint: int) -> np.ndarray:
    """Plain numpy twin of `native.fps` (the tests' reference)."""
    n = len(xyz)
    centroids = np.zeros(npoint, dtype=np.int64)
    distance = np.full(n, 1e10)
    farthest = 0
    for i in range(npoint):
        centroids[i] = farthest
        d = np.sum((xyz - xyz[farthest]) ** 2, axis=-1)
        np.minimum(distance, d, out=distance)
        farthest = int(np.argmax(distance))
    return centroids


def crop_ball_from_pts(pts: np.ndarray, center: np.ndarray, radius: float,
                       num_points: int,
                       rng: np.random.RandomState) -> np.ndarray:
    """Indices of a ball crop of num_points points: grow the radius (at
    least 0.05) x1.1 up to 10 times until >= 10 points lie within, take
    every point if none does, duplicate to num_points, FPS."""
    distance = np.sqrt(np.sum((pts - center) ** 2, axis=-1))
    radius = max(float(radius), 0.05)
    idx = np.where(distance <= radius)[0]
    for _ in range(10):
        if len(idx) >= 10:
            break
        radius *= 1.10
        idx = np.where(distance <= radius)[0]
    if len(idx) == 0:
        idx = np.where(distance <= 1e9)[0]
    if len(idx) == 0:
        return idx
    while len(idx) < num_points:
        idx = np.concatenate([idx, idx], axis=0)
    return idx[farthest_point_sample(pts[idx], num_points, rng)]


def random_vector(std: float, shape, kind: str,
                  rng: np.random.RandomState) -> np.ndarray:
    """Perturbation magnitudes: "normal" N(0, std), "uniform" U(-std, std)
    or "exact" +-std."""
    if kind == "normal":
        return rng.randn(*shape) * std
    if kind == "uniform":
        return rng.rand(*shape) * 2 * std - std
    if kind == "exact":
        sign = np.sign(rng.randn(*shape))
        return np.where(sign == 0, 1.0, sign) * std
    raise ValueError(f"unsupported random type {kind}")


def random_translation(std: float, shape, kind: str,
                       rng: np.random.RandomState) -> np.ndarray:
    """Translations [*shape, 3]: a `random_vector` length along a uniformly
    random direction."""
    norm = np.asarray(random_vector(std, shape, kind, rng))
    direction = rng.randn(*(tuple(shape) + (3,)))
    direction /= np.maximum(np.linalg.norm(direction, axis=-1, keepdims=True),
                            1e-8)
    return norm[..., None] * direction
