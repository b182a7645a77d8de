"""Gaussian blur of a float64 image on the host, without OpenCV.

`gaussian_blur(img, ksize, sigma)` computes what
`cv2.GaussianBlur(img, (ksize, ksize), sigmaX=sigma)` computes on a 2-D
float64 image (the SAPIEN depth-sensor augmentation's blur): the kernel of
`cv2.getGaussianKernel` for sigma > 0 (its bit-exact construction:
exp(-0.125 (2i + 1 - k)^2 / sigma^2) off the centre, 1 at it, each tap
times the reciprocal of their sum), sigmaY = sigmaX, applied separably,
rows then columns, with `BORDER_REFLECT_101` (numpy's "reflect" padding).
The card's machine has no OpenCV.
"""
from __future__ import annotations

import numpy as np


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """`cv2.getGaussianKernel(ksize, sigma)` for sigma > 0, float64 [k]."""
    if ksize < 1 or ksize % 2 == 0:
        raise ValueError(f"ksize must be odd and positive, got {ksize}")
    if not sigma > 0:
        raise ValueError(f"sigma must be positive, got {sigma}")
    half = (ksize - 1) // 2
    scale = -0.125 / (sigma * sigma)
    x = np.arange(1 - ksize, -1, 2, dtype=np.float64)[:half]   # 2i + 1 - k
    t = np.exp((x * x) * scale)
    total = 0.0
    for v in t:                 # OpenCV's order of the sum
        total += v
    total = total * 2.0 + 1.0
    inv = 1.0 / total
    side = t * inv
    return np.concatenate([side, [inv], side[::-1]])


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, (ksize, ksize), sigmaX=sigma)` of a 2-D
    image, in float64."""
    img = np.asarray(img, np.float64)
    if img.ndim != 2:
        raise ValueError(f"gaussian_blur takes a 2-D image, got "
                         f"{img.shape}")
    k = gaussian_kernel(ksize, sigma)
    r = ksize // 2
    out = img
    for axis in (1, 0):         # rows, then columns
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        src = np.pad(out, pad, mode="reflect")
        n = out.shape[axis]
        acc = np.zeros_like(out)
        for j in range(ksize):
            acc += k[j] * np.take(src, np.arange(j, j + n), axis=axis)
        out = acc
    return out
