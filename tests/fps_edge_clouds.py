"""Clouds at the edge of the blocked FPS kernels' skip rule (shared by the
CPU and card tests).

A row of points is skipped by a pick when lb^2 * 0.999999 >= the max of the
row's running minima, where lb is the distance from the pick to the row's
box.  These clouds put three blocks of points where, at pick 1, that lower
bound lands exactly on the block's max, one ulp above it and one ulp below
it, for every row that lies inside a block: point 0 is the origin (pick 0),
point 1 the farthest point from it (pick 1), and each block repeats the 8
corners of a small box, so every aligned row of up to 512 points inside it
has the block's box and max.
"""
import numpy as np

N = 2048
BLOCK = 512                  # blocks at [512, 1024), [1024, 1536), [1536, 2048)
FAR = np.float32(4.0)        # pick 1: (FAR, 0, 0)
OFFSETS = (0, 1, -1)         # lb^2 * 0.999999 - the block's max, in ulps


def _f32(v):
    return np.float32(v)


def pick1_bound(lo, hi):
    """lb^2 * 0.999999 from (FAR, 0, 0) to the box [lo, hi], in float32 as
    the kernels evaluate it."""
    g = np.maximum(np.maximum(lo - np.array([FAR, 0, 0], np.float32),
                              np.array([FAR, 0, 0], np.float32) - hi),
                   _f32(0))
    return ((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]) * _f32(0.999999)


def pick0_max(pts):
    """The max over pts of the squared distance to the origin, in float32."""
    return max((p[0] * p[0] + p[1] * p[1]) + p[2] * p[2] for p in pts)


def _corners(x0, x1, y0, y1, w):
    return np.array([[x, y, z] for x in (x0, x1) for y in (y0, y1)
                     for z in (-w, w)], np.float32)


def _block(offset, y):
    """The corners of a box [x0, x1] x [y, y + 2w] x [-w, w] whose far face
    x1 is chosen, float by float, so that pick 1's bound is `offset` ulps
    from the max over the corners after pick 0 (None if no x1 of the scan
    gives it)."""
    w = _f32(0.125)
    y0, y1 = _f32(y), _f32(y) + _f32(2) * w
    # where (FAR - x1)^2 + y0^2 = x1^2 + y1^2 + w^2, then float by float
    x1 = _f32((float(FAR) ** 2 + float(y0) ** 2 - float(y1) ** 2
               - float(w) ** 2) / (2 * float(FAR)))
    for _ in range(64):
        c = _corners(x1 - _f32(0.25), x1, y0, y1, w)
        lb2, m = pick1_bound(c.min(0), c.max(0)), pick0_max(c)
        target = m
        for _ in range(abs(offset)):
            target = np.nextafter(target, _f32(np.inf * np.sign(offset)))
        if lb2 == target:
            return c
        x1 = np.nextafter(x1, _f32(np.inf if lb2 > target else -np.inf))
    return None


def skip_edge_cloud(seed: int) -> np.ndarray:
    """[N, 3] float32, in scan order: the origin, (FAR, 0, 0), filler points
    in the cube [-0.5, 0.5]^3, then the three blocks (OFFSETS) of BLOCK points."""
    rng = np.random.RandomState(seed)
    filler = rng.uniform(-0.5, 0.5, (BLOCK - 2, 3)).astype(np.float32)
    parts = [np.zeros((1, 3), np.float32),
             np.array([[FAR, 0, 0]], np.float32), filler]
    for offset in OFFSETS:
        for y in np.linspace(0.3, 0.8, 64, dtype=np.float32):
            c = _block(offset, y)
            if c is not None:
                break
        else:
            raise AssertionError(f"no block at {offset} ulps")
        parts.append(np.tile(c, (BLOCK // len(c), 1)))
    return np.ascontiguousarray(np.concatenate(parts))


def edge_offsets(xyz: np.ndarray, row: int) -> list:
    """For each row of `row` points inside a block: pick 1's bound minus the
    row's max after pick 0, in ulps of the max (-1, 0, 1, or None when
    further)."""
    out = []
    for start in range(BLOCK, N, row):
        pts = xyz[start:start + row]
        lb2, m = pick1_bound(pts.min(0), pts.max(0)), pick0_max(pts)
        steps = {0: m, 1: np.nextafter(m, _f32(np.inf)),
                 -1: np.nextafter(m, _f32(-np.inf))}
        out.append(next((k for k, v in steps.items() if v == lb2), None))
    return out
