"""OpenCV's `cv2.line` (8-connected, integer end points, no shift) in numpy,
pixel for pixel, so that the visualisers need no OpenCV.

OpenCV draws (imgproc/drawing.cpp):

  * thickness 1: `Line`, the 8-connected Bresenham walk of `LineIterator`
    from the left end point (the line first clipped to the image by
    `clipLine`);
  * thicker: the segment first clipped (`clipLine`) to the image grown by
    the thickness on every side, then `ThickLine`: the segment's quad in
    16-bit fixed point (`XY_SHIFT`) filled by `FillConvexPoly` (its outline
    drawn by the fixed-point `Line2`, then its scanlines), plus a filled
    `Circle` of radius round(thickness / 2) at each end.

The functions follow that code step for step, with C's integer semantics:
arithmetic right shifts, division truncated toward zero, `cvRound` half
to even, and 64-bit fixed point.  They draw into an [H, W, C] uint8 image
in place.
"""
from __future__ import annotations

import math

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncated toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _i32(v: int) -> int:
    """C's cast of a 64-bit integer to int (two's complement wrap)."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def clip_line(width: int, height: int, p1, p2):
    """OpenCV's `clipLine` on a width x height rectangle: (inside, p1, p2)
    with the end points moved onto its border."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = width - 1, height - 1
    if width <= 0 or height <= 0:
        return False, (x1, y1), (x2, y2)
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _put(img, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _hline(img, y: int, x1: int, x2: int, color) -> None:
    # ICV_HLINE: x1..x2 inclusive, nothing when x1 > x2
    if x1 <= x2:
        img[y, x1:x2 + 1] = color


def line8(img, p1, p2, color) -> None:
    """`Line(img, pt1, pt2, color, 8)`: LineIterator's 8-connected walk,
    left to right, over the line clipped to the image."""
    H, W = img.shape[:2]
    p1 = (_i32(p1[0]), _i32(p1[1]))
    p2 = (_i32(p2[0]), _i32(p2[1]))
    if not (0 <= p1[0] < W and 0 <= p2[0] < W and 0 <= p1[1] < H
            and 0 <= p2[1] < H):
        ok, p1, p2 = clip_line(W, H, p1, p2)
        if not ok:
            return
        p1 = (_i32(p1[0]), _i32(p1[1]))
        p2 = (_i32(p2[0]), _i32(p2[1]))
    delta_x = delta_y = 1
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:                       # leftToRight
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    if dy < 0:
        dy, delta_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        delta_x, delta_y = delta_y, delta_x
    err = dx - (dy + dy)
    plus_delta, minus_delta = dx + dx, -(dy + dy)
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = color
        minor = err < 0
        err += minus_delta + (plus_delta if minor else 0)
        if vert:
            y += delta_x
            if minor:
                x += delta_y
        else:
            x += delta_x
            if minor:
                y += delta_y


def line2(img, p1, p2, color) -> None:
    """`Line2`: the fixed-point (XY_SHIFT) line that outlines a filled
    polygon."""
    H, W = img.shape[:2]
    ok, (x1, y1), (x2, y2) = clip_line(W << XY_SHIFT, H << XY_SHIFT, p1, p2)
    if not ok:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = _i32((x2 - x1) >> XY_SHIFT)
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        ecount = _i32((y2 - y1) >> XY_SHIFT)
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(img, _i32((x2 + (XY_ONE >> 1)) >> XY_SHIFT),
         _i32((y2 + (XY_ONE >> 1)) >> XY_SHIFT), color)
    if ax > ay:
        x1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, _i32(x1), _i32(y1 >> XY_SHIFT), color)
            x1 += 1
            y1 += y_step
            ecount -= 1
    else:
        y1 >>= XY_SHIFT
        while ecount >= 0:
            _put(img, _i32(x1 >> XY_SHIFT), _i32(y1), color)
            x1 += x_step
            y1 += 1
            ecount -= 1


def fill_convex_poly(img, v, color, shift: int = XY_SHIFT) -> None:
    """`FillConvexPoly(img, v, npts, color, 8, shift)`: the outline by
    `line2`, then each scanline between the two edges walked down from the
    top vertex."""
    H, W = img.shape[:2]
    npts = len(v)
    delta = 1 << shift >> 1
    delta1 = delta2 = XY_ONE >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (px, py) in enumerate(v):
        if py < ymin:
            ymin, imin = py, i
        ymax, xmax, xmin = max(ymax, py), max(xmax, px), min(xmin, px)
        p = (px << up, py << up)
        line2(img, p0, p, color)
        p0 = p
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or _i32(xmax) < 0 or _i32(ymax) < 0 or _i32(xmin) >= W \
            or _i32(ymin) >= H:
        return
    ymax = min(ymax, H - 1)
    edges = npts
    y = _i32(ymin)
    edge = [{"idx": imin, "di": 1, "x": -XY_ONE, "dx": 0, "ye": y},
            {"idx": imin, "di": npts - 1, "x": -XY_ONE, "dx": 0, "ye": y}]
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % npts
                while edges > 0:
                    edges -= 1
                    ty = _i32((v[idx][1] + delta) >> shift)
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs) * 2 + (ty - y),
                                        2 * (ty - y))
                        e["x"] = xs
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % npts
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = _i32((edge[left]["x"] + delta1) >> XY_SHIFT)
            xx2 = _i32((edge[right]["x"] + delta2) >> XY_SHIFT)
            if xx2 >= 0 and xx1 < W:
                _hline(img, y, max(xx1, 0), min(xx2, W - 1), color)
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > _i32(ymax):
            break


def filled_circle(img, center, radius: int, color) -> None:
    """`Circle(img, center, radius, color, fill=1)`: the midpoint circle's
    spans, clipped to the image."""
    H, W = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = (cx >= radius and cx < W - radius and cy >= radius
              and cy < H - radius)
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            for yy, a, b in ((y11, x11, x12), (y12, x11, x12),
                             (y21, x21, x22), (y22, x21, x22)):
                _hline(img, yy, a, b, color)
        elif x11 < W and x12 >= 0 and y21 < H and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, W - 1)
            for yy in (y11, y12):
                if 0 <= yy < H:
                    _hline(img, yy, x11, x12, color)
            if x21 < W and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, W - 1)
                for yy in (y21, y22):
                    if 0 <= yy < H:
                        _hline(img, yy, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> None:
    """`cv2.line(img, p0, p1, color, thickness)` with the default 8-connected
    line type, in place; p0 / p1 are (x, y) integer points."""
    color = np.asarray(color, img.dtype)[:img.shape[-1]] if img.ndim == 3 \
        else np.asarray(color, img.dtype).reshape(-1)[0]
    p0, p1 = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if thickness > 1:
        # the segment first clipped to the image grown by the thickness
        H, W = img.shape[:2]
        t = thickness
        ok, q0, q1 = clip_line(W + 2 * t, H + 2 * t, (p0[0] + t, p0[1] + t),
                               (p1[0] + t, p1[1] + t))
        if not ok:
            return
        p0, p1 = (q0[0] - t, q0[1] - t), (q1[0] - t, q1[1] - t)
    x0, y0 = p0[0] << XY_SHIFT, p0[1] << XY_SHIFT
    x1, y1 = p1[0] << XY_SHIFT, p1[1] << XY_SHIFT
    if thickness <= 1:
        line8(img, ((x0 + (XY_ONE >> 1)) >> XY_SHIFT,
                    (y0 + (XY_ONE >> 1)) >> XY_SHIFT),
              ((x1 + (XY_ONE >> 1)) >> XY_SHIFT,
               (y1 + (XY_ONE >> 1)) >> XY_SHIFT), color)
        return
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = round(dy * r), round(dx * r)
        fill_convex_poly(img, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                               (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)],
                         color)
    radius = (t + (XY_ONE >> 1)) >> XY_SHIFT
    for x, y in ((x0, y0), (x1, y1)):
        filled_circle(img, (_i32((x + (XY_ONE >> 1)) >> XY_SHIFT),
                            _i32((y + (XY_ONE >> 1)) >> XY_SHIFT)),
                      radius, color)
