"""Fixed-shape frame preprocessing on tensors: depth backprojection, the
ball crop with radius growth and a random subsample + FPS, the OTF frame of
the dataset path, and the in-step NOCS-2D detection-mask selection
(counterpart of `captra_tpu/data/preprocess.py`).

Everything here runs on the step's device with no host synchronisation, so
the OTF tracking step (`tracking/tracker.py`, `nocs_otf`) crops inside the
step from the carried pose: the depth image is the only host-to-device
transfer of a frame.  The functions are batched over a leading cloud axis B
where the JAX functions are single-cloud (the JAX tracker vmaps them).

The one interface difference: the crops' random input is an explicit
argument: one cyclic shift per cloud `shift` [B] in [0, M) for the bucketed
subsample, uniform scores [M] for the sorted one.  The JAX crops draw them
as `jax.random.randint(key, (), 0, M)` and `jax.random.uniform(key, (M,))`
(preprocess.py:110-115, 190), which torch cannot reproduce; the parity
tests feed the port the JAX draws.

The radius-growth factors 1.1^k and 1.2^k are float32 literal tables equal
to what `1.1 ** jnp.arange(10)` and `1.2 ** jnp.arange(6)` give in JAX, so
no `pow` on the card can move a ball-boundary point by an ulp.  Line
references (preprocess.py:N) are to `captra_tpu/data/preprocess.py`.
"""
from __future__ import annotations

import numpy as np
import torch

from captra_tpu_torch.device import constant
from captra_tpu_torch.ops import pointops

# NOCS real-camera intrinsics (reference nocs_data_process.py:20)
NOCS_REAL_INTRINSICS = np.array([[591.0125, 0.0, 322.525],
                                 [0.0, 590.16775, 244.11084],
                                 [0.0, 0.0, 1.0]], np.float32)
# NOCS synthetic (CAMERA) intrinsics (reference nocs_utils.py:5)
NOCS_CAMERA_INTRINSICS = np.array([[577.5, 0.0, 319.5],
                                   [0.0, 577.5, 239.5],
                                   [0.0, 0.0, 1.0]], np.float32)

# float32 1.1 ** k, k = 0..9 and 1.2 ** k, k = 0..5, as JAX computes them
CROP_GROWTH = (1.0, 1.100000023841858, 1.2100000381469727,
               1.3310000896453857, 1.4641001224517822, 1.610510230064392,
               1.7715612649917603, 1.9487173557281494, 2.1435892581939697,
               2.357948064804077)
DET_GROWTH = (1.0, 1.2000000476837158, 1.440000057220459,
              1.7280001640319824, 2.0736002922058105, 2.4883205890655518)
# the 8 corners of the tracked ball's cube (preprocess.py:220-221)
_CUBE_SIGNS = tuple((sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0)
                    for sz in (-1.0, 1.0))


def intrinsics_tensor(intrinsics, device) -> torch.Tensor:
    """The camera matrix as a float32 [3, 3] tensor on `device`."""
    if not torch.is_tensor(intrinsics):
        intrinsics = torch.tensor(np.asarray(intrinsics, np.float32))
    return intrinsics.to(device=device, dtype=torch.float32)


def _grid(H: int, W: int, device):
    rows = torch.arange(H, dtype=torch.int32, device=device)[:, None]
    cols = torch.arange(W, dtype=torch.int32, device=device)[None, :]
    return rows.expand(H, W), cols.expand(H, W)


def intrinsics_inverse(K: torch.Tensor) -> torch.Tensor:
    """Inverse of a camera matrix [[fx, s, cx], [0, fy, cy], [0, 0, 1]] by
    back-substitution with the reciprocals of fx and fy: the float32 values
    `jnp.linalg.inv` gives on zero-skew intrinsics, on any device (a
    library inverse differs by an ulp, and by device)."""
    r0, r1 = 1.0 / K[0, 0], 1.0 / K[1, 1]
    inv12 = -K[1, 2] * r1
    inv02 = -(K[0, 2] + K[0, 1] * inv12) * r0
    zero, one = torch.zeros_like(r0), torch.ones_like(r0)
    return torch.stack([torch.stack([r0, -K[0, 1] * r0 * r1, inv02]),
                        torch.stack([zero, r1, inv12]),
                        torch.stack([zero, zero, one])])


def backproject_depth(depth: torch.Tensor, intrinsics, mask=None,
                      scale: float = 0.001):
    """depth [H, W] (raw integer units) -> (pts [H*W, 3] metric, valid
    [H*W]), with the reference's y-flip (v = H - row) and z-negation
    (preprocess.py:44-65)."""
    H, W = depth.shape
    K = intrinsics_tensor(intrinsics, depth.device)
    rows, cols = _grid(H, W, depth.device)
    valid = depth > 0
    if mask is not None:
        valid = valid & torch.as_tensor(mask, device=depth.device).bool()
    K_inv = intrinsics_inverse(K)
    uv1 = torch.stack([cols.float(), (H - rows).float(),
                       torch.ones((H, W), device=depth.device)], dim=-1)
    xyz = uv1 @ K_inv.T
    z = depth.float()
    pts = xyz * (z[..., None] / xyz[..., 2:3])
    pts = torch.cat([pts[..., :2], -pts[..., 2:]], dim=-1)
    return pts.reshape(H * W, 3) * scale, valid.reshape(H * W)


def backproject_depth_planes(depth: torch.Tensor, intrinsics: torch.Tensor,
                             scale: float = 0.001):
    """Planes layout: depth [B, H, W] -> (pts3 [B, 3, H*W], valid
    [B, H*W]) (preprocess.py:132-152; zero-skew intrinsics).  The
    intrinsics are a float32 [3, 3] tensor on the depth's device."""
    B, H, W = depth.shape
    rows, cols = _grid(H, W, depth.device)
    valid = depth > 0
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    z = depth.float()
    x = (cols.float() - cx) / fx * z
    y = ((H - rows).float() - cy) / fy * z
    pts3 = torch.stack([x.reshape(B, -1), y.reshape(B, -1),
                        -z.reshape(B, -1)], dim=1)
    return pts3 * scale, valid.reshape(B, -1)


def _first_true(x: torch.Tensor, dim: int = -1):
    """Index of the first True along `dim` and whether there is one (the
    index is the axis length where there is none)."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    order = torch.arange(n, device=x.device).reshape(shape)
    first = torch.where(x, order, n).amin(dim=dim)
    return first, first < n


def _in_ball(pts3: torch.Tensor, valid: torch.Tensor, center: torch.Tensor,
             radius: torch.Tensor, max_grow: int) -> torch.Tensor:
    """[B, M] the crop's ball (preprocess.py:93-108): the first of
    max(radius, 0.05) * 1.1^k with at least 10 valid points within, else
    the largest; an empty ball takes every valid point."""
    if max_grow > len(CROP_GROWTH):
        raise ValueError(f"max_grow {max_grow} > {len(CROP_GROWTH)}")
    dev = pts3.device
    dx = pts3[:, 0] - center[:, 0, None]
    dy = pts3[:, 1] - center[:, 1, None]
    dz = pts3[:, 2] - center[:, 2, None]
    dist = torch.where(valid, torch.sqrt(dx * dx + dy * dy + dz * dz),
                       torch.inf)                             # [B, M]
    growth = constant(CROP_GROWTH[:max_grow], torch.float32, dev)
    radii = torch.clamp_min(radius, 0.05)[:, None] * growth   # [B, G]
    counts = (dist[:, None, :] <= radii[:, :, None]).sum(-1)  # [B, G]
    k, any_k = _first_true(counts >= 10)
    k = torch.where(any_k, k, max_grow - 1)
    in_ball = dist <= torch.gather(radii, 1, k[:, None])
    return torch.where(in_ball.any(-1, keepdim=True), in_ball, valid)


def crop_working_set(shift: torch.Tensor, pts3: torch.Tensor,
                     valid: torch.Tensor, center: torch.Tensor,
                     radius: torch.Tensor, num_points: int,
                     work_factor: int = 5, max_grow: int = 10):
    """The crop's FPS working set (preprocess.py:176-199): shift [B] in
    [0, M), pts3 [B, 3, M], valid [B, M], center [B, 3], radius [B] ->
    (take [B, W] int64 indices into M, sub3 [B, 3, W]).

    The ball of `_in_ball`; the W = min(work_factor * num_points, M) points
    are the first in-ball point of each of W buckets of G = ceil(M/W) after
    a cyclic shift by `shift`; an empty bucket takes the first in-ball
    point overall, so a small ball fills the set with duplicates."""
    B, _, M = pts3.shape
    dev = pts3.device
    in_ball = _in_ball(pts3, valid, center, radius, max_grow)
    W = min(work_factor * num_points, M)
    G = -(-M // W)
    shift = shift.to(device=dev, dtype=torch.int64)
    pos = torch.arange(W * G, device=dev)
    # rolled[j] = in_ball[(j + shift) % M] for j < M; the pad W*G - M is
    # empty (jnp.roll then jnp.pad)
    rolled = torch.gather(in_ball, 1, (pos[None] + shift[:, None]) % M)
    rolled = rolled & (pos < M)[None]
    first, found = _first_true(rolled.reshape(B, W, G))      # [B, W]
    cand = (torch.arange(W, device=dev)[None] * G + first
            + shift[:, None]) % M
    fb, _ = _first_true(rolled)
    fb = torch.where(fb < W * G, fb, 0)                       # argmax of none
    take = torch.where(found, cand, ((fb + shift) % M)[:, None])
    return take, torch.gather(pts3, 2, take[:, None].expand(B, 3, W))


def crop_ball_batch_planes(shift: torch.Tensor, pts3: torch.Tensor,
                           valid: torch.Tensor, center: torch.Tensor,
                           radius: torch.Tensor, num_points: int,
                           work_factor: int = 5, max_grow: int = 10,
                           fps_mode: str = "exact"):
    """Batched ball crop on planes-layout clouds (preprocess.py:155-211):
    shift [B] in [0, M), pts3 [B, 3, M], valid [B, M], center [B, 3],
    radius [B] -> (points3 [B, 3, num_points], idx [B, num_points] int64).

    The working set of `crop_working_set`, then FPS down to num_points
    ("exact": one global sweep; "grouped": the stratified 8-way
    approximation).  FPS is reached through `pointops`, so it takes the
    CUDA kernels on the card."""
    take, sub3 = crop_working_set(shift, pts3, valid, center, radius,
                                  num_points, work_factor, max_grow)
    if fps_mode == "grouped":
        fps_idx = pointops.farthest_point_sample_grouped_t(sub3, num_points)
    elif fps_mode == "exact":
        fps_idx = pointops.farthest_point_sample_indices(
            sub3.transpose(1, 2).contiguous(), num_points)
    else:
        raise ValueError(f"unknown fps_mode {fps_mode!r} (exact|grouped)")
    final = torch.gather(take, 1, fps_idx.long())
    B = pts3.shape[0]
    points3 = torch.gather(pts3, 2, final[:, None].expand(B, 3, num_points))
    return points3, final


def crop_ball(draw: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor,
              center: torch.Tensor, radius: torch.Tensor, num_points: int,
              work_factor: int = 5, max_grow: int = 10,
              method: str = "sort"):
    """Ball crop + FPS of one cloud in rows layout (preprocess.py:66-129):
    pts [M, 3], valid [M] bool, center [3], radius [] -> (points
    [num_points, 3], idx [num_points] int64 into pts).

    The ball of `_in_ball`, then a working set of W = min(work_factor *
    num_points, M) points, FPS'd down to num_points ([1, W] through
    `pointops`: the CUDA kernels on the card).  `method` picks the working
    set and `draw` is its random input:
      "sort"   (the JAX default on every backend but the TPU, so the
               default here): draw = uniform scores [M]; the in-ball points
               in increasing score order (a stable argsort), wrapped to W;
      "bucket" (the JAX default on the TPU): draw = the cyclic shift [] in
               [0, M); the first in-ball point of each of W buckets, as
               `crop_working_set`.
    Both wrap-fill to W, so a small ball gives FPS duplicates."""
    M = pts.shape[0]
    W = min(work_factor * num_points, M)
    pts3, valid, center = pts.T[None], valid[None], center[None]
    radius = radius.reshape(1)
    if method == "bucket":
        take = crop_working_set(draw.reshape(1), pts3, valid, center, radius,
                                num_points, work_factor, max_grow)[0][0]
    elif method == "sort":
        in_ball = _in_ball(pts3, valid, center, radius, max_grow)[0]
        count = torch.clamp_min(in_ball.sum(), 1)
        scores = torch.where(in_ball, draw.to(pts.device), torch.inf)
        order = torch.argsort(scores, stable=True)
        take = order[torch.arange(W, device=pts.device) % count]
    else:
        raise ValueError(f"unknown crop method {method!r} (sort|bucket)")
    fps_idx = pointops.farthest_point_sample_indices(
        pts[take][None].contiguous(), num_points)[0]
    final = take[fps_idx.long()]
    return pts[final], final


def otf_frame_from_depth(draw: torch.Tensor, depth: torch.Tensor,
                         obj_mask: torch.Tensor, intrinsics,
                         center: torch.Tensor, radius: torch.Tensor,
                         gt_pose, num_points: int, method: str = "sort"):
    """One OTF frame of the dataset path (preprocess.py:295-316): depth
    [H, W] + instance mask [H, W] + tracked center [3] and radius [] ->
    {points [num_points, 3], labels, nocs}: the rows backprojection, then
    `crop_ball` (`draw` and `method` as there).

    labels follow the NOCS convention, 0 = object, 1 = background; nocs is
    the GT pose's canonical frame on the object points, 0 elsewhere.
    gt_pose: a single-part `Pose` (rotation [3, 3], translation [3, 1],
    scale [])."""
    pts, valid = backproject_depth(depth, intrinsics)
    points, idx = crop_ball(draw, pts, valid, center, radius, num_points,
                            method=method)
    is_obj = obj_mask.reshape(-1).to(points.device)[idx].to(torch.int32)
    labels = 1 - is_obj
    canon = ((points - gt_pose.translation[..., 0]) /
             gt_pose.scale) @ gt_pose.rotation
    nocs = torch.where((labels == 0)[:, None], canon, 0.0)
    return {"points": points, "labels": labels, "nocs": nocs}


def projected_bbox_2d(center: torch.Tensor, radius: torch.Tensor,
                      intrinsics: torch.Tensor, image_hw) -> torch.Tensor:
    """Project the tracked ball's cube to a 2D (y1, x1, y2, x2) window
    (preprocess.py:214-233): center [..., 3], radius [...] -> [..., 4]."""
    h, w = image_hw
    radius = torch.clamp_min(radius, 0.05)
    signs = constant(_CUBE_SIGNS, torch.float32, center.device)   # [8, 3]
    corners = center[..., None, :] + signs * radius[..., None, None]
    pts = corners * 1000.0
    pts = -pts / pts[..., 2:3]
    px, py, pz = pts[..., 0], pts[..., 1], -pts[..., 2]
    K = intrinsics
    u = K[0, 0] * px + K[0, 1] * py + K[0, 2] * pz
    v = K[1, 0] * px + K[1, 1] * py + K[1, 2] * pz
    rows, cols = h - v, u
    return torch.stack([
        torch.clamp(rows.amin(-1), 0, h - 1),
        torch.clamp(cols.amin(-1), 0, w - 1),
        torch.clamp(rows.amax(-1), 0, h - 1),
        torch.clamp(cols.amax(-1), 0, w - 1)], dim=-1)


def _bbox_iou_1vK(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of box [..., 4] against boxes [..., K, 4] (y1, x1, y2, x2) ->
    [..., K] (preprocess.py:236-249)."""
    box = box[..., None, :]
    y1 = torch.maximum(box[..., 0], boxes[..., 0])
    y2 = torch.minimum(box[..., 2], boxes[..., 2])
    x1 = torch.maximum(box[..., 1], boxes[..., 1])
    x2 = torch.minimum(box[..., 3], boxes[..., 3])

    def area(x1, x2, y1, y2):
        return torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)

    inter = area(x1, x2, y1, y2)
    union = (area(box[..., 1], box[..., 3], box[..., 0], box[..., 2]) +
             area(boxes[..., 1], boxes[..., 3], boxes[..., 0], boxes[..., 2])
             - inter)
    return inter / torch.clamp_min(union, 1e-9)


def unpack_detection_masks(packed: torch.Tensor, image_hw) -> torch.Tensor:
    """Bit-packed masks [..., H, ceil(W/8)] uint8 (little bit order along W,
    as `np.packbits(..., bitorder="little")`) -> bool [..., H, W]
    (preprocess.py:252-263)."""
    W = image_hw[1]
    shifts = torch.arange(8, dtype=packed.dtype, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    full = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,))
    return full[..., :W].bool()


def select_detection_mask(det_masks: torch.Tensor, det_boxes: torch.Tensor,
                          det_valid: torch.Tensor, center: torch.Tensor,
                          radius: torch.Tensor, intrinsics: torch.Tensor,
                          image_hw, min_iou: float = 0.05,
                          max_grow: int = 6):
    """NOCS-2D detection selection (preprocess.py:266-292), batched: among
    the valid detections of each cloud, the mask whose 2D box best overlaps
    the projected tracked ball, growing the projection by 1.2 until a hit.

    det_masks [B, K, ...] (bool, or bit-packed: the selection only indexes
    them); det_boxes [B, K, 4]; det_valid [B, K]; center [B, 3]; radius [B]
    -> (mask [B, ...], found [B])."""
    if max_grow > len(DET_GROWTH):
        raise ValueError(f"max_grow {max_grow} > {len(DET_GROWTH)}")
    B = det_boxes.shape[0]
    growth = constant(DET_GROWTH[:max_grow], torch.float32, center.device)
    radii = radius[:, None] * growth                            # [B, G]
    box = projected_bbox_2d(center[:, None, :].expand(B, max_grow, 3), radii,
                            intrinsics, image_hw)               # [B, G, 4]
    ious = torch.where(det_valid[:, None, :],
                       _bbox_iou_1vK(box, det_boxes[:, None]), -1.0)
    hit = ious.amax(-1) > min_iou                               # [B, G]
    g, any_hit = _first_true(hit)
    g = torch.where(any_hit, g, max_grow - 1)
    rows = torch.arange(B, device=det_boxes.device)
    best = torch.argmax(ious[rows, g], dim=-1)                  # [B]
    return det_masks[rows, best], det_valid.any(-1)
