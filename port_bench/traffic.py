"""The general traffic generator: a traffic file's parameters and a seed
-> the frames of B tracked streams, made on the device.

`"input": "points"` (a copy of the port's `data/synthetic.make_trajectory`,
batched over the streams and drawn from a `torch.Generator`): each stream
is one object of the configuration's category with parts on shells (a
surface of revolution for a symmetric category, box faces otherwise),
moving smoothly (a fixed rotation and translation a frame, prismatic or
revolute joints opening at a fixed rate a part), observed as num_points
camera points with Gaussian noise.  Returns frames {"points" [T, B, N, 3]}
and the frame-0 pose, the streams' init.

`"input": "depth"` (a copy of the port's `data/depth_frames.py`): each
stream is a raw 480x640 depth video in millimetres, a background and a
square object plate that moves a pixel a frame, the plate's depth jittered
a frame and every pixel's by the sensor's noise (uniform, +-pixel_noise_mm;
a flat plate backprojects to a lattice whose equidistant points make every
FPS pick a tie), with the object mask and the crop's cyclic shift a
frame.  Returns
frames {"depth" int32 [T, B, H, W], "mask" bool, "shift" int64 [T, B]} and
the init: identity rotation, the mean of frame 0's object points, a fixed
scale.
"""
from __future__ import annotations

import math

import torch

from port_bench.harness import derive_seed
from port_bench.reference.captra import NOCS_REAL_INTRINSICS, backproject


def _uniform(g, lo, hi, *shape):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def _normal(g, *shape):
    return torch.randn(shape, generator=g, device=g.device)


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def rotation_about(axis, theta):
    """Rodrigues: unit axes [..., 3], angles [...] -> [..., 3, 3]."""
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero],
                    -1).reshape(axis.shape[:-1] + (3, 3))
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    return torch.eye(3, dtype=axis.dtype, device=axis.device) + s * k \
        + (1 - c) * (k @ k)


def _quat_matrix(q):
    q = _unit(q)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w,
        2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w,
        2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y,
    ], -1).reshape(q.shape[:-1] + (3, 3))


def _shell_points(g, obj: dict, B: int, N: int):
    """NPCS points [B, N, 3] and their part labels [N]: n = N // P points a
    part, the rest on part 0."""
    P = obj["num_parts"]
    dev = g.device
    per = N // P
    labels = torch.arange(N, device=dev) // per
    labels = torch.where(labels < P, labels, 0)
    sizes = _uniform(g, 0.08, 0.18, B, P, 3)
    size = sizes[:, labels]                                  # [B, N, 3]
    if obj["sym"]:
        y = _uniform(g, -1.0, 1.0, B, N)
        theta = _uniform(g, 0.0, 2 * math.pi, B, N)
        r = 0.6 + 0.4 * torch.cos(1.5 * y)
        pts = torch.stack([r * torch.cos(theta), y, r * torch.sin(theta)], -1)
    else:
        face = torch.randint(0, 6, (B, N), generator=g, device=dev)
        uv = _uniform(g, -1.0, 1.0, B, N, 2)
        axis, sign = face % 3, (face // 3) * 2.0 - 1.0
        first = torch.where(axis == 0, 1, 0)
        second = torch.where(axis == 2, 1, 2)
        pts = torch.zeros(B, N, 3, device=dev)
        pts.scatter_(-1, axis[..., None], sign[..., None])
        pts.scatter_(-1, first[..., None], uv[..., :1])
        pts.scatter_(-1, second[..., None], uv[..., 1:])
    offsets = torch.zeros(P, 3, device=dev)
    offsets[:, 0] = (torch.arange(P, device=dev) - (P - 1) / 2) * 0.25
    return pts * size + offsets[labels], labels, offsets, sizes


def _objects(g, traffic: dict, cfg: dict, B: int, T: int):
    """B objects of the configuration's category over T frames -> camera
    points [T, B, N, 3], the part poses (rotation [T, B, P, 3, 3],
    translation [T, B, P, 3], scale [B]), the NPCS [B, N, 3], their labels
    [N] and each part's NPCS box [B, P, 2, 3]."""
    device = g.device
    obj = cfg["obj"]
    N = cfg["num_points"]
    P = obj["num_parts"]
    root = list(obj["tree"]).index(-1)
    npcs, labels, offsets, sizes = _shell_points(g, obj, B, N)
    scale = _uniform(g, *traffic["scale_range"], B)
    base_R = _quat_matrix(_normal(g, B, 4))
    base_t = _uniform(g, -0.1, 0.1, B, 3) + torch.tensor(
        [0.0, 0.0, traffic["depth_m"]], device=device)
    axis = _unit(_normal(g, B, 3))
    dtrans = _unit(_normal(g, B, 3)) * traffic["motion_trans"]
    djoint = _uniform(g, 0.2, 1.0, B, P) * traffic["joint_rate"]

    f = torch.arange(T, device=device, dtype=torch.float32)
    R_cur = rotation_about(axis[None].expand(T, B, 3),
                           (f + 1)[:, None].expand(T, B)
                           * traffic["motion_rad"]) @ base_R  # [T, B, 3, 3]
    t_cur = base_t + (f + 1)[:, None, None] * dtrans         # [T, B, 3]
    Rs, ts = [], []
    for p in range(P):
        if p == root or obj["num_joints"] == 0:
            Rs.append(R_cur)
            ts.append(t_cur)
            continue
        axes = list(obj["main_axis"])
        ax = torch.zeros(3, device=device)
        ax[axes[min(p, len(axes) - 1)] if axes else 1] = 1.0
        theta = f[:, None] * djoint[None, :, p]              # [T, B]
        if obj["joint_type"] == "prismatic":
            R_loc = torch.eye(3, device=device).expand(T, B, 3, 3)
            t_loc = ax * (theta * 0.3)[..., None]
        else:
            R_loc = rotation_about(ax.expand(T, B, 3), theta)
            t_loc = ((torch.eye(3, device=device) - R_loc)
                     @ offsets[p])
        Rs.append(R_cur @ R_loc)
        ts.append(scale[None, :, None] * (R_cur @ t_loc[..., None])[..., 0]
                  + t_cur)
    R = torch.stack(Rs, 2)                                   # [T, B, P, 3, 3]
    t = torch.stack(ts, 2)                                   # [T, B, P, 3]
    points = torch.zeros(T, B, N, 3, device=device)
    for p in range(P):
        posed = (scale[None, :, None, None]
                 * (npcs[None] @ R[:, :, p].transpose(-1, -2))
                 + t[:, :, p, None])
        points = torch.where((labels == p)[None, None, :, None], posed,
                             points)
    points = points + _normal(g, T, B, N, 3) * traffic["noise"]
    boxes = torch.stack([offsets - sizes, offsets + sizes], 2)  # [B, P, 2, 3]
    return points, R, t, scale, npcs, labels, boxes


def points_video(traffic: dict, cfg: dict, seed: int, device):
    """Synthetic camera clouds of B moving objects (see the module)."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, "traffic"))
    B, T = traffic["streams"], traffic["frames"]
    P = cfg["obj"]["num_parts"]
    points, R, t, scale, *_ = _objects(g, traffic, cfg, B, T)
    init = {"rotation": R[0].contiguous(), "translation": t[0, ..., None]
            .contiguous(), "scale": scale[:, None].expand(B, P).contiguous()}
    return {"points": points}, init


def train_pool(traffic: dict, cfg: dict, seed: int, device) -> dict:
    """A pool of `pool` training samples on the device: one frame of as
    many objects (as `points_video` makes them), with their NPCS, labels,
    ground-truth part poses, NPCS boxes and a perturbed init pose (the
    rotation turned by |N(0, 1)| x perturb_deg about a random axis, the
    translation moved by N(0, 1) x perturb_t along a random direction, the
    scale by N(0, 1) x perturb_s)."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, "traffic"))
    G = traffic["pool"]
    P = cfg["obj"]["num_parts"]
    points, R, t, scale, npcs, labels, boxes = _objects(g, traffic, cfg, G,
                                                        1)
    R, t = R[0], t[0, ..., None]                             # [G, P, ...]
    s = scale[:, None].expand(G, P)
    angle = _normal(g, G, P).abs() * math.radians(traffic["perturb_deg"])
    jitter = rotation_about(_unit(_normal(g, G, P, 3)), angle)
    direction = _unit(_normal(g, G, P, 3))
    init = {"rotation": R @ jitter,
            "translation": t + (direction * _normal(g, G, P, 1)
                                * traffic["perturb_t"])[..., None],
            "scale": s + _normal(g, G, P) * traffic["perturb_s"]}
    return {"points": points[0], "labels": labels.expand(G, -1).contiguous(),
            "nocs": npcs, "rotation": R.contiguous(),
            "translation": t.contiguous(), "scale": s.contiguous(),
            "corners": boxes, **{f"init_{k}": v.contiguous()
                                 for k, v in init.items()}}


def depth_video(traffic: dict, cfg: dict, seed: int, device):
    """Raw depth videos of B moving object plates (see the module)."""
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, "traffic"))
    B, T = traffic["streams"], traffic["frames"]
    H, W = traffic["height"], traffic["width"]
    side, speed = traffic["object_px"], traffic["speed_px"]
    (r_lo, r_hi), (c_lo, c_hi) = traffic["origin_rows"], traffic["origin_cols"]
    if r_hi - 1 + speed * (T - 1) + side > H or \
            c_hi - 1 + speed * (T - 1) + side > W:
        raise ValueError("the object leaves the image within the video")
    oy = torch.randint(r_lo, r_hi, (B,), generator=g, device=device)
    ox = torch.randint(c_lo, c_hi, (B,), generator=g, device=device)
    jit, px = traffic["jitter_mm"], traffic["pixel_noise_mm"]
    plate = traffic["object_mm"] + torch.randint(
        -jit, jit, (T, B), generator=g, device=device)
    shift = torch.randint(0, H * W, (T, B), generator=g, device=device)
    rows = torch.arange(H, device=device)[None, :, None]
    cols = torch.arange(W, device=device)[None, None, :]
    depth = torch.empty((T, B, H, W), dtype=torch.int32, device=device)
    mask = torch.empty((T, B, H, W), dtype=torch.bool, device=device)
    for t in range(T):
        top = (oy + speed * t)[:, None, None]
        left = (ox + speed * t)[:, None, None]
        inside = ((rows >= top) & (rows < top + side) & (cols >= left)
                  & (cols < left + side))
        mask[t] = inside
        noise = torch.randint(-px, px + 1, (B, H, W), generator=g,
                              device=device, dtype=torch.int32)
        depth[t] = torch.where(inside, plate[t][:, None, None],
                               traffic["background_mm"]).int() + noise
    pts, _ = backproject(depth[0], cfg.get("intrinsics", NOCS_REAL_INTRINSICS))
    m = mask[0].reshape(B, -1, 1).float()
    center = (pts * m).sum(1) / m.sum(1)                     # [B, 3]
    P = cfg["obj"]["num_parts"]
    init = {"rotation": torch.eye(3, device=device).expand(B, P, 3, 3)
            .contiguous(),
            "translation": center[:, None, :, None].expand(B, P, 3, 1)
            .contiguous(),
            "scale": torch.full((B, P), float(traffic["init_scale"]),
                                device=device)}
    return {"depth": depth, "mask": mask, "shift": shift}, init


def make(traffic: dict, cfg: dict, seed: int, device):
    """(frames {name: [T, B, ...] on the device}, init pose) for a tracking
    traffic file's parameters."""
    kind = traffic["input"]
    if kind == "points":
        return points_video(traffic, cfg, seed, device)
    if kind == "depth":
        return depth_video(traffic, cfg, seed, device)
    raise ValueError(f"unknown traffic input {kind!r}")
