"""Synthetic trajectories and training batches (counterpart of
`captra_tpu/data/synthetic.py`; the host-side generator in numpy, draw for
draw the same numbers).

Per-part NPCS clouds on shells (a surface of revolution for symmetric
categories, box faces otherwise), a smooth per-frame 9-DoF pose trajectory
(child parts follow the root with joint motion), and observed camera clouds
= posed NPCS + sensor noise.  `make_frame_batch` cuts single-frame training
batches from them; `geometry_pool` keeps the pose-free geometry on the host
and `device_pose_batch` renders it under fresh random poses on the device,
its draws explicit (`draw_pose_batch` from a `torch.Generator`, or given);
`device_trajectory_batch` renders smooth trajectories of it the same way
(`draw_trajectory_batch`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from captra_tpu_torch.config.schema import ObjCfg
from captra_tpu_torch.device import constant
from captra_tpu_torch.pose.part_dof import Pose, tree_root
from captra_tpu_torch.pose.rotations import (
    axis_theta_to_matrix, quat_to_matrix,
)


@dataclass
class Trajectory:
    """T frames of a tracked object, all numpy.

    points [T, N, 3] camera cloud (not centered); labels [T, N]; nocs
    [T, N, 3]; rotation [T, P, 3, 3], translation [T, P, 3, 1], scale
    [T, P]; corners [P, 2, 3] NPCS part bounds."""
    points: np.ndarray
    labels: np.ndarray
    nocs: np.ndarray
    rotation: np.ndarray
    translation: np.ndarray
    scale: np.ndarray
    corners: np.ndarray


def _part_shell(rng: np.random.RandomState, n: int, size: np.ndarray):
    """Points on the faces of a box of half-extent `size`."""
    face = rng.randint(0, 6, n)
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.zeros((n, 3), np.float32)
    axis, sign = face % 3, (face // 3) * 2 - 1
    rows = np.arange(n)
    first = np.where(axis == 0, 1, 0)
    second = np.where(axis == 2, 1, 2)
    pts[rows, axis] = sign
    pts[rows, first] = uv[:, 0]
    pts[rows, second] = uv[:, 1]
    return pts * size


def _revolution_shell(rng: np.random.RandomState, n: int, size: np.ndarray):
    """Bottle-like surface of revolution about y (radius varies with
    height, so the y axis is observable)."""
    y = rng.uniform(-1, 1, n)
    theta = rng.uniform(0, 2 * np.pi, n)
    r = (0.6 + 0.4 * np.cos(1.5 * y))
    pts = np.stack([r * np.cos(theta) * size[0], y * size[1],
                    r * np.sin(theta) * size[2]], axis=-1)
    return pts.astype(np.float32)


def _random_rotation(rng) -> np.ndarray:
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2*y*y - 2*z*z, 2*x*y - 2*z*w, 2*x*z + 2*y*w],
        [2*x*y + 2*z*w, 1 - 2*x*x - 2*z*z, 2*y*z - 2*x*w],
        [2*x*z - 2*y*w, 2*y*z + 2*x*w, 1 - 2*x*x - 2*y*y],
    ], dtype=np.float32)


def _axis_angle(axis, theta) -> np.ndarray:
    """Rodrigues' formula."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)
    return R.astype(np.float32)


def make_trajectory(seed: int, obj: ObjCfg, num_frames: int = 30,
                    num_points: int = 1024, noise: float = 0.002,
                    scale_range=(0.15, 0.3), motion_rad: float = 0.03,
                    motion_trans: float = 0.01) -> Trajectory:
    """Deterministic synthetic trajectory for a category config."""
    rng = np.random.RandomState(seed)
    P = obj.num_parts
    root = tree_root(obj.tree)

    sizes = rng.uniform(0.08, 0.18, (P, 3)).astype(np.float32)
    offsets = np.zeros((P, 3), np.float32)
    for p in range(P):
        offsets[p, 0] = (p - (P - 1) / 2) * 0.25
    shell = _revolution_shell if obj.sym else _part_shell
    n_per = num_points // P
    npcs_parts, labels_parts = [], []
    for p in range(P):
        npcs_parts.append(shell(rng, n_per, sizes[p]) + offsets[p])
        labels_parts.append(np.full(n_per, p, np.int64))
    rest = num_points - n_per * P
    if rest:
        npcs_parts.append(shell(rng, rest, sizes[0]) + offsets[0])
        labels_parts.append(np.full(rest, 0, np.int64))
    npcs = np.concatenate(npcs_parts).astype(np.float32)  # [N, 3]
    labels = np.concatenate(labels_parts)
    corners = np.stack([offsets - sizes, offsets + sizes], axis=1)

    scale = rng.uniform(*scale_range)
    base_R = _random_rotation(rng)
    base_t = rng.uniform(-0.1, 0.1, 3).astype(np.float32) + np.array(
        [0, 0, 0.8], np.float32)
    Rs = np.zeros((num_frames, P, 3, 3), np.float32)
    ts = np.zeros((num_frames, P, 3, 1), np.float32)
    ss = np.full((num_frames, P), scale, np.float32)
    axis = rng.randn(3).astype(np.float32)
    axis /= np.linalg.norm(axis)
    dtrans = rng.randn(3).astype(np.float32)
    dtrans = dtrans / np.linalg.norm(dtrans) * motion_trans
    joint_state = np.zeros(P, np.float32)
    djoint = rng.uniform(0.2, 1.0, P).astype(np.float32) * 0.03

    R_cur, t_cur = base_R.copy(), base_t.copy()
    for f in range(num_frames):
        R_cur = _axis_angle(axis, motion_rad) @ R_cur
        t_cur = t_cur + dtrans
        for p in range(P):
            if p == root or obj.num_joints == 0:
                Rs[f, p], ts[f, p, :, 0] = R_cur, t_cur
            else:
                jidx = min(p, len(obj.main_axis) - 1) if obj.main_axis else 0
                ax = np.zeros(3, np.float32)
                ax[obj.main_axis[jidx] if obj.main_axis else 1] = 1.0
                theta = joint_state[p] + f * djoint[p]
                if obj.joint_type == "prismatic":
                    R_local = np.eye(3, dtype=np.float32)
                    t_local = ax * theta * 0.3
                else:
                    R_local = _axis_angle(ax, theta)
                    t_local = (np.eye(3) - R_local) @ offsets[p]
                Rs[f, p] = R_cur @ R_local
                ts[f, p, :, 0] = (scale * (R_cur @ t_local) + t_cur)

    posed = np.einsum("tpij,nj->tpni", Rs, npcs) * ss[..., None, None]
    posed = posed + np.swapaxes(ts, -1, -2)
    sel = posed[np.arange(num_frames)[:, None], labels[None, :],
                np.arange(npcs.shape[0])[None, :]]  # [T, N, 3]
    points = sel + rng.randn(*sel.shape).astype(np.float32) * noise
    return Trajectory(
        points=points.astype(np.float32),
        labels=np.broadcast_to(labels, (num_frames, labels.shape[0])).copy(),
        nocs=np.broadcast_to(npcs, (num_frames,) + npcs.shape).copy(),
        rotation=Rs, translation=ts, scale=ss, corners=corners)


def batch_trajectories(trajs: list[Trajectory]) -> dict:
    """Stack B same-shape trajectories into arrays [T, B, ...]: points,
    labels, nocs, rotation, translation, scale; as the JAX function gives
    them, also "pose", a `Pose` [T, B, P] of CPU tensors over the same
    arrays, and "corners" [B, P, 2, 3]."""
    out = {name: np.stack([getattr(t, name) for t in trajs], axis=1)
           for name in ("points", "labels", "nocs", "rotation",
                        "translation", "scale")}
    out["pose"] = Pose(*(torch.from_numpy(out[k])
                         for k in ("rotation", "translation", "scale")))
    out["corners"] = np.stack([t.corners for t in trajs])
    return out


def make_frame_batch(seed: int, obj: ObjCfg, batch: int = 8,
                     num_points: int = 512, num_frames: int = 4) -> dict:
    """Single-frame training batch of CPU tensors: points [B, N, 3],
    labels [B, N], nocs [B, N, 3], pose (a `Pose` [B, P]), corners
    [B, P, 2, 3]; frame `seed % num_frames` of trajectories `seed * 131 +
    b`."""
    trajs = [make_trajectory(seed * 131 + b, obj, num_frames=num_frames,
                             num_points=num_points) for b in range(batch)]
    f = seed % num_frames

    def stack(name):
        return torch.from_numpy(np.stack([getattr(t, name)[f]
                                          for t in trajs]))

    return {"points": stack("points"), "labels": stack("labels"),
            "nocs": stack("nocs"),
            "pose": Pose(stack("rotation"), stack("translation"),
                         stack("scale")),
            "corners": torch.from_numpy(np.stack([t.corners
                                                  for t in trajs]))}


def geometry_pool(seed: int, obj: ObjCfg, count: int,
                  num_points: int) -> dict:
    """Host NPCS geometry for device-side pose resampling, numpy: {npcs
    [G, N, 3], labels [G, N], corners [G, P, 2, 3]} (the pose- and
    noise-free part of `make_trajectory`)."""
    rng = np.random.RandomState(seed)
    P = obj.num_parts
    shell = _revolution_shell if obj.sym else _part_shell
    all_npcs, all_labels, all_corners = [], [], []
    for _ in range(count):
        sizes = rng.uniform(0.08, 0.18, (P, 3)).astype(np.float32)
        offsets = np.zeros((P, 3), np.float32)
        for p in range(P):
            offsets[p, 0] = (p - (P - 1) / 2) * 0.25
        n_per = num_points // P
        npcs_parts, labels_parts = [], []
        for p in range(P):
            npcs_parts.append(shell(rng, n_per, sizes[p]) + offsets[p])
            labels_parts.append(np.full(n_per, p, np.int64))
        rest = num_points - n_per * P
        if rest:
            npcs_parts.append(shell(rng, rest, sizes[0]) + offsets[0])
            labels_parts.append(np.full(rest, 0, np.int64))
        all_npcs.append(np.concatenate(npcs_parts).astype(np.float32))
        all_labels.append(np.concatenate(labels_parts))
        all_corners.append(np.stack([offsets - sizes, offsets + sizes],
                                    axis=1))
    return {"npcs": np.stack(all_npcs), "labels": np.stack(all_labels),
            "corners": np.stack(all_corners)}


def _normal(generator: torch.Generator, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def _unit(generator: torch.Generator, *shape) -> torch.Tensor:
    # uniform [0, 1)
    return torch.rand(shape, generator=generator, device=generator.device)


def draw_pose_batch(B: int, N: int, P: int,
                    generator: torch.Generator) -> dict:
    """`device_pose_batch`'s raw draws for B clouds of N points and P parts
    from `generator`, on its device: standard normal "quat" [B, 4] and
    "noise" [B, N, 3], uniform [0, 1) "trans" [B, 3], "scale" [B] and
    "theta" [B, P]."""
    g = generator
    return {"quat": _normal(g, B, 4), "trans": _unit(g, B, 3),
            "scale": _unit(g, B), "theta": _unit(g, B, P),
            "noise": _normal(g, B, N, 3)}


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # jax.random.uniform's map of [0, 1) floats onto [lo, hi), the span in
    # the draws' dtype
    dt = np.float64 if u.dtype == torch.float64 else np.float32
    span = float(dt(hi) - dt(lo))
    return torch.clamp_min(u * span + lo, lo)


def device_pose_batch(npcs: torch.Tensor, labels: torch.Tensor,
                      corners: torch.Tensor, obj: ObjCfg,
                      draws: dict | None = None,
                      generator: torch.Generator | None = None,
                      scale_range=(0.15, 0.3), noise: float = 0.002) -> dict:
    """Re-render pooled NPCS geometry under fresh random poses on its
    device: npcs [B, N, 3], labels [B, N], corners [B, P, 2, 3] -> a
    training batch {points, labels, nocs, pose, corners}.  The root pose is
    uniform-random (a normalised Gaussian quaternion, translation in
    [-0.1, 0.1)^3 + (0, 0, 0.8), one scale in `scale_range`); child parts
    turn about `main_axis` anchored at their NPCS centre (or slide along
    it) by a joint state in [0, 0.6), as `make_trajectory` moves them.

    The draws are `draws` (`draw_pose_batch`'s raw normals and [0, 1)
    uniforms), else drawn from `generator`, else this raises."""
    B, N, _ = npcs.shape
    P = obj.num_parts
    if draws is None:
        if generator is None:
            raise ValueError("device_pose_batch needs its draws (draws=) or "
                             "a torch.Generator")
        draws = draw_pose_batch(B, N, P, generator)
    q = draws["quat"]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    R_root = quat_to_matrix(q)                                  # [B, 3, 3]
    t_root = _uniform(draws["trans"], -0.1, 0.1) + constant(
        (0.0, 0.0, 0.8), npcs.dtype, npcs.device)
    s = _uniform(draws["scale"], *scale_range)
    theta = _uniform(draws["theta"], 0.0, 0.6)

    offsets = torch.mean(corners, dim=2)                        # [B, P, 3]
    R, t = _compose_parts(R_root, t_root, s, theta, offsets, obj)

    posed = torch.einsum("bpij,bnj->bpni", R, npcs) * s[:, None, None, None] \
        + t[:, :, None]                                         # [B,P,N,3]
    own = torch.gather(posed, 1, labels.long()[:, None, :, None].expand(
        B, 1, N, 3))[:, 0]
    points = own + noise * draws["noise"]
    pose = Pose(rotation=R, translation=t[..., None],
                scale=s[:, None].expand(B, P))
    return {"points": points, "labels": labels, "nocs": npcs, "pose": pose,
            "corners": corners}


def draw_trajectory_batch(B: int, N: int, P: int, num_frames: int,
                          generator: torch.Generator) -> dict:
    """`device_trajectory_batch`'s raw draws for B trajectories of
    `num_frames` frames, N points and P parts from `generator`, on its
    device: standard normal "quat" [B, 4], "axis" [B, 3], "dtrans" [B, 3]
    and "noise" [T, B, N, 3], uniform [0, 1) "trans" [B, 3], "scale" [B],
    "theta0" [B, P] and "djoint" [B, P]."""
    g = generator
    return {"quat": _normal(g, B, 4), "trans": _unit(g, B, 3),
            "scale": _unit(g, B), "theta0": _unit(g, B, P),
            "djoint": _unit(g, B, P), "axis": _normal(g, B, 3),
            "dtrans": _normal(g, B, 3),
            "noise": _normal(g, num_frames, B, N, 3)}


def device_trajectory_batch(npcs: torch.Tensor, labels: torch.Tensor,
                            corners: torch.Tensor, obj: ObjCfg,
                            num_frames: int, draws: dict | None = None,
                            generator: torch.Generator | None = None,
                            scale_range=(0.15, 0.3), noise: float = 0.002,
                            motion_rad: float = 0.03,
                            motion_trans: float = 0.01) -> dict:
    """Smooth [T, B] trajectories of pooled geometry rendered on its
    device, the trajectory analogue of `device_pose_batch` (on-policy
    rollout fine-tuning, `training/rollout.py`).  The base pose has
    `device_pose_batch`'s distribution; the root then turns by
    `motion_rad` a frame about a random axis (the drift composed on the
    left) and moves `motion_trans` a frame along a random direction, and
    each child joint advances at a constant random rate, as
    `make_trajectory` moves them.

    npcs [B, N, 3], labels [B, N], corners [B, P, 2, 3] -> {points
    [T, B, N, 3], labels [T, B, N], nocs [T, B, N, 3], pose `Pose`
    [T, B, P], corners [B, P, 2, 3]}.  The draws are `draws`
    (`draw_trajectory_batch`'s), else drawn from `generator`, else this
    raises."""
    B, N, _ = npcs.shape
    P = obj.num_parts
    T = num_frames
    if draws is None:
        if generator is None:
            raise ValueError("device_trajectory_batch needs its draws "
                             "(draws=) or a torch.Generator")
        draws = draw_trajectory_batch(B, N, P, T, generator)
    dtype, dev = npcs.dtype, npcs.device
    q = draws["quat"]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    R0 = quat_to_matrix(q)                                      # [B, 3, 3]
    t0 = _uniform(draws["trans"], -0.1, 0.1) + constant(
        (0.0, 0.0, 0.8), dtype, dev)
    s = _uniform(draws["scale"], *scale_range)
    theta0 = _uniform(draws["theta0"], 0.0, 0.6)
    djoint = _uniform(draws["djoint"], 0.2, 1.0) * 0.03
    axis = draws["axis"]
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    dtrans = draws["dtrans"]
    dtrans = dtrans / torch.linalg.norm(dtrans, dim=-1,
                                        keepdim=True) * motion_trans

    f = torch.arange(1, T + 1, dtype=torch.float32, device=dev)  # [T]
    # the drift of every (frame, trajectory): Rodrigues(axis_b, rad * f)
    drift = axis_theta_to_matrix(
        axis[None].expand(T, B, 3).reshape(T * B, 3),
        (motion_rad * f)[:, None].expand(T, B).reshape(T * B))
    R_root = torch.einsum("mij,mjk->mik", drift,
                          R0[None].expand(T, B, 3, 3).reshape(T * B, 3, 3))
    t_root = (t0[None] + f[:, None, None] * dtrans[None]).reshape(T * B, 3)
    theta = (theta0[None] + (f - 1.0)[:, None, None] * djoint[None]) \
        .reshape(T * B, P)
    s_flat = s[None].expand(T, B).reshape(T * B)

    offsets = torch.mean(corners, dim=2)                        # [B, P, 3]
    off_flat = offsets[None].expand(T, B, P, 3).reshape(T * B, P, 3)
    R, t = _compose_parts(R_root, t_root, s_flat, theta, off_flat, obj)

    npcs_flat = npcs[None].expand(T, B, N, 3).reshape(T * B, N, 3)
    labels_flat = labels.long()[None].expand(T, B, N).reshape(T * B, N)
    posed = torch.einsum("bpij,bnj->bpni", R, npcs_flat) \
        * s_flat[:, None, None, None] + t[:, :, None]           # [TB,P,N,3]
    own = torch.gather(posed, 1, labels_flat[:, None, :, None].expand(
        T * B, 1, N, 3))[:, 0]
    points = own + noise * draws["noise"].reshape(T * B, N, 3)

    pose = Pose(rotation=R.reshape(T, B, P, 3, 3),
                translation=t.reshape(T, B, P, 3)[..., None],
                scale=s[None, :, None].expand(T, B, P))
    return {"points": points.reshape(T, B, N, 3),
            "labels": labels[None].expand(T, B, N),
            "nocs": npcs[None].expand(T, B, N, 3),
            "pose": pose, "corners": corners}


def _compose_parts(R_root, t_root, s, theta, offsets, obj: ObjCfg):
    """Per-part poses from a root pose and per-part joint states: R_root
    [M, 3, 3], t_root [M, 3], s [M], theta [M, P], offsets [M, P, 3] ->
    (R [M, P, 3, 3], t [M, P, 3])."""
    M = R_root.shape[0]
    root = tree_root(obj.tree)
    eye = torch.eye(3, dtype=R_root.dtype, device=R_root.device)
    Rs, ts = [], []
    for p in range(obj.num_parts):
        if p == root or obj.num_joints == 0:
            Rs.append(R_root)
            ts.append(t_root)
            continue
        jidx = min(p, len(obj.main_axis) - 1) if obj.main_axis else 0
        ax = [0.0, 0.0, 0.0]
        ax[obj.main_axis[jidx] if obj.main_axis else 1] = 1.0
        ax = constant(tuple(ax), R_root.dtype, R_root.device)
        if obj.joint_type == "prismatic":
            R_local = eye.expand(M, 3, 3)
            t_local = ax * theta[:, p:p + 1] * 0.3                 # [M, 3]
        else:
            R_local = axis_theta_to_matrix(ax.expand(M, 3), theta[:, p])
            t_local = torch.einsum("bij,bj->bi", eye - R_local,
                                   offsets[:, p])
        Rs.append(torch.einsum("bij,bjk->bik", R_root, R_local))
        ts.append(s[:, None] * torch.einsum("bij,bj->bi", R_root, t_local)
                  + t_root)
    return torch.stack(Rs, dim=1), torch.stack(ts, dim=1)
