"""Synthetic trajectories in numpy (counterpart of the host-side generator
in `captra_tpu/data/synthetic.py`, draw for draw the same numbers).

Per-part NPCS clouds on shells (a surface of revolution for symmetric
categories, box faces otherwise), a smooth per-frame 9-DoF pose trajectory
(child parts follow the root with joint motion), and observed camera clouds
= posed NPCS + sensor noise.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from captra_tpu_torch.config.schema import ObjCfg
from captra_tpu_torch.pose.part_dof import tree_root


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
    """Stack B same-shape trajectories into arrays [T, B, ...]."""
    return {name: np.stack([getattr(t, name) for t in trajs], axis=1)
            for name in ("points", "labels", "nocs", "rotation",
                         "translation", "scale")}
