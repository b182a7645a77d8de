"""Per-part 9-DoF pose algebra over a `Pose` of tensors (counterpart of
`captra_tpu/pose/part_dof.py`).

A pose is (R in SO(3), t in R^3, s > 0) per part; articulated objects carry
one pose per part plus a kinematic `tree` (parent indices, -1 = root).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from captra_tpu_torch.pose import metrics
from captra_tpu_torch.pose import rotations as rot
from captra_tpu_torch.utils.precision import f32_precision


@dataclass
class Pose:
    """Batch of per-part similarity poses.

    rotation:    [..., 3, 3]
    translation: [..., 3, 1]
    scale:       [...]
    Leading dims are typically [B, P] (batch, parts).
    """
    rotation: torch.Tensor
    translation: torch.Tensor
    scale: torch.Tensor

    @classmethod
    def identity(cls, shape: Sequence[int] = (), dtype=torch.float32,
                 device=None) -> "Pose":
        shape = tuple(shape)
        return cls(
            rotation=torch.eye(3, dtype=dtype, device=device).expand(
                shape + (3, 3)).clone(),
            translation=torch.zeros(shape + (3, 1), dtype=dtype,
                                    device=device),
            scale=torch.ones(shape, dtype=dtype, device=device),
        )

    def __getitem__(self, idx) -> "Pose":
        return Pose(self.rotation[idx], self.translation[idx], self.scale[idx])

    def map(self, fn) -> "Pose":
        return Pose(fn(self.rotation), fn(self.translation), fn(self.scale))

    def to(self, *args, **kwargs) -> "Pose":
        return self.map(lambda x: x.to(*args, **kwargs))


# ---------------------------------------------------------------------------
# kinematic tree helpers
# ---------------------------------------------------------------------------

def tree_root(tree: Sequence[int]) -> int:
    """Root part index of a parent list."""
    roots = [p for p, parent in enumerate(tree) if parent == -1]
    if len(roots) != 1:
        raise ValueError(f"tree {tree} must have exactly one root")
    return roots[0]


# ---------------------------------------------------------------------------
# applying poses
# ---------------------------------------------------------------------------

@f32_precision
def apply_pose(pose: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Pose canonical points into camera space: s * (pts @ R.T) + t.
    pose leading dims [..., P]; pts [..., P, N, 3] (rows)."""
    est = pts @ pose.rotation.transpose(-1, -2)
    est = est * pose.scale[..., None, None]
    return est + pose.translation.transpose(-1, -2)


@f32_precision
def inverse_apply_pose(pose: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Camera -> canonical: R.T (pts - t) / s, row layout."""
    est = pts - pose.translation.transpose(-1, -2)
    est = est @ pose.rotation  # rows (R^T x)^T
    return est / pose.scale[..., None, None]


@f32_precision
def canonicalize_columns(pose: Pose, pts_c3n: torch.Tensor) -> torch.Tensor:
    """Camera -> canonical for column layout [..., 3, N] (the network input
    path)."""
    cam = pts_c3n - pose.translation
    cam = pose.rotation.transpose(-1, -2) @ cam
    return cam / pose.scale[..., None, None]


# ---------------------------------------------------------------------------
# pose composition
# ---------------------------------------------------------------------------

@f32_precision
def merge_delta_pose(base: Pose, delta_rotation: torch.Tensor | None = None,
                     delta_scale: torch.Tensor | None = None,
                     delta_trans: torch.Tensor | None = None) -> Pose:
    """Compose a canonical-frame delta onto a base pose:

        R <- R_base @ R_delta
        s <- s_delta * s_base
        t <- t_base + s_base * R_base @ t_delta
    """
    rotation, translation, scale = base.rotation, base.translation, base.scale
    if delta_rotation is not None:
        rotation = base.rotation @ delta_rotation
    if delta_scale is not None:
        scale = delta_scale * base.scale
    if delta_trans is not None:
        translation = base.translation + base.scale[..., None, None] * (
            base.rotation @ delta_trans)
    return Pose(rotation=rotation, translation=translation, scale=scale)


@f32_precision
def compute_parts_delta_pose(init: Pose, final: Pose, canon: Pose) -> Pose:
    """Supervision target: the canonical-frame delta taking `init` to
    `final` given the canonicalization pose `canon`, all per part [..., P]
    (the (t_0 - t_c) term always included; it vanishes when t_0 == t_c)."""
    s0, sf, sc = init.scale, final.scale, canon.scale
    t0, tf, tc = init.translation, final.translation, canon.translation
    R0, Rf, Rc = init.rotation, final.rotation, canon.rotation

    s_delta = sf / s0
    RcT = Rc.transpose(-1, -2)
    R0T = R0.transpose(-1, -2)
    R_delta = (RcT @ Rf) @ (R0T @ Rc)

    t = tf - tc - s_delta[..., None, None] * ((Rf @ R0T) @ (t0 - tc))
    t_delta = (RcT @ t) / sc[..., None, None]
    return Pose(rotation=R_delta, translation=t_delta, scale=s_delta)


# ---------------------------------------------------------------------------
# evaluation & perturbation
# ---------------------------------------------------------------------------

def eval_part_full(gt: Pose, pred: Pose, yaxis_only: bool = False) -> dict:
    """Per-part pose errors and 5deg5cm / 10deg10cm indicators, each shaped
    like `gt.scale` ([..., P])."""
    rdiff = metrics.rot_diff_degree(gt.rotation, pred.rotation,
                                    yaxis_only=yaxis_only)
    tdiff = metrics.trans_diff(gt.translation, pred.translation)
    sdiff = metrics.scale_diff(gt.scale, pred.scale)
    return {
        "rdiff": rdiff,
        "tdiff": tdiff,
        "sdiff": sdiff,
        "5deg5cm": ((rdiff <= 5.0) & (tdiff <= 0.05)).float(),
        "10deg10cm": ((rdiff <= 10.0) & (tdiff <= 0.10)).float(),
    }


# the raw draws of `add_noise_to_pose` for poses of leading shape S: name ->
# trailing shape; "rot_quat" is standard normal, the others follow `kind`
# (standard normal, or uniform in [0, 1))
NOISE_DRAWS = {"rot_angle": (), "rot_quat": (4,), "scale": (),
               "trans_norm": (), "trans_dir": (3,)}


def draw_pose_noise(shape, kind: str, generator: torch.Generator) -> dict:
    """`add_noise_to_pose`'s draws for poses of leading shape `shape`, from
    `generator` (on its device)."""
    out = {}
    for name, tail in NOISE_DRAWS.items():
        size = tuple(shape) + tail
        if kind == "uniform" and name != "rot_quat":
            out[name] = torch.rand(size, generator=generator,
                                   device=generator.device)
        else:
            out[name] = torch.randn(size, generator=generator,
                                    device=generator.device)
    return out


def add_noise_to_pose(pose: Pose, rot_rad: float, trans_sigma: float,
                      scale_sigma: float, kind: str = "normal",
                      noise: dict | None = None,
                      generator: torch.Generator | None = None) -> Pose:
    """Perturb a pose for init-frame simulation: rotation jittered by
    |N| * rot_rad (U * rot_rad for "uniform") about a random axis, scale by
    N * scale_sigma, translation along a random direction by
    N * trans_sigma (N: standard normal, or 2U - 1 for "uniform").

    The draws are explicit: `noise` (the `NOISE_DRAWS` tensors), else drawn
    from `generator`, else this raises."""
    if noise is None:
        if generator is None:
            raise ValueError("add_noise_to_pose needs its draws (noise=) or "
                             "a torch.Generator")
        noise = draw_pose_noise(pose.scale.shape, kind, generator)

    def rand(x):
        return x * 2.0 - 1.0 if kind == "uniform" else x

    rotation = rot.noisy_rot_matrix(pose.rotation, rot_rad,
                                    noise["rot_angle"], noise["rot_quat"],
                                    kind=kind)
    scale = pose.scale + rand(noise["scale"]) * scale_sigma
    norm = rand(noise["trans_norm"]) * trans_sigma          # [..., P]
    direction = rand(noise["trans_dir"])
    direction = direction / torch.clamp(
        torch.linalg.norm(direction, dim=-1, keepdim=True), min=1e-9)
    translation = pose.translation + (direction * norm[..., None])[..., None]
    return Pose(rotation=rotation, translation=translation, scale=scale)
