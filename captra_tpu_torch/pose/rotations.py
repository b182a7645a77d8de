"""Rotation representations and conversions on tensors (counterpart of
`captra_tpu/pose/rotations.py`).

All functions are shape-polymorphic over leading batch dims; zero-norm inputs
fall back instead of producing NaNs.  The JAX module's samplers
(`random_quat`, `jitter_quat`, `noisy_rot_matrix`) draw from `jax.random`
keys and belong to the init-noise path, which this port does not carry yet.
"""
from __future__ import annotations

import math

import torch

from captra_tpu_torch.device import constant

EPS = 1e-8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# basic vector helpers
# ---------------------------------------------------------------------------

def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    """Normalize quaternion(s) [..., 4] (wxyz)."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def normalize_vector(v: torch.Tensor, fallback=(1.0, 0.0, 0.0)
                     ) -> torch.Tensor:
    """Unit-normalize [..., D]; zero-norm rows fall back to `fallback`
    (the reference's degenerate-input rule)."""
    mag = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-24)
    valid = mag > EPS
    backup = constant(tuple(fallback), v.dtype, v.device).expand(v.shape)
    unit = v / torch.clamp(mag, min=EPS)
    return torch.where(valid, unit, backup)


# ---------------------------------------------------------------------------
# quaternions (w, x, y, z)
# ---------------------------------------------------------------------------

def quat_multiply(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    real1, im1 = q[..., :1], q[..., 1:]
    real2, im2 = r[..., :1], r[..., 1:]
    real = real1 * real2 - torch.sum(im1 * im2, dim=-1, keepdim=True)
    im = real1 * im2 + real2 * im1 + _cross(im1, im2)
    return torch.cat([real, im], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    out = quat_multiply(quat_multiply(q, qv), quat_conjugate(q))
    return out[..., 1:]


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    m = torch.stack([
        1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w,
        2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w,
        2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y,
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (trace
    formula with clamping; adequate away from trace == -1)."""
    trace = torch.clamp(1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2],
                        min=0.0)
    r = torch.sqrt(trace)
    s = 1.0 / (2.0 * r + 1e-7)
    w = 0.5 * r
    x = (m[..., 2, 1] - m[..., 1, 2]) * s
    y = (m[..., 0, 2] - m[..., 2, 0]) * s
    z = (m[..., 1, 0] - m[..., 0, 1]) * s
    return normalize_quat(torch.stack([w, x, y, z], dim=-1))


def axis_theta_to_quat(axis: torch.Tensor, theta: torch.Tensor
                       ) -> torch.Tensor:
    w = torch.cos(theta / 2.0)
    xyz = axis * torch.sin(theta / 2.0)[..., None]
    return normalize_quat(torch.cat([w[..., None], xyz], dim=-1))


def quat_to_axis_theta(q: torch.Tensor):
    q = normalize_quat(q)
    cosa = q[..., 0]
    sina = torch.sqrt(torch.clamp(1.0 - cosa ** 2, min=0.0))
    axis = q[..., 1:] / torch.clamp(sina[..., None], min=EPS)
    theta = 2.0 * torch.arccos(torch.clamp(cosa, -1.0, 1.0))
    return axis, theta


def axis_theta_to_matrix(axis, theta):
    return quat_to_matrix(axis_theta_to_quat(axis, theta))


def matrix_to_axis_theta(m):
    return quat_to_axis_theta(matrix_to_quat(m))


def matrix_to_rotvec(m: torch.Tensor) -> torch.Tensor:
    """Keeps the reference's (theta % 2pi + 2pi) offset, which only the
    exp_* losses consume as a difference."""
    axis, theta = matrix_to_axis_theta(m)
    theta = torch.remainder(theta, 2 * math.pi) + 2 * math.pi
    return axis * theta[..., None]


def rotvec_to_matrix(rv: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.norm(rv, dim=-1)
    axis = rv / torch.clamp(theta[..., None], min=EPS)
    return axis_theta_to_matrix(axis, theta)


def so3_interpolate(ra: torch.Tensor, rb: torch.Tensor,
                    alpha: float) -> torch.Tensor:
    """Geodesic interpolation from `ra` toward `rb` by fraction `alpha`
    along the short arc: ra @ exp(alpha * log(ra^T rb))."""
    rel = ra.transpose(-1, -2) @ rb
    axis, theta = matrix_to_axis_theta(rel)
    return ra @ axis_theta_to_matrix(axis, alpha * theta)


# ---------------------------------------------------------------------------
# learned-representation decoders
# ---------------------------------------------------------------------------

def ortho6d_to_matrix(poses: torch.Tensor) -> torch.Tensor:
    """Ortho-6D [..., 6] -> R [..., 3, 3] with columns (x, y, z)."""
    x_raw, y_raw = poses[..., 0:3], poses[..., 3:6]
    x = normalize_vector(x_raw)
    z = normalize_vector(_cross(x, y_raw))
    y = _cross(z, x)
    return torch.stack([x, y, z], dim=-1)  # columns


def gram_schmidt_3x3(m: torch.Tensor) -> torch.Tensor:
    """Orthonormalize the columns of [..., 3, 3]."""
    a1, a2, a3 = m[..., :, 0], m[..., :, 1], m[..., :, 2]

    def proj(u, a):
        top = torch.sum(u * a, dim=-1, keepdim=True)
        bottom = torch.clamp(torch.sum(u * u, dim=-1, keepdim=True), min=EPS)
        return (top / bottom) * u

    u1 = a1
    u2 = a2 - proj(u1, a2)
    u3 = a3 - proj(u1, a3) - proj(u2, a3)
    return torch.stack(
        [normalize_vector(u1), normalize_vector(u2), normalize_vector(u3)],
        dim=-1)


def yvec_to_matrix(vec: torch.Tensor) -> torch.Tensor:
    """Unit y-axis vector [..., 3] -> full frame [..., 3, 3] (columns x,y,z);
    the x/z completion is arbitrary, as only y is supervised."""
    y = normalize_vector(vec)
    x_raw = constant((1.0, 0.0, 0.0), y.dtype, y.device).expand(y.shape)
    z = normalize_vector(_cross(x_raw, y))
    x = _cross(y, z)
    return torch.stack([x, y, z], dim=-1)
