"""RotationNet: per-part rotation-delta regression + pose composition
(counterpart of `captra_tpu/models/rotnet.py`).

The encoder runs on the flattened [B*P] batch; each part has its own head,
applied to its own part's features only (the JAX package vmaps one head
over the part axis with stacked [P, ...] parameters; here the heads are a
ModuleList `regressor.heads.{p}` and the converter unstacks)."""
from __future__ import annotations

import torch
from torch import nn

from captra_tpu_torch.config.schema import Config
from captra_tpu_torch.device import constant, resolve_device
from captra_tpu_torch.models.backbone import PointNet2Msg
from captra_tpu_torch.models.blocks import (
    PointMLP, at_least_f32, compute_dtype, init_xavier_,
)
from captra_tpu_torch.pose import rotations as rot
from captra_tpu_torch.pose.part_dof import (
    Pose, inverse_apply_pose, merge_delta_pose,
)
from captra_tpu_torch.pose.pose_fit import labels_to_part_mask, part_fit_st
from captra_tpu_torch.pose.procrustes import (
    similarity_fit, similarity_fit_ransac,
)

HEAD_DIMS = (512, 512, 256)


class RotationRegressor(nn.Module):
    """Per-part rotation heads: MLP [512, 512, 256] -> 6D (3D if sym),
    GroupNorm (group size 2) on hidden layers, computing in `dtype`; the
    decode runs in float32."""

    def __init__(self, num_parts: int, sym: bool, in_dim: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.sym = sym
        rot_dim = 3 if sym else 6
        self.heads = nn.ModuleList([
            PointMLP(in_dim, HEAD_DIMS + (rot_dim,), norm="gn",
                     final_acti="none", dtype=dtype)
            for _ in range(num_parts)])

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        # feat [B, P, N, C]; head p sees feat[:, p]
        raw = at_least_f32(torch.stack([head(feat[:, p])
                                        for p, head in enumerate(self.heads)],
                                       dim=1))
        if self.sym:
            return rot.normalize_vector(raw)  # unit y-vec per point
        R = rot.ortho6d_to_matrix(raw)        # [B, P, N, 3, 3]
        return R.reshape(R.shape[:-2] + (9,))


class RotNet(nn.Module):
    """Encoder over per-part canonicalized clouds + per-part heads + masked
    mean.

    Input: per-part canonical points [B, P, N, 3] and labels [B, N].
    Output dict:
      rtvec:       [B, P, 9|3]  masked-mean rotation rep (defaults for empty)
      point_rtvec: [B, P, N, 9|3] per-point reps
    Compute dtype, device, mode and initialisation as `CoordNet`."""

    def __init__(self, cfg: Config, bn_momentum: float = 0.9, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        dtype = compute_dtype(cfg)
        net = cfg.network
        self.num_parts = cfg.obj.num_parts
        self.sym = cfg.obj.sym
        self.encoder = PointNet2Msg(cfg.pointnet, net.backbone_out_dim,
                                    use_xyz_feat=False, norm=net.norm,
                                    bn_momentum=bn_momentum,
                                    fps_mode=net.fps_mode, dtype=dtype)
        self.regressor = RotationRegressor(self.num_parts, self.sym,
                                           net.backbone_out_dim, dtype=dtype)
        init_xavier_(self, generator)
        self.to(device).eval()

    def forward(self, canon_parts: torch.Tensor, labels: torch.Tensor):
        B, P, N, _ = canon_parts.shape
        feat = self.encoder(canon_parts.reshape(B * P, N, 3))
        point_rtvec = self.regressor(feat.reshape(B, P, N, -1))

        mask = labels_to_part_mask(labels, self.num_parts)  # [B, P, N]
        count = torch.sum(mask, dim=-1, keepdim=True)
        mean = torch.sum(point_rtvec * mask[..., None], dim=-2) / torch.clamp(
            count, min=1.0)
        default = constant((0.0, 1.0, 0.0) if self.sym
                           else (1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0),
                           mean.dtype, mean.device)
        mean = torch.where(count > 0, mean, default)
        return {"rtvec": mean, "point_rtvec": point_rtvec}


def canonicalize_per_part(points: torch.Tensor, points_mean: torch.Tensor,
                          state: Pose) -> torch.Tensor:
    """Centered camera points [B, N, 3] + mean [B, 3] -> per-part canonical
    clouds [B, P, N, 3] under the per-part poses `state` [B, P]."""
    cam = points + points_mean[:, None]  # [B, N, 3]
    return inverse_apply_pose(state, cam[:, None])


def decode_rotation(out: dict, sym: bool):
    """Network output -> (delta R [B, P, 3, 3], per-point R
    [B, P, N, 3, 3])."""
    if sym:
        return (rot.yvec_to_matrix(out["rtvec"]),
                rot.yvec_to_matrix(out["point_rtvec"]))
    rt, pr = out["rtvec"], out["point_rtvec"]
    return (rot.gram_schmidt_3x3(rt.reshape(rt.shape[:-1] + (3, 3))),
            rot.gram_schmidt_3x3(pr.reshape(pr.shape[:-1] + (3, 3))))


def compose_track_pose(state: Pose, delta_rotation: torch.Tensor,
                       labels: torch.Tensor, pred_nocs: torch.Tensor,
                       points: torch.Tensor, points_mean: torch.Tensor,
                       num_parts: int, sym: bool,
                       scale_clamp: float = 0.0,
                       rot_fit: str = "delta",
                       rot_fit_alpha: float = 0.5,
                       delta_gain: float = 1.0,
                       fit_ransac: int = 0,
                       fit_ransac_th: float = 0.01,
                       gumbel_rot: torch.Tensor | None = None,
                       gumbel_fit: torch.Tensor | None = None) -> Pose:
    """Tracking-mode pose update: R_new = R_state @ R_delta, then s/t fitted
    from the predicted NPCS, each part falling back to its previous pose
    when the fit is invalid (<= 3 points, non-finite, or scale <= 1e-4).

    pred_nocs: [B, P, N, 3]; labels: [B, N].  The JAX function's opt-in
    deviations (rotnet.py:140-233), each off by default:

      delta_gain != 1  scales the delta's rotation angle about its axis;
      rot_fit "npcs"   takes the rotation from an absolute masked solve of
                       the NPCS against the camera points; "fused" moves
                       the composed rotation toward it by rot_fit_alpha
                       (sym: the y axis only, no move where the axes are
                       (anti)parallel; else along the geodesic); a part
                       with <= 3 points or a non-finite solve keeps the
                       composed rotation;
      fit_ransac > 0   solves both fits with that many RANSAC hypotheses
                       (inliers within fit_ransac_th);
      scale_clamp > 0  bounds the fitted scale to [s / (1+c), s (1+c)] of
                       the previous scale s.

    The RANSAC draws are explicit: gumbel_rot (the absolute solve's, used
    when rot_fit != "delta") and gumbel_fit (the s/t fit's), each
    [B, P, fit_ransac, N]; a fit that needs missing draws raises."""
    if delta_gain != 1.0:
        # exp(g * log(delta)); at theta ~ 0 the axis is arbitrary but
        # g * theta ~ 0 too
        axis, theta = rot.matrix_to_axis_theta(delta_rotation)
        delta_rotation = rot.axis_theta_to_matrix(axis, delta_gain * theta)
    merged = merge_delta_pose(state, delta_rotation=delta_rotation)
    cam = (points + points_mean[:, None])[:, None].expand(pred_nocs.shape)
    if rot_fit != "delta":
        mask = labels_to_part_mask(labels, num_parts)       # [B, P, N]
        if fit_ransac > 0:
            r_abs = similarity_fit_ransac(
                pred_nocs, cam, mask, num_hyps=fit_ransac,
                inlier_th=fit_ransac_th, sym=sym, gumbel=gumbel_rot)[0]
        else:
            r_abs = similarity_fit(pred_nocs, cam, mask, sym=sym)[0]
        if rot_fit == "fused" and sym:
            # blend the y-axis direction only: the minimal rotation taking
            # the carried y axis toward the solved one, scaled by alpha;
            # the carried spin stays
            y_c = merged.rotation[..., :, 1]
            y_a = r_abs[..., :, 1]
            axis = rot.cross(y_c, y_a)
            norm = torch.linalg.norm(axis, dim=-1)
            theta = torch.atan2(norm, torch.sum(y_c * y_a, dim=-1))
            # (anti)parallel axes: no update (the axis is ambiguous)
            theta = torch.where(norm < 1e-6, 0.0, theta)
            r_abs = rot.axis_theta_to_matrix(
                rot.normalize_vector(axis),
                rot_fit_alpha * theta) @ merged.rotation
        elif rot_fit == "fused":
            r_abs = rot.so3_interpolate(merged.rotation, r_abs,
                                        rot_fit_alpha)
        ok = (torch.sum(mask, dim=-1) > 3) & torch.isfinite(r_abs).all(
            dim=-1).all(dim=-1)                             # [B, P]
        merged = Pose(
            rotation=torch.where(ok[..., None, None], r_abs,
                                 merged.rotation),
            translation=merged.translation, scale=merged.scale)
    fitted, valid = part_fit_st(labels, pred_nocs, cam, merged.rotation,
                                num_parts=num_parts, sym=sym, min_scale=1e-4,
                                ransac_hyps=fit_ransac,
                                ransac_th=fit_ransac_th, gumbel=gumbel_fit)
    vf = valid.float()
    fitted_scale = fitted.scale
    if scale_clamp > 0.0:
        fitted_scale = torch.clamp(fitted_scale,
                                   min=state.scale / (1.0 + scale_clamp),
                                   max=state.scale * (1.0 + scale_clamp))
    scale = vf * fitted_scale + (1.0 - vf) * state.scale
    v3 = vf[..., None, None]
    translation = v3 * fitted.translation + (1.0 - v3) * state.translation
    return Pose(rotation=merged.rotation, translation=translation,
                scale=scale)
