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
    PointMLP, check_network_supported, init_xavier_,
)
from captra_tpu_torch.pose import rotations as rot
from captra_tpu_torch.pose.part_dof import (
    Pose, inverse_apply_pose, merge_delta_pose,
)
from captra_tpu_torch.pose.pose_fit import labels_to_part_mask, part_fit_st

HEAD_DIMS = (512, 512, 256)


class RotationRegressor(nn.Module):
    """Per-part rotation heads: MLP [512, 512, 256] -> 6D (3D if sym),
    GroupNorm (group size 2) on hidden layers."""

    def __init__(self, num_parts: int, sym: bool, in_dim: int):
        super().__init__()
        self.sym = sym
        rot_dim = 3 if sym else 6
        self.heads = nn.ModuleList([
            PointMLP(in_dim, HEAD_DIMS + (rot_dim,), norm="gn",
                     final_acti="none") for _ in range(num_parts)])

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        # feat [B, P, N, C]; head p sees feat[:, p]
        raw = torch.stack([head(feat[:, p])
                           for p, head in enumerate(self.heads)], dim=1)
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
    Device, mode and initialisation as `CoordNet`."""

    def __init__(self, cfg: Config, bn_momentum: float = 0.9, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        check_network_supported(cfg)
        net = cfg.network
        self.num_parts = cfg.obj.num_parts
        self.sym = cfg.obj.sym
        self.encoder = PointNet2Msg(cfg.pointnet, net.backbone_out_dim,
                                    use_xyz_feat=False, norm=net.norm,
                                    bn_momentum=bn_momentum,
                                    fps_mode=net.fps_mode)
        self.regressor = RotationRegressor(self.num_parts, self.sym,
                                           net.backbone_out_dim)
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
                       num_parts: int, sym: bool) -> Pose:
    """Tracking-mode pose update: R_new = R_state @ R_delta, then s/t fitted
    from the predicted NPCS, each part falling back to its previous pose
    when the fit is invalid (<= 3 points, non-finite, or scale <= 1e-4).

    pred_nocs: [B, P, N, 3]; labels: [B, N].  The JAX function's opt-in
    deviations (scale_clamp, rot_fit, delta_gain, fit_ransac) are not
    ported; `make_track_step` refuses configs that ask for them."""
    merged = merge_delta_pose(state, delta_rotation=delta_rotation)
    cam = (points + points_mean[:, None])[:, None].expand(pred_nocs.shape)
    fitted, valid = part_fit_st(labels, pred_nocs, cam, merged.rotation,
                                num_parts=num_parts, sym=sym, min_scale=1e-4)
    vf = valid.float()
    scale = vf * fitted.scale + (1.0 - vf) * state.scale
    v3 = vf[..., None, None]
    translation = v3 * fitted.translation + (1.0 - v3) * state.translation
    return Pose(rotation=merged.rotation, translation=translation,
                scale=scale)
