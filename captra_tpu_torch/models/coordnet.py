"""CoordinateNet: part segmentation + NPCS regression + analytic s/t solve
(counterpart of `captra_tpu/models/coordnet.py`)."""
from __future__ import annotations

import torch
from torch import nn

from captra_tpu_torch.config.schema import Config
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.models.backbone import PointNet2Msg
from captra_tpu_torch.models.blocks import (
    PointMLP, check_network_supported, init_xavier_,
)
from captra_tpu_torch.pose import procrustes
from captra_tpu_torch.pose.part_dof import Pose, canonicalize_columns
from captra_tpu_torch.pose.pose_fit import labels_to_part_mask
from captra_tpu_torch.utils.precision import f32_precision

# the x and z columns of [..., 3], as a slice: indexing with a list would
# copy the index to the device and synchronise the host on every call
_XZ = slice(0, 3, 2)


class CoordNet(nn.Module):
    """Backbone(use_xyz_feat) -> softmax seg [B, N, P+extra] and sigmoid-0.5
    NPCS [B, N, 3P].

    Built on `device` (CUDA unless given; raises without a card), in eval
    mode, with flax's xavier initialisation drawn from `generator` (a CPU
    generator; None uses torch's global one)."""

    def __init__(self, cfg: Config, bn_momentum: float = 0.9, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        check_network_supported(cfg)
        net = cfg.network
        self.backbone = PointNet2Msg(cfg.pointnet, net.backbone_out_dim,
                                     use_xyz_feat=True, norm=net.norm,
                                     bn_momentum=bn_momentum,
                                     fps_mode=net.fps_mode)
        self.seg_head = PointMLP(net.backbone_out_dim, (cfg.obj.num_seg,),
                                 norm="none", final_acti="none")
        self.nocs_head = PointMLP(
            net.backbone_out_dim,
            tuple(net.nocs_head_dims) + (3 * cfg.obj.num_parts,),
            norm=net.norm, final_acti="none", bn_momentum=bn_momentum)
        init_xavier_(self, generator)
        self.to(device).eval()

    def forward(self, canon_points: torch.Tensor) -> dict:
        """canon_points: [B, N, 3] already canonicalized camera points."""
        feat = self.backbone(canon_points)
        seg = torch.softmax(self.seg_head(feat), dim=-1)
        nocs = torch.sigmoid(self.nocs_head(feat)) - 0.5
        return {"seg": seg, "nocs": nocs}


def canonicalize(points: torch.Tensor, points_mean: torch.Tensor,
                 canon_pose: Pose) -> torch.Tensor:
    """(centered points [B, N, 3] + mean [B, 3]) -> canonical frame of
    `canon_pose` ([B] batch dims)."""
    cam = points.transpose(-1, -2) + points_mean[..., None]  # [B, 3, N]
    return canonicalize_columns(canon_pose, cam).transpose(-1, -2)


@f32_precision
def solve_st(seg: torch.Tensor, nocs: torch.Tensor, points: torch.Tensor,
             points_mean: torch.Tensor, labels: torch.Tensor,
             gt_rotation: torch.Tensor, init_pose: Pose, num_parts: int,
             sym: bool, given_scale: torch.Tensor | None = None) -> Pose:
    """Masked s/t solve given the (GT or tracked) rotation.

    seg [B, N, S]; nocs [B, N, 3P]; points/points_mean: centered camera
    points [B, N, 3] + mean [B, 3]; labels [B, N]; gt_rotation
    [B, P, 3, 3]; init_pose: fallback for empty/NaN parts; given_scale (the
    training path's GT scale) scales the NPCS before the translation fit."""
    B, N, _ = points.shape
    pred_npcs = nocs.reshape(B, N, num_parts, 3).movedim(2, 1)  # [B,P,N,3]
    cam = (points + points_mean[:, None])[:, None]              # [B,1,N,3]

    mask = labels_to_part_mask(labels, num_parts)               # [B, P, N]
    valid = (torch.sum(mask, dim=-1) > 0).float()

    rotation = gt_rotation
    if sym:
        # 2D y-axis refinement in the canonical frame
        canon_cam = torch.einsum("bpji,bqnj->bpni", rotation, cam)  # R^T x
        _, s2c = procrustes.masked_center(pred_npcs[..., _XZ], mask)
        _, t2c = procrustes.masked_center(canon_cam[..., _XZ], mask)
        rot3d = procrustes.rot_around_yaxis_to_3d(
            procrustes.rot2d_fit(s2c, t2c))
        rotated_npcs = torch.einsum("bpij,bpjk,bpnk->bpni", rotation, rot3d,
                                    pred_npcs)
    else:
        rotated_npcs = torch.einsum("bpij,bpnj->bpni", rotation, pred_npcs)

    _, rn_c = procrustes.masked_center(rotated_npcs, mask, detach_center=True)
    _, cam_c = procrustes.masked_center(cam.expand(rotated_npcs.shape), mask,
                                        detach_center=True)
    scale = procrustes.scale_fit(rn_c, cam_c, mask)      # [B, P]
    scale = valid * scale + (1.0 - valid) * init_pose.scale
    scale = torch.where(torch.isfinite(scale), scale, init_pose.scale)

    st_scale = given_scale if given_scale is not None else scale
    scaled_npcs = st_scale[..., None, None] * rotated_npcs
    translation = procrustes.translation_fit(scaled_npcs, cam, mask)
    v3 = valid[..., None, None]
    translation = v3 * translation + (1.0 - v3) * init_pose.translation
    okt = torch.isfinite(torch.sum(translation, dim=(-1, -2), keepdim=True))
    translation = torch.where(okt, translation, init_pose.translation)
    return Pose(rotation=rotation, translation=translation, scale=scale)
