"""PointNet++ MSG backbone, channels-last (counterpart of
`captra_tpu/models/backbone.py`)."""
from __future__ import annotations

import torch
from torch import nn

from captra_tpu_torch import ops
from captra_tpu_torch.config.schema import PointNetCfg, SAMsgCfg
from captra_tpu_torch.models.blocks import PointMLP


class SetAbstractionMsg(nn.Module):
    """FPS -> per-radius ball query -> grouped MLP -> max-pool, multi-scale.
    fps_mode "grouped" takes the stratified 8-way FPS approximation."""

    def __init__(self, cfg: SAMsgCfg, in_feat_dim: int, norm: str = "bn",
                 bn_momentum: float = 0.9, fps_mode: str = "exact"):
        super().__init__()
        self.cfg = cfg
        self.fps_mode = fps_mode
        for i, mlp in enumerate(cfg.mlp_list):
            self.add_module(f"scale_{i}", PointMLP(
                in_feat_dim + 3, mlp, norm=norm, final_acti="relu",
                last_norm=True, bn_momentum=bn_momentum))
        self.out_dim = sum(m[-1] for m in cfg.mlp_list)

    def forward(self, xyz, feats):
        fps_idx = ops.farthest_point_sample(xyz, self.cfg.npoint,
                                            mode=self.fps_mode)
        new_xyz = ops.gather_xyz(xyz, fps_idx)  # [B, S, 3]
        outs = []
        for i, (radius, k) in enumerate(zip(self.cfg.radius_list,
                                            self.cfg.nsample_list)):
            g = ops.ball_group(radius, k, xyz, new_xyz, feats)
            g = getattr(self, f"scale_{i}")(g)
            outs.append(torch.amax(g, dim=2))  # [B, S, C]
        return new_xyz, torch.cat(outs, dim=-1)


class SetAbstractionAll(nn.Module):
    """Group-all global stage: xyz FIRST, then features."""

    def __init__(self, mlp: tuple, in_dim: int, norm: str = "bn",
                 bn_momentum: float = 0.9):
        super().__init__()
        self.mlp = PointMLP(in_dim, mlp, norm=norm, final_acti="relu",
                            last_norm=True, bn_momentum=bn_momentum)

    def forward(self, xyz, feats):
        g = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
        g = self.mlp(g)
        new_xyz = torch.zeros_like(xyz[:, :1])
        return new_xyz, torch.amax(g, dim=1, keepdim=True)  # [B, 1, C]


class FeaturePropagation(nn.Module):
    """Inverse-squared-distance 3-NN upsampling + unit MLP; a single coarse
    point (S == 1) broadcasts instead."""

    def __init__(self, mlp: tuple, in_dim: int, norm: str = "bn",
                 bn_momentum: float = 0.9):
        super().__init__()
        self.mlp = PointMLP(in_dim, mlp, norm=norm, final_acti="relu",
                            last_norm=True, bn_momentum=bn_momentum)

    def forward(self, xyz1, xyz2, feats1, feats2):
        if xyz2.shape[1] == 1:
            interp = feats2.expand(feats2.shape[0], xyz1.shape[1],
                                   feats2.shape[-1])
        else:
            sq_dist, idx = ops.three_nn(xyz1, xyz2)
            recip = 1.0 / (sq_dist + 1e-8)
            weight = recip / torch.sum(recip, dim=-1, keepdim=True)
            interp = ops.three_interp_rows(feats2, idx, weight)
        x = interp if feats1 is None else torch.cat([feats1, interp], dim=-1)
        return self.mlp(x)


class PointNet2Msg(nn.Module):
    """3 SA stages + 3 FP stages + final unit layer, out_dim channels.

    Input xyz [B, N, 3] (rows).  use_xyz_feat feeds xyz as the l0 feature
    (CoordNet); otherwise l0 features are empty (RotNet)."""

    def __init__(self, cfg: PointNetCfg, out_dim: int = 128,
                 use_xyz_feat: bool = False, norm: str = "bn",
                 bn_momentum: float = 0.9, fps_mode: str = "exact"):
        super().__init__()
        self.use_xyz_feat = use_xyz_feat
        l0 = 3 if use_xyz_feat else 0
        kw = dict(norm=norm, bn_momentum=bn_momentum)
        self.sa1 = SetAbstractionMsg(cfg.sa1, l0, fps_mode=fps_mode, **kw)
        self.sa2 = SetAbstractionMsg(cfg.sa2, self.sa1.out_dim,
                                     fps_mode=fps_mode, **kw)
        self.sa3 = SetAbstractionAll(cfg.sa3_mlp, 3 + self.sa2.out_dim, **kw)
        self.fp3 = FeaturePropagation(
            cfg.fp3_mlp, self.sa2.out_dim + cfg.sa3_mlp[-1], **kw)
        self.fp2 = FeaturePropagation(
            cfg.fp2_mlp, self.sa1.out_dim + cfg.fp3_mlp[-1], **kw)
        self.fp1 = FeaturePropagation(
            cfg.fp1_mlp, 3 + l0 + cfg.fp2_mlp[-1], **kw)
        self.out = PointMLP(cfg.fp1_mlp[-1], (out_dim,), final_acti="relu",
                            last_norm=True, **kw)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        l0_xyz = xyz
        l0_feats = xyz if self.use_xyz_feat else None
        l1_xyz, l1 = self.sa1(l0_xyz, l0_feats)
        l2_xyz, l2 = self.sa2(l1_xyz, l1)
        l3_xyz, l3 = self.sa3(l2_xyz, l2)
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        # fp1's skip input is [xyz, xyz] for CoordNet, xyz for RotNet
        l0_in = l0_xyz if l0_feats is None else torch.cat(
            [l0_xyz, l0_feats], dim=-1)
        l0 = self.fp1(l0_xyz, l1_xyz, l0_in, l1)
        return self.out(l0)
