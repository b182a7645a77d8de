"""PointNet++ MSG backbone, channels-last (counterpart of
`captra_tpu/models/backbone.py`).

`dtype` (None: float32) is every PointMLP's compute dtype.  xyz stays
float32 throughout, so FPS, ball query and 3-NN see the float32 geometry
and pick the same indices in every dtype.  Where float32 xyz or 3-NN
weights meet features of the compute dtype (`torch.cat`, the
interpolation's product), the result is float32, as `jnp` promotes; the
next PointMLP casts it back.

A stage's neighbour search (every radius of a set-abstraction stage, a
propagation stage's 3-NN) takes `ops.neighbors`: one distance product a
stage, then one hand-written selection kernel for float32 CUDA clouds
that take no gradient (in training too), its plain twin for any other
input; each runs inside a `backbone.neighbors` span.  A set-abstraction
scale in eval mode with BatchNorm, float32 and no gradient wanted takes
`ops.sa_mlp.sa_scale` (on CUDA one hand-written kernel: gather, MLP and
max-pool with no grouped activation in device memory, its first layer
factored per point where the shapes say so; on the CPU its plain twin,
today's arithmetic); any other scale runs the module chain
(`SetAbstractionMsg.fused`).  Both kernels route by the one rule of
`ops.cuda_build.takes_kernel`.  The tracer's denominators are counted
here, `nbr_stages` once a stage and `sa_scales` once a scale; the kernels'
`nbr_fused` and `sa_fused` are counted at their launches."""
from __future__ import annotations

import torch
from torch import nn

from captra_tpu_torch import ops
from captra_tpu_torch.config.schema import PointNetCfg, SAMsgCfg
from captra_tpu_torch.models.blocks import BatchNorm, PointMLP
from captra_tpu_torch.ops import cuda_build, neighbors, sa_mlp
from captra_tpu_torch.utils import profiling


class SetAbstractionMsg(nn.Module):
    """FPS -> every radius's ball query from one distance product ->
    grouped MLP a radius -> max-pool, multi-scale.  fps_mode "grouped"
    takes the stratified 8-way FPS approximation."""

    def __init__(self, cfg: SAMsgCfg, in_feat_dim: int, norm: str = "bn",
                 bn_momentum: float = 0.9, fps_mode: str = "exact",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.fps_mode = fps_mode
        for i, mlp in enumerate(cfg.mlp_list):
            self.add_module(f"scale_{i}", PointMLP(
                in_feat_dim + 3, mlp, norm=norm, final_acti="relu",
                last_norm=True, bn_momentum=bn_momentum, dtype=dtype))
        self.out_dim = sum(m[-1] for m in cfg.mlp_list)

    def fused(self, xyz, feats) -> bool:
        """Whether `forward` takes the fused scales (`sa_mlp.sa_scale`), by
        what the module sees: no gradient wanted, float32 inputs on the CPU
        or CUDA, and every scale's MLP in eval mode with BatchNorm and a
        float32 compute dtype.  Anything else (training, GroupNorm,
        bfloat16 or float16, autograd) keeps the module chain.  A shape the
        kernel cannot hold raises there (`sa_mlp.sa_mlp_cuda`)."""
        if torch.is_grad_enabled() or xyz.device.type not in ("cpu", "cuda"):
            return False
        if xyz.dtype != torch.float32 or (
                feats is not None and feats.dtype != torch.float32):
            return False
        for i in range(len(self.cfg.nsample_list)):
            mlp = getattr(self, f"scale_{i}")
            bn = all(isinstance(getattr(mlp, f"norm_{j}", None), BatchNorm)
                     for j in range(mlp.num_layers))
            if mlp.training or mlp.dtype not in (None, torch.float32) \
                    or not bn:
                return False
        return True

    def forward(self, xyz, feats):
        # FPS picks indices and takes no gradient
        fps_idx = ops.farthest_point_sample(xyz.detach(), self.cfg.npoint,
                                            mode=self.fps_mode)
        new_xyz = ops.gather_xyz(xyz, fps_idx)  # [B, S, 3]
        # the ball query takes xyz in its own layout: the layout steers the
        # distance product's rounding, hence the ball's edge
        with profiling.annotate("backbone.neighbors"):
            profiling.count("nbr_stages")
            idxs = neighbors.ball_query_stage(
                self.cfg.radius_list, self.cfg.nsample_list, xyz, new_xyz)
        profiling.count("sa_scales", len(idxs))
        if self.fused(xyz, feats):
            return new_xyz, self._fused_scales(xyz, new_xyz, feats, idxs)
        outs = []
        for i, idx in enumerate(idxs):
            g = ops.group_ball(idx, xyz, new_xyz, feats)
            g = getattr(self, f"scale_{i}")(g)
            outs.append(torch.amax(g, dim=2))  # [B, S, C]
        return new_xyz, torch.cat(outs, dim=-1)

    def _fused_scales(self, xyz, new_xyz, feats, idxs):
        """Every scale through `sa_mlp.sa_scale`, each writing its columns
        of one [B, S, out_dim] tensor (no concatenation).  On the kernel's
        route, the scales that `sa_mlp.factored` picks by shape take their
        first layer from one `sa_mlp.sa_table_cuda` of the stage, each its
        own columns."""
        rows = xyz.contiguous()
        feats = None if feats is None else feats.contiguous()
        (B, N), S = rows.shape[:2], new_xyz.shape[1]
        cf = 0 if feats is None else feats.shape[-1]
        layers = [scale_layers(getattr(self, f"scale_{i}"))
                  for i in range(len(idxs))]
        on_card = cuda_build.takes_kernel(rows, new_xyz, feats)
        picked = [on_card and sa_mlp.factored(N, S, idx.shape[-1], cf)
                  for idx in idxs]
        table = sa_mlp.sa_table_cuda(feats, [ls[0].weight for ls, p in
                                             zip(layers, picked) if p]) \
            if any(picked) else None
        out = xyz.new_empty((B, S, self.out_dim))
        offset = col = 0
        for idx, ls, p in zip(idxs, layers, picked):
            sa_mlp.sa_scale(rows, new_xyz, feats, idx, ls, out, offset,
                            table if p else None, col)
            offset += ls[-1].weight.shape[0]
            col += ls[0].weight.shape[0] if p else 0
        return out


def scale_layers(mlp: PointMLP) -> list:
    """A BatchNorm `PointMLP`'s layers as `sa_mlp.Layer`s: each Linear's
    weight and bias with its BatchNorm's weight, bias, running statistics
    and eps (the tensors themselves, not copies)."""
    layers = []
    for j in range(mlp.num_layers):
        dense, norm = getattr(mlp, f"dense_{j}"), getattr(mlp, f"norm_{j}")
        layers.append(sa_mlp.Layer(dense.weight, dense.bias, norm.weight,
                                   norm.bias, norm.running_mean,
                                   norm.running_var, norm.eps))
    return layers


class SetAbstractionAll(nn.Module):
    """Group-all global stage: xyz FIRST, then features."""

    def __init__(self, mlp: tuple, in_dim: int, norm: str = "bn",
                 bn_momentum: float = 0.9, dtype: torch.dtype | None = None):
        super().__init__()
        self.mlp = PointMLP(in_dim, mlp, norm=norm, final_acti="relu",
                            last_norm=True, bn_momentum=bn_momentum,
                            dtype=dtype)

    def forward(self, xyz, feats):
        g = xyz if feats is None else torch.cat([xyz, feats], dim=-1)
        g = self.mlp(g)
        new_xyz = torch.zeros_like(xyz[:, :1])
        return new_xyz, torch.amax(g, dim=1, keepdim=True)  # [B, 1, C]


class FeaturePropagation(nn.Module):
    """Inverse-squared-distance 3-NN upsampling (`neighbors.three_nn_stage`)
    + unit MLP; a single coarse point (S == 1) broadcasts instead."""

    def __init__(self, mlp: tuple, in_dim: int, norm: str = "bn",
                 bn_momentum: float = 0.9, dtype: torch.dtype | None = None):
        super().__init__()
        self.mlp = PointMLP(in_dim, mlp, norm=norm, final_acti="relu",
                            last_norm=True, bn_momentum=bn_momentum,
                            dtype=dtype)

    def forward(self, xyz1, xyz2, feats1, feats2):
        if xyz2.shape[1] == 1:
            interp = feats2.expand(feats2.shape[0], xyz1.shape[1],
                                   feats2.shape[-1])
        else:
            with profiling.annotate("backbone.neighbors"):
                profiling.count("nbr_stages")
                sq_dist, idx = neighbors.three_nn_stage(xyz1, xyz2)
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
                 bn_momentum: float = 0.9, fps_mode: str = "exact",
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.use_xyz_feat = use_xyz_feat
        l0 = 3 if use_xyz_feat else 0
        kw = dict(norm=norm, bn_momentum=bn_momentum, dtype=dtype)
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
