"""The yardstick's arithmetic: the card's published peaks, the operations a
configuration's step needs, counted from its shapes, and the least time of
an FPS sweep, counted from its inputs.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): 67
TFLOP/s in float32 outside the tensor cores (the port's matrix products run
with TF32 off) and 3.35 TB/s of HBM.
"""
from __future__ import annotations

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# an FPS pick, per point: 3 subtractions, 3 products, 2 sums for the
# distance, a minimum and a comparison
FPS_OPS_PER_POINT_PICK = 10
ROT_HEAD_DIMS = (512, 512, 256)


def mlp_flops(in_dim: int, dims) -> int:
    """Multiply-adds x 2 of a per-point MLP, one point."""
    total, last = 0, in_dim
    for d in dims:
        total += 2 * last * d
        last = d
    return total


def _distance_flops(n: int, m: int) -> int:
    # the -2 a.b product of a pairwise squared distance
    return 2 * n * m * 3


def backbone_flops(pn: dict, n: int, out_dim: int, xyz_feat: bool) -> int:
    """One cloud of n points through the PointNet++ MSG backbone: every
    set-abstraction and feature-propagation MLP at its grouped size, the
    unit layer, and the pairwise distances of the ball queries and the
    3-NN interpolations."""
    l0 = 3 if xyz_feat else 0
    sa1, sa2 = pn["sa1"], pn["sa2"]
    s1, s2 = sa1["npoint"], sa2["npoint"]
    total = 0
    feat, points, centers = l0, n, s1
    for sa in (sa1, sa2):
        for k, mlp in zip(sa["nsample_list"], sa["mlp_list"]):
            total += centers * k * mlp_flops(feat + 3, mlp)
            total += _distance_flops(centers, points)
        feat = sum(m[-1] for m in sa["mlp_list"])
        points, centers = centers, s2
    d1 = sum(m[-1] for m in sa1["mlp_list"])
    d2 = feat
    total += s2 * mlp_flops(3 + d2, pn["sa3_mlp"])
    total += s2 * mlp_flops(d2 + pn["sa3_mlp"][-1], pn["fp3_mlp"])
    total += s1 * mlp_flops(d1 + pn["fp3_mlp"][-1], pn["fp2_mlp"])
    total += _distance_flops(s1, s2)
    total += n * mlp_flops(3 + l0 + pn["fp2_mlp"][-1], pn["fp1_mlp"])
    total += _distance_flops(n, s1)
    total += n * mlp_flops(pn["fp1_mlp"][-1], (out_dim,))
    return total


def coordnet_flops(cfg: dict) -> int:
    """One cloud through CoordNet: the backbone with xyz features, the
    segmentation and NPCS heads."""
    net, obj, n = cfg["network"], cfg["obj"], cfg["num_points"]
    c = net["backbone_out_dim"]
    P = obj["num_parts"]
    heads = (mlp_flops(c, (P + obj["extra_dims"],))
             + mlp_flops(c, tuple(net["nocs_head_dims"]) + (3 * P,)))
    return backbone_flops(cfg["pointnet"], n, c, True) + n * heads


def rotnet_flops(cfg: dict) -> int:
    """One stream through RotNet: the backbone on each part's cloud and
    each part's head on it."""
    net, obj, n = cfg["network"], cfg["obj"], cfg["num_points"]
    c = net["backbone_out_dim"]
    rot_dim = 3 if obj["sym"] else 6
    per_part = (backbone_flops(cfg["pointnet"], n, c, False)
                + n * mlp_flops(c, ROT_HEAD_DIMS + (rot_dim,)))
    return obj["num_parts"] * per_part


def track_step_flops(cfg: dict, streams: int) -> int:
    """A tracking step of `streams` streams: CoordNet and RotNet on each."""
    return streams * (coordnet_flops(cfg) + rotnet_flops(cfg))


def fps_bound_s(clouds: int, n: int, npoint: int, picks: int) -> float:
    """Least seconds of one FPS launch on `clouds` clouds of n points to
    npoint: the points read once and the indices written once against
    `picks` (summed over the clouds: each cloud's min(npoint, its distinct
    points)) sweeps over every point of a cloud, the larger."""
    bytes_s = (clouds * n * 3 * 4 + clouds * npoint * 4) / HBM_BYTES_PER_S
    ops_s = n * picks * FPS_OPS_PER_POINT_PICK / FP32_FLOPS
    return max(bytes_s, ops_s)
