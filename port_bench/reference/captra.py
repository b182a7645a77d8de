"""Plain PyTorch reference of one CAPTRA tracking step (Weng et al., ICCV
2021; https://github.com/HalfSummer11/CAPTRA), written from the published
description and the reference code's semantics, independent of the
program under test: it imports nothing of the port.

A step, for B streams at once, from the carried per-part pose [B, P]:

  1. (raw-depth input only) backproject the depth image, crop the ball of
     radius 0.6 * scale around the carried root translation (grown by 1.1
     until it holds 10 points), keep the first in-ball point of each of
     5 * num_points buckets after a cyclic shift, then farthest-point
     sample num_points of them;
  2. canonicalize the cloud by the root pose, run CoordNet (PointNet++ MSG
     backbone with xyz features, a softmax segmentation head and a sigmoid
     NPCS head), labels = argmax of the segmentation;
  3. canonicalize the cloud by each part's pose, run RotNet (the same
     backbone without xyz features, a GroupNorm MLP head a part) and
     average each part's per-point rotation over its labelled points;
  4. compose the rotation delta onto the carried rotation and fit each
     part's scale and translation to the NPCS (a y-axis 2D refinement for
     symmetric categories); a part with <= 3 points or a degenerate fit
     keeps its carried pose.

Weights are a dict of tensors named as the weight spec (`weight_spec`)
names them.  `matmul="tf32"` computes every matrix product with its
operands rounded to TF32 (10 mantissa bits), the control of the benchmark's
comparison; the default is full float32.  The FPS below is the plain
max-min loop (first pick 0, running minimum from 1e10, ties to the lowest
index), so it picks what any exact FPS picks.
"""
from __future__ import annotations

import torch

ROT_HEAD_DIMS = (512, 512, 256)
BN_EPS = 1e-5
GN_EPS = 1e-5
GN_GROUP = 2
# the crop's radius growth 1.1 ** k, k = 0..9, as float32 computes the
# power
CROP_GROWTH = (1.0, 1.100000023841858, 1.2100000381469727,
               1.3310000896453857, 1.4641001224517822, 1.610510230064392,
               1.7715612649917603, 1.9487173557281494, 2.1435892581939697,
               2.357948064804077)
CROP_MIN_POINTS = 10
MIN_RADIUS = 0.05
CALIBRATE_VAR_FLOOR = 0.1
NOCS_REAL_INTRINSICS = ((591.0125, 0.0, 322.525),
                        (0.0, 590.16775, 244.11084),
                        (0.0, 0.0, 1.0))


# ---------------------------------------------------------------------------
# weight layout
# ---------------------------------------------------------------------------

def _mlp_spec(prefix: str, in_dim: int, dims, norm: str, last_norm: bool):
    """(name, shape, kind) of one per-point MLP: dense_i, then norm_i on
    every layer but the last unless `last_norm`."""
    out, last = [], in_dim
    for i, d in enumerate(dims):
        out += [(f"{prefix}.dense_{i}.weight", (d, last), "linear_w"),
                (f"{prefix}.dense_{i}.bias", (d,), "linear_b")]
        if norm != "none" and (i < len(dims) - 1 or last_norm):
            n = f"{prefix}.norm_{i}"
            out += [(f"{n}.weight", (d,), f"{norm}_w"),
                    (f"{n}.bias", (d,), f"{norm}_b")]
            if norm == "bn":
                out += [(f"{n}.running_mean", (d,), "bn_mean"),
                        (f"{n}.running_var", (d,), "bn_var"),
                        (f"{n}.num_batches_tracked", (), "count")]
        last = d
    return out


def _backbone_spec(prefix: str, pn: dict, out_dim: int, xyz_feat: bool):
    l0 = 3 if xyz_feat else 0
    spec = []
    feat = l0
    for sa in ("sa1", "sa2"):
        for i, mlp in enumerate(pn[sa]["mlp_list"]):
            spec += _mlp_spec(f"{prefix}.{sa}.scale_{i}", feat + 3, mlp,
                              "bn", True)
        feat = sum(m[-1] for m in pn[sa]["mlp_list"])
    sa1_dim = sum(m[-1] for m in pn["sa1"]["mlp_list"])
    sa2_dim = feat
    spec += _mlp_spec(f"{prefix}.sa3.mlp", 3 + sa2_dim, pn["sa3_mlp"], "bn",
                      True)
    spec += _mlp_spec(f"{prefix}.fp3.mlp", sa2_dim + pn["sa3_mlp"][-1],
                      pn["fp3_mlp"], "bn", True)
    spec += _mlp_spec(f"{prefix}.fp2.mlp", sa1_dim + pn["fp3_mlp"][-1],
                      pn["fp2_mlp"], "bn", True)
    spec += _mlp_spec(f"{prefix}.fp1.mlp", 3 + l0 + pn["fp2_mlp"][-1],
                      pn["fp1_mlp"], "bn", True)
    spec += _mlp_spec(f"{prefix}.out", pn["fp1_mlp"][-1], (out_dim,), "bn",
                      True)
    return spec


def weight_spec(cfg: dict) -> dict:
    """{"coord": [(name, shape, kind)], "rot": [...]}: the two nets' leaves
    in a fixed order, for the configuration `cfg` (the benchmark's
    configuration file)."""
    pn, net, obj = cfg["pointnet"], cfg["network"], cfg["obj"]
    P = obj["num_parts"]
    num_seg = P + obj["extra_dims"]
    C = net["backbone_out_dim"]
    coord = _backbone_spec("backbone", pn, C, True)
    coord += _mlp_spec("seg_head", C, (num_seg,), "none", False)
    coord += _mlp_spec("nocs_head", C, tuple(net["nocs_head_dims"]) + (3 * P,),
                       "bn", False)
    rot = _backbone_spec("encoder", pn, C, False)
    rot_dim = 3 if obj["sym"] else 6
    for p in range(P):
        rot += _mlp_spec(f"regressor.heads.{p}", C, ROT_HEAD_DIMS + (rot_dim,),
                         "gn", False)
    return {"coord": coord, "rot": rot}


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away);
    the gradient passes through unrounded."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x.detach()) if x.requires_grad else rounded


class Precision:
    """Matrix products in float32, or with TF32-rounded operands.  With
    `calibrate` a forward pass sets every BatchNorm's running statistics to
    its batch's (biased) moments before it normalises (each variance at
    least CALIBRATE_VAR_FLOOR of the layer's mean variance): the weight
    maker's calibration of random nets on the traffic.  With `train` every
    BatchNorm normalises with its batch's moments (biased variance), as in
    a training step."""

    def __init__(self, matmul: str = "float32", calibrate: bool = False,
                 train: bool = False):
        if matmul not in ("float32", "tf32"):
            raise ValueError(f"unknown matmul precision {matmul!r}")
        self.tf32 = matmul == "tf32"
        self.calibrate = calibrate
        self.train = train

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = _tf32(a), _tf32(b)
        return a @ b

    def linear(self, x, w, b):
        return self.mm(x, w.t()) + b


# ---------------------------------------------------------------------------
# point operations
# ---------------------------------------------------------------------------

def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Farthest-point sampling xyz [B, N, 3] -> int64 [B, npoint]."""
    B, N, _ = xyz.shape
    x, y, z = xyz.float().unbind(-1)
    dist = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    far = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    out = torch.empty((B, npoint), dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        out[:, i] = far
        dx = x - x[rows, far][:, None]
        dy = y - y[rows, far][:, None]
        dz = z - z[rows, far][:, None]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        far = torch.argmax(dist, dim=-1)
    return out


def _sqdist(pr: Precision, a: torch.Tensor, b: torch.Tensor):
    """|a_i - b_j|^2 [B, N, M] as -2 a.b + |a|^2 + |b|^2."""
    d = -2.0 * pr.mm(a, b.transpose(-1, -2))
    d = d + torch.sum(a * a, dim=-1, keepdim=True)
    return d + torch.sum(b * b, dim=-1)[..., None, :]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C] rows at idx [B, ...] -> [B, ..., C]."""
    B = x.shape[0]
    flat = idx.reshape(B, -1)
    out = torch.gather(x, 1, flat[..., None].expand(B, flat.shape[1],
                                                     x.shape[-1]))
    return out.reshape(idx.shape + (x.shape[-1],))


def _ball_query(pr, radius: float, k: int, xyz, centers):
    """The first k points (in index order) within `radius` of each center,
    missing slots filled with the first; no point in the ball: index 0."""
    N = xyz.shape[1]
    r2 = float(torch.tensor(radius, dtype=torch.float32) ** 2)
    inside = _sqdist(pr, centers, xyz) <= r2
    order = torch.arange(N, device=xyz.device)
    key = torch.where(inside, order, N)
    sel = torch.sort(key, dim=-1).values[..., :k]
    first = torch.where(sel[..., :1] < N, sel[..., :1], 0)
    return torch.where(sel < N, sel, first)


# ---------------------------------------------------------------------------
# the nets
# ---------------------------------------------------------------------------

def _bn(pr, x, w, n):
    if pr.train:
        flat = x.reshape(-1, x.shape[-1])
        mean = flat.mean(0)
        var = ((flat - mean) ** 2).mean(0)
        return (x - mean) / torch.sqrt(var + BN_EPS) * w[f"{n}.weight"] \
            + w[f"{n}.bias"]
    if pr.calibrate:
        flat = x.reshape(-1, x.shape[-1])
        var = flat.var(0, unbiased=False)
        w[f"{n}.running_mean"] = flat.mean(0)
        w[f"{n}.running_var"] = torch.clamp_min(var, CALIBRATE_VAR_FLOOR
                                                * var.mean())
    return ((x - w[f"{n}.running_mean"])
            / torch.sqrt(w[f"{n}.running_var"] + BN_EPS)
            * w[f"{n}.weight"] + w[f"{n}.bias"])


def _gn(pr, x, w, n):
    """GroupNorm over groups of GN_GROUP channels, statistics per sample
    over its points; x [B, N, C]."""
    B, N, C = x.shape
    g = x.reshape(B, N, C // GN_GROUP, GN_GROUP)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((g - mean) / torch.sqrt(var + GN_EPS)).reshape(B, N, C)
    return y * w[f"{n}.weight"] + w[f"{n}.bias"]


def _mlp(pr, w, prefix, x, layers: int, norm: str, last_norm: bool,
         last_relu: bool):
    for i in range(layers):
        last = i == layers - 1
        x = pr.linear(x, w[f"{prefix}.dense_{i}.weight"],
                      w[f"{prefix}.dense_{i}.bias"])
        if norm != "none" and (not last or last_norm):
            x = (_bn if norm == "bn" else _gn)(pr, x, w, f"{prefix}.norm_{i}")
        if not last or last_relu:
            x = torch.relu(x)
    return x


def _sa_msg(pr, w, prefix, sa: dict, xyz, feats):
    idx = fps(xyz, sa["npoint"])
    centers = _take(xyz, idx)                                # [B, S, 3]
    outs = []
    for i, (radius, k) in enumerate(zip(sa["radius_list"],
                                        sa["nsample_list"])):
        nb = _ball_query(pr, radius, k, xyz, centers)        # [B, S, k]
        rel = _take(xyz, nb) - centers[:, :, None]
        g = rel if feats is None else torch.cat([_take(feats, nb), rel], -1)
        g = _mlp(pr, w, f"{prefix}.scale_{i}", g, len(sa["mlp_list"][i]),
                 "bn", True, True)
        outs.append(g.max(dim=2).values)
    return centers, torch.cat(outs, dim=-1)


def _fp(pr, w, prefix, layers, xyz1, xyz2, feats1, feats2):
    if xyz2.shape[1] == 1:
        interp = feats2.expand(feats2.shape[0], xyz1.shape[1],
                               feats2.shape[-1])
    else:
        d = _sqdist(pr, xyz1, xyz2)
        dists, idxs = [], []
        for _ in range(3):
            i = torch.argmin(d, dim=-1, keepdim=True)
            dists.append(torch.gather(d, -1, i))
            idxs.append(i)
            d = d.scatter(-1, i, float("inf"))
        dist, idx = torch.cat(dists, -1), torch.cat(idxs, -1)
        recip = 1.0 / (dist + 1e-8)
        wgt = recip / recip.sum(-1, keepdim=True)
        interp = (_take(feats2, idx) * wgt[..., None]).sum(-2)
    x = interp if feats1 is None else torch.cat([feats1, interp], -1)
    return _mlp(pr, w, prefix, x, layers, "bn", True, True)


def backbone(pr, w, prefix: str, pn: dict, xyz, xyz_feat: bool):
    """PointNet++ MSG: 2 multi-scale set abstractions, a group-all one, 3
    feature propagations and a unit layer -> [B, N, out_dim]."""
    l0 = xyz if xyz_feat else None
    l1_xyz, l1 = _sa_msg(pr, w, f"{prefix}.sa1", pn["sa1"], xyz, l0)
    l2_xyz, l2 = _sa_msg(pr, w, f"{prefix}.sa2", pn["sa2"], l1_xyz, l1)
    g = _mlp(pr, w, f"{prefix}.sa3.mlp", torch.cat([l2_xyz, l2], -1),
             len(pn["sa3_mlp"]), "bn", True, True)
    l3 = g.max(dim=1, keepdim=True).values
    l3_xyz = torch.zeros_like(l2_xyz[:, :1])
    l2 = _fp(pr, w, f"{prefix}.fp3.mlp", len(pn["fp3_mlp"]), l2_xyz, l3_xyz,
             l2, l3)
    l1 = _fp(pr, w, f"{prefix}.fp2.mlp", len(pn["fp2_mlp"]), l1_xyz, l2_xyz,
             l1, l2)
    skip = xyz if l0 is None else torch.cat([xyz, l0], -1)
    f = _fp(pr, w, f"{prefix}.fp1.mlp", len(pn["fp1_mlp"]), xyz, l1_xyz, skip,
            l1)
    return _mlp(pr, w, f"{prefix}.out", f, 1, "bn", True, True)


def coordnet(pr, w, cfg: dict, canon):
    """-> seg [B, N, P + extra] probabilities, nocs [B, N, 3P] in
    (-0.5, 0.5)."""
    feat = backbone(pr, w, "backbone", cfg["pointnet"], canon, True)
    seg = torch.softmax(_mlp(pr, w, "seg_head", feat, 1, "none", False,
                             False), dim=-1)
    layers = len(cfg["network"]["nocs_head_dims"]) + 1
    nocs = torch.sigmoid(_mlp(pr, w, "nocs_head", feat, layers, "bn", False,
                              False)) - 0.5
    return seg, nocs


def _unit(v, fallback):
    mag = torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-24)
    back = torch.tensor(fallback, dtype=v.dtype, device=v.device)
    return torch.where(mag > 1e-8, v / torch.clamp(mag, min=1e-8),
                       back.expand(v.shape))


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def yvec_to_matrix(y):
    """A y axis [..., 3] -> a frame whose columns are (x, y, z)."""
    y = _unit(y, (1.0, 0.0, 0.0))
    ex = torch.tensor((1.0, 0.0, 0.0), dtype=y.dtype, device=y.device)
    z = _unit(_cross(ex, y), (1.0, 0.0, 0.0))
    return torch.stack([_cross(y, z), y, z], dim=-1)


def ortho6d_to_matrix(v):
    x = _unit(v[..., 0:3], (1.0, 0.0, 0.0))
    z = _unit(_cross(x, v[..., 3:6]), (1.0, 0.0, 0.0))
    return torch.stack([x, _cross(z, x), z], dim=-1)


def gram_schmidt(m):
    """Orthonormalise the columns of [..., 3, 3]."""
    a1, a2, a3 = m[..., :, 0], m[..., :, 1], m[..., :, 2]

    def proj(u, a):
        return ((u * a).sum(-1, keepdim=True)
                / torch.clamp((u * u).sum(-1, keepdim=True), min=1e-8)) * u

    u2 = a2 - proj(a1, a2)
    u3 = a3 - proj(a1, a3) - proj(u2, a3)
    return torch.stack([_unit(u, (1.0, 0.0, 0.0)) for u in (a1, u2, u3)],
                       dim=-1)


def rotnet_delta(pr, w, cfg: dict, canon_parts, labels):
    """canon_parts [B, P, N, 3], labels [B, N] -> the rotation delta of
    each part [B, P, 3, 3]: the mean of the per-point rotations over the
    part's points (a y axis for a symmetric category, else a 3x3 matrix
    orthonormalised)."""
    B, P, N, _ = canon_parts.shape
    sym = cfg["obj"]["sym"]
    feat = backbone(pr, w, "encoder", cfg["pointnet"],
                    canon_parts.reshape(B * P, N, 3), False)
    feat = feat.reshape(B, P, N, -1)
    reps = []
    for p in range(P):
        raw = _mlp(pr, w, f"regressor.heads.{p}", feat[:, p],
                   len(ROT_HEAD_DIMS) + 1, "gn", False, False)
        reps.append(_unit(raw, (1.0, 0.0, 0.0)) if sym
                    else ortho6d_to_matrix(raw).reshape(B, N, 9))
    rep = torch.stack(reps, dim=1)                           # [B, P, N, D]
    mask = (labels[:, None, :] == torch.arange(P, device=labels.device)[
        None, :, None]).float()
    count = mask.sum(-1, keepdim=True)
    mean = (rep * mask[..., None]).sum(-2) / torch.clamp(count, min=1.0)
    default = torch.tensor((0.0, 1.0, 0.0) if sym else
                           (1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0),
                           dtype=mean.dtype, device=mean.device)
    mean = torch.where(count > 0, mean, default)
    if sym:
        return yvec_to_matrix(mean)
    return gram_schmidt(mean.reshape(B, P, 3, 3))


# ---------------------------------------------------------------------------
# pose fit
# ---------------------------------------------------------------------------

def _masked_center(x, m):
    """x [..., N, C], mask m [..., N] -> (centroid [..., 1, C], (x - c) * m)."""
    wm = m[..., None]
    c = (x * wm).sum(-2, keepdim=True) / torch.clamp(wm.sum(-2, keepdim=True),
                                                     min=1.0)
    return c, (x - c) * wm


def fit_scale_translation(pr, npcs, cam, mask, rotation, sym: bool):
    """Per part, given the rotation [B, P, 3, 3]: the scale and translation
    with cam ~= s * R npcs + t over the part's points (npcs, cam
    [B, P, N, 3], mask [B, P, N]).  A symmetric part's rotation is first
    turned about its y axis to fit the NPCS in the xz plane (used for the
    fit only)."""
    R = rotation
    if sym:
        tgt = pr.mm(cam, R)                    # rows R^T c
        _, s2 = _masked_center(npcs[..., 0::2], mask)
        _, t2 = _masked_center(tgt[..., 0::2], mask)
        M = pr.mm(s2.transpose(-1, -2), t2)    # sum s2_i t2_i^T  [2, 2]
        # the 2D rotation maximising trace(R2^T sum t2 s2^T)
        c_raw = M[..., 0, 0] + M[..., 1, 1]
        s_raw = M[..., 0, 1] - M[..., 1, 0]
        r = torch.sqrt(c_raw ** 2 + s_raw ** 2)
        ok = (r > 1e-12) & torch.isfinite(r)
        c = torch.where(ok, c_raw / torch.clamp(r, min=1e-12), 1.0)
        s = torch.where(ok, s_raw / torch.clamp(r, min=1e-12), 0.0)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        ry = torch.stack([c, zero, -s, zero, one, zero, s, zero, c],
                         -1).reshape(c.shape + (3, 3))
        R = pr.mm(R, ry)
    _, src_c = _masked_center(npcs, mask)
    _, tgt_c = _masked_center(cam, mask)
    posed_c = pr.mm(src_c, R.transpose(-1, -2))
    num = (posed_c * tgt_c * mask[..., None]).sum((-1, -2))
    den = (posed_c * posed_c * mask[..., None]).sum((-1, -2)) + 1e-6
    scale = num / den
    posed = scale[..., None, None] * pr.mm(npcs, R.transpose(-1, -2))
    wn = mask / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    t = ((cam - posed) * wn[..., None]).sum(-2)
    return scale, t[..., None]


def track_points(pr, w_coord, w_rot, cfg: dict, pose: dict, points_raw):
    """One tracking step on camera clouds points_raw [B, N, 3] from the
    carried pose {"rotation" [B, P, 3, 3], "translation" [B, P, 3, 1],
    "scale" [B, P]} -> (new pose, seg, nocs)."""
    obj = cfg["obj"]
    P, sym = obj["num_parts"], obj["sym"]
    root = list(obj["tree"]).index(-1)
    B, N, _ = points_raw.shape
    mean = points_raw.mean(dim=1)
    cam = (points_raw - mean[:, None]) + mean[:, None]      # [B, N, 3]
    R, t, s = pose["rotation"], pose["translation"], pose["scale"]

    # column layout: R^T (x - t) / s
    canon = (pr.mm(R[:, root].transpose(-1, -2),
                   cam.transpose(-1, -2) - t[:, root])
             / s[:, root, None, None]).transpose(-1, -2)
    seg, nocs = coordnet(pr, w_coord, cfg, canon)
    labels = torch.argmax(seg, dim=-1)

    canon_parts = pr.mm(cam[:, None] - t.transpose(-1, -2), R) \
        / s[..., None, None]                                 # [B, P, N, 3]
    delta = rotnet_delta(pr, w_rot, cfg, canon_parts, labels)
    new_R = pr.mm(R, delta)

    npcs = nocs.reshape(B, N, P, 3).permute(0, 2, 1, 3)
    mask = (labels[:, None, :] == torch.arange(P, device=labels.device)[
        None, :, None]).float()
    cam_p = cam[:, None].expand(B, P, N, 3)
    fs, ft = fit_scale_translation(pr, npcs, cam_p, mask, new_R, sym)
    ok = ((mask.sum(-1) > 3) & torch.isfinite(fs) & (fs > 1e-4)
          & torch.isfinite(ft).all(-1).all(-1)
          & torch.isfinite(new_R).all(-1).all(-1))
    new = {"rotation": new_R,
           "translation": torch.where(ok[..., None, None], ft, t),
           "scale": torch.where(ok, fs, s)}
    return new, seg, nocs


# ---------------------------------------------------------------------------
# raw depth: backprojection and the ball crop
# ---------------------------------------------------------------------------

def backproject(depth, K):
    """depth [B, H, W] in mm -> points [B, H*W, 3] in m (y up, z toward the
    camera), valid [B, H*W]."""
    B, H, W = depth.shape
    K = torch.tensor(K, dtype=torch.float32, device=depth.device)
    rows = torch.arange(H, device=depth.device, dtype=torch.float32)[:, None]
    cols = torch.arange(W, device=depth.device, dtype=torch.float32)[None, :]
    z = depth.float()
    x = (cols - K[0, 2]) / K[0, 0] * z
    y = ((H - rows) - K[1, 2]) / K[1, 1] * z
    pts = torch.stack([x, y, -z], dim=-1).reshape(B, H * W, 3) * 0.001
    return pts, (depth > 0).reshape(B, H * W)


def crop(pts, valid, center, radius, num_points: int, work_factor: int,
         shift):
    """The ball crop of each cloud: pts [B, M, 3], valid [B, M], center
    [B, 3], radius [B], shift [B] -> the indices [B, num_points] of the
    cropped points."""
    B, M, _ = pts.shape
    dx, dy, dz = (pts - center[:, None]).unbind(-1)
    d = torch.where(valid, torch.sqrt(dx * dx + dy * dy + dz * dz), torch.inf)
    growth = torch.tensor(CROP_GROWTH, dtype=torch.float32,
                          device=pts.device)
    radii = torch.clamp_min(radius, MIN_RADIUS)[:, None] * growth  # [B, G]
    counts = (d[:, None, :] <= radii[:, :, None]).sum(-1)
    enough = counts >= CROP_MIN_POINTS
    k = torch.where(enough.any(-1), enough.float().argmax(-1),
                    len(CROP_GROWTH) - 1)
    inside = d <= torch.gather(radii, 1, k[:, None])
    inside = torch.where(inside.any(-1, keepdim=True), inside, valid)

    W = min(work_factor * num_points, M)
    G = -(-M // W)
    j = torch.arange(W * G, device=pts.device)
    src = (j[None] + shift[:, None].long()) % M
    rolled = torch.gather(inside, 1, src) & (j < M)[None]
    buckets = rolled.reshape(B, W, G)
    has = buckets.any(-1)
    first = buckets.float().argmax(-1)
    pick = (torch.arange(W, device=pts.device)[None] * G + first
            + shift[:, None].long()) % M
    any_in = rolled.any(-1)
    first_all = torch.where(any_in, rolled.float().argmax(-1), 0)
    fallback = ((first_all + shift.long()) % M)[:, None]
    take = torch.where(has, pick, fallback)                 # [B, W]
    sel = fps(_take(pts, take), num_points)
    return torch.gather(take, 1, sel)


def track_depth(pr, w_coord, w_rot, cfg: dict, pose: dict, depth, shift,
                K=NOCS_REAL_INTRINSICS):
    """One tracking step on raw depth [B, H, W] (mm): crop around the
    carried root pose, then `track_points`; a frame with no valid depth
    keeps the carried pose.  -> (new pose, seg, nocs)."""
    root = list(cfg["obj"]["tree"]).index(-1)
    pts, valid = backproject(depth, K)
    center = pose["translation"][:, root, :, 0]
    radius = cfg["data_radius"] * pose["scale"][:, root]
    idx = crop(pts, valid, center, radius, cfg["num_points"],
               cfg["track"].get("otf_work_factor", 5), shift)
    # the cropped points taken from coordinate planes [B, 3, N]
    planes = torch.gather(pts.transpose(1, 2), 2,
                          idx[:, None].expand(-1, 3, -1))
    new, seg, nocs = track_points(pr, w_coord, w_rot, cfg, pose,
                                  planes.transpose(1, 2))
    ok = valid.any(-1)
    new = {k: torch.where(ok.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                          pose[k]) for k, v in new.items()}
    return new, seg, nocs
