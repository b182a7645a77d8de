"""Seeded random weights of a configuration's two nets, made on the device
in one draw and handed alike to the program and to the reference.

Every leaf comes from one uniform draw of a `torch.Generator` on the
device: linear kernels xavier-uniform, linear biases within +-0.05,
norm scales in [0.8, 1.2) and shifts within +-0.1, BatchNorm running means
within +-0.1 and variances in [0.5, 1.5) (so that no normalisation is the
identity, and the comparison sees it).

Random nets are then made to track as trained ones do, following the
object without chaos:

  * CoordNet predicts NPCS from the canonical cloud: PASS channels of its
    group-all stage carry max(+-x), max(+-y), max(+-z) of the cloud's
    centres (the box around the cloud), the feature propagations carry them
    to every point, fp1 subtracts the box's centre from each point's
    canonical coordinates (both signs, through the ReLUs), and the NPCS
    head gives sigmoid(NOCS_SLOPE * (x - centre)) - 0.5 for every part.
    The tracker's fits then follow the cloud.  These channels read nothing
    else and nothing else reads them, and their BatchNorms are the
    identity; every other weight stays random;
  * the object's parts get SEG_BIAS over a background channel;
  * each RotNet head's last layer is scaled by ROT_GAIN about the identity
    rotation's representation (a random delta a frame compounds);
  * `calibrate` sets every other BatchNorm's running statistics to the
    moments of its input on the traffic's first tracked frame (a random
    net's features otherwise carry a large constant offset).
"""
from __future__ import annotations

import math

import torch

from port_bench.harness import derive_seed

SEG_BIAS = 3.0
NOCS_SLOPE = 4.2
PASS = 6            # channels carrying (+x, -x, +y, -y, +z, -z)
ROT_GAIN = 0.01
IDENTITY = {True: (0.0, 1.0, 0.0), False: (1.0, 0.0, 0.0, 0.0, 1.0, 0.0)}


def _leaf(kind: str, u: torch.Tensor, shape) -> torch.Tensor:
    if kind == "linear_w":
        fan_out, fan_in = shape
        return (2.0 * u - 1.0) * math.sqrt(6.0 / (fan_in + fan_out))
    if kind == "linear_b":
        return (2.0 * u - 1.0) * 0.05
    if kind in ("bn_w", "gn_w"):
        return 0.8 + 0.4 * u
    if kind in ("bn_b", "gn_b", "bn_mean"):
        return (2.0 * u - 1.0) * 0.1
    if kind == "bn_var":
        return 0.5 + u
    raise ValueError(f"unknown leaf kind {kind!r}")


def make(spec: dict, cfg: dict, seed: int, device, tame: bool = True
         ) -> dict:
    """{net: {leaf name: tensor}} for the leaves of `spec` ({net: [(name,
    shape, kind)]}, the reference's weight layout) and the configuration
    `cfg`, drawn from `seed` on `device`; with `tame` made to track (see
    the module; `calibrate` follows once the traffic is made), else as
    drawn (a net to be trained)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "weights"))
    leaves = [leaf for net in spec for leaf in spec[net]]
    total = sum(math.prod(s) for _, s, k in leaves if k != "count")
    u = torch.rand(total, generator=gen, device=device)
    out, offset = {}, 0
    for net, net_leaves in spec.items():
        w = {}
        for name, shape, kind in net_leaves:
            if kind == "count":
                w[name] = torch.zeros((), dtype=torch.long, device=device)
                continue
            n = math.prod(shape)
            w[name] = _leaf(kind, u[offset:offset + n].view(shape), shape)
            offset += n
        out[net] = w
    if tame:
        _tame(out, cfg)
        _pass_through(out["coord"], cfg)
    return out


def _signed_xyz(d: torch.Tensor) -> torch.Tensor:
    """[PASS, 3]: rows +x, -x, +y, -y, +z, -z."""
    return torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                         [0, 0, 1], [0, 0, -1]], dtype=d.dtype,
                        device=d.device)


def _route(w: dict, dense: str, src: torch.Tensor | None, cols: int) -> None:
    """Rows 0..PASS-1 of `dense` read only the input columns `cols` ..
    cols + PASS - 1 (identity), or the first columns by the given block
    `src`; no other row reads the columns `cols` .. cols + PASS - 1."""
    W = w[f"{dense}.weight"].clone()
    W[:, cols:cols + PASS] = 0.0
    W[:PASS] = 0.0
    if src is None:
        W[:PASS, cols:cols + PASS] = torch.eye(PASS, dtype=W.dtype,
                                               device=W.device)
    else:
        W[:PASS, :src.shape[1]] = src
    w[f"{dense}.weight"] = W
    b = w[f"{dense}.bias"].clone()
    b[:PASS] = 0.0
    w[f"{dense}.bias"] = b


def _pass_through(w: dict, cfg: dict) -> None:
    """Install CoordNet's PASS channels (see the module)."""
    pn, P = cfg["pointnet"], cfg["obj"]["num_parts"]
    d1 = sum(m[-1] for m in pn["sa1"]["mlp_list"])
    d2 = sum(m[-1] for m in pn["sa2"]["mlp_list"])
    # sa3 reads [the centres' xyz, l2]: +-xyz, then kept
    _route(w, "backbone.sa3.mlp.dense_0", _signed_xyz(w[
        "backbone.sa3.mlp.dense_0.weight"]), 0)
    for i in range(1, len(pn["sa3_mlp"])):
        _route(w, f"backbone.sa3.mlp.dense_{i}", None, 0)
    # fp3 reads [l2 (d2), global (sa3 out)]; fp2 [l1 (d1), fp3 out]
    _route(w, "backbone.fp3.mlp.dense_0", None, d2)
    for i in range(1, len(pn["fp3_mlp"])):
        _route(w, f"backbone.fp3.mlp.dense_{i}", None, 0)
    _route(w, "backbone.fp2.mlp.dense_0", None, d1)
    for i in range(1, len(pn["fp2_mlp"])):
        _route(w, f"backbone.fp2.mlp.dense_{i}", None, 0)
    # fp1 reads [xyz, xyz, fp2 out]: rows +-(x - (max x - max -x) / 2)
    Wf = w["backbone.fp1.mlp.dense_0.weight"]
    src = torch.zeros(PASS, 6 + PASS, dtype=Wf.dtype, device=Wf.device)
    src[:, :3] = _signed_xyz(Wf)
    for r in range(PASS):
        axis, sign = r // 2, 1.0 - 2.0 * (r % 2)
        src[r, 6 + 2 * axis] = -0.5 * sign
        src[r, 6 + 2 * axis + 1] = 0.5 * sign
    _route(w, "backbone.fp1.mlp.dense_0", src, 6)
    for i in range(1, len(pn["fp1_mlp"])):
        _route(w, f"backbone.fp1.mlp.dense_{i}", None, 0)
    _route(w, "backbone.out.dense_0", None, 0)
    _route(w, "nocs_head.dense_0", None, 0)
    # the NPCS of every part: slope * (+x - -x) of the centred coordinates
    last = _last_dense(w, "nocs_head")
    Wn = torch.zeros_like(w[f"{last}.weight"])
    for p in range(P):
        for axis in range(3):
            Wn[3 * p + axis, 2 * axis] = NOCS_SLOPE
            Wn[3 * p + axis, 2 * axis + 1] = -NOCS_SLOPE
    w[f"{last}.weight"] = Wn
    w[f"{last}.bias"] = torch.zeros_like(w[f"{last}.bias"])


def _identity_pass_norms(w: dict) -> None:
    """The BatchNorms of the PASS channels: the identity."""
    for name in list(w):
        if name.endswith(".running_mean") and (
                name.startswith(("backbone.sa3.", "backbone.fp",
                                 "backbone.out.", "nocs_head."))):
            n = name[:-len(".running_mean")]
            for leaf, value in (("running_mean", 0.0),
                                ("running_var", 1.0 - 1e-5),
                                ("weight", 1.0), ("bias", 0.0)):
                t = w[f"{n}.{leaf}"].clone()
                t[:PASS] = value
                w[f"{n}.{leaf}"] = t


def _last_dense(w: dict, prefix: str) -> str:
    i = max(int(k[len(prefix) + 7:].split(".")[0]) for k in w
            if k.startswith(prefix + ".dense_"))
    return f"{prefix}.dense_{i}"


def _tame(nets: dict, cfg: dict) -> None:
    obj = cfg["obj"]
    coord = nets["coord"]
    if obj["extra_dims"] > 0:
        b = coord["seg_head.dense_0.bias"]
        parts = torch.arange(b.shape[0], device=b.device) < obj["num_parts"]
        coord["seg_head.dense_0.bias"] = torch.where(parts, b + SEG_BIAS, b)
    rot = nets["rot"]
    ident = IDENTITY[bool(obj["sym"])]
    for p in range(obj["num_parts"]):
        last = _last_dense(rot, f"regressor.heads.{p}")
        rot[f"{last}.weight"] = rot[f"{last}.weight"] * ROT_GAIN
        rot[f"{last}.bias"] = torch.tensor(ident, dtype=torch.float32,
                                           device=rot[f"{last}.bias"].device)


@torch.no_grad()
def calibrate(ref, cfg: dict, w: dict, init: dict, frame: dict) -> None:
    """Set the BatchNorm running statistics of both nets in `w` to their
    inputs' moments on `frame` (one frame of the traffic, tracked from the
    pose `init`): one pass of the reference in calibration mode."""
    pr = ref.Precision(calibrate=True)
    if "depth" in frame:
        ref.track_depth(pr, w["coord"], w["rot"], cfg, init, frame["depth"],
                        frame["shift"])
    else:
        ref.track_points(pr, w["coord"], w["rot"], cfg, init,
                         frame["points"])
    _identity_pass_norms(w["coord"])
