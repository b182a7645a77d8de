"""The port's bfloat16 compute against the JAX package's: the same flax
variables (converted with captra_tpu_torch.training.convert) on the same
seeded inputs, both packages computing in `network/compute_dtype`
bfloat16.

Two runs in bfloat16 round differently (XLA's CPU dot and torch's, flax's
fast GroupNorm variance and the port's two-pass one), so the bound is
relative to the JAX package's own bfloat16 error:

    max |port_bf16 - jax_bf16| <= 2 max |jax_bf16 - jax_f32| + eps,

eps one bfloat16 ulp (2^-8) of the largest |jax_f32|.  The port must also
have computed in the low dtype: its own low-precision run lies at least a
quarter of the JAX package's gap from its float32 run,

    max |port_bf16 - port_f32| >= max |jax_bf16 - jax_f32| / 4,

so a port that ran in float32, or cast only its output, fails.  xyz stays float32,
so the FPS and ball-query indices inside the bfloat16 backbone are equal
to the JAX package's, bit for bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu import ops as jops
from captra_tpu.config import schema as jschema
from captra_tpu.data.synthetic import (
    batch_trajectories as jbatch, make_trajectory as jmake,
)
from captra_tpu.models.backbone import PointNet2Msg as JPointNet2Msg
from captra_tpu.models.blocks import PointMLP as JPointMLP
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.models.rotnet import RotNet as JRotNet
from captra_tpu.pose.part_dof import Pose as JPose
from captra_tpu.tracking import tracker as jtracker
from captra_tpu_torch.config import get_config, schema as tschema
from captra_tpu_torch.config.presets import (
    nocs_bottle, nocs_bottle_otf, nocs_bottle_otf_overrides,
    nocs_bottle_overrides,
)
from captra_tpu_torch.models.backbone import PointNet2Msg
from captra_tpu_torch.models.blocks import PointMLP, compute_dtype
from captra_tpu_torch.models.coordnet import CoordNet
from captra_tpu_torch.ops import neighbors, pointops
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking.tracker import (
    make_track_step, track_trajectory,
)
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, load_flax_variables, rotnet_from_flax,
)
from tests.torch_port_helpers import cloud, perturb, tiny_config, to_numpy

N = 128
BF16 = "bfloat16"


def assert_within_jax_error(port, jax_low, jax_f32, port_f32, what: str):
    """The bounds of this file's docstring; the JAX run must really have
    rounded (a nonzero error)."""
    port, jax_low, jax_f32, port_f32 = (
        np.asarray(x, np.float64) for x in (port, jax_low, jax_f32, port_f32))
    jax_err = np.abs(jax_low - jax_f32).max()
    eps = 2.0 ** -8 * np.abs(jax_f32).max()
    got = np.abs(port - jax_low).max()
    own = np.abs(port - port_f32).max()
    assert jax_err > 0, f"{what}: the JAX run did not round"
    assert got <= 2 * jax_err + eps, (
        f"{what}: |port - jax| {got:.3g} > 2 x {jax_err:.3g} + {eps:.3g}")
    assert own >= 0.25 * jax_err, (
        f"{what}: the port's low-precision run is {own:.3g} from its float32 "
        f"run, under a quarter of the JAX package's {jax_err:.3g}")


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _low(cfg, dtype: str = BF16):
    return cfg.replace(network=dataclasses.replace(cfg.network,
                                                   compute_dtype=dtype))


@pytest.mark.parametrize("norm,dtype", [("bn", BF16), ("gn", BF16),
                                        ("none", BF16), ("gn", "float16")])
def test_point_mlp_low_precision_matches_flax(norm, dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 8, 6).astype(np.float32)
    kw = dict(norm=norm, final_acti="relu", last_norm=True)
    j32 = JPointMLP((8, 16, 4), **kw)
    jlow = JPointMLP((8, 16, 4), dtype=jnp.dtype(dtype), **kw)
    v = perturb(to_numpy(j32.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                  train=False)), np.random.RandomState(1))
    pm = load_flax_variables(
        PointMLP(6, (8, 16, 4), dtype=getattr(torch, dtype), **kw).eval(), v)
    pm32 = load_flax_variables(PointMLP(6, (8, 16, 4), **kw).eval(), v)
    got = pm(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    assert_within_jax_error(got.float().detach().numpy(),
                            _f32(jlow.apply(v, jnp.asarray(x))),
                            j32.apply(v, jnp.asarray(x)),
                            pm32(torch.from_numpy(x)).detach().numpy(),
                            f"PointMLP {norm}")


@pytest.mark.parametrize("use_xyz_feat", [True, False])
@pytest.mark.parametrize("norm", ["bn", "gn"])
def test_pointnet2msg_bf16_matches_flax(norm, use_xyz_feat):
    cfg = tiny_config(jschema, norm=norm)
    xyz = cloud(np.random.RandomState(2), 2, N)
    j32 = JPointNet2Msg(cfg.pointnet, 32, use_xyz_feat=use_xyz_feat,
                        norm=norm)
    jlow = JPointNet2Msg(cfg.pointnet, 32, use_xyz_feat=use_xyz_feat,
                         norm=norm, dtype=jnp.bfloat16)
    v = perturb(to_numpy(j32.init(jax.random.PRNGKey(0), jnp.asarray(xyz),
                                  train=False)), np.random.RandomState(1))
    pm, pm32 = (load_flax_variables(
        PointNet2Msg(tiny_config(tschema, norm=norm).pointnet, 32,
                     use_xyz_feat=use_xyz_feat, norm=norm,
                     dtype=dtype).eval(), v)
        for dtype in (torch.bfloat16, None))
    got = pm(torch.from_numpy(xyz))
    assert got.dtype == torch.bfloat16
    assert_within_jax_error(got.float().detach().numpy(),
                            _f32(jlow.apply(v, jnp.asarray(xyz))),
                            j32.apply(v, jnp.asarray(xyz)),
                            pm32(torch.from_numpy(xyz)).detach().numpy(),
                            f"PointNet2Msg {norm}")


def test_bf16_backbone_indices_equal_jax(monkeypatch):
    """Every FPS and ball-query index the bfloat16 CoordNet backbone takes
    equals the JAX op's on the same float32 xyz."""
    cfg = tiny_config(jschema)
    xyz = cloud(np.random.RandomState(5), 2, N)
    v = to_numpy(JCoordNet(cfg).init(jax.random.PRNGKey(0),
                                     jnp.asarray(xyz), train=False))
    net = coordnet_from_flax(_low(tiny_config(tschema)), v, device="cpu")
    fps_calls, ball_calls = [], []
    fps, ball = (pointops.farthest_point_sample_indices,
                 neighbors.ball_query_stage)

    def rec_fps(x, npoint):
        out = fps(x, npoint)
        fps_calls.append((x.clone(), npoint, out))
        return out

    def rec_ball(radii, nsamples, x, new_x):
        # a stage's radii from one distance product: a call a radius
        outs = ball(radii, nsamples, x, new_x)
        ball_calls.extend((radius, nsample, x.clone(), new_x.clone(), out)
                          for radius, nsample, out in zip(radii, nsamples,
                                                          outs))
        return outs

    monkeypatch.setattr(pointops, "farthest_point_sample_indices", rec_fps)
    monkeypatch.setattr(neighbors, "ball_query_stage", rec_ball)
    net(torch.from_numpy(xyz))
    pn = cfg.pointnet
    assert len(fps_calls) == 2
    assert len(ball_calls) == len(pn.sa1.radius_list) + len(
        pn.sa2.radius_list)
    for x, npoint, out in fps_calls:
        assert x.dtype == torch.float32
        want = jops.farthest_point_sample(jnp.asarray(x.numpy()), npoint)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    for radius, nsample, x, new_x, out in ball_calls:
        assert x.dtype == torch.float32 and new_x.dtype == torch.float32
        want = jops.ball_query(radius, nsample, jnp.asarray(x.numpy()),
                               jnp.asarray(new_x.numpy()))
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    # the first sweep's input is the cloud itself
    np.testing.assert_array_equal(fps_calls[0][0].numpy(), xyz)


@pytest.mark.parametrize("norm", ["bn", "gn"])
@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_coordnet_bf16_matches_flax(obj, norm):
    jcfg, tcfg = tiny_config(jschema, obj, norm), tiny_config(tschema, obj,
                                                               norm)
    pts = cloud(np.random.RandomState(3), 2, N)
    v = perturb(to_numpy(JCoordNet(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(pts), train=False)),
        np.random.RandomState(1))
    want32 = JCoordNet(jcfg).apply(v, jnp.asarray(pts))
    wantlow = JCoordNet(_low(jcfg)).apply(v, jnp.asarray(pts))
    got, got32 = (coordnet_from_flax(c, v, device="cpu")(
        torch.from_numpy(pts)) for c in (_low(tcfg), tcfg))
    for k in ("seg", "nocs"):
        assert got[k].dtype == torch.float32       # leaves the net in f32
        assert_within_jax_error(got[k].detach().numpy(), wantlow[k],
                                want32[k], got32[k].detach().numpy(),
                                f"CoordNet {k}")


@pytest.mark.parametrize("norm", ["bn", "gn"])
@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_rotnet_bf16_matches_flax(obj, norm):
    jcfg, tcfg = tiny_config(jschema, obj, norm), tiny_config(tschema, obj,
                                                               norm)
    rng = np.random.RandomState(4)
    P = jcfg.obj.num_parts
    parts = cloud(rng, 2, P, N)
    labels = rng.randint(0, P + 1, (2, N))
    args = (jnp.asarray(parts), jnp.asarray(labels))
    v = to_numpy(JRotNet(jcfg).init(jax.random.PRNGKey(0), *args,
                                    train=False))
    want32 = JRotNet(jcfg).apply(v, *args)
    wantlow = JRotNet(_low(jcfg)).apply(v, *args)
    got, got32 = (rotnet_from_flax(c, v, device="cpu")(
        torch.from_numpy(parts), torch.from_numpy(labels))
        for c in (_low(tcfg), tcfg))
    assert got["rtvec"].dtype == torch.float32
    assert_within_jax_error(got["rtvec"].detach().numpy(), wantlow["rtvec"],
                            want32["rtvec"], got32["rtvec"].detach().numpy(),
                            "RotNet rtvec")


B, TN, T = 2, 256, 4
NOCS_GAIN = 30.0


@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_bf16_trajectory_matches_jax(obj):
    """3 tracked frames in bfloat16, each pose component within the bound
    (NOCS head scaled by NOCS_GAIN in both packages, as in
    tests/test_torch_otf.py: random nets amplify ulp differences)."""
    jcfg = tiny_config(jschema, obj, num_points=TN)
    tcfg32 = tiny_config(tschema, obj, num_points=TN)
    data = jbatch([jmake(seed=s, obj=jcfg.obj, num_frames=T, num_points=TN)
                   for s in range(B)])
    P = jcfg.obj.num_parts
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    cv = to_numpy(JCoordNet(jcfg).init(k1, jnp.zeros((1, TN, 3)),
                                       train=False))
    head = cv["params"]["nocs_head"]["dense_1"]
    head["kernel"] = head["kernel"] * np.float32(NOCS_GAIN)
    rv = to_numpy(JRotNet(jcfg).init(k2, jnp.zeros((1, P, TN, 3)),
                                     jnp.zeros((1, TN), jnp.int32),
                                     train=False))
    gt = data["pose"]
    frames = {"points": data["points"], "labels": data["labels"]}
    init = JPose(rotation=gt.rotation[0], translation=gt.translation[0],
                 scale=gt.scale[0])
    want = {}
    for dtype in ("float32", BF16):
        cfg = _low(jcfg, dtype)
        coord, rotn = JCoordNet(cfg), JRotNet(cfg)
        step = jtracker.make_track_step(
            cfg, lambda p, c=coord: c.apply(cv, p),
            lambda p, lab, r=rotn: r.apply(rv, p, lab))
        want[dtype] = jax.jit(lambda ip, fr, s=step: jtracker.track_trajectory(
            s, ip, fr))(init, frames)[1]

    tinit = Pose(*(torch.tensor(np.asarray(x)[0]) for x in
                   (gt.rotation, gt.translation, gt.scale)))
    got = {}
    for dtype in ("float32", BF16):
        tcfg = _low(tcfg32, dtype)
        step = make_track_step(
            tcfg, coordnet_from_flax(tcfg, cv, device="cpu"),
            rotnet_from_flax(tcfg, rv, device="cpu"), device="cpu")
        got[dtype] = track_trajectory(
            step, tinit, {k: np.array(v) for k, v in frames.items()},
            device="cpu")[1].pose
    assert got[BF16].rotation.shape[0] == T - 1
    for f in ("rotation", "translation", "scale"):
        assert torch.isfinite(getattr(got[BF16], f)).all()
        assert_within_jax_error(getattr(got[BF16], f).numpy(),
                                getattr(want[BF16].pose, f),
                                getattr(want["float32"].pose, f),
                                getattr(got["float32"], f).numpy(),
                                f"{obj} trajectory {f}")


def test_compute_dtype_names():
    cfg = tiny_config(tschema)
    assert compute_dtype(cfg) is None
    assert compute_dtype(_low(cfg)) is torch.bfloat16
    assert compute_dtype(_low(cfg, "float16")) is torch.float16
    for bad in ("bf16", "float64", "int8"):
        with pytest.raises(ValueError, match="network/compute_dtype"):
            CoordNet(_low(cfg, bad), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", BF16])
def test_code_built_configs_with_dtype_equal_yaml(dtype):
    assert nocs_bottle(dtype) == get_config(
        "config_track.yml", overrides=nocs_bottle_overrides(dtype))
    assert nocs_bottle_otf(compute_dtype=dtype) == get_config(
        "config_track.yml",
        overrides=nocs_bottle_otf_overrides(compute_dtype=dtype))
    assert nocs_bottle(dtype).network.compute_dtype == dtype
