"""The port's losses, BatchNorm in train mode, optimizer chain, schedules
and synthetic training data against the JAX package's, on the same seeded
numpy inputs and the same draws.

Tolerances: every loss within 1e-6 relative (float32 sums in another
order); BN train-mode output and its updated running statistics within
1e-5 of flax's `mutable=["batch_stats"]`; the optimizer chain's parameters
within 1e-6 of optax's after 3 updates on the same gradients (NaN, +-inf
and over-norm ones among them); schedules, `make_frame_batch` and
`geometry_pool` exactly; `device_pose_batch` within 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.data import synthetic as jsyn
from captra_tpu.models import losses as JL
from captra_tpu.models.blocks import PointMLP as JPointMLP
from captra_tpu.pose import part_dof as jpd
from captra_tpu.pose.part_dof import Pose as JPose
from captra_tpu.pose.rotations import quat_to_matrix as jquat_to_matrix
from captra_tpu.training import trainer as jtrainer
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.data import synthetic as tsyn
from captra_tpu_torch.models import losses as TL
from captra_tpu_torch.models.blocks import PointMLP
from captra_tpu_torch.pose import part_dof as tpd
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.training import trainer as ttrainer
from captra_tpu_torch.training.convert import (
    flax_variables, load_flax_variables,
)
from tests.torch_port_helpers import (
    jax_pose_batch_draws, jax_pwm_indices, perturb, tiny_config, to_numpy,
)

REL = 1e-6
BN_TOL = 1e-5
OPT_TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rel=REL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _poses(rng, B, P):
    q = rng.randn(B, P, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(jquat_to_matrix(jnp.asarray(q)))
    t = rng.randn(B, P, 3, 1).astype(np.float32) * 0.2
    s = rng.uniform(0.1, 0.4, (B, P)).astype(np.float32)
    return (JPose(*map(jnp.asarray, (R, t, s))),
            Pose(*map(_t, (R, t, s))))


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    B, N, P = 3, 64, 2
    labels = rng.randint(0, P + 1, (B, N))
    labels[2] = 1                 # a row with no part-0 point
    return dict(
        B=B, N=N, P=P, labels=labels,
        seg=jax.nn.softmax(rng.randn(B, N, P + 1).astype(np.float32)),
        nocs=rng.uniform(-0.5, 0.5, (B, N, 3 * P)).astype(np.float32),
        nocs_gt=rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32),
        poses=[_poses(rng, B, P) for _ in range(2)],
        pts=rng.randn(B, P, 8, 3).astype(np.float32) * 0.3,
        rot_pts=rng.randn(B, P, N, 3, 3).astype(np.float32))


def test_safe_norm_and_its_zero_subgradient():
    x = np.array([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0]], np.float32)
    _close(TL.safe_norm(_t(x)), JL.safe_norm(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    TL.safe_norm(xt).sum().backward()
    jg = jax.grad(lambda v: JL.safe_norm(v).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), atol=1e-7)
    assert np.all(xt.grad.numpy()[0] == 0)


def test_miou_and_choose_coord(data):
    _close(TL.miou_loss(_t(data["seg"]), _t(data["labels"])),
           JL.miou_loss(jnp.asarray(data["seg"]), jnp.asarray(data["labels"])))
    _close(TL.choose_coord_by_label(_t(data["nocs"]), _t(data["labels"]),
                                    data["P"]),
           JL.choose_coord_by_label(jnp.asarray(data["nocs"]),
                                    jnp.asarray(data["labels"]), data["P"]))


def test_nocs_loss(data):
    _close(TL.nocs_loss(_t(data["nocs"]), _t(data["nocs_gt"]),
                        _t(data["labels"]), data["P"]),
           JL.nocs_loss(*map(jnp.asarray, (data["nocs"], data["nocs_gt"],
                                           data["labels"])), data["P"]))


def test_sym_nocs_loss_with_the_jax_sample(data):
    key = jax.random.PRNGKey(4)
    want = JL.sym_nocs_loss(key, *map(jnp.asarray, (
        data["nocs"], data["nocs_gt"], data["labels"])), data["P"],
        pwm_num=16)
    idx = jax_pwm_indices(key, data["labels"], 16)
    got = TL.sym_nocs_loss(_t(data["nocs"]), _t(data["nocs_gt"]),
                           _t(data["labels"]), data["P"], pwm_num=16,
                           pwm_idx=_t(idx))
    for g, w in zip(got, want):
        _close(g, w)
    with pytest.raises(ValueError, match="sample"):
        TL.sym_nocs_loss(_t(data["nocs"]), _t(data["nocs_gt"]),
                         _t(data["labels"]), data["P"])


def test_pwm_draw_is_uniform_over_part_zero(data):
    labels = _t(data["labels"])
    idx = TL.draw_pwm_indices(labels, 4096,
                              torch.Generator().manual_seed(0))
    assert idx.shape == (3, 4096)
    for b in range(2):
        assert bool((labels[b][idx[b]] == 0).all())
        hit = np.bincount(idx[b].numpy(), minlength=data["N"])
        zero = (data["labels"][b] == 0)
        assert (hit[zero] > 0).all() and (hit[~zero] == 0).all()
    # a row without part 0 samples every point
    assert len(np.unique(idx[2].numpy())) > data["N"] // 2


@pytest.mark.parametrize("metric", ["frob", "l2", "l1", "exp_l2",
                                    "exp_l1"])
def test_rot_trace_loss(data, metric):
    (ja, ta), (jb, tb) = data["poses"]
    _close(TL.rot_trace_loss(ta.rotation, tb.rotation, metric),
           JL.rot_trace_loss(ja.rotation, jb.rotation, metric))


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_pose_term_losses(data, metric):
    (ja, ta), (jb, tb) = data["poses"]
    _close(TL.rot_yaxis_loss(ta.rotation, tb.rotation, metric),
           JL.rot_yaxis_loss(ja.rotation, jb.rotation, metric))
    _close(TL.trans_loss(ta.translation, tb.translation, metric),
           JL.trans_loss(ja.translation, jb.translation, metric))
    _close(TL.scale_loss(ta.scale, tb.scale, metric),
           JL.scale_loss(ja.scale, jb.scale, metric))
    got = TL.point_pose_loss(ta, tb, _t(data["pts"]), metric)
    want = JL.point_pose_loss(ja, jb, jnp.asarray(data["pts"]), metric)
    for g, w in zip(got, want):
        _close(g, w)


def test_part_dof_loss_and_weighted_total(data):
    (ja, ta), (jb, tb) = data["poses"]
    types = {"r": "frob", "s": "l1", "t": "l1"}
    got = TL.part_dof_loss(ta, tb, types)
    want = JL.part_dof_loss(ja, jb, types)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])
    weights = tiny_config(tschema).loss_weight
    _close(TL.weighted_total(got, weights),
           JL.weighted_total(want, tiny_config(jschema).loss_weight))


def test_compute_parts_delta_pose(data):
    (ja, ta), (jb, tb) = data["poses"]
    got = tpd.compute_parts_delta_pose(ta, tb, ta)
    want = jpd.compute_parts_delta_pose(ja, jb, ja)
    for f in ("rotation", "translation", "scale"):
        _close(getattr(got, f), getattr(want, f))
    got = tpd.compute_parts_delta_pose(ta, tb, tb)
    want = jpd.compute_parts_delta_pose(ja, jb, jb)
    _close(got.translation, want.translation)


def _bn_mlp_runs(dtype):
    """A 3-layer BN PointMLP in train mode, flax and port, on the same
    seeded input and variables: (port output, flax output, port stats,
    flax stats)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 16, 8, 6) * 2 + 1).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    tdt = None if dtype == "float32" else torch.bfloat16
    jm = JPointMLP((8, 16, 4), norm="bn", final_acti="relu", last_norm=True,
                   bn_momentum=0.8, dtype=jdt)
    v = perturb(to_numpy(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 train=False)), np.random.RandomState(1))
    want, mut = jm.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    pm = load_flax_variables(PointMLP(6, (8, 16, 4), norm="bn",
                                      final_acti="relu", last_norm=True,
                                      bn_momentum=0.8, dtype=tdt), v).train()
    got = pm(_t(x))
    return (got.float().detach().numpy(), np.asarray(want, np.float32),
            flax_variables(pm)["batch_stats"], to_numpy(mut["batch_stats"]))


def test_batchnorm_train_mode_matches_flax():
    """Output and the updated running statistics; the variance written is
    the biased one (torch's own update would write n / (n - 1) of it)."""
    got, want, stats, jstats = _bn_mlp_runs("float32")
    np.testing.assert_allclose(got, want, atol=BN_TOL)
    for layer, s in jstats.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats[layer][k], s[k], atol=BN_TOL,
                                       err_msg=f"{layer} {k}")


def test_batchnorm_train_mode_bf16_within_twice_the_jax_error():
    """bfloat16 compute, statistics in float32: the port's distance to the
    float32 flax run within twice the JAX package's own plus one bf16 ulp
    of the value (as tests/test_torch_bf16.py holds the nets)."""
    _, ref_j, _, ref_jstats = _bn_mlp_runs("float32")
    got, want, stats, jstats = _bn_mlp_runs("bfloat16")
    ulp = np.abs(ref_j) * 2.0 ** -8
    assert np.all(np.abs(got - ref_j) <= 2 * np.abs(want - ref_j).max()
                  + ulp + 1e-6)
    for layer, s in ref_jstats.items():
        for k in ("mean", "var"):
            port_err = np.abs(stats[layer][k] - s[k]).max()
            jax_err = np.abs(jstats[layer][k] - s[k]).max()
            assert port_err <= 2 * jax_err + 2.0 ** -8 * np.abs(s[k]).max(), \
                (layer, k, port_err, jax_err)


def test_batchnorm_keeps_a_non_finite_statistic_old():
    pm = PointMLP(3, (4,), norm="bn", last_norm=True).train()
    before = [b.clone() for b in pm.norm_0.buffers()]
    x = torch.ones(2, 5, 3)
    x[0, 0, 0] = float("inf")
    pm(x)
    for b, old in zip(pm.norm_0.buffers(), before):
        assert torch.equal(b, old)
    pm(torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(0)))
    assert not torch.equal(pm.norm_0.running_mean, before[0])
    assert bool(torch.isfinite(pm.norm_0.running_var).all())


def _optax_chain(cfg, steps_per_epoch):
    return jtrainer.make_optimizer(cfg, steps_per_epoch)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_optimizer_chain_matches_optax(optimizer, grad_clip):
    rng = np.random.RandomState(0)
    shapes = [(5, 3), (7,), (2, 4)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = []
    for step in range(3):
        g = [rng.randn(*s).astype(np.float32) for s in shapes]
        if grad_clip > 0:
            if step == 0:
                g[0][1, 2] = np.nan
                g[1][3] = np.inf
                g[2][0, 0] = -np.inf
            if step == 1:
                g = [x * 50.0 for x in g]             # over the norm
            if step == 2:
                g[1][0] = 3e4                         # over the clip
        grads.append(g)
    cfgs = {s: dataclasses.replace(
        tiny_config(s), optim=dataclasses.replace(
            tiny_config(s).optim, optimizer=optimizer, grad_clip=grad_clip,
            learning_rate=0.01, lr_step_size=1))
        for s in (jschema, tschema)}
    tx = _optax_chain(cfgs[jschema], 2)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    jstate = tx.init(jp)
    opt = ttrainer.Optimizer(cfgs[tschema], 2)
    offs = np.cumsum([0] + [p.size for p in params])
    flat = torch.from_numpy(np.concatenate([p.ravel() for p in params]))
    tstate = opt.init(flat)
    for g in grads:
        jg = {str(i): jnp.asarray(x) for i, x in enumerate(g)}
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        gflat = torch.from_numpy(np.concatenate([x.ravel() for x in g]))
        tstate = opt.step(tstate, flat, gflat)
    assert tstate["count"] == 3
    for i in range(len(params)):
        got = flat[offs[i]:offs[i + 1]].numpy().reshape(shapes[i])
        np.testing.assert_allclose(got, np.asarray(jp[str(i)]),
                                   atol=OPT_TOL, rtol=0, err_msg=str(i))
        assert np.isfinite(got).all() or grad_clip == 0


def test_schedules_exactly():
    cfgs = {s: dataclasses.replace(
        tiny_config(s), optim=dataclasses.replace(
            tiny_config(s).optim, learning_rate=1e-3, lr_gamma=0.5,
            lr_step_size=2, lr_clip=1e-5, bn_momentum_step_size=3))
        for s in (jschema, tschema)}
    js = jtrainer.make_lr_schedule(cfgs[jschema], 7)
    ts = ttrainer.make_lr_schedule(cfgs[tschema], 7)
    for step in (0, 6, 7, 13, 14, 27, 28, 100, 500, 5000):
        assert ts(step) == float(js(jnp.asarray(step, jnp.int32))), step
    for epoch in range(0, 80, 3):
        assert ttrainer.bn_momentum_for_epoch(cfgs[tschema], epoch) == \
            jtrainer.bn_momentum_for_epoch(cfgs[jschema], epoch), epoch


@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_make_frame_batch_and_geometry_pool_exactly(obj):
    jo = tiny_config(jschema, obj).obj
    to = tiny_config(tschema, obj).obj
    want = jsyn.make_frame_batch(5, jo, batch=3, num_points=100)
    got = tsyn.make_frame_batch(5, to, batch=3, num_points=100)
    for k in ("points", "labels", "nocs", "corners"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for f in ("rotation", "translation", "scale"):
        np.testing.assert_array_equal(getattr(got["pose"], f).numpy(),
                                      np.asarray(getattr(want["pose"], f)))
    want = jsyn.geometry_pool(3, jo, count=4, num_points=101)
    got = tsyn.geometry_pool(3, to, count=4, num_points=101)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_device_pose_batch_matches_jax(obj):
    jo = tiny_config(jschema, obj).obj
    to = tiny_config(tschema, obj).obj
    pool = tsyn.geometry_pool(1, to, count=3, num_points=64)
    key = jax.random.PRNGKey(9)
    want = jsyn.device_pose_batch(key, *map(jnp.asarray, (
        pool["npcs"], pool["labels"].astype(np.int32), pool["corners"])),
        jo)
    got = tsyn.device_pose_batch(
        *map(torch.from_numpy, (pool["npcs"], pool["labels"],
                                pool["corners"])), to,
        draws=jax_pose_batch_draws(key, 3, 64, to.num_parts))
    for k in ("points", "nocs", "corners"):
        _close(got[k], want[k])
    for f in ("rotation", "translation", "scale"):
        _close(getattr(got["pose"], f), getattr(want["pose"], f))
    drawn = tsyn.device_pose_batch(
        *map(torch.from_numpy, (pool["npcs"], pool["labels"],
                                pool["corners"])), to,
        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn["points"]).all()
    with pytest.raises(ValueError, match="draws"):
        tsyn.device_pose_batch(*map(torch.from_numpy, (
            pool["npcs"], pool["labels"], pool["corners"])), to)
