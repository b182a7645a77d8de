"""The port's basin-head trainer (`captra_tpu_torch/cli/train_basin_head.py`)
against `scripts/train_basin_head.py`'s pieces in the JAX package, and the
head's initialisation against flax's.

A tiny bottle CoordNet with the head (256 points), its BN statistics
perturbed and its NOCS head scaled x30.  The draws (pool indices, offset
uniforms, axes) are inputs, made with numpy.  In float64 in both packages
(the JAX CoordNet casts its pooled features to float32 before the head, so
its logits carry a float32 rounding): the inputs, the loss and the head's
gradient within 1e-6; after three Adam steps the head within 1e-5 of a
leaf, and every other leaf unchanged bit for bit in both packages (in the
JAX script's Adam over all parameters their gradient, moments and updates
are zero).  The CLI's checkpoint reads through the JAX reader, and its
seg and NPCS outputs are the input net's bit for bit."""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.data.synthetic import (
    batch_trajectories as jbatch, make_trajectory as jmake,
)
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.models.coordnet import canonicalize as jcanonicalize
from captra_tpu.pose import rotations as jrot
from captra_tpu.pose.part_dof import Pose as JPose
from captra_tpu.training import checkpoint as jckpt
from captra_tpu_torch.cli import train_basin_head as bh
from captra_tpu_torch.config import get_config as tget_config
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.models.coordnet import CoordNet
from captra_tpu_torch.training import checkpoint as tckpt
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, flat_tree, flax_variables,
)
from tests.torch_port_helpers import one_torch_thread, perturb, tiny_config

N = 256
NOCS_GAIN = 30.0
POOL_TRAJS, POOL_FRAMES = 2, 2
M = 6
LR = 1e-3
DATA_RADIUS = 0.6


def _configs(basin=True, norm="bn"):
    out = []
    for schema in (jschema, tschema):
        cfg = tiny_config(schema, "bottle", norm=norm, num_points=N)
        out.append(cfg.replace(network=dataclasses.replace(
            cfg.network, basin_head=basin)))
    return out


def _variables(tcfg, seed=0):
    net = CoordNet(tcfg, device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    v = perturb(flax_variables(net), np.random.RandomState(seed + 1))
    v["params"]["nocs_head"]["dense_1"]["kernel"] *= np.float32(NOCS_GAIN)
    return v


def _np64(tree):
    if hasattr(tree, "items"):
        return {k: _np64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def _leaves(tree, path=()):
    if hasattr(tree, "items"):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


def _jax_pool(jcfg):
    """The script's pool, as it builds it (trajectory-major)."""
    data = jbatch([jmake(seed=bh.POOL_SEED_BASE + s, obj=jcfg.obj,
                         num_frames=POOL_FRAMES, num_points=N)
                   for s in range(POOL_TRAJS)])
    pts = np.asarray(data["points"])
    rgt = np.asarray(data["pose"].rotation)[:, :, 0]
    S = POOL_TRAJS * POOL_FRAMES
    return (pts.transpose(1, 0, 2, 3).reshape(S, N, 3),
            rgt.transpose(1, 0, 2, 3).reshape(S, 3, 3))


def _jax_make_inputs(pool_pts, pool_rgt, idx, u, axis, sym):
    """The script's `make_inputs` with its draws as inputs."""
    p = pool_pts[idx]
    rg = pool_rgt[idx]
    theta = jnp.where(u < 0.25, u * 4.0 * 30.0, (u - 0.25) / 0.75 * 180.0)
    axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
    q = jrot.axis_theta_to_matrix(axis, jnp.deg2rad(theta))
    rc = jnp.einsum("mij,mjk->mik", q, rg)
    if sym:
        ang = jnp.rad2deg(jnp.arccos(jnp.clip(
            jnp.sum(rc[:, :, 1] * rg[:, :, 1], -1), -1.0, 1.0)))
    else:
        ang = theta
    mean = jnp.mean(p, axis=1)
    ctr = p - mean[:, None]
    r = jnp.max(jnp.linalg.norm(ctr, axis=-1), axis=1)
    pose = JPose(rotation=rc, translation=mean[..., None],
                 scale=r / DATA_RADIUS)
    return jcanonicalize(ctr, mean, pose), ang


def _draws(seed, S):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, S, M), rng.uniform(size=M),
            rng.randn(M, 3))


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread (under the parallel test run torch's thread a
    core oversubscribes the cores)."""
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _configs()
    return dict(jcfg=jcfg, tcfg=tcfg, v=_variables(tcfg),
                jpool=_jax_pool(jcfg),
                tpool=bh.make_pool(tcfg.obj, POOL_TRAJS, POOL_FRAMES, N,
                                   bh.POOL_SEED_BASE))


def _port_head(s):
    """The tiny net in float64 with its head as a train state under
    optax.adam(LR): (net, state, optimizer)."""
    net = coordnet_from_flax(s["tcfg"], s["v"], device="cpu").double()
    for name, p in net.named_parameters():
        p.requires_grad_(name.split(".")[0] in bh.HEAD)
    return (net, *bh.head_state(s["tcfg"], net, LR))


_JAX_STEP = {}


def _jax_step(jcfg):
    """The script's step, jitted once for the module: (params, Adam state,
    batch_stats, pool, draws) -> (loss, gradient over every parameter,
    params and Adam state after `optax.adam(LR)`'s update)."""
    if "fn" not in _JAX_STEP:
        jm = JCoordNet(jcfg)
        tx = optax.adam(LR)

        def loss_fn(params, batch_stats, jpool, draws):
            canon, ang = _jax_make_inputs(*jpool, *draws, True)
            out = jm.apply({"params": params, "batch_stats": batch_stats},
                           canon, train=False)
            target = jnp.clip(1.0 - ang / 90.0, 0.0, 1.0)
            return jnp.mean(optax.sigmoid_binary_cross_entropy(
                out["basin"], target))

        def step(params, opt, batch_stats, jpool, draws):
            loss, grads = jax.value_and_grad(loss_fn)(params, batch_stats,
                                                      jpool, draws)
            updates, opt = tx.update(grads, opt, params)
            return loss, grads, optax.apply_updates(params, updates), opt
        _JAX_STEP["fn"] = jax.jit(step)
        _JAX_STEP["tx"] = tx
    return _JAX_STEP["fn"], _JAX_STEP["tx"]


def _port_draws(draws):
    idx, u, axis = draws
    return (torch.from_numpy(idx), torch.from_numpy(u),
            torch.from_numpy(axis))


def test_pool_inputs_loss_and_head_gradient_match_jax(setup):
    s = setup
    assert all(np.array_equal(a, b) for a, b in zip(s["tpool"], s["jpool"]))
    S = s["tpool"][0].shape[0]
    draws = _draws(0, S)
    tpool = [torch.from_numpy(x).double() for x in s["tpool"]]
    with jax.enable_x64(True):
        jpool = [jnp.asarray(x, jnp.float64) for x in s["jpool"]]
        jd = (jnp.asarray(draws[0]), jnp.asarray(draws[1]),
              jnp.asarray(draws[2]))
        jcanon, jang = _jax_make_inputs(*jpool, *jd, True)
        v64 = jax.tree.map(jnp.asarray, _np64(s["v"]))
        step, tx = _jax_step(s["jcfg"])
        loss, grads, _, _ = step(v64["params"], tx.init(v64["params"]),
                                 v64["batch_stats"], jpool, jd)
        loss, grads = float(loss), jax.tree.map(np.asarray, grads)
    canon, ang = bh.make_inputs(*tpool, *_port_draws(draws), True,
                                DATA_RADIUS)
    assert canon.dtype == torch.float64
    np.testing.assert_allclose(canon.numpy(), np.asarray(jcanon), atol=1e-6)
    np.testing.assert_allclose(ang.numpy(), np.asarray(jang), atol=1e-6)
    assert float(ang.max()) > 30.0 > float(ang.min())

    net, state, _ = _port_head(s)
    tloss, _ = bh.loss_fn(net, canon, ang)
    assert abs(float(tloss.detach()) - loss) <= 1e-6
    tloss.backward()
    tgrads = flat_tree(state, state.grads)
    assert sorted(tgrads) == sorted(bh.HEAD)
    for path, got in _leaves(tgrads):
        want = grads[path[0]][path[1]]
        assert np.abs(want).max() > 1e-4, path
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=str(path))
    # everything but the head has a zero gradient in the script's loss
    for path, g in _leaves(grads):
        if path[0] not in bh.HEAD:
            assert not np.any(g), path


def test_three_adam_steps_move_only_the_head(setup):
    s = setup
    S = s["tpool"][0].shape[0]
    steps = [_draws(10 + i, S) for i in range(3)]
    with jax.enable_x64(True):
        v64 = jax.tree.map(jnp.asarray, _np64(s["v"]))
        jpool = [jnp.asarray(x, jnp.float64) for x in s["jpool"]]
        params = v64["params"]
        step, tx = _jax_step(s["jcfg"])
        opt = tx.init(params)
        for d in steps:
            jd = tuple(jnp.asarray(x) for x in d)
            _, _, params, opt = step(params, opt, v64["batch_stats"], jpool,
                                     jd)
        jparams = jax.tree.map(np.asarray, params)

    net, state, tx = _port_head(s)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    tpool = [torch.from_numpy(x).double() for x in s["tpool"]]
    for d in steps:
        bh.train_step(net, state, tx, *tpool, _port_draws(d), True,
                      DATA_RADIUS)
    assert state.step == 3 and state.opt_state["count"] == 3
    got = flax_variables(net)["params"]
    start = _np64(s["v"]["params"])
    moved = 0.0
    for (path, want), (_, g), (_, was) in zip(
            _leaves(jparams), _leaves(got), _leaves(start)):
        if path[0] in bh.HEAD:
            assert not np.array_equal(want, was), path
            moved = max(moved, np.abs(want - was).max())
            np.testing.assert_allclose(g, want, atol=1e-5, err_msg=str(path))
        else:
            # the JAX script's Adam leaves every other leaf as it was
            assert np.array_equal(want, was), path
    assert moved > 1e-3
    for k, v in net.state_dict().items():
        if k.split(".")[0] not in bh.HEAD:
            assert torch.equal(v, before[k]), k


def test_cli_checkpoint_reads_in_jax_and_keeps_seg_and_nocs(
        setup, tmp_path, monkeypatch):
    """The CLI on a JAX-written CoordNet checkpoint without the head: a
    head is drawn, trained for 3 steps, and the checkpoint reads through
    the JAX `load_checkpoint` equal to the port's reading; every leaf but
    the head's is the input's bit for bit, and the JAX net's seg and NPCS
    on it equal the input net's bit for bit."""
    s = setup
    _, tcfg_plain = _configs(basin=False)
    v = _variables(tcfg_plain, seed=3)
    state = types.SimpleNamespace(
        params=v["params"], batch_stats=v["batch_stats"],
        opt_state=optax.adam(1e-3).init(v["params"]), step=0)
    src = jckpt.save_checkpoint(str(tmp_path / "coord" / "ckpt"), 0, state)

    tiny = tiny_config(tschema, num_points=N)

    def get_config(config, overrides=None, base_dir=None):
        cfg = tget_config(config, overrides, base_dir)
        return cfg.replace(num_points=N, pointnet=tiny.pointnet,
                           network=dataclasses.replace(
                               cfg.network, backbone_out_dim=32,
                               nocs_head_dims=(16,)))
    monkeypatch.setattr(bh, "get_config", get_config)
    out = tmp_path / "basin"
    report = bh.main(["--coord", src, "--out", str(out), "--steps", "3",
                      "--batch", "4", "--pool_trajs", "2", "--pool_frames",
                      "2", "--dtype", "float32", "--norm", "bn"],
                     device="cpu")
    assert sorted(report["sep"]) == list(bh.PROBE_THETAS)
    with open(out / "REPORT.json") as f:
        saved = json.load(f)
    assert sorted(saved) == ["args", "sep"]
    assert sorted(map(int, saved["sep"])) == list(bh.PROBE_THETAS)

    jpay = jckpt.load_checkpoint(report["checkpoint"])
    tpay = tckpt.load_checkpoint(report["checkpoint"])
    assert jpay["step"] == 3 and jpay["epoch"] == 0
    for coll in ("params", "batch_stats"):
        jl, tl = list(_leaves(jpay[coll])), list(_leaves(tpay[coll]))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, a), (_, b) in zip(jl, tl):
            assert a.dtype == b.dtype and np.array_equal(a, b), path
    assert set(jpay["params"]) == set(v["params"]) | set(bh.HEAD)
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(v[coll]):
            got = jpay[coll]
            for k in path:
                got = got[k]
            assert np.array_equal(np.asarray(got), leaf), path
    assert int(jpay["opt_state"]["count"]) == 3

    _, tcfg = _configs(basin=True)
    pts = torch.from_numpy(
        np.random.RandomState(5).randn(2, N, 3).astype(np.float32) * 0.3)
    with torch.no_grad():
        before = coordnet_from_flax(tcfg_plain, v, device="cpu")(pts)
        after = coordnet_from_flax(tcfg, {
            "params": jpay["params"], "batch_stats": jpay["batch_stats"]},
            device="cpu")(pts)
    for k in ("seg", "nocs"):
        assert torch.equal(after[k], before[k]), k
    assert after["basin"].shape == (2,)


def test_cli_refuses_a_mismatched_norm(tmp_path):
    _, tcfg = _configs(basin=False)
    path = tckpt.save_checkpoint(str(tmp_path / "ckpt"), 0, _variables(tcfg))
    with pytest.raises(ValueError, match="norm=bn.*norm=gn"):
        bh.main(["--coord", path, "--out", str(tmp_path / "o")],
                device="cpu")


def test_head_initialisation_is_flax_dense():
    """The head drawn as flax's `Dense` draws it (lecun-normal: a normal
    truncated at two standard deviations, variance 1 / fan_in; zero bias)
    at the full width's shapes: the kernels' spread and bound against a
    flax draw of the same shapes; every other layer's draw is the one of
    a net without the head, bit for bit."""
    cfg = tget_config("config_track.yml", {"obj_config": "obj_info_nocs.yml",
                                           "obj_category": "1"})
    with_head = CoordNet(cfg.replace(network=dataclasses.replace(
        cfg.network, basin_head=True)), device="cpu",
        generator=torch.Generator().manual_seed(0))
    plain = CoordNet(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    sd = with_head.state_dict()
    for k, v in plain.state_dict().items():
        assert torch.equal(sd[k], v), k
    init = jax.nn.initializers.lecun_normal()
    for i, name in enumerate(bh.HEAD):
        fc = getattr(with_head, name)
        kernel = fc.weight.detach().numpy().T             # [in, out]
        assert not fc.bias.detach().any()
        want = np.asarray(init(jax.random.PRNGKey(i), kernel.shape))
        fan_in = kernel.shape[0]
        bound = 2.0 / np.sqrt(fan_in) / 0.87962566103423978
        assert np.abs(kernel).max() <= bound + 1e-6
        assert np.abs(want).max() <= bound + 1e-6
        rel = 0.03 if kernel.size > 10_000 else 0.25
        assert abs(kernel.std() - want.std()) <= rel * want.std(), name
        assert abs(kernel.std() - 1 / np.sqrt(fan_in)) <= rel / np.sqrt(
            fan_in), name
        assert abs(kernel.mean()) <= 4 * kernel.std() / np.sqrt(kernel.size)
