"""The orbax checkpoint format in the port (`training/orbax_io.py`, read and
written with tensorstore alone; `training/checkpoint.py`,
`training/convert.py::optax_leaves / restore_optax_leaves`) against the
JAX package's orbax checkpoints.

- Trees the JAX package writes read back bit for bit (against orbax's own
  restore), and the JAX package loads the port's.
- The optax chain's flat leaf order is taken from `jax.tree.leaves` of
  the JAX chain's state, for Adam and SGD, with and without the gradient
  clip (`found_nan` leaves), and both `restore_state` round trips hold:
  a port state written as orbax restores in the JAX package with its
  parameters and every moment bit-equal; a JAX float64 state after one
  Adam step, saved as orbax, restores in the port bit for bit and its
  next float64 step is the JAX package's next step (losses within 1e-5,
  gradient and moment leaves within 1e-4 of their largest entry, the
  trainer tests' bars).
- `--ckpt_format orbax` through the port's train CLI: a resumed run
  equals the uninterrupted one bit for bit.
- Without tensorstore, the format raises `ImportError` naming it."""
import os
import sys
from os.path import join as pjoin

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.data.synthetic import make_frame_batch as jmake_frame_batch
from captra_tpu.training import checkpoint as jckpt
from captra_tpu.training import trainer as jtrainer
from captra_tpu_torch.cli import train as train_cli
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.data.synthetic import make_frame_batch
from captra_tpu_torch.training import checkpoint as ckpt
from captra_tpu_torch.training import orbax_io
from captra_tpu_torch.training import trainer as ttrainer
from captra_tpu_torch.training.convert import (
    flat_tree, flax_state_dict, flax_variables, optax_leaves,
)
from tests.test_torch_train_cli import (  # noqa: F401 - fixtures
    _argv, _assert_equal_trees, _payload, config_dir, short_epochs,
)
from tests.test_torch_trainer import (
    B, GRAD_TOL, LOSS_TOL, N, _as_f64, _jax_state, _jax_step, _variables,
    f64_state, step_f64, train_config,
)
from tests.torch_port_helpers import one_torch_thread, to_numpy, tree_leaves

CASE = ("rot", "laptop", "bn")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _leaves_equal(got, want):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def _port_state(optimizer, grad_clip, steps=1):
    """A float32 port state of the laptop RotNet after `steps` steps (its
    moments non-trivial), its trainer, the JAX trainer of the same config
    and the variables it started from."""
    import dataclasses
    cfgs = [train_config(s, *CASE, optimizer=optimizer) for s in
            (jschema, tschema)]
    cfgs = [c.replace(optim=dataclasses.replace(c.optim,
                                                grad_clip=grad_clip))
            for c in cfgs]
    tt = ttrainer.Trainer(cfgs[1], steps_per_epoch=2, device="cpu")
    jt = jtrainer.Trainer(cfgs[0], steps_per_epoch=2)
    variables = _variables(tt, 1)
    state = tt.init_state(variables=variables)
    for s in range(steps):
        state, _, _ = tt.train_step(
            state, make_frame_batch(s, cfgs[1].obj, batch=B, num_points=N),
            generator=torch.Generator().manual_seed(s))
    return state, tt, jt, variables


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_port_orbax_restores_bit_equal_in_jax(tmp_path, optimizer,
                                              grad_clip):
    """The port's leaves in the JAX chain's flatten order (checked against
    `jax.tree.leaves` by structure and dtype), written as orbax: the JAX
    `load_checkpoint` + `restore_state` give the port's parameters,
    statistics, step and every moment bit for bit (no fallback to fresh
    moments)."""
    state, tt, jt, variables = _port_state(optimizer, grad_clip)
    path = ckpt.save_train_state(str(tmp_path / "ckpt"), 3, state,
                                 format="orbax", grad_clip=grad_clip)
    assert os.path.isdir(path) and path.endswith("model_0003")
    fresh = _jax_state(jt, variables)
    jleaves = jax.tree.leaves(fresh.opt_state)
    ours = optax_leaves(state, grad_clip)
    assert [np.asarray(x).dtype for x in ours] == \
        [np.asarray(x).dtype for x in jleaves]
    assert [np.shape(x) for x in ours] == [np.shape(x) for x in jleaves]

    payload = jckpt.load_checkpoint(path)
    assert payload["step"] == 1 and payload["epoch"] == 3
    restored = jckpt.restore_state(payload, fresh)
    want = flax_variables(state.module)
    _leaves_equal(to_numpy(restored.params), want["params"])
    _leaves_equal(to_numpy(restored.batch_stats), want["batch_stats"])
    assert int(restored.step) == 1
    names = ("mu", "nu") if optimizer == "adam" else ("trace",)
    kind = "ScaleByAdamState" if optimizer == "adam" else "TraceState"
    jopt = next(s for s in restored.opt_state if type(s).__name__ == kind)
    for name in names:
        _leaves_equal(to_numpy(getattr(jopt, name)),
                      flat_tree(state, state.opt_state[name]))
    sched = next(s for s in restored.opt_state
                 if type(s).__name__ == "ScaleByScheduleState")
    assert int(sched.count) == state.opt_state["count"] == 1
    # and the port reads its own checkpoint back exactly
    back = ckpt.restore_state(ckpt.load_checkpoint(path),
                              tt.init_state(variables=variables))
    assert back.step == 1 and back.opt_state["count"] == 1
    for name in names:
        assert torch.equal(back.opt_state[name], state.opt_state[name])
    assert torch.equal(back.params, state.params)


def _np(tree):
    """A JAX tree as numpy, dtypes kept (float64 under x64)."""
    return jax.tree.map(np.asarray, tree)


def _f64_params(state):
    return {k: v.detach().numpy() for k, v in
            state.param_views(state.params).items()}


def test_jax_orbax_restores_in_the_port_and_steps_as_jax(tmp_path):
    """A JAX float64 state after one Adam step (clipped chain), saved as
    orbax under x64, read by the port: the tree equals orbax's own
    restore bit for bit, the port's float64 state holds its parameters,
    statistics and moments bit for bit, and the next step matches the
    JAX package's next step."""
    jcfg = train_config(jschema, *CASE, optimizer="adam")
    tcfg = train_config(tschema, *CASE, optimizer="adam")
    jt = jtrainer.Trainer(jcfg, steps_per_epoch=2)
    tt = ttrainer.Trainer(tcfg, steps_per_epoch=2, device="cpu")
    step = _jax_step(jt)
    variables = _variables(tt, 2)
    with jax.enable_x64(True):
        xstate = _jax_state(jt, _as_f64(variables))
        key = jax.random.PRNGKey(100)
        jbatch = _as_f64(jmake_frame_batch(0, jcfg.obj, batch=B,
                                           num_points=N))
        xstate, *_ = step(xstate, jbatch, key)
        path = jckpt.save_checkpoint(str(tmp_path / "ckpt"), 1, xstate,
                                     extra={"note": "x"}, format="orbax")
    # the tree: tensorstore's read is orbax's restore, bit for bit
    tree = orbax_io.read_tree(path)
    _leaves_equal(tree, dict(ocp.PyTreeCheckpointer().restore(path)))
    payload = ckpt.load_checkpoint(path)
    assert payload["extra"] == {"note": "x"}
    assert (payload["step"], payload["epoch"]) == (1, 1)
    assert isinstance(payload["step"], int)
    assert tree["params"][next(iter(tree["params"]))] is not None

    qstate = ckpt.restore_state(payload, f64_state(tt, variables))
    assert qstate.step == 1 and qstate.opt_state["count"] == 1
    want = flax_state_dict({"params": _np(xstate.params)})
    got = _f64_params(qstate)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)
    adam = next(s for s in xstate.opt_state
                if type(s).__name__ == "ScaleByAdamState")
    for name in ("mu", "nu"):
        want = flax_state_dict({"params": _np(getattr(adam, name))})
        got = {k: v.numpy() for k, v in qstate.param_views(
            qstate.opt_state[name]).items()}
        for k in got:
            np.testing.assert_array_equal(got[k], want[k].numpy(),
                                          err_msg=f"{name} {k}")
    stats = flax_state_dict({"batch_stats": _np(xstate.batch_stats)})
    own = qstate.module.state_dict()
    for k, v in stats.items():
        np.testing.assert_array_equal(own[k].numpy(), v.numpy(), err_msg=k)

    # the next step, in both packages, from the restored states
    xstate2, qstate, xrec, qrec = step_f64(step, tt, xstate, qstate, 1,
                                           jax.random.PRNGKey(101))
    for k, v in xrec["losses"].items():
        assert abs(qrec["losses"][k] - v) <= LOSS_TOL * max(1.0, abs(v)), k
    xg, qg = dict(tree_leaves(xrec["grads"])), dict(tree_leaves(
        qrec["grads"]))
    big = max(np.abs(v).max() for v in xg.values())
    for k, v in xg.items():
        scale = max(np.abs(v).max(), 1e-3 * big)
        assert np.abs(qg[k] - v).max() <= GRAD_TOL * scale, k
    adam2 = next(s for s in xstate2.opt_state
                 if type(s).__name__ == "ScaleByAdamState")
    for name in ("mu", "nu"):
        want = dict(tree_leaves(_np(getattr(adam2, name))))
        got = dict(tree_leaves(flat_tree(qstate, qstate.opt_state[name])))
        big = max(np.abs(v).max() for v in want.values())
        for k, v in want.items():
            scale = max(np.abs(v).max(), 1e-3 * big)
            assert np.abs(got[k] - v).max() <= GRAD_TOL * scale, (name, k)
    assert qstate.opt_state["count"] == int(adam2.count) == 2


def test_orbax_leaf_keys_sort_numerically(tmp_path):
    """The JAX writer pads keys to 4 digits: past 9999 leaves "10000"
    sorts before "9999" as text.  `restore_state` orders them as integers,
    as the JAX function does."""
    state, tt, _, variables = _port_state("sgd", 0.0, steps=1)
    leaves = optax_leaves(state, 0.0)
    saved = {str(9995 + i): leaf for i, leaf in enumerate(leaves)}
    assert sorted(saved) != sorted(saved, key=int)  # text order permutes
    variables1 = flax_variables(state.module)
    payload = {"params": variables1["params"],
               "batch_stats": variables1["batch_stats"],
               "opt_state_leaves": saved, "step": 1}
    back = ckpt.restore_state(payload, tt.init_state(variables=variables))
    assert back.opt_state["count"] == 1
    assert torch.equal(back.opt_state["trace"], state.opt_state["trace"])


def test_write_tree_is_atomic_and_replaces(tmp_path):
    """A re-save of the same epoch replaces it (the JAX `force=True`), no
    temporary directory is left, and leaves of every dtype the format
    carries (0-d int64 step and epoch, bool, int32) round-trip through
    orbax's own reader."""
    d = str(tmp_path / "model_0001")
    tree = {"params": {"a": {"w": np.arange(6, dtype=np.float32)
                             .reshape(2, 3)}, "b": np.ones(3, np.float64)},
            "opt_state_leaves": {"0000": np.asarray(True),
                                 "0001": np.asarray(3, np.int32)},
            "step": np.asarray(5, np.int64), "epoch": np.asarray(1, np.int64)}
    orbax_io.write_tree(d, tree)
    tree["step"] = np.asarray(6, np.int64)
    orbax_io.write_tree(d, tree)
    assert os.listdir(tmp_path) == ["model_0001"]
    _leaves_equal(dict(ocp.PyTreeCheckpointer().restore(d)), tree)
    _leaves_equal(orbax_io.read_tree(d), tree)
    assert ckpt.latest_checkpoint(str(tmp_path)) == d


def test_cli_orbax_resume_equals_the_uninterrupted_run(config_dir, tmp_path,
                                                       short_epochs):
    """`--ckpt_format orbax`: two epochs straight, or one then a resume,
    give the same checkpoint bit for bit; each is an orbax directory that
    the JAX package loads; a pickle epoch written beside them is the
    newest and holds the same net."""
    fmt = ["--ckpt_format", "orbax"]
    straight = str(tmp_path / "straight")
    train_cli.main(_argv(config_dir, straight, "--total_epoch", "2", *fmt),
                   device="cpu")
    resumed = str(tmp_path / "resumed")
    train_cli.main(_argv(config_dir, resumed, "--total_epoch", "1", *fmt),
                   device="cpu")
    assert os.path.isdir(pjoin(resumed, "ckpt", "model_0000"))
    train_cli.main(_argv(config_dir, resumed, "--total_epoch", "2", *fmt),
                   device="cpu")
    a, b = _payload(straight, 1), _payload(resumed, 1)
    assert a["epoch"] == b["epoch"] == 1 and a["step"] == b["step"]
    for key in ("params", "batch_stats", "opt_state_leaves"):
        _assert_equal_trees(a[key], b[key])
    log = open(pjoin(resumed, "log", "log.txt")).read()
    assert "resumed from" in log and "(epoch 1)" in log
    j = jckpt.load_checkpoint(pjoin(straight, "ckpt", "model_0001"))
    _assert_equal_trees(j["params"], a["params"])
    assert int(j["step"]) == a["step"]
    # the formats mix under one naming: a pickle epoch beside orbax ones
    _, cfg = train_cli.parse(_argv(config_dir, resumed))
    trainer = ttrainer.Trainer(cfg, device="cpu")
    state = ckpt.restore_state(b, trainer.init_state())
    ckpt.save_train_state(pjoin(resumed, "ckpt"), 2, state)
    assert ckpt.latest_checkpoint(pjoin(resumed, "ckpt")).endswith(
        "model_0002")
    assert os.path.isfile(pjoin(resumed, "ckpt", "model_0002"))
    _assert_equal_trees(_payload(resumed, 2)["params"], a["params"])


def test_without_tensorstore_the_format_raises_naming_it(tmp_path,
                                                         monkeypatch):
    state, _, _, _ = _port_state("sgd", 0.0, steps=0)
    path = ckpt.save_train_state(str(tmp_path), 0, state, format="orbax")
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        ckpt.load_checkpoint(path)
    with pytest.raises(ImportError, match="tensorstore"):
        ckpt.save_train_state(str(tmp_path), 1, state, format="orbax")
    assert sorted(os.listdir(tmp_path)) == ["model_0000"]
    # the pickle format needs no tensorstore
    ckpt.save_train_state(str(tmp_path), 2, state)
    assert ckpt.load_checkpoint(pjoin(str(tmp_path), "model_0002"))[
        "epoch"] == 2
    jnp.zeros(())   # JAX stays usable in this process
