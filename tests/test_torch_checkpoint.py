"""The port's checkpoint reader and writer against the JAX package's
(`captra_tpu/training/checkpoint.py`), and the flax-tree converter both
ways.

A JAX checkpoint of a tiny `Trainer` state (optax Adam state inside) is read
by the port in a process where importing jax, flax, optax or orbax fails;
the nets built from it match `CoordNet.apply` / `RotNet.apply` at atol 1e-4
(the `test_torch_models.py` tolerance).  Trees that only move between the
packages (the converter's round trip, the port's checkpoint read by the JAX
package) must be equal bit for bit."""
import io
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.data.synthetic import make_frame_batch
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.models.rotnet import RotNet as JRotNet
from captra_tpu.training import checkpoint as jckpt
from captra_tpu.training.trainer import Trainer, TrainState
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.training import checkpoint as tckpt
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, flax_variables, rotnet_from_flax,
)
from tests.torch_port_helpers import cloud, perturb, tiny_config, to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
N = 128


def _trainer_state(net_type: str, obj: str = "laptop"):
    """A `Trainer`'s fresh state (`Trainer.init_state`, with the net's init
    jitted: eager flax init costs seconds a layer on the CPU)."""
    cfg = tiny_config(jschema, obj, num_points=N)
    cfg = cfg.replace(network=jschema.NetworkCfg(
        type=net_type, backbone_out_dim=32, nocs_head_dims=(16,)))
    trainer = Trainer(cfg, steps_per_epoch=10)
    batch = make_frame_batch(0, cfg.obj, batch=2, num_points=N)
    if net_type == "canon_coord":
        example = (batch["points"],)
    else:
        example = (jnp.zeros((2, cfg.obj.num_parts, N, 3)), batch["labels"])
    variables = jax.jit(lambda k: trainer.module.init(k, *example,
                                                      train=False))(
        jax.random.PRNGKey(0 if net_type == "canon_coord" else 1))
    # nontrivial BN statistics, so a reader that dropped them would show
    stats = perturb(to_numpy(variables["batch_stats"]),
                    np.random.RandomState(2))
    return cfg, TrainState(params=variables["params"], batch_stats=stats,
                           opt_state=trainer.tx.init(variables["params"]),
                           step=jnp.zeros((), jnp.int32))


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """A CoordNet and a RotNet experiment of the laptop (two parts: the
    RotNet's heads are stacked) written by the JAX package."""
    root = tmp_path_factory.mktemp("jax_ckpts")
    out = {}
    for net_type, name in (("canon_coord", "coord"), ("rot", "rot")):
        cfg, state = _trainer_state(net_type)
        d = str(root / name / "ckpt")
        jckpt.save_checkpoint(d, epoch=3, state=state)
        out[name] = (cfg, state, d)
    return out


_BLOCKED_READER = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "captra_tpu"):
    sys.modules[name] = None
import numpy as np, torch
from captra_tpu_torch.training import checkpoint as ckpt
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, rotnet_from_flax)
from tests.torch_port_helpers import tiny_config
from captra_tpu_torch.config import schema
coord_dir, rot_dir, inputs, out = sys.argv[1:5]
cv, rv = ckpt.load_track_variables(ckpt.latest_checkpoint(coord_dir),
                                   ckpt.latest_checkpoint(rot_dir))
raw = ckpt.load_checkpoint(ckpt.latest_checkpoint(rot_dir))
cfg = tiny_config(schema, "laptop", num_points={N})
x = np.load(inputs)
with torch.no_grad():
    c = coordnet_from_flax(cfg, cv, device="cpu")(torch.from_numpy(x["pts"]))
    r = rotnet_from_flax(cfg, rv, device="cpu")(
        torch.from_numpy(x["parts"]), torch.from_numpy(x["labels"]))
np.savez(out, seg=c["seg"].numpy(), nocs=c["nocs"].numpy(),
         rtvec=r["rtvec"].numpy())
bad = sorted(n for n in sys.modules if sys.modules[n] is not None
             and n.split(".")[0] in ("jax", "flax", "optax", "orbax"))
stubs = sorted({type(x).__name__ for x in raw["opt_state"]
                if isinstance(x, ckpt.InertState)})
print(len(raw["opt_state"]), ",".join(stubs), raw["step"], raw["epoch"], bad)
"""


def test_jax_checkpoint_builds_the_nets_without_jax(jax_ckpts, tmp_path):
    rng = np.random.RandomState(4)
    pts = cloud(rng, 2, N)
    parts = cloud(rng, 2, 2, N)
    labels = rng.randint(0, 2, (2, N)).astype(np.int32)
    np.savez(tmp_path / "in.npz", pts=pts, parts=parts, labels=labels)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    run = subprocess.run(
        [sys.executable, "-c", _BLOCKED_READER.replace("{N}", str(N)),
         jax_ckpts["coord"][2], jax_ckpts["rot"][2],
         str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    # every optax state came back as a stub; step and epoch as written
    n, stubs, step, epoch, bad = run.stdout.split()
    assert len(stubs.split(",")) >= 2 and "ScaleByAdamState" in stubs
    assert (step, epoch, bad) == ("0", "3", "[]")
    got = np.load(tmp_path / "out.npz")

    (ccfg, cstate, _), (rcfg, rstate, _) = (jax_ckpts["coord"],
                                            jax_ckpts["rot"])
    cvars = {"params": cstate.params, "batch_stats": cstate.batch_stats}
    rvars = {"params": rstate.params, "batch_stats": rstate.batch_stats}
    want_c = jax.jit(lambda v, x: JCoordNet(ccfg).apply(v, x, train=False))(
        cvars, jnp.asarray(pts))
    want_r = jax.jit(lambda v, x, lab: JRotNet(rcfg).apply(
        v, x, lab, train=False))(rvars, jnp.asarray(parts),
                                 jnp.asarray(labels))
    np.testing.assert_allclose(got["seg"], np.asarray(want_c["seg"]),
                               atol=ATOL)
    np.testing.assert_allclose(got["nocs"], np.asarray(want_c["nocs"]),
                               atol=ATOL)
    np.testing.assert_allclose(got["rtvec"], np.asarray(want_r["rtvec"]),
                               atol=ATOL)


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y)


def test_track_variables_equal_the_jax_reader(jax_ckpts):
    paths = [jckpt.latest_checkpoint(jax_ckpts[n][2])
             for n in ("coord", "rot")]
    for got, want in zip(tckpt.load_track_variables(*paths),
                         jckpt.load_track_variables(*paths)):
        _assert_trees_equal(got, jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("net", ["coord", "rot"])
def test_port_checkpoint_read_by_jax_bit_for_bit(net, tmp_path):
    tcfg = tiny_config(tschema, "laptop", num_points=N)
    gen = torch.Generator().manual_seed(5)
    from captra_tpu_torch.models.coordnet import CoordNet
    from captra_tpu_torch.models.rotnet import RotNet
    module = (CoordNet if net == "coord" else RotNet)(
        tcfg, device="cpu", generator=gen)
    with torch.no_grad():   # BN statistics that are not the identity
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.uniform_(-0.5, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    tree = flax_variables(module)
    path = tckpt.save_checkpoint(str(tmp_path / "ckpt"), 7, tree, step=11,
                                 extra={"note": "port"})
    assert path.endswith("model_0007")
    cv, rv = jckpt.load_track_variables(path, path)
    _assert_trees_equal(tree, jax.tree.map(np.asarray, cv))
    raw = jckpt.load_checkpoint(path)
    assert (raw["step"], raw["epoch"], raw["opt_state"],
            raw["extra"]) == (11, 7, (), {"note": "port"})


@pytest.mark.parametrize("net", ["coord", "rot"])
def test_flax_variables_round_trip(jax_ckpts, net):
    """flax tree -> port module -> flax tree, equal bit for bit (the RotNet's
    per-part heads stacked back on their [P] axis)."""
    state = jax_ckpts[net][1]
    tree = {"params": to_numpy(state.params),
            "batch_stats": to_numpy(state.batch_stats)}
    tcfg = tiny_config(tschema, "laptop")
    build = coordnet_from_flax if net == "coord" else rotnet_from_flax
    _assert_trees_equal(flax_variables(build(tcfg, tree, device="cpu")), tree)


def test_latest_and_pinned_epochs(tmp_path):
    d = str(tmp_path / "ckpt")
    tree = {"params": {"w": np.ones(2, np.float32)}, "batch_stats": {}}
    assert tckpt.latest_checkpoint(d) is None
    for e in (1, 2, 5, 10):
        tckpt.save_checkpoint(d, e, tree)
    os.makedirs(os.path.join(d, "notes"))
    open(os.path.join(d, "model_0003.tmp"), "w").close()
    assert tckpt.latest_checkpoint(d).endswith("model_0010")
    assert tckpt.latest_checkpoint(d, epoch=2).endswith("model_0002")
    assert tckpt.latest_checkpoint(d, epoch=-1).endswith("model_0010")
    assert tckpt.latest_checkpoint(d, epoch=9) is None
    for epoch in (None, 2, 9):
        assert tckpt.latest_checkpoint(d, epoch) == \
            jckpt.latest_checkpoint(d, epoch)


def test_orbax_checkpoint_raises(tmp_path):
    """An orbax checkpoint is a directory under the same naming; one whose
    metadata holds no tree raises (reading real ones:
    tests/test_torch_orbax.py)."""
    d = tmp_path / "ckpt"
    (d / "model_0002").mkdir(parents=True)
    (d / "model_0002" / "_METADATA").write_text("{}")
    path = tckpt.latest_checkpoint(str(d))
    assert path.endswith("model_0002")
    with pytest.raises(ValueError, match="orbax metadata"):
        tckpt.load_checkpoint(path)


class _Call:
    """Pickles as a call of fn(*args)."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return (self.fn, self.args)


@pytest.mark.parametrize("payload", [
    lambda tmp: _Call(os.system, "true"),
    lambda tmp: {"params": json.JSONEncoder()},
    # a memmap in mode w+ would create (or truncate) a file at any path
    lambda tmp: {"params": _Call(np.memmap, str(tmp / "made"), np.uint8,
                                 "w+", 0, (4,))},
    lambda tmp: _Call(np.load, str(tmp / "made")),
], ids=["os.system", "json", "numpy.memmap", "numpy.load"])
def test_reader_refuses_other_classes(payload, tmp_path):
    path = tmp_path / "model_0000"
    path.write_bytes(pickle.dumps(payload(tmp_path)))
    with pytest.raises(pickle.UnpicklingError, match="may not name"):
        tckpt.load_checkpoint(str(path))
    assert not (tmp_path / "made").exists()


@pytest.mark.parametrize("protocol", range(2, pickle.HIGHEST_PROTOCOL + 1))
def test_reader_reads_every_pickle_protocol(protocol, tmp_path):
    """Arrays (contiguous or not), numpy scalars and dtypes, as each pickle
    protocol writes them (protocol 5 names `_frombuffer`)."""
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "strided": np.arange(12.0).reshape(3, 4)[:, ::2],
            "i": np.arange(3, dtype=np.int32), "b": np.array([True, False]),
            "s": np.float32(2.5), "dt": np.dtype("f4")}
    path = tmp_path / "model_0000"
    path.write_bytes(pickle.dumps(tree, protocol=protocol))
    got = tckpt.load_checkpoint(str(path))
    for k in ("a", "strided", "i", "b"):
        np.testing.assert_array_equal(got[k], tree[k])
        assert got[k].dtype == tree[k].dtype
    assert got["s"] == tree["s"] and got["dt"] == tree["dt"]


def test_reader_maps_numpy_core_spellings(monkeypatch):
    """A pickle naming numpy's core package in the other spelling (numpy
    before 2.0 wrote `numpy.core`) loads all the same."""
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    # protocol 2 names classes as "module\nname\n" text, so the module can
    # be respelled in place
    new = pickle.dumps({"a": arr, "s": np.float32(2.5)}, protocol=2)
    assert b"numpy._core" in new
    old = new.replace(b"numpy._core", b"numpy.core")
    for data in (new, old):
        got = tckpt._CheckpointUnpickler(io.BytesIO(data)).load()
        np.testing.assert_array_equal(got["a"], arr)
        assert got["s"] == np.float32(2.5)
    monkeypatch.setattr(tckpt.importlib.util, "find_spec", lambda name: None)
    assert tckpt._numpy_module("numpy._core.multiarray") == \
        "numpy.core.multiarray"
    assert tckpt._numpy_module("numpy") == "numpy"
