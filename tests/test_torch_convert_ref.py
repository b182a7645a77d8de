"""The reference's torch checkpoints through the port's reader
(`captra_tpu_torch/training/convert.py`: `load_torch_state_dict`,
`convert_backbone`, `convert_coordnet`, `convert_rotnet`,
`convert_track_checkpoint`) against the JAX package's converters.

State dicts in the reference's layout come from
`tests/torch_port_helpers.py` (`reference_coordnet_sd`,
`reference_rotnet_sd`): the PointNet++ backbone as tests/test_convert.py's
`_fake_backbone_sd` lays it out, the seg / NOCS heads and the per-part
rotation heads by their Sequential indices, weights scaled by
1/sqrt(fan-in) so a forward stays in range.  The
trees must be equal bit for bit; the port's nets holding them must match
the JAX modules on the same input within 1e-5, both in float64 (the JAX
ones under `jax.enable_x64`), where flax's E[x^2] - E[x]^2 GroupNorm
variance is exact enough to see a wrong mean; a checkpoint naming a class
is refused (`torch.load(weights_only=True)`)."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.models.rotnet import RotNet as JRotNet
from captra_tpu.training import convert as jconvert
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.training import convert as tconvert
from tests.test_convert import _fake_backbone_sd
from tests.torch_port_helpers import (
    assert_tree_equal, reference_backbone_sd, reference_coordnet_sd,
    reference_rotnet_sd, reference_track_state_dict, tiny_config,
)

N = 64
NET_TOL = 1e-5


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def test_reference_backbone_layout_is_test_converts():
    for obj, in_dim in (("bottle", 3), ("laptop", 0)):
        pn = tiny_config(tschema, obj).pointnet
        want = _fake_backbone_sd({}, "net.backbone", pn, in_dim)
        got = reference_backbone_sd("net.backbone", pn, in_dim,
                                    np.random.RandomState(0))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), k


CASES = [("coordnet", "bottle"), ("coordnet", "laptop"),
         ("rotnet", "bottle"), ("rotnet", "laptop")]


@pytest.mark.parametrize("net,obj", CASES,
                         ids=["-".join(c) for c in CASES])
def test_converted_trees_equal_jax(net, obj):
    """CoordNet of the symmetric bottle and the laptop; RotNet of 1 and 2
    parts."""
    tcfg, jcfg = tiny_config(tschema, obj), tiny_config(jschema, obj)
    build = (reference_coordnet_sd if net == "coordnet" else
             reference_rotnet_sd)
    sd = _np(build(tcfg, "net", seed=1))
    got = getattr(tconvert, f"convert_{net}")(sd, tcfg)
    want = jax.tree.map(np.asarray, getattr(jconvert, f"convert_{net}")(
        sd, jcfg))
    assert_tree_equal(got, want)
    # every parameter and statistic of the port's net is covered
    module = (tconvert.coordnet_from_flax if net == "coordnet" else
              tconvert.rotnet_from_flax)(tcfg, got, device="cpu")
    assert module is not None


def _composed(path, obj, extra=None):
    cfg = tiny_config(tschema, obj)
    sd = reference_track_state_dict(cfg, seed=2)
    ckpt = {"epoch": 5, "iteration": 1200, "model": sd,
            "optimizer": {"state": {}, "param_groups": [
                {"lr": 1e-3, "betas": (0.9, 0.999), "params": [0, 1]}]}}
    ckpt.update(extra or {})
    torch.save(ckpt, path)
    return sd


_NETS = {}


def _track_checkpoint(tmp_path_factory, obj):
    if obj not in _NETS:
        path = str(tmp_path_factory.mktemp("ref") / "ckpt.pt")
        sd = _composed(path, obj)
        _NETS[obj] = (path, sd)
    return _NETS[obj]


@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_track_checkpoint_round_trips(tmp_path_factory, obj):
    path, sd = _track_checkpoint(tmp_path_factory, obj)
    tcfg, jcfg = tiny_config(tschema, obj), tiny_config(jschema, obj)
    got = tconvert.load_torch_state_dict(path)
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.numpy().dtype
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    coord, rot = tconvert.convert_track_checkpoint(path, tcfg)
    jcoord, jrot = jconvert.convert_track_checkpoint(path, jcfg)
    assert_tree_equal(coord, jax.tree.map(np.asarray, jcoord))
    assert_tree_equal(rot, jax.tree.map(np.asarray, jrot))
    # a bare state dict (no {"model": ...} wrapper) reads the same
    bare = os.path.join(os.path.dirname(path), "bare.pt")
    torch.save(sd, bare)
    assert_tree_equal(tconvert.convert_track_checkpoint(bare, tcfg)[0], coord)


def _f64(tree):
    return jax.tree.map(lambda x: x.astype(np.float64) if np.issubdtype(
        x.dtype, np.floating) else x, tree)


@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_converted_nets_match_jax_modules(tmp_path_factory, obj):
    path, _ = _track_checkpoint(tmp_path_factory, obj)
    tcfg, jcfg = tiny_config(tschema, obj), tiny_config(jschema, obj)
    cv, rv = map(_f64, tconvert.convert_track_checkpoint(path, tcfg))
    P = tcfg.obj.num_parts
    rng = np.random.RandomState(4)
    x = rng.randn(2, N, 3) * 0.3
    parts = rng.randn(2, P, N, 3) * 0.3
    labels = rng.randint(0, P, (2, N))
    with jax.enable_x64(True):
        want, wrot = jax.jit(lambda cv, rv, x, parts, labels: (
            JCoordNet(jcfg).apply(cv, x, train=False),
            JRotNet(jcfg).apply(rv, parts, labels, train=False)))(
                cv, rv, x, parts, jnp.asarray(labels, jnp.int32))
        want, wrot = jax.tree.map(np.asarray, (want, wrot))
    with torch.no_grad():
        got = tconvert.coordnet_from_flax(tcfg, cv, device="cpu").double(
            ).eval()(torch.from_numpy(x))
        grot = tconvert.rotnet_from_flax(tcfg, rv, device="cpu").double(
            ).eval()(torch.from_numpy(parts), torch.from_numpy(labels))
    for name, g, w in (("coord", got, want), ("rot", grot, wrot)):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k],
                                       rtol=0, atol=NET_TOL,
                                       err_msg=f"{name} {k}")


class _Planted:
    """Unpickling it would create a directory."""

    def __init__(self, target):
        self.target = target

    def __reduce__(self):
        return (os.makedirs, (self.target,))


def test_checkpoint_naming_a_class_is_refused(tmp_path):
    target = str(tmp_path / "created_by_unpickling")
    path = str(tmp_path / "planted.pt")
    cfg = tiny_config(tschema, "bottle")
    _composed(path, "bottle", extra={"note": _Planted(target)})
    with pytest.raises(pickle.UnpicklingError, match="Weights only"):
        tconvert.load_torch_state_dict(path)
    with pytest.raises(pickle.UnpicklingError):
        tconvert.convert_track_checkpoint(path, cfg)
    assert not os.path.exists(target)
