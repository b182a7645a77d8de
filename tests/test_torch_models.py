"""Port networks vs the flax reference: the same flax variables (converted
with captra_tpu_torch.training.convert) on the same seeded cloud.

Tolerance atol 1e-4: float32 matmuls sum in another order, and flax's
GroupNorm fast variance (E[x^2] - E[x]^2) rounds differently from any
re-association of it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.models.backbone import PointNet2Msg as JPointNet2Msg
from captra_tpu.models.blocks import PointMLP as JPointMLP
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.models.rotnet import RotNet as JRotNet
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.models.backbone import PointNet2Msg
from captra_tpu_torch.models.blocks import PointMLP
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, load_flax_variables, rotnet_from_flax,
)
from tests.torch_port_helpers import cloud, perturb, tiny_config, to_numpy

ATOL = 1e-4
N = 128


def _variables(module, *args, seed=0):
    v = to_numpy(module.init(jax.random.PRNGKey(seed), *args, train=False))
    return perturb(v, np.random.RandomState(seed + 1))


@pytest.mark.parametrize("norm", ["bn", "gn", "none"])
def test_point_mlp_matches_flax(norm):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 8, 6).astype(np.float32)
    jm = JPointMLP((8, 16, 4), norm=norm, final_acti="relu", last_norm=True)
    v = _variables(jm, jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    pm = load_flax_variables(
        PointMLP(6, (8, 16, 4), norm=norm, final_acti="relu",
                 last_norm=True).eval(), v)
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("use_xyz_feat", [True, False])
@pytest.mark.parametrize("norm", ["bn", "gn"])
def test_pointnet2msg_matches_flax(norm, use_xyz_feat):
    cfg = tiny_config(jschema, norm=norm)
    xyz = cloud(np.random.RandomState(2), 2, N)
    jm = JPointNet2Msg(cfg.pointnet, 32, use_xyz_feat=use_xyz_feat,
                       norm=norm)
    v = _variables(jm, jnp.asarray(xyz))
    want = np.asarray(jm.apply(v, jnp.asarray(xyz), train=False))
    pm = load_flax_variables(
        PointNet2Msg(tiny_config(tschema, norm=norm).pointnet, 32,
                     use_xyz_feat=use_xyz_feat, norm=norm).eval(), v)
    got = pm(torch.from_numpy(xyz)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("norm", ["bn", "gn"])
@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_coordnet_matches_flax(obj, norm):
    jcfg, tcfg = tiny_config(jschema, obj, norm), tiny_config(tschema, obj,
                                                               norm)
    pts = cloud(np.random.RandomState(3), 2, N)
    jm = JCoordNet(jcfg)
    v = _variables(jm, jnp.asarray(pts))
    want = jm.apply(v, jnp.asarray(pts), train=False)
    net = coordnet_from_flax(tcfg, v, device="cpu")
    got = net(torch.from_numpy(pts))
    for k in ("seg", "nocs"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=ATOL)


@pytest.mark.parametrize("norm", ["bn", "gn"])
@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_rotnet_matches_flax(obj, norm):
    """rtvec (the masked mean the tracker decodes) and each part's raw head
    output at atol 1e-4, plus the per-point unit y-vectors for the sym
    category.  The non-sym per-point 6D -> matrix decode is not compared
    point by point: on random weights some points have nearly parallel 6D
    halves, where the decode amplifies any float32 rounding ~1/angle in
    both packages alike.  Flax-initialised weights: seeded BN statistics
    make near-constant GroupNorm groups in the heads, where flax's fast
    variance alone is off by more than the tolerance."""
    jcfg, tcfg = tiny_config(jschema, obj, norm), tiny_config(tschema, obj,
                                                               norm)
    rng = np.random.RandomState(4)
    P = jcfg.obj.num_parts
    parts = cloud(rng, 2, P, N)
    labels = rng.randint(0, P + 1, (2, N))  # label P selects no part
    labels[1] = 0                           # part 1 empty in cloud 1
    jm = JRotNet(jcfg)
    v = to_numpy(jm.init(jax.random.PRNGKey(0), jnp.asarray(parts),
                         jnp.asarray(labels), train=False))
    want = jm.apply(v, jnp.asarray(parts), jnp.asarray(labels), train=False)
    net = rotnet_from_flax(tcfg, v, device="cpu")
    got = net(torch.from_numpy(parts), torch.from_numpy(labels))
    np.testing.assert_allclose(got["rtvec"].detach().numpy(),
                               np.asarray(want["rtvec"]), atol=ATOL)
    if jcfg.obj.sym:
        np.testing.assert_allclose(got["point_rtvec"].detach().numpy(),
                                   np.asarray(want["point_rtvec"]),
                                   atol=ATOL)

    # the stacked [P, ...] head parameters: part p's head on part p's
    # encoder features
    feat = net.encoder(torch.from_numpy(parts.reshape(2 * P, N, 3)))
    feat = feat.reshape(2, P, N, -1)
    head = JPointMLP((512, 512, 256, 3 if jcfg.obj.sym else 6), norm="gn")
    heads = v["params"]["regressor"]["heads"]
    for p in range(P):
        hv = {"params": jax.tree.map(lambda x, p=p: x[p], heads)}
        f = feat[:, p].detach().numpy()
        np.testing.assert_allclose(
            net.regressor.heads[p](feat[:, p]).detach().numpy(),
            np.asarray(head.apply(hv, jnp.asarray(f))), atol=ATOL)


def test_converter_rejects_mismatched_tree():
    jcfg, tcfg = tiny_config(jschema, "laptop"), tiny_config(tschema,
                                                             "bottle")
    pts = cloud(np.random.RandomState(5), 1, N)
    v = _variables(JCoordNet(jcfg), jnp.asarray(pts))
    with pytest.raises(ValueError):
        coordnet_from_flax(tcfg, v, device="cpu")
