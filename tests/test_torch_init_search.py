"""The port's GT-less frame-0 init against the JAX package: the basin head
through `training/convert.py`, and `search_init_orientation` with the mode
scorer (tau > 0 and tau <= 0) and the basin scorer, on a tiny CoordNet with
the same converted flax weights and frame 0 of a synthetic trajectory, from
`init_pose_from_cloud`'s guess.

Both packages get the same two edits of the random weights: the NOCS
head's last layer scaled by NOCS_GAIN (as tests/test_torch_otf.py does; a
larger gain saturates the sigmoid, and the absolute fits then place the
laptop's parts far outside the cloud, where they are ill-conditioned),
and SEG_BIAS added to the seg head's part logits (a random head labels the
bottle's cloud background, every candidate is then degenerate and the
search returns its guess).

The chosen poses agree within 1e-4 (rotation and translation atol, scale
rtol), and the candidate sets within 2e-7."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.data.synthetic import make_trajectory as jmake
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.pose import rotations as jrot
from captra_tpu.tracking import tracker as jtracker
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.tracking import tracker as ttracker
from captra_tpu_torch.training.convert import coordnet_from_flax
from tests.torch_port_helpers import cloud, perturb, tiny_config, to_numpy

N = 128
NOCS_GAIN = 30.0
SEG_BIAS = 3.0


def _configs(obj: str, basin: bool = False, **track):
    out = []
    for s in (jschema, tschema):
        cfg = tiny_config(s, obj, num_points=N)
        out.append(cfg.replace(
            network=dataclasses.replace(cfg.network, basin_head=basin),
            track=dataclasses.replace(cfg.track, **track)))
    return out


def _coordnet(jcfg, seed: int = 0):
    jm = JCoordNet(jcfg)
    v = to_numpy(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, N, 3)),
                         train=False))
    v = perturb(v, np.random.RandomState(seed + 1))
    head = v["params"]["nocs_head"]["dense_1"]
    head["kernel"] = head["kernel"] * np.float32(NOCS_GAIN)
    seg = v["params"]["seg_head"]["dense_0"]
    seg["bias"][:jcfg.obj.num_parts] += np.float32(SEG_BIAS)
    return jm, v


@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_basin_head_matches_flax(obj):
    """The basin logit at atol 1e-5, seg and NPCS as without the head
    (atol 1e-4, tests/test_torch_models.py)."""
    jcfg, tcfg = _configs(obj, basin=True)
    jm, v = _coordnet(jcfg)
    assert "basin_fc1" in v["params"] and "basin_fc2" in v["params"]
    pts = cloud(np.random.RandomState(3), 3, N)
    want = jm.apply(v, jnp.asarray(pts), train=False)
    net = coordnet_from_flax(tcfg, v, device="cpu")
    got = net(torch.from_numpy(pts))
    assert got["basin"].shape == (3,)
    np.testing.assert_allclose(got["basin"].detach().numpy(),
                               np.asarray(want["basin"]), atol=1e-5)
    for k in ("seg", "nocs"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=1e-4)


@pytest.mark.parametrize("K,sym", [(7, True), (7, False), (1, True)])
def test_search_candidates_match_jax(K, sym):
    """`init_candidates` equals the JAX search's candidate set
    (tracker.py:212-221), rows exact to 1 ulp."""
    want = jnp.eye(3, dtype=jnp.float32)[None]
    if K > 1:
        extra = (jtracker._rots_y_to(jtracker._fibonacci_sphere(K - 1))
                 if sym else jrot.quat_to_matrix(
                     jtracker._super_fibonacci_quats(K - 1)))
        want = jnp.concatenate([want, extra], 0)
    got = ttracker.init_candidates(K, sym)
    assert got.dtype == torch.float32 and got.shape == (K, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-7)


# (object, K, track overrides): the mode scorer with tau > 0 and tau <= 0,
# and the basin scorer; K = 65 at B = 2 runs two chunks of 64 candidates,
# the second padded with 63 copies of candidate 0
SEARCHES = {
    "bottle_mode": ("bottle", 9, dict(init_search_tau=10.0)),
    "laptop_mode": ("laptop", 9, dict(init_search_tau=20.0)),
    "bottle_residual": ("bottle", 9, dict(init_search_tau=0.0)),
    "laptop_residual": ("laptop", 9, dict(init_search_tau=-1.0)),
    "bottle_basin": ("bottle", 9, dict(init_search_scorer="basin")),
    "bottle_mode_chunks": ("bottle", 65, dict(init_search_tau=10.0,
                                              init_search_steps=1)),
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_search_init_orientation_matches_jax(name):
    obj, K, track = SEARCHES[name]
    basin = track.get("init_search_scorer") == "basin"
    jcfg, tcfg = _configs(obj, basin=basin, init_search=K, **track)
    jm, v = _coordnet(jcfg)
    B = 2
    pts = np.stack([np.asarray(jmake(seed=20 + b, obj=jcfg.obj, num_frames=1,
                                     num_points=N).points[0])
                    for b in range(B)])
    P = jcfg.obj.num_parts
    jinit = jtracker.init_pose_from_cloud(jnp.asarray(pts), P)
    want = jax.jit(lambda p, ip: jtracker.search_init_orientation(
        lambda c: jm.apply(v, c, train=False), p, ip, jcfg))(
        jnp.asarray(pts), jinit)

    tinit = ttracker.init_pose_from_cloud(pts, P, device="cpu")
    got = ttracker.search_init_orientation(
        coordnet_from_flax(tcfg, v, device="cpu"), pts, tinit, tcfg,
        device="cpu")
    assert got.rotation.shape == (B, P, 3, 3)
    # a search that changed nothing would pass against a search that did
    # the same; the guess is the identity
    assert not np.allclose(np.asarray(want.rotation),
                           np.asarray(jinit.rotation), atol=1e-3)
    np.testing.assert_allclose(got.rotation.numpy(),
                               np.asarray(want.rotation), atol=1e-4)
    np.testing.assert_allclose(got.translation.numpy(),
                               np.asarray(want.translation), atol=1e-4)
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-4)


def test_basin_scorer_needs_the_head():
    _, tcfg = _configs("bottle", init_search=3,
                       init_search_scorer="basin")
    net = ttracker_coordnet(tcfg)
    pts = cloud(np.random.RandomState(4), 1, N) + np.float32(1.0)
    with pytest.raises(ValueError, match="basin_head"):
        ttracker.search_init_orientation(
            net, pts, ttracker.init_pose_from_cloud(pts, 1, device="cpu"),
            tcfg, device="cpu")


def ttracker_coordnet(tcfg):
    from captra_tpu_torch.models.coordnet import CoordNet
    return CoordNet(tcfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
