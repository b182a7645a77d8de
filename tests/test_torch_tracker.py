"""The port's tracking slice as a whole against the JAX tracker: the same
synthetic trajectory (captra_tpu.data.synthetic, B=2, N=256, T=4), the same
flax weights converted into the port, poses of every tracked frame compared.

Rotation and translation at atol 1e-4, scale at rtol 1e-4, predicted labels
exactly.  Both runs are deterministic on the CPU, so a point that sits on a
ball-query radius in one package and not the other would fail every run,
not some."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.data.synthetic import (
    batch_trajectories as jbatch, make_trajectory as jmake,
)
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.models.rotnet import RotNet as JRotNet
from captra_tpu.pose.part_dof import Pose as JPose
from captra_tpu.tracking import tracker as jtracker
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.data import synthetic as tsynthetic
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking.tracker import (
    make_track_step, track_trajectory,
)
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, rotnet_from_flax,
)
from tests.torch_port_helpers import tiny_config, to_numpy

B, N, T = 2, 256, 4


def _track_both(obj: str, gt_label: bool = False):
    jcfg, tcfg = tiny_config(jschema, obj, num_points=N), tiny_config(
        tschema, obj, num_points=N)
    if gt_label:
        jcfg = jcfg.replace(track=jschema.TrackCfg(init_frame_gt=True,
                                                   gt_label=True))
        tcfg = tcfg.replace(track=tschema.TrackCfg(init_frame_gt=True,
                                                   gt_label=True))
    data = jbatch([jmake(seed=s, obj=jcfg.obj, num_frames=T, num_points=N)
                   for s in range(B)])
    P = jcfg.obj.num_parts
    coord, rotn = JCoordNet(jcfg), JRotNet(jcfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    cv = to_numpy(coord.init(k1, jnp.zeros((1, N, 3)), train=False))
    rv = to_numpy(rotn.init(k2, jnp.zeros((1, P, N, 3)),
                            jnp.zeros((1, N), jnp.int32), train=False))
    gt = data["pose"]
    frames = {"points": data["points"], "labels": data["labels"]}

    jstep = jtracker.make_track_step(
        jcfg, lambda p: coord.apply(cv, p, train=False),
        lambda p, lab: rotn.apply(rv, p, lab, train=False))
    init = JPose(rotation=gt.rotation[0], translation=gt.translation[0],
                 scale=gt.scale[0])
    _, jaux = jax.jit(lambda ip, fr: jtracker.track_trajectory(
        jstep, ip, fr))(init, frames)

    step = make_track_step(tcfg, coordnet_from_flax(tcfg, cv, device="cpu"),
                           rotnet_from_flax(tcfg, rv, device="cpu"),
                           device="cpu")
    tinit = Pose(*(torch.tensor(np.asarray(x)[0]) for x in
                   (gt.rotation, gt.translation, gt.scale)))
    _, aux = track_trajectory(
        step, tinit, {k: np.array(v) for k, v in frames.items()},
        device="cpu")
    return jaux, aux


@pytest.mark.parametrize("obj,gt_label", [("bottle", False),
                                          ("laptop", False),
                                          ("laptop", True)])
def test_tracked_trajectory_matches_jax(obj, gt_label):
    jaux, aux = _track_both(obj, gt_label)
    assert aux.pose.rotation.shape == (T - 1, B) + jaux.pose.rotation.shape[2:]
    np.testing.assert_array_equal(aux.pred_labels.numpy(),
                                  np.asarray(jaux.pred_labels))
    np.testing.assert_allclose(aux.pose.rotation.numpy(),
                               np.asarray(jaux.pose.rotation), atol=1e-4)
    np.testing.assert_allclose(aux.pose.translation.numpy(),
                               np.asarray(jaux.pose.translation), atol=1e-4)
    np.testing.assert_allclose(aux.pose.scale.numpy(),
                               np.asarray(jaux.pose.scale), rtol=1e-4)


@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_synthetic_trajectory_matches_jax(obj):
    """The port's numpy generator draws the JAX package's numbers."""
    cfg = tiny_config(jschema, obj)
    want = jmake(seed=3, obj=cfg.obj, num_frames=T, num_points=N)
    got = tsynthetic.make_trajectory(3, tiny_config(tschema, obj).obj,
                                     num_frames=T, num_points=N)
    for name in ("points", "labels", "nocs", "corners"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want, name)))
    for name in ("rotation", "translation", "scale"):
        np.testing.assert_array_equal(getattr(got, name),
                                      np.asarray(getattr(want.pose, name)))
