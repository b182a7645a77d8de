"""The port's tracking opt-ins against the JAX tracker: the same synthetic
trajectories (captra_tpu.data.synthetic, B=2, N=256, T=4), the same flax
weights converted into the port, on the NOCS bottle (one symmetric part)
and the SAPIEN laptop (two parts), poses of every tracked frame compared.

Rotation and translation at atol 1e-4, scale at rtol 1e-4, predicted labels
exactly, as in tests/test_torch_tracker.py.  Random nets predict NPCS with
a tiny spread, which the fits divide by; both packages get the NOCS head's
last layer scaled by NOCS_GAIN (as tests/test_torch_otf.py does), so a
1-ulp difference is not amplified past the tolerance.

`fit_ransac`'s draws are the JAX step's own: `jax.random.gumbel` on
PRNGKey(13) folded with the frame key (tracker.py:442-446), split at
rotnet.py:173 into the absolute solve's and the s/t fit's when `rot_fit` is
not "delta", fed to the port as frame["gumbel_rot"] / frame["gumbel_fit"].
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.config import get_config as jget_config
from captra_tpu.config import schema as jschema
from captra_tpu.data.synthetic import (
    batch_trajectories as jbatch, make_trajectory as jmake,
)
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.models.rotnet import RotNet as JRotNet
from captra_tpu.pose import procrustes as jprocrustes
from captra_tpu.pose import rotations as jrot
from captra_tpu.pose.part_dof import Pose as JPose
from captra_tpu.tracking import tracker as jtracker
from captra_tpu_torch.config import get_config, schema as tschema
from captra_tpu_torch.config.presets import nocs_bottle, nocs_bottle_overrides
from captra_tpu_torch.pose import procrustes as tprocrustes
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking.tracker import (
    TrackAux, make_track_step, track_trajectory,
)
from captra_tpu_torch.tracking.tracker import (
    evaluate_track as tevaluate_track,
    init_pose_from_cloud as tinit_pose_from_cloud,
    init_pose_from_gt as tinit_pose_from_gt,
)
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, rotnet_from_flax,
)
from tests.torch_port_helpers import jax_pose_noise, tiny_config, to_numpy

B, N, T = 2, 256, 4
NOCS_GAIN = 100.0
HYPS = 8
# track_cfg overrides of each case; "best" is resolved by each package's
# loader from `quality_profile: best`
CASES = {
    "best": None,
    "refine_forward": dict(refine_iters=2, refine_mode="forward"),
    "refine_debias": dict(refine_iters=2, refine_mode="debias"),
    "fused": dict(rot_fit="fused", rot_fit_alpha=0.3),
    "stacked": dict(conf_weighted_delta=True, delta_gain=1.5,
                    scale_clamp=0.05, motion_model="const_vel"),
    "ransac": dict(fit_ransac=HYPS),
    "ransac_npcs": dict(fit_ransac=HYPS, rot_fit="npcs"),
    "ransac_fused": dict(fit_ransac=HYPS, rot_fit="fused",
                         fit_ransac_th=0.05),
}
_OBJ = {"bottle": ("obj_info_nocs.yml", "1"),
        "laptop": ("obj_info_sapien.yml", "laptop")}


def _best_track(get_config_fn, obj: str):
    """track_cfg of `quality_profile: best` as a package's loader resolves
    it for `obj`."""
    path, category = _OBJ[obj]
    return get_config_fn("config_track.yml", overrides={
        "obj_config": path, "obj_category": category,
        "track_cfg/quality_profile": "best"}).track


@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_best_profile_resolves_as_in_jax(obj):
    """`quality_profile: best` gives the same track_cfg in both loaders
    (rigid: npcs + 3 forward passes; articulated: npcs), and the code-built
    bottle equals the loaded one."""
    want = _best_track(jget_config, obj)
    got = _best_track(get_config, obj)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.rot_fit == "npcs"
    assert got.refine_iters == (3 if obj == "bottle" else 1)
    if obj == "bottle":
        built = nocs_bottle(quality_profile="best")
        assert built == get_config("config_track.yml",
                                   overrides=nocs_bottle_overrides(
                                       quality_profile="best"))
        assert dataclasses.replace(built.track, init_frame_gt=False) == got


def _configs(obj: str, case: str):
    jcfg = tiny_config(jschema, obj, num_points=N)
    tcfg = tiny_config(tschema, obj, num_points=N)
    if CASES[case] is None:
        jt = _best_track(jget_config, obj)
        tt = _best_track(get_config, obj)
        jt, tt = (dataclasses.replace(t, init_frame_gt=True)
                  for t in (jt, tt))
    else:
        jt = dataclasses.replace(jcfg.track, **CASES[case])
        tt = dataclasses.replace(tcfg.track, **CASES[case])
    if obj == "laptop":
        jt, tt = (dataclasses.replace(t, gt_label=True) for t in (jt, tt))
    return jcfg.replace(track=jt), tcfg.replace(track=tt)


def jax_gumbel_draws(track, T: int, B: int, P: int, N: int) -> dict:
    """The RANSAC draws the JAX step makes on frames keyed 0..T-1, stacked
    [T, B, P, hyps, N]."""
    shape = (B, P, track.fit_ransac, N)
    rot, fit = [], []
    for t in range(T):
        key = jax.random.fold_in(jax.random.PRNGKey(13), t)
        if track.rot_fit != "delta":
            kr, key = jax.random.split(key)
            rot.append(np.asarray(jax.random.gumbel(kr, shape)))
        fit.append(np.asarray(jax.random.gumbel(key, shape)))
    out = {"gumbel_fit": np.stack(fit)}
    if rot:
        out["gumbel_rot"] = np.stack(rot)
    return out


def _to_port(carry):
    """A JAX step's carry (a Pose, or the motion model's tuple) as the
    port's."""
    if isinstance(carry, tuple):
        return (_to_port(carry[0]),) + tuple(
            torch.from_numpy(np.array(x)) for x in carry[1:])
    return Pose(*(torch.from_numpy(np.array(getattr(carry, f)))
                  for f in ("rotation", "translation", "scale")))


def _jax_poses(jcfg, data, cv, rv, shift: float = 0.0):
    """The JAX step frame by frame from the GT init, its translation moved
    by `shift`; returns (carries, auxes)."""
    coord, rotn = JCoordNet(jcfg), JRotNet(jcfg)
    jstep = jtracker.make_track_step(
        jcfg, lambda p: coord.apply(cv, p, train=False),
        lambda p, lab: rotn.apply(rv, p, lab, train=False))
    gt = data["pose"]
    carry = JPose(rotation=gt.rotation[0],
                  translation=gt.translation[0] + np.float32(shift),
                  scale=gt.scale[0])
    if hasattr(jstep, "init_carry"):
        carry = jstep.init_carry(carry)
    run = jax.jit(jstep)
    carries, jauxs = [carry], []
    for t in range(1, T):
        carry, jaux = run(carry, {
            "key": jnp.int32(t), "points": jnp.asarray(data["points"][t]),
            "labels": jnp.asarray(data["labels"][t])})
        carries.append(carry)
        jauxs.append(jaux)
    return carries, jauxs


def _weights(jcfg):
    """Flax variables of both nets from PRNGKey(0), the NOCS head's last
    layer scaled by NOCS_GAIN."""
    P = jcfg.obj.num_parts
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    cv = to_numpy(JCoordNet(jcfg).init(k1, jnp.zeros((1, N, 3)),
                                       train=False))
    head = cv["params"]["nocs_head"]["dense_1"]
    head["kernel"] = head["kernel"] * np.float32(NOCS_GAIN)
    rv = to_numpy(JRotNet(jcfg).init(k2, jnp.zeros((1, P, N, 3)),
                                      jnp.zeros((1, N), jnp.int32),
                                      train=False))
    return cv, rv


def _data(jcfg):
    return jbatch([jmake(seed=s, obj=jcfg.obj, num_frames=T, num_points=N)
                   for s in range(B)])


def test_laptop_third_frame_is_chaotic_in_jax():
    """Why FREE_FRAMES stops at two on the laptop: with refine_iters=2
    debias and rot_fit fused together, moving the JAX package's own init
    translation by 1e-6 moves its first two tracked rotations by less than
    this file's tolerance, 1e-4, and its third by more."""
    jcfg = tiny_config(jschema, "laptop", num_points=N)
    jcfg = jcfg.replace(track=dataclasses.replace(
        jcfg.track, gt_label=True, refine_iters=2, refine_mode="debias",
        rot_fit="fused", rot_fit_alpha=0.3))
    data = _data(jcfg)
    cv, rv = _weights(jcfg)
    _, a = _jax_poses(jcfg, data, cv, rv)
    _, b = _jax_poses(jcfg, data, cv, rv, shift=1e-6)
    moved = [float(np.abs(np.asarray(x.pose.rotation)
                          - np.asarray(y.pose.rotation)).max())
             for x, y in zip(a, b)]
    assert max(moved[:2]) < 1e-4 < moved[2], moved


def _track_both(obj: str, case: str):
    """The JAX step over the trajectory frame by frame, and the port's step
    both free-running from the same init and from the JAX carry before each
    frame.  Returns, per tracked frame, (JAX aux, free-running port aux,
    port aux from the JAX carry)."""
    jcfg, tcfg = _configs(obj, case)
    data = _data(jcfg)
    P = jcfg.obj.num_parts
    cv, rv = _weights(jcfg)
    carries, jauxs = _jax_poses(jcfg, data, cv, rv)

    gt = data["pose"]
    frames = {"points": np.asarray(data["points"]),
              "labels": np.asarray(data["labels"])}
    if tcfg.track.fit_ransac:
        frames.update(jax_gumbel_draws(tcfg.track, T, B, P, N))
    step = make_track_step(tcfg, coordnet_from_flax(tcfg, cv, device="cpu"),
                           rotnet_from_flax(tcfg, rv, device="cpu"),
                           device="cpu")
    tinit = Pose(*(torch.tensor(np.asarray(x)[0]) for x in
                   (gt.rotation, gt.translation, gt.scale)))
    _, free = track_trajectory(step, tinit, frames, device="cpu")
    forced = [step(_to_port(carries[t - 1]),
                   {k: torch.from_numpy(v[t]) for k, v in frames.items()})[1]
              for t in range(1, T)]
    return jauxs, [_frame(free, t) for t in range(T - 1)], forced


def _frame(aux: TrackAux, t: int) -> TrackAux:
    return TrackAux(pose=aux.pose[t], pred_labels=aux.pred_labels[t],
                    seg=aux.seg[t], nocs=aux.nocs[t])


def assert_frame_matches(jaux, aux, where: str):
    np.testing.assert_array_equal(aux.pred_labels.numpy(),
                                  np.asarray(jaux.pred_labels), err_msg=where)
    for f in ("rotation", "translation", "scale"):
        assert torch.isfinite(getattr(aux.pose, f)).all(), (where, f)
    np.testing.assert_allclose(aux.pose.rotation.numpy(),
                               np.asarray(jaux.pose.rotation), atol=1e-4,
                               err_msg=where)
    np.testing.assert_allclose(aux.pose.translation.numpy(),
                               np.asarray(jaux.pose.translation), atol=1e-4,
                               err_msg=where)
    np.testing.assert_allclose(aux.pose.scale.numpy(),
                               np.asarray(jaux.pose.scale), rtol=1e-4,
                               err_msg=where)


# tracked frames over which the free-running trajectories are compared: all
# on the bottle, the first two on the laptop, whose third frame the random
# nets put where the JAX package itself is chaotic
# (test_laptop_third_frame_is_chaotic_in_jax): there the port is held step
# by step, from the JAX carry
FREE_FRAMES = {"bottle": T - 1, "laptop": 2}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("obj", ["bottle", "laptop"])
def test_opt_in_trajectory_matches_jax(obj, case):
    jauxs, free, forced = _track_both(obj, case)
    assert free[0].pose.rotation.shape == jauxs[0].pose.rotation.shape
    for t in range(T - 1):
        assert_frame_matches(jauxs[t], forced[t],
                             f"tracked frame {t + 1} from the JAX carry")
    for t in range(FREE_FRAMES[obj]):
        assert_frame_matches(jauxs[t], free[t],
                             f"tracked frame {t + 1} free-running")


# ---------------------------------------------------------------------------
# the functions alone
# ---------------------------------------------------------------------------

def _fit_problem(seed: int, B=2, P=2, N=64, outliers=0.3):
    """NPCS source, camera target = s R src + t with noise and outliers, a
    part mask with holes; float32 numpy."""
    rng = np.random.RandomState(seed)
    src = rng.uniform(-0.5, 0.5, (B, P, N, 3)).astype(np.float32)
    q = rng.randn(B, P, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.asarray(jrot.quat_to_matrix(jnp.asarray(q, jnp.float32)))
    s = rng.uniform(0.1, 0.3, (B, P, 1, 1)).astype(np.float32)
    t = rng.randn(B, P, 1, 3).astype(np.float32) * 0.2
    tgt = s * (src @ np.swapaxes(R, -1, -2)) + t
    tgt += rng.randn(*tgt.shape).astype(np.float32) * 0.002
    bad = rng.rand(B, P, N) < outliers
    tgt[bad] += rng.randn(int(bad.sum()), 3).astype(np.float32) * 0.1
    mask = (rng.rand(B, P, N) < 0.8).astype(np.float32)
    return src, tgt.astype(np.float32), mask, R.astype(np.float32)


def _jax_ransac(monkeypatch, gumbel, *args, **kwargs):
    """The JAX function on the given Gumbel draws (its one `jax.random`
    call answered with them)."""
    monkeypatch.setattr(jax.random, "gumbel",
                        lambda key, shape: jnp.asarray(gumbel))
    return jprocrustes.similarity_fit_ransac(*args, **kwargs)


@pytest.mark.parametrize("given_rotation,sym", [(False, False), (True, True),
                                                (True, False)])
@pytest.mark.parametrize("tie", [False, True])
def test_similarity_fit_ransac_matches_jax(monkeypatch, given_rotation, sym,
                                           tie):
    """Within 1e-5 (rotation, translation; scale relative), the refit mask
    equal.  `tie`: every score of hypothesis 0 equal and hypothesis 1's top
    three tied, so the picks follow the tie order alone (lax.top_k: the
    lower index first)."""
    src, tgt, mask, R = _fit_problem(1)
    H = 16
    g = np.array(jax.random.gumbel(jax.random.PRNGKey(5),
                                   mask.shape[:-1] + (H, mask.shape[-1])))
    if tie:
        g[..., 0, :] = 0.25
        g[..., 1, 40:] = 7.0
    rotation = R if given_rotation else None
    kw = dict(num_hyps=H, inlier_th=0.01, sym=sym)
    want = _jax_ransac(monkeypatch, g, jnp.asarray(src), jnp.asarray(tgt),
                       jnp.asarray(mask), jax.random.PRNGKey(0),
                       rotation=None if rotation is None
                       else jnp.asarray(rotation), **kw)
    got = tprocrustes.similarity_fit_ransac(
        torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(mask),
        rotation=None if rotation is None else torch.from_numpy(rotation),
        gumbel=torch.from_numpy(g), **kw)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert not np.array_equal(np.asarray(want[3]), mask)   # inliers chosen
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5)


def test_similarity_fit_ransac_falls_back_to_the_full_mask(monkeypatch):
    """A threshold no hypothesis meets 4 times: the refit takes the whole
    mask, in both packages."""
    src, tgt, mask, _ = _fit_problem(2)
    H = 8
    g = np.array(jax.random.gumbel(jax.random.PRNGKey(6),
                                   mask.shape[:-1] + (H, mask.shape[-1])))
    kw = dict(num_hyps=H, inlier_th=1e-7)
    want = _jax_ransac(monkeypatch, g, jnp.asarray(src), jnp.asarray(tgt),
                       jnp.asarray(mask), jax.random.PRNGKey(0), **kw)
    got = tprocrustes.similarity_fit_ransac(
        torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(mask),
        gumbel=torch.from_numpy(g), **kw)
    np.testing.assert_array_equal(np.asarray(want[3]), mask)
    np.testing.assert_array_equal(got[3].numpy(), mask)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5)


def test_ransac_draws_are_explicit():
    src, tgt, mask, _ = _fit_problem(3)
    args = (torch.from_numpy(src), torch.from_numpy(tgt),
            torch.from_numpy(mask))
    with pytest.raises(ValueError, match="Gumbel"):
        tprocrustes.similarity_fit_ransac(*args, num_hyps=4)
    runs = [tprocrustes.similarity_fit_ransac(
        *args, num_hyps=4, generator=torch.Generator().manual_seed(3))
        for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _jax_noise(key, shape, kind):
    """The draws `add_noise_to_pose` makes from `key`, as tensors."""
    return {k: torch.from_numpy(v)
            for k, v in jax_pose_noise(key, shape, kind).items()}


@pytest.mark.parametrize("kind", ["normal", "uniform"])
@pytest.mark.parametrize("crop", [False, True])
def test_init_pose_from_gt_matches_jax(kind, crop):
    jcfg, tcfg = (tiny_config(s, "laptop") for s in (jschema, tschema))
    jcfg, tcfg = (c.replace(
        track=dataclasses.replace(c.track, init_frame_gt=False),
        perturb=dataclasses.replace(c.perturb, kind=kind, r=12.0))
        for c in (jcfg, tcfg))
    rng = np.random.RandomState(7)
    q = rng.randn(3, 2, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    gt = dict(rotation=np.asarray(jrot.quat_to_matrix(
                  jnp.asarray(q, jnp.float32))),
              translation=rng.randn(3, 2, 3, 1).astype(np.float32),
              scale=rng.uniform(0.1, 0.4, (3, 2)).astype(np.float32))
    crop_t = rng.randn(3, 1, 3, 1).astype(np.float32) if crop else None
    crop_s = rng.uniform(0.1, 0.4, (3, 1)).astype(np.float32) if crop \
        else None
    key = jax.random.PRNGKey(11)
    want = jtracker.init_pose_from_gt(
        key, JPose(**{k: jnp.asarray(v) for k, v in gt.items()}), jcfg,
        crop_translation=None if crop_t is None else jnp.asarray(crop_t),
        crop_scale=None if crop_s is None else jnp.asarray(crop_s))
    got = tinit_pose_from_gt(
        Pose(**{k: torch.from_numpy(v) for k, v in gt.items()}), tcfg,
        noise=_jax_noise(key, (3, 2), kind),
        crop_translation=None if crop_t is None else torch.from_numpy(crop_t),
        crop_scale=None if crop_s is None else torch.from_numpy(crop_s))
    for f in ("rotation", "translation", "scale"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-6,
                                   err_msg=f)
    assert not np.allclose(got.rotation.numpy(), gt["rotation"], atol=1e-3)
    # the GT itself with init_frame/gt, and a draw from a generator
    gtp = Pose(**{k: torch.from_numpy(v) for k, v in gt.items()})
    assert tinit_pose_from_gt(gtp, tcfg.replace(track=dataclasses.replace(
        tcfg.track, init_frame_gt=True))) is gtp
    with pytest.raises(ValueError, match="draws"):
        tinit_pose_from_gt(gtp, tcfg)
    drawn = tinit_pose_from_gt(gtp, tcfg,
                               generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(drawn.rotation).all()


def test_init_pose_from_cloud_matches_jax():
    pts = (np.random.RandomState(8).randn(3, 100, 3) * 0.2 + [0, 0, 1]
           ).astype(np.float32)
    want = jtracker.init_pose_from_cloud(jnp.asarray(pts), 2, 0.6)
    got = tinit_pose_from_cloud(pts, 2, 0.6, device="cpu")
    for f in ("rotation", "translation", "scale"):
        assert getattr(got, f).shape == np.asarray(getattr(want, f)).shape
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


@pytest.mark.parametrize("sym", [True, False])
def test_evaluate_track_matches_jax(sym):
    rng = np.random.RandomState(9)

    def poses():
        q = rng.randn(3, 2, 2, 4)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        return dict(rotation=np.array(jrot.quat_to_matrix(
                        jnp.asarray(q, jnp.float32))),
                    translation=rng.randn(3, 2, 2, 3, 1).astype(
                        np.float32) * 0.05,
                    scale=rng.uniform(0.1, 0.4, (3, 2, 2)).astype(np.float32))

    pred, gt = poses(), poses()
    pred["rotation"][0] = gt["rotation"][0]       # some 5deg5cm hits
    pred["translation"][0] = gt["translation"][0] + 0.01
    want = jtracker.evaluate_track(
        *(JPose(**{k: jnp.asarray(v) for k, v in p.items()})
          for p in (pred, gt)), sym)
    got = tevaluate_track(
        *(Pose(**{k: torch.from_numpy(v) for k, v in p.items()})
          for p in (pred, gt)), sym)
    assert sorted(got) == sorted(want)
    assert np.asarray(want["5deg5cm"]).any()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-3 if k == "rdiff" else 1e-6,
                                   err_msg=k)


def test_step_ransac_draws_come_from_the_frame_or_the_generator():
    """A RANSAC step takes the frame's draws, else its generator's (the
    same seed, the same poses), else raises; a const_vel step says how its
    carry starts."""
    from captra_tpu_torch.models.coordnet import CoordNet
    from captra_tpu_torch.models.rotnet import RotNet

    _, tcfg = _configs("bottle", "ransac_npcs")
    gen = torch.Generator().manual_seed(0)
    nets = (CoordNet(tcfg, device="cpu", generator=gen),
            RotNet(tcfg, device="cpu", generator=gen))
    data = jmake(seed=1, obj=jschema.ObjCfg(**_jobj("bottle")),
                 num_frames=2, num_points=N)
    pose = Pose(*(torch.from_numpy(np.asarray(x)[0][None]) for x in
                  (data.pose.rotation, data.pose.translation,
                   data.pose.scale)))
    frame = {"points": torch.from_numpy(np.asarray(data.points)[1][None])}
    with pytest.raises(ValueError, match="fit_ransac"):
        make_track_step(tcfg, *nets, device="cpu")(pose, frame)
    runs = [make_track_step(tcfg, *nets, device="cpu",
                            generator=torch.Generator().manual_seed(4))(
        pose, frame)[0] for _ in range(2)]
    assert torch.equal(runs[0].rotation, runs[1].rotation)
    draws = jax_gumbel_draws(tcfg.track, 1, 1, 1, N)
    fed = make_track_step(tcfg, *nets, device="cpu")(pose, {
        **frame, **{k: torch.from_numpy(v[0]) for k, v in draws.items()}})[0]
    assert torch.isfinite(fed.rotation).all()

    cv_cfg = tcfg.replace(track=dataclasses.replace(
        tcfg.track, fit_ransac=0, motion_model="const_vel"))
    step = make_track_step(cv_cfg, *nets, device="cpu")
    carry = step.init_carry(pose)
    assert torch.equal(carry[1], torch.eye(3).expand(1, 1, 3, 3))
    assert torch.equal(carry[2], torch.zeros(1, 1, 3, 1))
    new, aux = step(carry, frame)
    assert len(new) == 3 and torch.equal(new[0].rotation, aux.pose.rotation)


def _jobj(obj):
    from tests.torch_port_helpers import OBJECTS
    return OBJECTS[obj]


@pytest.mark.parametrize("gain", [1.0, 0.6])
def test_extrapolate_pose_matches_jax(gain):
    from captra_tpu_torch.tracking.tracker import extrapolate_pose

    rng = np.random.RandomState(12)

    def pose():
        q = rng.randn(2, 2, 4)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        return dict(rotation=np.array(jrot.quat_to_matrix(
                        jnp.asarray(q, jnp.float32))),
                    translation=rng.randn(2, 2, 3, 1).astype(np.float32),
                    scale=rng.uniform(0.1, 0.4, (2, 2)).astype(np.float32))

    prev, cur = pose(), pose()
    want = jtracker.extrapolate_pose(
        *(JPose(**{k: jnp.asarray(v) for k, v in p.items()})
          for p in (prev, cur)), gain=gain)
    got = extrapolate_pose(
        *(Pose(**{k: torch.from_numpy(v) for k, v in p.items()})
          for p in (prev, cur)), gain=gain)
    for f in ("rotation", "translation", "scale"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=1e-5,
                                   err_msg=f)
