"""The port's OTF slice against the JAX package: depth backprojection, the
ball crop (exact and grouped, ragged and full width, an all-invalid frame),
the NOCS-2D detection selection, the synthetic depth video, and the OTF
tracking step as a whole (tiny nets with converted flax weights, gt labels,
nocs2d labels, sensor dropout) at B = 1 and B = 2.

The crop's one random input, a cyclic shift per cloud, is the port's
explicit `shift`; every test feeds it the JAX draw (`_jax_shifts`).  Crop
indices and points must be equal; trajectories agree within 1e-4 (rotation
and translation atol, scale rtol), as in tests/test_torch_tracker.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.data import preprocess as jprep
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.models.rotnet import RotNet as JRotNet
from captra_tpu.pose.part_dof import Pose as JPose
from captra_tpu.tracking import tracker as jtracker
from captra_tpu_torch.config import get_config, schema as tschema
from captra_tpu_torch.config.presets import (
    nocs_bottle_otf, nocs_bottle_otf_overrides,
)
from captra_tpu_torch.data import depth_frames, preprocess as tprep
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking.tracker import (
    make_track_step, track_trajectory,
)
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, rotnet_from_flax,
)
from tests.torch_port_helpers import tiny_config, to_numpy

H, W = 64, 80
CAMERA_K = np.asarray(jprep.NOCS_CAMERA_INTRINSICS)


def _scene(seed: int, H: int = H, W: int = W, ox=None, oy=None):
    """Background at 1.5 m and an object blob at 1.0 m, with per-pixel
    noise and 5% missing returns, from a seed."""
    rng = np.random.RandomState(seed)
    depth = 1500 + rng.randint(-5, 5, (H, W)).astype(np.int32)
    mask = np.zeros((H, W), bool)
    oy = H // 3 if oy is None else oy
    ox = W // 3 if ox is None else ox
    mask[oy:oy + H // 4, ox:ox + W // 4] = True
    depth[mask] = 1000 + rng.randint(-20, 20, mask.sum())
    depth[rng.rand(H, W) < 0.05] = 0
    return depth, mask


def _jax_shifts(frame_key: int, B: int, M: int) -> np.ndarray:
    """The shifts the JAX OTF step draws for one frame (tracker.py:378-379,
    preprocess.py:190)."""
    keys = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(0), frame_key), B)
    return np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (), 0, M))(keys))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("hw", [(64, 80), (480, 640)])
@pytest.mark.parametrize("camera", ["real", "camera"])
def test_backproject_depth_planes_matches_jax(hw, camera):
    K = {"real": tprep.NOCS_REAL_INTRINSICS,
         "camera": tprep.NOCS_CAMERA_INTRINSICS}[camera]
    depth = np.stack([_scene(s, *hw)[0] for s in range(2)])
    jpts, jvalid = jax.vmap(
        lambda d: jprep.backproject_depth_planes(d, jnp.asarray(K)))(
        jnp.asarray(depth))
    pts, valid = tprep.backproject_depth_planes(
        _t(depth), tprep.intrinsics_tensor(K, "cpu"))
    assert pts.shape == (2, 3, hw[0] * hw[1]) and pts.dtype == torch.float32
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("hw", [(64, 80), (480, 640)])
def test_backproject_depth_matches_jax(hw):
    depth, mask = _scene(3, *hw)
    jpts, jvalid = jprep.backproject_depth(jnp.asarray(depth),
                                           jnp.asarray(CAMERA_K),
                                           jnp.asarray(mask))
    pts, valid = tprep.backproject_depth(_t(depth), CAMERA_K, _t(mask))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    # K's inverse is jnp.linalg.inv's own values (`intrinsics_inverse`)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))


def test_growth_tables_match_jax():
    for table, base, n in ((tprep.CROP_GROWTH, 1.1, 10),
                           (tprep.DET_GROWTH, 1.2, 6)):
        got = np.asarray(table, np.float32)
        np.testing.assert_array_equal(got, np.asarray(base ** jnp.arange(n)))
        np.testing.assert_array_equal(
            got, np.asarray(jax.jit(lambda: base ** jnp.arange(n))()))


def _crop_both(depth, num_points, fps_mode, K=CAMERA_K, radius=(0.1, 0.15),
               frame_key=3):
    B = depth.shape[0]
    M = depth.shape[1] * depth.shape[2]
    pts3, valid = jax.vmap(
        lambda d: jprep.backproject_depth_planes(d, jnp.asarray(K)))(
        jnp.asarray(depth))
    # centers near the blob of cloud 0, off by a seeded centimetre
    blob = np.asarray(_scene(0, *depth.shape[1:])[1]).reshape(-1)
    c0 = np.asarray(pts3)[0][:, blob & np.asarray(valid)[0]].mean(-1)
    center = (c0 + 0.01 * np.random.RandomState(1).randn(B, 3)).astype(
        np.float32)
    radius = np.asarray(radius[:B], np.float32)
    keys = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(0), frame_key), B)
    jp3, jidx = jprep.crop_ball_batch_planes(
        keys, pts3, valid, jnp.asarray(center), jnp.asarray(radius),
        num_points, fps_mode=fps_mode)
    tpts3, tvalid = tprep.backproject_depth_planes(
        _t(depth), tprep.intrinsics_tensor(K, "cpu"))
    p3, idx = tprep.crop_ball_batch_planes(
        _t(_jax_shifts(frame_key, B, M)), tpts3, tvalid, _t(center),
        _t(radius), num_points, fps_mode=fps_mode)
    return (np.asarray(jp3), np.asarray(jidx)), (p3.numpy(), idx.numpy())


@pytest.mark.parametrize("num_points,fps_mode", [
    (128, "exact"),     # W = 640, G = 8
    (100, "exact"),     # ragged: W = 500, G = 11, pad 380
    (128, "grouped"),
])
def test_crop_matches_jax(num_points, fps_mode):
    depth = np.stack([_scene(s)[0] for s in range(2)])
    (jp3, jidx), (p3, idx) = _crop_both(depth, num_points, fps_mode)
    assert idx.shape == (2, num_points) and p3.shape == (2, 3, num_points)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(p3, jp3)


def test_crop_full_width_matches_jax():
    """480x640, 4096 points: the 20480-point working set of the OTF
    protocol."""
    depth = _scene(0, 480, 640)[0][None]
    (jp3, jidx), (p3, idx) = _crop_both(depth, 4096, "exact",
                                        K=tprep.NOCS_REAL_INTRINSICS,
                                        radius=(0.3,))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(p3, jp3)


def test_crop_all_invalid_frame_matches_jax():
    depth = np.stack([_scene(0)[0], np.zeros((H, W), np.int32)])
    (jp3, jidx), (p3, idx) = _crop_both(depth, 128, "exact")
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(p3, jp3)
    assert (idx[1] == idx[1, 0]).all()     # one point, the shifted start


def test_unpack_detection_masks_matches_jax():
    rng = np.random.RandomState(4)
    masks = rng.rand(2, 3, 7, 21) < 0.4                 # W not a multiple of 8
    packed = np.packbits(masks, axis=-1, bitorder="little")
    want = np.asarray(jprep.unpack_detection_masks(jnp.asarray(packed),
                                                   (7, 21)))
    got = tprep.unpack_detection_masks(_t(packed), (7, 21)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, masks)


def test_projected_bbox_2d_matches_jax():
    rng = np.random.RandomState(5)
    center = (rng.randn(6, 3) * [0.1, 0.1, 0.2] + [0, 0, -1.0]).astype(
        np.float32)
    radius = rng.uniform(0.01, 0.4, 6).astype(np.float32)  # some below 0.05
    K = jnp.asarray(tprep.NOCS_REAL_INTRINSICS)
    want = np.stack([np.asarray(jprep.projected_bbox_2d(
        jnp.asarray(c), jnp.asarray(r), K, (480, 640)))
        for c, r in zip(center, radius)])
    got = tprep.projected_bbox_2d(
        _t(center), _t(radius),
        tprep.intrinsics_tensor(tprep.NOCS_REAL_INTRINSICS, "cpu"),
        (480, 640)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_select_detection_mask_matches_jax():
    rng = np.random.RandomState(6)
    B, K, hw = 4, 5, (48, 64)
    masks = rng.rand(B, K, *hw) < 0.5
    y1 = rng.uniform(0, 30, (B, K))
    x1 = rng.uniform(0, 40, (B, K))
    boxes = np.stack([y1, x1, y1 + rng.uniform(2, 18, (B, K)),
                      x1 + rng.uniform(2, 24, (B, K))], -1).astype(np.float32)
    valid = rng.rand(B, K) < 0.7
    valid[3] = False                                     # no detection
    center = (rng.randn(B, 3) * [0.05, 0.05, 0.1] + [0, 0, -1.0]).astype(
        np.float32)
    radius = rng.uniform(0.01, 0.1, B).astype(np.float32)
    Kc = jnp.asarray(CAMERA_K)
    want = [jprep.select_detection_mask(
        jnp.asarray(masks[b]), jnp.asarray(boxes[b]), jnp.asarray(valid[b]),
        jnp.asarray(center[b]), jnp.asarray(radius[b]), Kc, hw)
        for b in range(B)]
    mask, found = tprep.select_detection_mask(
        _t(masks), _t(boxes), _t(valid), _t(center), _t(radius),
        tprep.intrinsics_tensor(CAMERA_K, "cpu"), hw)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.stack([np.asarray(m) for m, _ in want]))
    np.testing.assert_array_equal(found.numpy(),
                                  [bool(f) for _, f in want])
    assert not found[3]


def test_depth_frames_match_bench_script():
    from scripts import bench_otf
    jd, jm = bench_otf.make_depth_frames(3, 2, seed=7)
    d, m = depth_frames.make_depth_frames(3, 2, seed=7)
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_array_equal(m, np.asarray(jm))
    jdet = bench_otf.make_det_frames(jd, jm)
    det = depth_frames.make_det_frames(d, m)
    for k in ("det_masks", "det_boxes", "det_valid"):
        np.testing.assert_array_equal(det[k], np.asarray(jdet[k]))
    # the bench's init pose (bench_otf.py:117-124)
    pts0, _ = jprep.backproject_depth(jd[0, 0], jprep.NOCS_REAL_INTRINSICS)
    c0 = np.asarray(pts0).reshape(480, 640, 3)[np.asarray(jm[0, 0])].mean(0)
    pose = depth_frames.otf_init_pose(d[0, 0], m[0, 0], B=2, num_parts=1)
    assert pose.rotation.shape == (2, 1, 3, 3)
    np.testing.assert_allclose(pose.translation[:, 0, :, 0].numpy(),
                               np.broadcast_to(c0, (2, 3)), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(pose.scale.numpy(), np.full((2, 1), 0.3,
                                                               np.float32))


# ---------------------------------------------------------------------------
# the OTF tracking step as a whole
# ---------------------------------------------------------------------------

T, N = 4, 128
# Random nets predict NPCS with a tiny spread, and the s/t fit divides by
# that spread: a 1e-7 difference in the NPCS then moves the fitted scale by
# ~1e-5, and the crop feeds the scale back, so the trajectory amplifies it
# frame by frame.  Both packages get the same flax weights with the NOCS
# head's last layer scaled by NOCS_GAIN, which spreads the NPCS and keeps
# the fitted scales at 0.04-0.23 (a bottle's size).
NOCS_GAIN = 30.0


def _video(B: int, dropout: bool):
    """T frames per cloud, the blob moving one pixel per frame; with
    `dropout`, cloud 0 loses every depth return at frame 2."""
    depth = np.zeros((T, B, H, W), np.int32)
    mask = np.zeros((T, B, H, W), bool)
    for t in range(T):
        for b in range(B):
            depth[t, b], mask[t, b] = _scene(10 * b + t, ox=24 + t + 3 * b,
                                             oy=20 + b)
    if dropout:
        depth[2, 0] = 0
        mask[2, 0] = False
    return depth, mask


def _otf_configs(case: str):
    track = dict(init_frame_gt=True, nocs_otf=True,
                 gt_label=case in ("gt", "dropout"),
                 nocs2d_label=case == "nocs2d")
    return tuple(tiny_config(s, num_points=N).replace(
        track=s.TrackCfg(**track)) for s in (jschema, tschema))


def _track_otf_both(case: str, B: int):
    jcfg, tcfg = _otf_configs(case)
    depth, mask = _video(B, dropout=case == "dropout")
    frames = {"depth": depth, "mask": mask}
    if case == "nocs2d":
        # detection 0: the blob grown by two pixels (so its labels differ
        # from the instance mask's); detection 1: a decoy in a corner
        grown = mask.copy()
        for axis in (2, 3):
            for step in (-2, -1, 1, 2):
                grown |= np.roll(mask, step, axis=axis)
        det = depth_frames.make_det_frames(depth, grown, K=3)
        decoy = np.zeros((H, W), bool)
        decoy[:8, :8] = True
        det["det_masks"][:, :, 1] = np.packbits(decoy, axis=-1,
                                                bitorder="little")
        det["det_boxes"][:, :, 1] = (0, 0, 7, 7)
        det["det_valid"][:, :, 1] = True
        # frame 1 of cloud 0 misses both: the instance mask stays
        det["det_valid"][1, 0] = False
        frames.update(det)
    P = jcfg.obj.num_parts
    pts0, _ = jprep.backproject_depth(jnp.asarray(depth[0, 0]),
                                      jnp.asarray(CAMERA_K))
    c0 = np.asarray(pts0).reshape(H, W, 3)[mask[0, 0]].mean(0)
    init = dict(rotation=np.broadcast_to(np.eye(3, dtype=np.float32),
                                         (B, P, 3, 3)),
                translation=np.broadcast_to(c0.reshape(1, 1, 3, 1),
                                            (B, P, 3, 1)).astype(np.float32),
                scale=np.full((B, P), 0.2, np.float32))

    coord, rotn = JCoordNet(jcfg), JRotNet(jcfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    cv = to_numpy(coord.init(k1, jnp.zeros((1, N, 3)), train=False))
    head = cv["params"]["nocs_head"]["dense_1"]
    head["kernel"] = head["kernel"] * np.float32(NOCS_GAIN)
    rv = to_numpy(rotn.init(k2, jnp.zeros((1, P, N, 3)),
                            jnp.zeros((1, N), jnp.int32), train=False))
    jstep = jtracker.make_track_step(
        jcfg, lambda p: coord.apply(cv, p, train=False),
        lambda p, lab: rotn.apply(rv, p, lab, train=False),
        intrinsics=jnp.asarray(CAMERA_K))
    jframes = {k: jnp.asarray(v) for k, v in frames.items()}
    jframes["key"] = jnp.arange(T, dtype=jnp.int32)
    _, jaux = jax.jit(lambda ip, fr: jtracker.track_trajectory(
        jstep, ip, fr))(JPose(**{k: jnp.asarray(v) for k, v in init.items()}),
                        jframes)

    step = make_track_step(tcfg, coordnet_from_flax(tcfg, cv, device="cpu"),
                           rotnet_from_flax(tcfg, rv, device="cpu"),
                           device="cpu", intrinsics=CAMERA_K)
    frames["shift"] = np.stack([_jax_shifts(t, B, H * W) for t in range(T)])
    _, aux = track_trajectory(step, Pose(**{k: _t(v) for k, v in
                                            init.items()}),
                              frames, device="cpu")
    return jaux, aux


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("case", ["gt", "nocs2d", "dropout"])
def test_otf_trajectory_matches_jax(case, B):
    jaux, aux = _track_otf_both(case, B)
    assert aux.pose.rotation.shape == (T - 1, B, 1, 3, 3)
    for f in ("rotation", "translation", "scale"):
        assert torch.isfinite(getattr(aux.pose, f)).all()
    np.testing.assert_array_equal(aux.pred_labels.numpy(),
                                  np.asarray(jaux.pred_labels))
    np.testing.assert_allclose(aux.pose.rotation.numpy(),
                               np.asarray(jaux.pose.rotation), atol=1e-4)
    np.testing.assert_allclose(aux.pose.translation.numpy(),
                               np.asarray(jaux.pose.translation), atol=1e-4)
    np.testing.assert_allclose(aux.pose.scale.numpy(),
                               np.asarray(jaux.pose.scale), rtol=1e-4)
    if case == "dropout":
        # the dead frame (tracked index 1 = frame 2) carries cloud 0's pose
        for f in ("rotation", "translation", "scale"):
            x = getattr(aux.pose, f)
            assert torch.equal(x[1, 0], x[0, 0])


def test_otf_step_draws_shifts_from_its_generator():
    _, tcfg = _otf_configs("gt")
    depth, mask = _video(1, dropout=False)
    frame = {"depth": depth[1], "mask": mask[1]}
    P = tcfg.obj.num_parts
    pose = Pose(torch.eye(3).expand(1, P, 3, 3),
                torch.tensor([0.0, 0.0, -1.0]).reshape(1, 1, 3, 1),
                torch.full((1, P), 0.2))

    def coord_fn(canon):
        return {"seg": torch.zeros(canon.shape[:2] + (2,)), "nocs": canon}

    def rot_fn(parts, labels):   # the bottle is symmetric: a y axis
        y = torch.tensor([0.0, 1.0, 0.0]).expand(parts.shape[0], P, 3)
        return {"rtvec": y,
                "point_rtvec": y[:, :, None].expand(-1, -1, N, -1)}

    with pytest.raises(ValueError, match="shift"):
        make_track_step(tcfg, coord_fn, rot_fn, device="cpu",
                        intrinsics=CAMERA_K)(pose, frame)
    runs = [make_track_step(tcfg, coord_fn, rot_fn, device="cpu",
                            intrinsics=CAMERA_K,
                            generator=torch.Generator().manual_seed(9))(
        pose, frame)[0] for _ in range(2)]
    assert torch.equal(runs[0].translation, runs[1].translation)


@pytest.mark.parametrize("fps_mode,nocs2d", [("exact", False),
                                             ("grouped", False),
                                             ("exact", True)])
def test_code_built_otf_config_equals_yaml(fps_mode, nocs2d):
    built = nocs_bottle_otf(fps_mode=fps_mode, nocs2d=nocs2d)
    loaded = get_config("config_track.yml", overrides=nocs_bottle_otf_overrides(
        fps_mode=fps_mode, nocs2d=nocs2d))
    for f in dataclasses.fields(tschema.Config):
        assert getattr(built, f.name) == getattr(loaded, f.name), f.name
    assert built.track.nocs_otf and built.track.otf_work_factor == 5
    assert built.network.fps_mode == fps_mode
    assert built.network.compute_dtype == "float32"
