"""The port's track CLI on datasets on disk (no `--synthetic_data`):
`captra_tpu_torch.cli.track.main` against `captra_tpu.cli.track.main` on
the same fixtures (the JAX tests' writers; each package on a root of its
own), from the same checkpoints of tiny seeded nets (written by the port in
the JAX package's pickle layout, which both CLIs read).

Cases: BMVC laptop (`gt_label`), GT-less captured drawers, NOCS bottle
`real_test` on points, on the OTF crop, and on the OTF crop with NOCS-2D
detections (the JAX CLI's crop shifts fed to the port as
`tests/test_torch_otf.py::_jax_shifts` gives them).  The depth images
carry per-pixel noise: a flat depth backprojects to a lattice whose
distance near-ties the JAX package's FPS, with XLA's FMAs on the CPU,
breaks otherwise than the port's (ROADMAP.md queue 3).  Tolerances: saved
poses within 1e-4 (rotation and translation atol, scale rtol) over the
T - 1 tracked frames, the same result files, batches and printed frames,
GT exactly, the AVG metrics within 1e-4.  The NOCS head of the random
CoordNet is scaled (NOCS_GAIN), so the fits do not divide by a tiny NPCS
spread.

The SAPIEN laptop chunks are held to the JAX package's batches bit for
bit, and the port's saved poses to `track_trajectory` on them: on this
fixture a chunk's first part-0 scale fit, over 16 of 128 points, amplifies
rounding 18-30 fold (the JAX package's own, under 2e-7 weight noise, 18
fold), which puts the nets' 3.5e-6 NPCS gap between the packages at
1e-4 - 3e-4 of the scale; the laptop's tracking is held to the JAX
package's in `tests/test_torch_cli.py`."""
import contextlib
import functools
import io
import os
import pickle
import re
import shutil
from os.path import join as pjoin

import numpy as np
import pytest
import torch

from captra_tpu.cli import track as jtrack
from captra_tpu.config.loader import DEFAULTS_DIR
from captra_tpu_torch.cli import track as ttrack
from captra_tpu_torch.models.coordnet import CoordNet
from captra_tpu_torch.models.rotnet import RotNet
from captra_tpu_torch.training.checkpoint import save_checkpoint
from captra_tpu_torch.training.convert import flax_variables
from tests.test_cli_e2e import TINY_POINTNET
from tests.test_data import _write_fake_nocs
from tests.test_sapien_data import _fake_cloud_dict, _model_info
from tests.test_torch_cli import (
    POSE_TOL, _assert_poses_close, _avg_line, _load_results,
)
from tests.test_torch_otf import NOCS_GAIN, _jax_shifts
from tests.test_track_paths import (
    _write_bmvc_root, _write_otf_root, _write_real_root,
)

# The laptop's random nets are chaotic after a frame or two in the JAX
# package itself (`tests/test_torch_cli.py::
# test_laptop_third_frame_is_chaotic_in_jax`): its trajectories here are
# T = 3 (BMVC) and T = 2 (SAPIEN chunks, obj/num_frames of the test's
# config).
BMVC_FRAMES = 3
SAPIEN_FRAMES = 2
OBJECTS = {"bottle": ["--obj_config", "obj_info_nocs.yml",
                      "--obj_category", "1"],
           "laptop": ["--obj_config", "obj_info_sapien.yml",
                      "--obj_category", "laptop"],
           "drawers": ["--obj_config", "obj_info_sapien.yml",
                       "--obj_category", "drawers"]}


def _write_noisy_otf_root(root):
    """`_write_otf_root`'s scene (3 frames), each depth PNG with +-5 mm of
    noise."""
    import cv2
    _write_otf_root(root)
    rng = np.random.RandomState(7)
    raw = pjoin(root, "nocs_full", "real_test", "scene_1")
    for name in sorted(os.listdir(raw)):
        if name.endswith("_depth.png"):
            depth = cv2.imread(pjoin(raw, name), -1).astype(np.int32)
            depth += rng.randint(-5, 6, depth.shape)
            cv2.imwrite(pjoin(raw, name), depth.astype(np.uint16))
    return root


def _write_sapien_seq(root, frames=2 * SAPIEN_FRAMES + 1):
    """SAPIEN `render_seq` tracks of a test instance (10101) and a train
    one (`tests/test_sapien_data.py`'s depth buffer with +-1 cm of noise),
    with each instance's precomputed `model_info` pickle."""
    rng = np.random.RandomState(5)
    for instance in ("10101", "20001"):
        base = pjoin(root, "render_seq", "laptop", instance, "0000")
        os.makedirs(pjoin(base, "cloud"))
        os.makedirs(pjoin(base, "gt"))
        for f in range(frames):
            cloud = _fake_cloud_dict(rng)
            depth = cloud["depth"]
            cloud["depth"] = np.where(
                depth < 1, depth + rng.uniform(-0.01, 0.01, depth.shape),
                depth).astype(np.float32)
            np.savez(pjoin(base, "cloud", f"{f}.npz"), all_dict=cloud)
            gt = {"camera_pose": (rng.randn(3) * 0.1, [1.0, 0.0, 0.0, 0.0]),
                  "link_pose": {p: (rng.randn(3) * 0.01 + [0, 0, -0.5],
                                    [1.0, 0.01 * f, 0.0, 0.0])
                                for p in range(2)}}
            with open(pjoin(base, "gt", f"{f}.pkl"), "wb") as fh:
                pickle.dump(gt, fh)
        os.makedirs(pjoin(root, "model_info", "laptop"), exist_ok=True)
        with open(pjoin(root, "model_info", "laptop", f"{instance}.pkl"),
                  "wb") as fh:
            pickle.dump(_model_info(), fh)
    return root


# name: (object, fixture writer, points, flags; "{root}" is the dataset's)
CASES = {
    "bmvc": ("laptop", functools.partial(_write_bmvc_root,
                                         frames=BMVC_FRAMES), 256,
             ["--mode_name", "bmvc_0", "--track_cfg/gt_label", "true"]),
    "real_gtless": ("drawers", _write_real_root, 128,
                    ["--mode_name", "real_test"]),
    "nocs_points": ("bottle", _write_fake_nocs, 128,
                    ["--mode_name", "real_test", "--batch_size", "4"]),
    "nocs_otf": ("bottle", _write_noisy_otf_root, 64,
                 ["--nocs_otf", "true"]),
    "nocs_otf_nocs2d": ("bottle", _write_noisy_otf_root, 64,
                        ["--nocs_otf", "true", "--track_cfg/nocs2d_label",
                         "true", "--track_cfg/nocs2d_path",
                         "{root}/nocs2d"]),
}


@pytest.fixture(scope="module")
def config_dir(tmp_path_factory):
    """The default configs, the tiny pointnet, and SAPIEN tracks chunked
    SAPIEN_FRAMES frames long."""
    out = str(tmp_path_factory.mktemp("configs") / "configs")
    shutil.copytree(DEFAULTS_DIR, out)
    with open(pjoin(out, "pointnet_config", "pointnet2_tiny.yml"), "w") as f:
        f.write(TINY_POINTNET)
    path = pjoin(out, "obj_config", "obj_info_sapien.yml")
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(re.sub(r"(?m)^num_frames: \d+$",
                       f"num_frames: {SAPIEN_FRAMES}", text))
    return out


@pytest.fixture(scope="module")
def checkpoints():
    """`save(obj, argv, coord_dir, rot_dir)` writes the seeded nets of
    `obj` (made once per object by the port, the NOCS head scaled) as the
    two experiments' checkpoints, which both CLIs read."""
    made = {}

    def save(obj, argv, coord_dir, rot_dir):
        if obj not in made:
            _, cfg = ttrack.parse(argv)
            gen = torch.Generator().manual_seed(0)
            coord = CoordNet(cfg, device="cpu", generator=gen)
            with torch.no_grad():
                coord.nocs_head.dense_1.weight *= NOCS_GAIN
            made[obj] = (flax_variables(coord),
                         flax_variables(RotNet(cfg, device="cpu",
                                               generator=gen)))
        for exp, variables in zip((coord_dir, rot_dir), made[obj]):
            save_checkpoint(pjoin(exp, "ckpt"), 0, variables)

    return save


def _argv(config_dir, root, exp, coord, obj, points, flags):
    return ["--config_dir", config_dir, "--experiment_dir", exp,
            "--coord_exp/dir", coord, "--basepath", root, *OBJECTS[obj],
            "--pointnet_cfg/camera", "pointnet2_tiny.yml",
            "--num_points", str(points), "--network/backbone_out_dim", "32",
            "--init_frame/gt", "true", "--save",
            *[f.replace("{root}", root) for f in flags]]


def _with_jax_shifts(sequences):
    """The OTF batches with the crop shifts the JAX CLI draws."""
    def wrapped(cfg, mode=None):
        for name, batch in sequences(cfg, mode):
            if "depth" in batch:
                T, B, H, W = batch["depth"].shape
                batch["shift"] = torch.from_numpy(np.stack(
                    [_jax_shifts(t, B, H * W) for t in range(T)]))
            yield name, batch
    return wrapped


@pytest.mark.parametrize("case", sorted(CASES))
def test_track_cli_on_disk_matches_jax(case, config_dir, checkpoints,
                                       tmp_path, monkeypatch):
    obj, write, points, flags = CASES[case]
    runs = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg / "data")
        os.makedirs(root)
        write(root)
        argv = _argv(config_dir, root, str(tmp_path / pkg / "rot"),
                     str(tmp_path / pkg / "coord"), obj, points, flags)
        checkpoints(obj, argv, str(tmp_path / pkg / "coord"),
                    str(tmp_path / pkg / "rot"))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if pkg == "jax":
                jtrack.main(argv)
            else:
                monkeypatch.setattr(ttrack, "dataset_sequences",
                                    _with_jax_shifts(
                                        ttrack.dataset_sequences))
                ttrack.main(argv, device="cpu")
        runs[pkg] = (out.getvalue(), _load_results(str(tmp_path / pkg /
                                                       "rot")))
    (jtext, want), (ttext, got) = runs["jax"], runs["port"]
    batch_line = re.compile(r"^(\S+): (\d+) frames x (\d+) in", re.M)
    assert batch_line.findall(ttext) == batch_line.findall(jtext)
    assert sorted(got) == sorted(want) and want
    for name in want:
        g, w = got[name], want[name]
        assert g["frame_nums"] == w["frame_nums"]
        _assert_poses_close(g["pred"]["poses"], w["pred"]["poses"])
        assert (g["gt"] is None) == (w["gt"] is None)
        if w["gt"] is not None:
            for k in ("rotation", "translation", "scale"):
                np.testing.assert_array_equal(g["gt"]["poses"][k],
                                              w["gt"]["poses"][k])
            np.testing.assert_array_equal(g["gt"]["corners"],
                                          w["gt"]["corners"])
    if "AVG: " in jtext:
        want_avg, got_avg = _avg_line(jtext), _avg_line(ttext)
        assert sorted(got_avg) == sorted(want_avg)
        for k in want_avg:
            assert abs(got_avg[k] - want_avg[k]) <= POSE_TOL + 1e-9, k
    else:
        assert case == "real_gtless" and "AVG: " not in ttext


def test_track_cli_tracks_sapien_chunks_as_the_jax_batches(
        config_dir, checkpoints, tmp_path, monkeypatch):
    """SAPIEN laptop, the default split (`test_seq`: `render_seq/`
    exists) in obj/num_frames chunks: the port CLI tracks the batches the
    JAX package's readers and loader give (names and values bit for bit),
    and saves `track_trajectory`'s poses on them from the GT init."""
    from captra_tpu.data.factory import make_dataset as jmake_dataset
    from captra_tpu.data.loader import sequence_batches as jsequence_batches
    from captra_tpu_torch.tracking.tracker import track_trajectory
    from tests.test_torch_cli import _jax_config
    from tests.test_torch_loader import _assert_batch_equal

    roots = [str(tmp_path / pkg / "data") for pkg in ("port", "jax")]
    for root in roots:
        os.makedirs(root)
        _write_sapien_seq(root)
    exp, coord = str(tmp_path / "rot"), str(tmp_path / "coord")
    argv = _argv(config_dir, roots[0], exp, coord, "laptop", 128, [])
    checkpoints("laptop", argv, coord, exp)
    tracked = []
    sequences = ttrack.track_sequences

    def record(cfg, step, seqs, **kwargs):
        tracked.extend(seqs)
        return sequences(cfg, step, tracked, **kwargs)

    monkeypatch.setattr(ttrack, "track_sequences", record)
    with contextlib.redirect_stdout(io.StringIO()):
        ttrack.main(argv, device="cpu")
    jcfg = _jax_config(_argv(config_dir, roots[1], exp, coord, "laptop",
                             128, []))
    want = list(jsequence_batches(jmake_dataset(jcfg, "test_seq"),
                                  SAPIEN_FRAMES, batch_size=jcfg.batch_size))
    assert [n for n, _ in tracked] == [n for n, _ in want]
    assert [n for n, _ in want] == [("10101/0000/0", "10101/0000/1")]
    for (_, got), (_, w) in zip(tracked, want):
        _assert_batch_equal(got, w)
    args, cfg = ttrack.parse(argv)
    step = ttrack.build_step(cfg, *ttrack.load_variables(cfg, args),
                             device="cpu")
    names, batch = tracked[0]
    _, aux = track_trajectory(step, batch["pose"][0], {
        "points": batch["points"]}, device="cpu")
    saved = _load_results(exp)
    assert sorted(saved) == [n.replace("/", "_") + ".pkl" for n in names]
    for b, name in enumerate(names):
        poses = saved[name.replace("/", "_") + ".pkl"]["pred"]["poses"]
        for f in ("rotation", "translation", "scale"):
            np.testing.assert_array_equal(
                poses[f], getattr(aux.pose, f)[:, b].numpy())


@pytest.mark.parametrize("lost", [0, -1])
def test_track_cli_otf_raises_without_a_depth_image(lost, config_dir,
                                                     checkpoints, tmp_path):
    """`--nocs_otf` on a scene that lost one depth PNG (a dataset moved
    after preprocessing: each frame records its depth image's absolute
    path) raises naming that file, where the CLI would otherwise track the
    stored points instead of the crop."""
    root = str(tmp_path / "data")
    os.makedirs(root)
    _write_otf_root(root)
    raw = pjoin(root, "nocs_full", "real_test", "scene_1")
    gone = pjoin(raw, sorted(n for n in os.listdir(raw)
                             if n.endswith("_depth.png"))[lost])
    os.remove(gone)
    exp, coord = str(tmp_path / "rot"), str(tmp_path / "coord")
    argv = _argv(config_dir, root, exp, coord, "bottle", 64,
                 ["--nocs_otf", "true"])
    checkpoints("bottle", argv, coord, exp)
    with pytest.raises(FileNotFoundError, match=re.escape(repr(gone))):
        ttrack.main(argv, device="cpu")


def test_track_sequences_otf_refuses_a_batch_without_depth():
    """Any batch without depth images under `track_cfg/nocs_otf` (here a
    synthetic one of points) raises before it is tracked."""
    _, cfg = ttrack.parse(["--nocs_otf", "true"])
    batch = {"points": torch.zeros(3, 2, 16, 3)}
    with pytest.raises(ValueError,
                       match=re.escape("a|b: track_cfg/nocs_otf")):
        ttrack.track_sequences(cfg, None, [(("a", "b"), batch)],
                               device="cpu")
