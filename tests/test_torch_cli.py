"""The port's track and evaluate CLIs (`captra_tpu_torch/cli/`) against the
JAX package's (`captra_tpu/cli/`).

One pair of checkpoints written by the JAX package (a tiny bottle CoordNet
and RotNet, the tiny pointnet of `tests/test_cli_e2e.py`, 128 points) goes
through both track CLIs with `--init_frame/gt true --save` on 4 synthetic
trajectories of 20 frames at `--batch_size 3`: a batch of B=3, then one of
B=1.  Tolerances:
- the printed AVG metrics: 1e-4 (their last printed digit);
- saved predicted poses: rotation and translation atol 1e-4, scale rtol
  1e-4; saved predicted corners atol 1e-4; saved GT poses exactly;
- the evaluators on the port's results: as in `tests/test_torch_eval.py`.
The laptop's whole-trajectory comparison runs T=3: random nets make its
later frames chaotic in the JAX package itself
(`test_laptop_third_frame_is_chaotic_in_jax`)."""
import argparse
import contextlib
import io
import os
import pickle
import re
import shutil
import types
from os.path import join as pjoin

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from captra_tpu.cli import args as jargs
from captra_tpu.cli import evaluate as jevaluate_cli
from captra_tpu.cli import track as jtrack
from captra_tpu.config import get_config as jget_config
from captra_tpu.config.loader import DEFAULTS_DIR
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.models.rotnet import RotNet as JRotNet
from captra_tpu.tracking import tracker as jtracker
from captra_tpu.training import checkpoint as jckpt
from captra_tpu_torch.cli import args as targs
from captra_tpu_torch.cli import evaluate as tevaluate_cli
from captra_tpu_torch.cli import track as ttrack
from captra_tpu_torch.config import get_config as tget_config
from captra_tpu_torch.data.synthetic import make_trajectory
from captra_tpu_torch.eval import evaluator as teval
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking.tracker import (
    init_pose_from_cloud, init_pose_from_gt, make_track_step,
    search_init_orientation, track_trajectory,
)
from captra_tpu_torch.training.convert import (
    coordnet_from_flax, rotnet_from_flax,
)
from tests.test_cli_e2e import TINY_POINTNET
from tests.test_torch_eval import assert_rows_close
from tests.torch_port_helpers import to_numpy

N = 128
POSE_TOL = 1e-4
OBJ_ARGS = {"bottle": ["--obj_config", "obj_info_nocs.yml",
                       "--obj_category", "1"],
            "laptop": ["--obj_config", "obj_info_sapien.yml",
                       "--obj_category", "laptop"]}


def _argv(config_dir, exp_dir, obj="bottle", extra=()):
    return ["--config_dir", config_dir, "--experiment_dir", exp_dir,
            *OBJ_ARGS[obj], "--pointnet_cfg/camera", "pointnet2_tiny.yml",
            "--num_points", str(N), "--batch_size", "3",
            "--network/backbone_out_dim", "32", "--synthetic_data", *extra]


def _jax_config(argv):
    a = jargs.add_args(argparse.ArgumentParser()).parse_args(argv)
    return jget_config(a.config, jargs.config_overrides(a), a.config_dir)


def _flax_variables(cfg):
    """Jitted flax inits of the CoordNet and RotNet of `cfg` (numpy)."""
    P = cfg.obj.num_parts
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    cv = jax.jit(lambda k: JCoordNet(cfg).init(
        k, jnp.zeros((1, N, 3)), train=False))(k1)
    rv = jax.jit(lambda k: JRotNet(cfg).init(
        k, jnp.zeros((1, P, N, 3)), jnp.zeros((1, N), jnp.int32),
        train=False))(k2)
    return to_numpy(cv), to_numpy(rv)


def _save_jax(exp_dir, variables):
    """A checkpoint as the JAX package's trainer writes it (Adam state)."""
    state = types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=optax.adam(1e-3).init(variables["params"]), step=0)
    jckpt.save_checkpoint(pjoin(exp_dir, "ckpt"), 0, state)


def _run(main, argv, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(argv, **kwargs)
    return out.getvalue(), ret


def _avg_line(text):
    line = next(ln for ln in text.splitlines() if ln.startswith("AVG: "))
    return {k: float(v) for k, v in re.findall(r"(\S+)=(\S+)", line)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX and the port's track CLI on the same JAX-written checkpoints:
    {config_dir, coord, jax / port: (experiment dir, stdout)}."""
    root = tmp_path_factory.mktemp("cli")
    config_dir = str(root / "configs")
    shutil.copytree(DEFAULTS_DIR, config_dir)
    with open(pjoin(config_dir, "pointnet_config", "pointnet2_tiny.yml"),
              "w") as f:
        f.write(TINY_POINTNET)
    coord = str(root / "coord")
    cfg = _jax_config(_argv(config_dir, coord))
    cv, rv = _flax_variables(cfg)
    _save_jax(coord, cv)
    out = {"config_dir": config_dir, "coord": coord, "cfg": cfg,
           "variables": (cv, rv)}
    extra = ["--coord_exp/dir", coord, "--init_frame/gt", "true", "--save"]
    for pkg, main, kwargs in (("jax", jtrack.main, {}),
                              ("port", ttrack.main, {"device": "cpu"})):
        exp = str(root / pkg)
        _save_jax(exp, rv)
        text, _ = _run(main, _argv(config_dir, exp, extra=extra), **kwargs)
        out[pkg] = (exp, text)
    return out


_ARGVS = [
    [],
    ["--synthetic_data", "--save", "--no_eval"],
    ["--init_frame/gt", "false", "--track_cfg/gt_label", "true",
     "--batch_size", "4", "--coord_exp/dir", "x", "--resume_epoch", "3"],
    ["--quality_profile", "best", "--track_cfg/rot_fit", "fused",
     "--track_cfg/rot_fit_alpha", "0.5", "--nocs_otf", "true"],
    ["--pose_perturb/r", "3.0", "--loss_weight/rloss", "2",
     "--network/nocs_head_dims", "16", "--num_devices", "2",
     "--ckpt_format", "orbax"],
    ["--track_cfg/otf_fps_mode", "grouped", "--track_cfg/init_search", "64",
     "--mode_name", "real_test", "--coord_exp/resume_epoch", "1"],
]


@pytest.mark.parametrize("argv", _ARGVS)
def test_args_and_overrides_equal_jax(argv):
    want = jargs.add_args(argparse.ArgumentParser()).parse_args(argv)
    got = targs.add_args(argparse.ArgumentParser()).parse_args(argv)
    assert vars(got) == vars(want)
    assert targs.config_overrides(got) == jargs.config_overrides(want)
    assert targs.boolean_string("True") is True
    with pytest.raises(ValueError):
        targs.boolean_string("yes")


def test_track_cli_avg_matches_jax(runs):
    jtext, ttext = runs["jax"][1], runs["port"][1]
    want, got = _avg_line(jtext), _avg_line(ttext)
    assert sorted(got) == sorted(want) == [
        "10deg10cm", "5deg5cm", "rdiff", "sdiff", "tdiff"]
    for k in want:
        assert abs(got[k] - want[k]) <= POSE_TOL + 1e-9, (k, got, want)
    # one line a batch (B=3, then B=1), each trajectory's errors, the total
    for text in (jtext, ttext):
        assert "synthetic/0000|synthetic/0001|synthetic/0002: 19 frames x 3" \
            in text
        assert "synthetic/0003: 19 frames x 1" in text
        assert re.search(r"^TOTAL: 76 frames, [0-9.]+ fps$", text, re.M)
    for name in ("0000", "0001", "0002", "0003"):
        assert f"  synthetic/{name}: rdiff=" in ttext


def _load_results(exp):
    data = pjoin(exp, "results", "data")
    out = {}
    for name in sorted(os.listdir(data)):
        with open(pjoin(data, name), "rb") as f:
            out[name] = pickle.load(f)
    return out


def _assert_poses_close(got, want):
    np.testing.assert_allclose(got["rotation"], want["rotation"],
                               atol=POSE_TOL)
    np.testing.assert_allclose(got["translation"], want["translation"],
                               atol=POSE_TOL)
    np.testing.assert_allclose(got["scale"], want["scale"], rtol=POSE_TOL)


def test_saved_results_match_jax(runs):
    want, got = _load_results(runs["jax"][0]), _load_results(runs["port"][0])
    assert sorted(got) == sorted(want) == [
        f"synthetic_{i:04d}.pkl" for i in range(4)]
    for name in want:
        g, w = got[name], want[name]
        assert g["frame_nums"] == w["frame_nums"] == [[t] for t in
                                                      range(1, 20)]
        for side in ("pred", "gt"):
            for k, v in g[side]["poses"].items():
                assert isinstance(v, np.ndarray) and v.dtype == np.float32
                assert v.shape == w[side]["poses"][k].shape
        _assert_poses_close(g["pred"]["poses"], w["pred"]["poses"])
        for k in ("rotation", "translation", "scale"):
            np.testing.assert_array_equal(g["gt"]["poses"][k],
                                          w["gt"]["poses"][k])
        np.testing.assert_allclose(g["pred"]["corners"],
                                   w["pred"]["corners"], atol=POSE_TOL)


def test_saved_gt_corners_are_each_trajectorys_own(runs):
    """The port saves trajectory b's own box.  The JAX CLI indexes the
    synthetic corners [B, P, 2, 3] as the real-data [T, B, P, 2, 3]
    (`captra_tpu/cli/track.py:192`): trajectory b of a batch gets part b of
    the batch's first trajectory, and, the bottle having one part, every
    trajectory gets its batch's first box (jnp clamps the index)."""
    cfg = runs["cfg"]
    want, got = _load_results(runs["jax"][0]), _load_results(runs["port"][0])
    boxes = [make_trajectory(i, cfg.obj, num_frames=20,
                             num_points=N).corners for i in range(4)]
    for i, first in enumerate((0, 0, 0, 3)):     # batches (0, 1, 2), (3,)
        name = f"synthetic_{i:04d}.pkl"
        np.testing.assert_array_equal(got[name]["gt"]["corners"], boxes[i])
        np.testing.assert_array_equal(want[name]["gt"]["corners"],
                                      boxes[first][0])
    assert not np.array_equal(boxes[1], boxes[0])


def _evaluate(runs, pkg_main, exp, extra=(), **kwargs):
    argv = _argv(runs["config_dir"], exp, extra=["--coord_exp/dir",
                                                 runs["coord"], *extra])
    return _run(pkg_main, argv, **kwargs)


@pytest.mark.parametrize("no_iou", [False, True])
def test_evaluate_cli_on_the_port_results_matches_jax(runs, tmp_path,
                                                      no_iou):
    """The port's result files through both evaluate CLIs: the same err.csv
    keys and rows, values to `tests/test_torch_eval.py`'s tolerances."""
    extra = ["--no_iou"] if no_iou else []
    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = str(tmp_path / pkg)
        shutil.copytree(pjoin(runs["port"][0], "results"),
                        pjoin(dirs[pkg], "results"))
    _evaluate(runs, jevaluate_cli.main, dirs["jax"], extra)
    text, (rows, avg) = _evaluate(runs, tevaluate_cli.main, dirs["port"],
                                  extra, device="cpu")
    with open(pjoin(dirs["jax"], "results", "err.pkl"), "rb") as f:
        want = pickle.load(f)
    assert len(rows) == 4 * 19
    assert_rows_close(rows, want, "bottle", pjoin(dirs["port"], "results"))
    has_iou = any("iou" in k for k in rows[next(iter(rows))])
    assert has_iou == (not no_iou)
    with open(pjoin(dirs["port"], "results", "err.csv")) as f:
        header = f.readline().strip().split(",")
    with open(pjoin(dirs["jax"], "results", "err.csv")) as f:
        assert header == f.readline().strip().split(",")
    assert f"rdiff_0: {avg['rdiff_0']:.6f}" in text


def _laptop_both(tmp_path, T=3, B=2):
    """Both packages' track_sequences on one laptop batch of T frames (the
    JAX step built by its CLI's build_step), saving results."""
    from captra_tpu.data.synthetic import (
        batch_trajectories as jbatch, make_trajectory as jmake,
    )
    cfg_dir = str(tmp_path / "configs")
    shutil.copytree(DEFAULTS_DIR, cfg_dir)
    with open(pjoin(cfg_dir, "pointnet_config", "pointnet2_tiny.yml"),
              "w") as f:
        f.write(TINY_POINTNET)
    argv = _argv(cfg_dir, str(tmp_path / "jax"), "laptop",
                 ["--init_frame/gt", "true"])
    jcfg = _jax_config(argv)
    a = targs.add_args(argparse.ArgumentParser()).parse_args(
        _argv(cfg_dir, str(tmp_path / "port"), "laptop",
              ["--init_frame/gt", "true"]))
    tcfg = tget_config(a.config, targs.config_overrides(a), a.config_dir)
    cv, rv = _flax_variables(jcfg)
    names = tuple(f"laptop/{s}" for s in range(B))
    trajs = [jmake(seed=s, obj=jcfg.obj, num_frames=T, num_points=N)
             for s in range(B)]
    jb = jbatch(trajs)
    jb["corners"] = jb["corners"][None]     # the real-data layout
    with contextlib.redirect_stdout(io.StringIO()):
        want = jtrack.track_sequences(
            jcfg, jtrack.build_step(jcfg, cv, rv), [(names, jb)], save=True)
        tb = next(ttrack.synthetic_sequences(tcfg, count=B, num_frames=T))[1]
        got = ttrack.track_sequences(
            tcfg, ttrack.build_step(tcfg, cv, rv, device="cpu"),
            [(names, tb)], save=True, device="cpu")
    return jcfg, tcfg, want, got


def test_laptop_track_sequences_matches_jax(tmp_path):
    """Two parts, T=3: the averages and the saved poses, then the port's
    evaluation of its files (grid IoU and joint state; held to the JAX
    evaluator in `tests/test_torch_eval.py`)."""
    jcfg, tcfg, want, got = _laptop_both(tmp_path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=POSE_TOL)
    jres = _load_results(pjoin(tmp_path / "jax"))
    tres = _load_results(pjoin(tmp_path / "port"))
    for name in jres:
        _assert_poses_close(tres[name]["pred"]["poses"],
                            jres[name]["pred"]["poses"])
        np.testing.assert_array_equal(tres[name]["gt"]["corners"],
                                      jres[name]["gt"]["corners"])
    rows, _ = teval.evaluate_results_dir(
        pjoin(tmp_path / "port", "results"), tcfg.obj, verbose=False,
        device="cpu")
    assert len(rows) == 2 * 2
    keys = set(rows[next(iter(rows))])
    assert {"iou_0", "iou_1", "theta_diff_0", "npcs_iou_1"} <= keys
    assert np.isfinite([v for r in rows.values() for v in r.values()]).all()


def _bottle_step(runs):
    cv, rv = runs["variables"]
    cfg = tget_config("config_track.yml", {
        "obj_config": "obj_info_nocs.yml", "obj_category": "1",
        "pointnet_cfg/camera": "pointnet2_tiny.yml", "num_points": N,
        "network/backbone_out_dim": 32}, runs["config_dir"])
    return cfg, cv, rv


def _recording(monkeypatch):
    """Record the init pose of every `track_trajectory` call of the CLI."""
    calls = []

    def record(step, init_pose, frames, device=None):
        calls.append(init_pose)
        return track_trajectory(step, init_pose, frames, device=device)

    monkeypatch.setattr(ttrack, "track_trajectory", record)
    return calls


def test_init_noise_draws_from_the_seeded_generator(runs, monkeypatch):
    """With init_frame/gt false the frame-0 noise of each batch is exactly
    `init_pose_from_gt(..., generator=torch.Generator().manual_seed(seed))`
    drawn in sequence order (the warm-up reuses its batch's init)."""
    cfg, cv, rv = _bottle_step(runs)
    assert not cfg.track.init_frame_gt
    cfg = cfg.replace(batch_size=3)
    calls = _recording(monkeypatch)
    step = ttrack.build_step(cfg, cv, rv, device="cpu")
    seqs = list(ttrack.synthetic_sequences(cfg, count=4, num_frames=4))
    with contextlib.redirect_stdout(io.StringIO()):
        ttrack.track_sequences(cfg, step, seqs, seed=7, device="cpu")
    gen = torch.Generator().manual_seed(7)
    want = [init_pose_from_gt(batch["pose"][0], cfg, generator=gen)
            for _, batch in seqs]
    # warm-up B=3, batch 1, warm-up B=1, batch 2
    assert len(calls) == 4
    for got, w in zip(calls, [want[0], want[0], want[1], want[1]]):
        for f in ("rotation", "translation", "scale"):
            assert torch.equal(getattr(got, f), getattr(w, f))
    assert not torch.equal(want[0].rotation, seqs[0][1]["pose"][0].rotation)


def test_gt_less_branch_is_cloud_init_then_search(runs, monkeypatch):
    """A batch without GT starts from `init_pose_from_cloud`, refined by the
    orientation search with track_cfg/init_search > 0; its results carry
    no GT and the evaluator skips them."""
    import dataclasses
    cfg, cv, rv = _bottle_step(runs)
    cfg = cfg.replace(track=dataclasses.replace(cfg.track, init_search=4),
                      experiment_dir=str(runs["coord"]) + "_gtless")
    step = ttrack.build_step(cfg, cv, rv, device="cpu")
    _, batch = next(ttrack.synthetic_sequences(cfg, count=2, num_frames=3))
    batch = {k: batch[k] for k in ("points", "labels")}
    calls = _recording(monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        avgs = ttrack.track_sequences(cfg, step, [(("a", "b"), batch)],
                                      save=True, device="cpu")
    assert avgs == {} and "AVG" not in out.getvalue()
    guess = init_pose_from_cloud(batch["points"][0], 1, cfg.data_radius,
                                 device="cpu")
    want = search_init_orientation(step.coord_fn, batch["points"][0], guess,
                                   cfg, device="cpu")
    assert not torch.equal(want.rotation, guess.rotation)
    for f in ("rotation", "translation", "scale"):
        assert torch.equal(getattr(calls[-1], f), getattr(want, f))
    results = pjoin(cfg.experiment_dir, "results")
    saved = _load_results(cfg.experiment_dir)
    assert sorted(saved) == ["a.pkl", "b.pkl"]
    assert all(r["gt"] is None for r in saved.values())
    rows, _ = teval.evaluate_results_dir(results, cfg.obj, verbose=False,
                                         device="cpu")
    assert rows == {}


@pytest.mark.parametrize("case", ["gt", "nocs2d"])
def test_otf_branch_tracks_the_depth_video(case, tmp_path):
    """A depth video through the CLI's OTF branch equals `track_trajectory`
    on the same frames (the OTF trajectory is held to the JAX package's,
    with these shifts, in `tests/test_torch_otf.py`): the batch's crop
    shifts (`_jax_shifts`) and, for nocs2d_label, its detections go into
    the frames; a batch without shifts draws them from the seeded
    generator (checked once, in the "gt" case)."""
    import dataclasses

    from captra_tpu_torch.data import depth_frames
    from captra_tpu_torch.models.coordnet import CoordNet
    from captra_tpu_torch.models.rotnet import RotNet
    from captra_tpu_torch.tracking.tracker import evaluate_track
    from tests.test_torch_otf import (
        CAMERA_K, NOCS_GAIN, T, W, H, _jax_shifts, _otf_configs, _video,
    )
    _, cfg = _otf_configs(case)
    cfg = cfg.replace(experiment_dir=str(tmp_path / "exp"))
    B, P = 2, 1
    depth, mask = _video(B, dropout=False)
    gen = torch.Generator().manual_seed(0)
    coord = CoordNet(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        coord.nocs_head.dense_1.weight *= NOCS_GAIN
    step = make_track_step(cfg, coord, RotNet(cfg, device="cpu",
                                              generator=gen),
                           device="cpu", intrinsics=CAMERA_K)
    # every frame's GT: the pose at frame 0's blob (only frame 0 seeds)
    pose = depth_frames.otf_init_pose(depth[0, 0], mask[0, 0], B, P,
                                      intrinsics=CAMERA_K).map(
        lambda x: x.expand((T,) + x.shape).clone())
    batch = {"depth": depth, "mask": mask, "pose": pose,
             "shift": np.stack([_jax_shifts(t, B, H * W) for t in range(T)])}
    frames = {k: batch[k] for k in ("depth", "mask", "shift")}
    if case == "nocs2d":
        det = depth_frames.make_det_frames(depth, mask, K=2)
        batch.update(det)
        frames.update(det)
    with contextlib.redirect_stdout(io.StringIO()):
        got = ttrack.track_sequences(cfg, step, [(("a", "b"), batch)],
                                     save=True, device="cpu")
    _, aux = track_trajectory(step, pose[0], frames, device="cpu")
    errs = evaluate_track(aux.pose, pose.map(lambda x: x[1:]), sym=True)
    for k, v in errs.items():
        assert got[k] == [float(torch.mean(v[:, b])) for b in range(B)], k
    saved = _load_results(cfg.experiment_dir)
    np.testing.assert_array_equal(saved["b.pkl"]["pred"]["poses"]["scale"],
                                  aux.pose.scale[:, 1].numpy())
    if case != "gt":
        return
    # no shifts in the batch: drawn from the generator of `seed`
    del batch["shift"]
    frames["shift"] = torch.randint(0, H * W, (T, B),
                                    generator=torch.Generator().manual_seed(3))
    with contextlib.redirect_stdout(io.StringIO()):
        drawn = ttrack.track_sequences(cfg, step, [(("a", "b"), batch)],
                                       seed=3, device="cpu")
    _, aux = track_trajectory(step, pose[0], frames, device="cpu")
    want = evaluate_track(aux.pose, pose.map(lambda x: x[1:]), sym=True)
    assert drawn["rdiff"] == [float(torch.mean(want["rdiff"][:, b]))
                              for b in range(B)]
    assert drawn != got


@pytest.mark.parametrize("argv,field", [
    (["--num_devices", "2"], "--num_devices"),
    (["--synthetic_data", "--num_devices", "2"], "--num_devices"),
])
def test_track_main_raises_for_what_is_not_ported(argv, field):
    """Every option is ported: `--num_devices 2` gets as far as the
    checkpoints (missing here), which the first process reads before it
    starts the ranks; on CUDA more ranks than cards raise."""
    with pytest.raises(FileNotFoundError, match="checkpoints not found"):
        ttrack.main(argv, device="cpu")
    from captra_tpu_torch.cli.train import num_ranks
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{cards + 1} ranks .* {cards} "
                                         "cards"):
        num_ranks(cards + 1, None, torch.device("cuda"))


def test_orbax_experiment_raises(runs, tmp_path):
    """An experiment whose checkpoint is a directory without orbax
    metadata raises naming what is missing (orbax experiments that are
    whole: tests/test_torch_orbax.py)."""
    exp = tmp_path / "orbax_exp"
    (exp / "ckpt" / "model_0000").mkdir(parents=True)
    argv = _argv(runs["config_dir"], str(exp),
                 extra=["--coord_exp/dir", runs["coord"]])
    with pytest.raises(FileNotFoundError, match="_METADATA"):
        ttrack.main(argv, device="cpu")
