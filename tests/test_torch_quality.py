"""The port's quality harness (`captra_tpu_torch/eval/quality.py` and the
CLIs `eval_checkpoint_track`, `flagship_demo`, `gtless_init_probe`)
against the JAX package and the JAX scripts it counterparts.

Tiny nets (the tiny pointnet of `tests/torch_port_helpers.py`, 256
points), runs of T = 3 frames at B = 2 trajectories, bottle, float32, BN.
Every tracked comparison goes through one jitted JAX composition
(`make_track_step` -> `track_trajectory`, then `evaluate_track`), the one
the scripts run.  Tolerances (the track CLI's err.csv bars): angles
within 5e-4 degrees, every other mean within 1e-5 (relative above 1).

The eval harness runs on checkpoints the JAX package's writer wrote
(xavier weights with perturbed BN statistics, the NOCS head scaled x30
and a seg bias, as tests/test_torch_init_search.py does: a random head's
NPCS has no spread and the fits are ill-conditioned); the flagship on its
own two-step nets; the probe on the eval harness's checkpoints."""
import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import types
from os.path import join as pjoin

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from captra_tpu.config import get_config as jget_config
from captra_tpu.config import schema as jschema
from captra_tpu.data.synthetic import (
    batch_trajectories as jbatch, make_trajectory as jmake,
)
from captra_tpu.models.coordnet import CoordNet as JCoordNet
from captra_tpu.models.rotnet import RotNet as JRotNet
from captra_tpu.pose.part_dof import Pose as JPose
from captra_tpu.tracking import tracker as jtracker
from captra_tpu.training import checkpoint as jckpt
from captra_tpu_torch.cli import eval_checkpoint_track as ev
from captra_tpu_torch.cli import flagship_demo as fd
from captra_tpu_torch.cli import gtless_init_probe as pr
from captra_tpu_torch.config import get_config as tget_config
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.eval import quality
from captra_tpu_torch.models.coordnet import CoordNet
from captra_tpu_torch.models.rotnet import RotNet
from captra_tpu_torch.training.convert import flax_variables
from tests.torch_port_helpers import one_torch_thread, perturb, tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T, B = 256, 3, 2
ANGLE_TOL, TOL = 5e-4, 1e-5
NOCS_GAIN, SEG_BIAS = 30.0, 3.0
NETS = ["--dtype", "float32", "--norm", "bn"]
BOTTLE = {"obj_config": "obj_info_nocs.yml", "obj_category": "1"}


def _script(name):
    """A script of `scripts/`, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", pjoin(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tiny(real, schema):
    """`get_config` with the tiny net and N points; the rest as loaded."""
    tiny = tiny_config(schema, num_points=N)

    def get_config(config, overrides=None, base_dir=None):
        cfg = real(config, overrides, base_dir)
        return cfg.replace(
            num_points=N, pointnet=tiny.pointnet,
            network=dataclasses.replace(cfg.network, backbone_out_dim=32,
                                        nocs_head_dims=(16,)))
    return get_config


jtiny = _tiny(jget_config, jschema)
ttiny = _tiny(tget_config, tschema)


@pytest.fixture(autouse=True)
def tiny_cli(monkeypatch):
    """The CLIs on the tiny net, torch on one thread (under the parallel
    test run torch's thread a core oversubscribes the cores)."""
    for module in (ev, fd, pr):
        monkeypatch.setattr(module, "get_config", ttiny)
    monkeypatch.setattr(fd, "TRACK_FRAMES", T)
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def jax_track():
    """means(cv, rv, init_pose, points, gt) -> (frame-1, full-scan) means
    of the JAX composition on the tiny float32 BN bottle; one jit."""
    cfg = jtiny("config_track.yml", {**BOTTLE, "init_frame/gt": True,
                                     "network/norm": "bn"})
    coord, rotn = JCoordNet(cfg), JRotNet(cfg)

    @jax.jit
    def run(cv, rv, ip, points):
        step = jtracker.make_track_step(
            cfg, lambda p: coord.apply(cv, p, train=False),
            lambda p, l: rotn.apply(rv, p, l, train=False))
        return jtracker.track_trajectory(step, ip, {"points": points})[1]

    def means(cv, rv, init_pose, points, gt):
        aux = run(cv, rv, init_pose, jnp.asarray(points))
        errs = jtracker.evaluate_track(aux.pose, gt.map(lambda x: x[1:]),
                                       sym=True)
        return ({k: float(jnp.mean(v[0])) for k, v in errs.items()},
                {k: float(jnp.mean(v)) for k, v in errs.items()})
    return means


def _jax_data(seed_base=1000):
    cfg = jtiny("config_track.yml", BOTTLE)
    return jbatch([jmake(seed=seed_base + s, obj=cfg.obj, num_frames=T,
                         num_points=N) for s in range(B)])


def _jax_frozen(gt):
    frozen = JPose(rotation=jnp.repeat(gt.rotation[:1], T - 1, 0),
                   translation=jnp.repeat(gt.translation[:1], T - 1, 0),
                   scale=jnp.repeat(gt.scale[:1], T - 1, 0))
    errs = jtracker.evaluate_track(frozen, gt.map(lambda x: x[1:]), True)
    return {k: float(jnp.mean(v)) for k, v in errs.items()}


def assert_means(got: dict, want: dict, where: str):
    """rdiff within ANGLE_TOL degrees; every other mean within TOL, of
    max(1, |value|) above 1 (a two-step net's scale error is ~11, where
    float32's own spacing is ~1e-6)."""
    assert sorted(got) == sorted(want), where
    for k, v in want.items():
        tol = ANGLE_TOL if k == "rdiff" else TOL * max(1.0, abs(v))
        assert abs(got[k] - v) <= tol, (where, k, got[k], v)


def _jax_tree(variables):
    return jax.tree.map(jnp.asarray, variables)


@pytest.fixture(scope="module")
def jax_checkpoints(tmp_path_factory):
    """A coord and a rot experiment's checkpoints written by the JAX
    package's writer (an Adam state beside them): {"coord", "rot" (paths),
    "cv", "rv" (the variables)}."""
    root = tmp_path_factory.mktemp("quality_ckpt")
    cfg = ttiny("config_track.yml", {**BOTTLE, "network/norm": "bn"})
    gen = torch.Generator().manual_seed(0)
    rng = np.random.RandomState(1)
    cv = perturb(flax_variables(CoordNet(cfg, device="cpu", generator=gen)),
                 rng)
    rv = perturb(flax_variables(RotNet(cfg, device="cpu", generator=gen)),
                 rng)
    cv["params"]["nocs_head"]["dense_1"]["kernel"] *= np.float32(NOCS_GAIN)
    cv["params"]["seg_head"]["dense_0"]["bias"][:1] += np.float32(SEG_BIAS)
    out = {"cv": cv, "rv": rv}
    for name, v in (("coord", cv), ("rot", rv)):
        state = types.SimpleNamespace(
            params=v["params"], batch_stats=v["batch_stats"],
            opt_state=optax.adam(1e-3).init(v["params"]), step=0)
        out[name] = jckpt.save_checkpoint(str(root / name / "ckpt"), 0,
                                          state)
    return out


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args, **kwargs)
    return buf.getvalue(), ret


# ---------------------------------------------------------------------------
# the eval harness
# ---------------------------------------------------------------------------

def test_eval_harness_matches_the_jax_composition(jax_checkpoints, jax_track,
                                                  tmp_path):
    """The port's CLI on JAX-written checkpoints: its frame-1, full-scan
    and frozen-init means against the script's composition, and its
    printed lines through `summarize_q4.parse_sweep` into the computed
    values."""
    c = jax_checkpoints
    argv = ["--coord", c["coord"], "--rot", c["rot"], "--trajs", str(B),
            "--frames", str(T), *NETS]
    text, report = _printed(ev.main, argv, device="cpu")
    data = _jax_data()
    gt = data["pose"]
    cfg = jtiny("config_track.yml", {**BOTTLE, "init_frame/gt": True})
    init = jtracker.init_pose_from_gt(jax.random.PRNGKey(0),
                                      gt.map(lambda x: x[0]), cfg)
    f1, full = jax_track(_jax_tree(c["cv"]), _jax_tree(c["rv"]), init,
                         data["points"], gt)
    got = report["variants"][""]
    assert_means(got["frame1"], f1, "frame-1")
    assert_means(got["full"], full, "full-scan")
    assert_means(report["frozen_init"], _jax_frozen(gt), "frozen-init")

    log = tmp_path / "SWEEP.log"
    log.write_text(text)
    parsed = _script("summarize_q4").parse_sweep(str(log))
    assert parsed == {"default": {"frame1": quality.rounded(got["frame1"]),
                                  "full": quality.rounded(got["full"])},
                      "frozen-init": quality.rounded(report["frozen_init"])}


def test_eval_harness_refuses_a_mismatched_norm(jax_checkpoints):
    c = jax_checkpoints
    with pytest.raises(ValueError, match="norm=bn.*norm=gn"):
        ev.main(["--coord", c["coord"], "--rot", c["rot"]], device="cpu")


@pytest.mark.parametrize("argv, want", [
    ([], [("", {"delta_gain": 1.0})]),
    (["--delta_gain", "1.0,1.5,2"],
     [("gain=1.0", {"delta_gain": 1.0}), ("gain=1.5", {"delta_gain": 1.5}),
      ("gain=2.0", {"delta_gain": 2.0})]),
    (["--sweep", "delta:1;npcs:1;npcs:3:forward"],
     [("delta:1", {"rot_fit": "delta", "refine_iters": 1}),
      ("npcs:1", {"rot_fit": "npcs", "refine_iters": 1}),
      ("npcs:3:forward", {"rot_fit": "npcs", "refine_iters": 3,
                          "refine_mode": "forward"})]),
    (["--sweep", "fused;delta:2:debias"],
     [("fused", {"rot_fit": "fused", "refine_iters": 1}),
      ("delta:2:debias", {"rot_fit": "delta", "refine_iters": 2,
                          "refine_mode": "debias"})]),
    (["--sweep", "npcs:2", "--delta_gain", "1.5,2"],
     [("npcs:2", {"rot_fit": "npcs", "refine_iters": 2})]),
])
def test_eval_variants_are_the_scripts(argv, want):
    """The variant list of `--delta_gain` lists and `--sweep` specs (a
    sweep replaces the gains), as the script builds it."""
    args = ev.parser().parse_args(["--coord", "c", "--rot", "r", *argv])
    assert ev.variants(args) == want


@pytest.mark.parametrize("argv, want", [
    ([], {}),
    (["--quality_profile", "best"], {"track_cfg/quality_profile": "best"}),
    (["--quality_profile", "best", "--refine_iters", "2"],
     {"track_cfg/quality_profile": "best", "track_cfg/refine_iters": 2}),
    (["--init_noise", "--scale_clamp", "0.05", "--motion_model",
      "const_vel", "--conf_weighted_delta", "--fit_ransac", "8"],
     {"track_cfg/scale_clamp": 0.05, "track_cfg/motion_model": "const_vel",
      "track_cfg/conf_weighted_delta": True, "track_cfg/fit_ransac": 8}),
    (["--rot_fit", "npcs", "--refine_mode", "forward", "--rot_fit_alpha",
      "0.5", "--dtype", "float32", "--norm", "bn", "--category", "2"],
     {"track_cfg/rot_fit": "npcs", "track_cfg/refine_mode": "forward"}),
])
def test_eval_config_follows_the_override_rule(argv, want):
    """Only a track flag that differs from its default enters the config
    (so `best` fills in the rest); the port's config equals the JAX
    package's `get_config` of the same overrides."""
    ap = ev.parser()
    args = ap.parse_args(["--coord", "c", "--rot", "r", *argv])
    overrides = ev.config_overrides(args, ap)
    base = {"obj_config": "obj_info_nocs.yml",
            "obj_category": args.category,
            "init_frame/gt": "--init_noise" not in argv,
            "network/compute_dtype": args.dtype, "network/norm": args.norm}
    assert overrides == {**base, **want}
    got = tget_config("config_track.yml", overrides)
    expect = jget_config("config_track.yml", overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(expect)


# ---------------------------------------------------------------------------
# the GT-less init probe
# ---------------------------------------------------------------------------

def test_repose_to_theta_is_the_scripts_bit_for_bit():
    """The port's numpy copy against the script's function, loaded by
    path, on the same scans, at RandomState(7) drawn through four thetas
    in turn."""
    script = _script("gtless_init_probe")
    jdata = _jax_data()
    tcfg = ttiny("config_track.yml", BOTTLE)
    tdata = quality.eval_set(tcfg.obj, B, T, N)
    jrng = np.random.RandomState(quality.REPOSE_SEED)
    trng = np.random.RandomState(quality.REPOSE_SEED)
    for theta in (0.0, 10.0, 45.0, 90.0):
        want = script.repose_to_theta(jdata, theta, jrng)
        got = quality.repose_to_theta(tdata, theta, trng)
        assert np.array_equal(got["points"], np.asarray(want["points"]))
        for f in ("rotation", "translation", "scale"):
            w = np.asarray(getattr(want["pose"], f))
            g = getattr(got["pose"], f).numpy()
            assert g.dtype == w.dtype and np.array_equal(g, w), (theta, f)


def test_probe_rows_match_the_jax_composition(jax_checkpoints, jax_track,
                                              monkeypatch, tmp_path):
    """The probe's gt-init, raw-draw and theta rows (unrounded here) against
    the JAX composition from `init_pose_from_cloud` on the same
    re-posed scans; the JSON report has the script's layout."""
    monkeypatch.setattr(quality, "rounded", lambda values, digits=4: values)
    c = jax_checkpoints
    out = tmp_path / "probe.json"
    thetas = (0.0, 45.0)
    _, report = _printed(pr.main, [
        "--coord", c["coord"], "--rot", c["rot"], "--trajs", str(B),
        "--frames", str(T), *NETS, "--thetas", ",".join(map(str, thetas)),
        "--out", str(out)], device="cpu")
    script = _script("gtless_init_probe")
    cv, rv = _jax_tree(c["cv"]), _jax_tree(c["rv"])
    base = _jax_data()
    rng = np.random.RandomState(quality.REPOSE_SEED)

    def cloud_init(data):
        return jtracker.init_pose_from_cloud(jnp.asarray(data["points"][0]),
                                             1, 0.6)
    rows = [("gt-init", base["pose"].map(lambda x: x[0]), base),
            ("cloud-init/raw-draw", cloud_init(base), base)]
    for theta in thetas:
        data = script.repose_to_theta(base, theta, rng)
        rows.append((f"cloud-init/theta={theta:g}", cloud_init(data), data))
    assert [r["tag"] for r in report["rows"]] == [t for t, _, _ in rows]
    for got, (tag, init, data) in zip(report["rows"], rows):
        f1, full = jax_track(cv, rv, init, data["points"], data["pose"])
        assert_means(got["frame1"], f1, f"{tag} frame-1")
        assert_means(got["full"], full, f"{tag} full-scan")
    saved = json.loads(out.read_text())
    assert sorted(saved) == ["args", "rows"]
    assert [r["tag"] for r in saved["rows"]] == [t for t, _, _ in rows]


# ---------------------------------------------------------------------------
# the flagship
# ---------------------------------------------------------------------------

def _flagship(out, *argv):
    return ["--batch", "4", "--track_trajs", str(B), "--out", str(out),
            "--distinct_batches", "3", "--norm", "bn", *argv]


def _evidence_keys(tree, depth=2):
    if depth == 0 or not isinstance(tree, dict):
        return None
    return {k: _evidence_keys(v, depth - 1) for k, v in tree.items()
            if not k.isdigit()}


def _covers(got, want) -> bool:
    if want is None:
        return True
    return isinstance(got, dict) and all(
        k in got and _covers(got[k], v) for k, v in want.items())


def test_flagship_snapshots_evidence_and_tracking(jax_track, tmp_path):
    """Two steps a leg with an `--eval_at 1` snapshot: the snapshot equals
    a separate one-step run's nets bit for bit; EVIDENCE.json has the keys
    of the JAX record's; the tracked block equals the JAX composition on
    the saved weights; `--skip_coord` loads the CoordNet and trains only
    the RotNet."""
    run_a = fd.parse(_flagship(tmp_path / "a", "--steps", "2",
                               "--eval_at", "1"))
    _, (report, legs) = _printed(fd.run, run_a, "cpu")
    _printed(fd.main, _flagship(tmp_path / "b", "--steps", "1"),
             device="cpu")
    for net in ("canon_coord", "rot"):
        snap = legs[net]["snapshots"][1]
        one = jckpt.load_checkpoint(str(tmp_path / "b" / net / "ckpt" /
                                        "model_0000"))
        module = (CoordNet if net == "canon_coord" else RotNet)(
            fd.track_config(run_a), device="cpu")
        module.load_state_dict(snap)
        snap_tree = flax_variables(module)
        for coll in ("params", "batch_stats"):
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                    snap_tree[coll]):
                other = one[coll]
                for key in path:
                    other = other[key.key]
                assert np.array_equal(leaf, np.asarray(other)), (net, path)

    with open(tmp_path / "a" / "EVIDENCE.json") as f:
        evidence = json.load(f)
    with open(pjoin(ROOT, "runs", "trend_bottle_aug", "EVIDENCE.json")) as f:
        record = json.load(f)
    assert _covers(evidence, _evidence_keys(record))
    assert sorted(evidence["trend"]) == ["1"]
    assert sorted(evidence["trend"]["1"]) == ["frame1", "full"]
    assert evidence["tracking"]["device"] == "cpu"
    assert len(evidence["canon_coord"]["total_loss_by_50"]) == 1

    data = _jax_data()
    cv, rv = (_jax_tree({k: v for k, v in jckpt.load_checkpoint(str(
        tmp_path / "a" / net / "ckpt" / "model_0000")).items()
        if k in ("params", "batch_stats")}) for net in ("canon_coord", "rot"))
    gt = data["pose"]
    f1, tracked = jax_track(cv, rv, gt.map(lambda x: x[0]),
                            data["points"] + np.float32(1e-9), gt)
    assert_means(evidence["tracking_frame1"], f1, "frame-1")
    assert_means(evidence["tracking"]["tracked"], tracked, "tracked")
    assert_means(evidence["tracking"]["frozen_init"], _jax_frozen(gt),
                 "frozen-init")

    text, (report_c, legs_c) = _printed(fd.run, fd.parse(_flagship(
        tmp_path / "b", "--steps", "1", "--skip_coord")), "cpu")
    assert "skipping coord training" in text
    assert report_c["canon_coord"] == {"final": {}, "sec": 0.0,
                                       "loaded": True}
    loaded = flax_variables(legs_c["canon_coord"]["state"].module)
    one = jckpt.load_checkpoint(str(tmp_path / "b" / "canon_coord" / "ckpt" /
                                    "model_0000"))
    for path, leaf in jax.tree_util.tree_leaves_with_path(loaded["params"]):
        other = one["params"]
        for key in path:
            other = other[key.key]
        assert np.array_equal(leaf, np.asarray(other)), path
    assert "rot" in report_c and report_c["rot"]["sec"] >= 0.0


def test_printed_rows_parse_as_the_script_prints_them():
    """`quality.row` prints what the eval script's `print(tag + "frame-1
    ", {...})` prints."""
    values = {"rdiff": 1.23456789, "5deg5cm": 0.5}
    for kind, label in (("frame-1", "frame-1    "),
                        ("full-scan", "full-scan  "),
                        ("frozen-init", "frozen-init")):
        for tag in ("", "npcs:3:forward"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                print((f"[{tag}] " if tag else "") + label,
                      {k: round(v, 4) for k, v in values.items()})
            line = quality.row(kind, values, tag)
            assert line + "\n" == buf.getvalue()
            m = _script("summarize_q4").ROW.match(line)
            assert m.group(1) == (tag or None) and m.group(2) == kind
            assert ast.literal_eval(m.group(3)) == quality.rounded(values)
