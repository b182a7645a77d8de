"""The port's saved results and offline evaluator against the JAX package's
(`captra_tpu/tracking/results.py`, `captra_tpu/eval/evaluator.py`).

Corners from the tracked aux are exact (a gather and a masked max).  On one
results directory the two evaluators give the same err.csv header, row
names and keys.  Translation and scale errors and prismatic joint states
agree within 1e-5 (metres; the largest difference seen over these cases is
7.5e-9).  Angles (rotation errors, revolute joint states) are held to
5e-4 degrees, about twice the largest difference seen, 2.7e-4 degrees (a
drawers rotation error; the laptop's reach 9.5e-5, its joint states
3.1e-5): they are arccos of a float32 trace, which XLA and torch round
differently, and arccos turns a 1-ulp (6e-8) trace difference into
6e-8 / sin(theta) radians, 2e-4 degrees at a 1-degree error.  The
axis-aligned IoU agrees within 1e-6 (3e-7 seen), the grid IoU within the
face bound of `test_torch_bbox.py` (2.4e-5 seen)."""
import csv
import os
import pickle
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.eval import evaluator as jeval
from captra_tpu.pose.part_dof import Pose as JPose
from captra_tpu.tracking import results as jresults
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.eval import evaluator as teval
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking import results as tresults
from tests.test_torch_bbox import _corners, _grid_bound, _poses
from tests.torch_port_helpers import OBJECTS

DRAWERS = dict(category="drawers", name="drawers", num_parts=4,
               num_joints=3, tree=(3, 3, 3, -1), sym=False,
               joint_type="prismatic", main_axis=(2, 2, 2), extra_dims=0)
OBJS = {**OBJECTS, "drawers": DRAWERS}
POSE_TOL = 1e-5
ANGLE_TOL = 5e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _track(rng, T: int, P: int):
    """A GT trajectory [T, P] and a prediction near it: rotated by a few
    degrees, moved by up to 5 mm, scaled by up to 1%."""
    gt = _poses(rng, T, P)
    q, r = np.linalg.qr(np.eye(3) + 0.05 * rng.randn(T, P, 3, 3))
    small = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    jitter = _poses(rng, T, P)
    pred = dict(rotation=(gt["rotation"] @ small).astype(np.float32),
                translation=gt["translation"] + 0.1 * jitter["translation"],
                scale=gt["scale"] * (1 + 0.05 * (jitter["scale"] - 1)))
    return gt, pred


def test_corners_from_track_aux_matches_jax():
    rng = np.random.RandomState(0)
    T, B, N, P = 3, 2, 64, 3
    labels = rng.randint(0, P + 1, (T, B, N))       # P: background
    nocs = rng.randn(T, B, N, 3 * P).astype(np.float32)
    want = jresults.corners_from_track_aux(
        types.SimpleNamespace(pred_labels=jnp.asarray(labels),
                              nocs=jnp.asarray(nocs)), P)
    got = tresults.corners_from_track_aux(
        types.SimpleNamespace(pred_labels=_t(labels), nocs=_t(nocs)), P)
    assert isinstance(got, np.ndarray) and got.shape == (T, B, P, 2, 3)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("obj", ["laptop", "drawers"])
def test_joint_states_match_jax(obj):
    rng = np.random.RandomState(1)
    P = OBJS[obj]["num_parts"]
    p = _poses(rng, 5, P)
    want = jeval.get_joint_state(jschema.ObjCfg(**OBJS[obj]),
                                 JPose(**{k: jnp.asarray(v)
                                          for k, v in p.items()}))
    got = teval.get_joint_state(tschema.ObjCfg(**OBJS[obj]),
                                Pose(**{k: _t(v) for k, v in p.items()}))
    assert got.shape == (5, OBJS[obj]["num_joints"])
    revolute = OBJS[obj].get("joint_type", "revolute") == "revolute"
    tol = ANGLE_TOL if revolute else POSE_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


def _results_dir(root, obj: str, gt_less: bool = False):
    """Two tracked trajectories of 4 frames saved by the JAX package, and
    with `gt_less` a third without GT."""
    rng = np.random.RandomState(2)
    P = OBJS[obj]["num_parts"]
    out = str(root / obj / "results")
    for i in range(2 + gt_less):
        gt, pred = _track(rng, 4, P)
        gt_corners = _corners(rng, P)
        pred_corners = np.broadcast_to(
            gt_corners * np.float32(1.1), (4, P, 2, 3)).copy()
        has_gt = i < 2
        jresults.save_track_result(
            out, f"traj_{i}", JPose(**pred),
            JPose(**gt) if has_gt else None, pred_corners,
            gt_corners if has_gt else None,
            frame_nums=[[t] for t in range(1, 5)])
    return out


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], {r[0]: dict(zip(rows[0][1:], map(float, r[1:])))
                     for r in rows[1:]}


def _evaluate_both(tmp_path, obj: str, eval_iou: bool, gt_less=False):
    src = _results_dir(tmp_path / "src", obj, gt_less)
    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = str(tmp_path / pkg)
        shutil.copytree(src, dirs[pkg])
    jeval.evaluate_results_dir(dirs["jax"], jschema.ObjCfg(**OBJS[obj]),
                               eval_iou=eval_iou, verbose=False)
    teval.evaluate_results_dir(dirs["port"], tschema.ObjCfg(**OBJS[obj]),
                               eval_iou=eval_iou, verbose=False,
                               device="cpu")
    return dirs


@pytest.mark.parametrize("obj,eval_iou", [("laptop", True),
                                          ("bottle", True),
                                          ("drawers", False)])
def test_evaluators_agree_on_one_results_dir(tmp_path, obj, eval_iou):
    dirs = _evaluate_both(tmp_path, obj, eval_iou)
    jhead, jrows = _read_csv(os.path.join(dirs["jax"], "err.csv"))
    thead, trows = _read_csv(os.path.join(dirs["port"], "err.csv"))
    assert thead == jhead and list(trows) == list(jrows)
    assert len(trows) == 2 * 4
    metrics = {k.rsplit("_", 1)[0] for k in thead[1:]}
    want = {"rdiff", "tdiff", "sdiff", "5deg5cm", "10deg10cm"}
    if eval_iou:
        want |= {"npcs_iou", "iou", "gt_bbox_iou"}
    if OBJS[obj]["num_parts"] > 1:
        want.add("theta_diff")
    assert metrics == want
    assert_rows_close(trows, jrows, obj, dirs["port"])
    with open(os.path.join(dirs["port"], "err.pkl"), "rb") as f:
        assert pickle.load(f) == trows


def assert_rows_close(rows: dict, jrows: dict, obj: str, results_dir: str):
    """The port's err rows against the JAX package's, each metric to its
    tolerance (the module docstring); `results_dir` holds the evaluated
    files, for the grid IoU's bounds."""
    assert list(rows) == list(jrows)
    revolute = OBJS[obj].get("joint_type", "revolute") == "revolute"
    grid = OBJS[obj]["num_parts"] > 1
    bounds = None
    for name, row in rows.items():
        assert sorted(row) == sorted(jrows[name]), name
        for key, v in row.items():
            w = jrows[name][key]
            metric = key.rsplit("_", 1)[0]
            if metric.endswith("iou") and grid:
                bounds = bounds or _iou_bounds(results_dir, obj)
                tol = bounds[name][key]
            elif metric.endswith("iou"):
                tol = 1e-6
            elif metric == "rdiff" or (metric == "theta_diff" and revolute):
                tol = ANGLE_TOL
            else:
                tol = POSE_TOL
            assert abs(v - w) <= tol, (name, key, v, w, tol)


def _iou_bounds(results_dir, obj):
    """{row: {key: bound}} of the grid IoUs of every saved trajectory."""
    out = {}
    data = os.path.join(results_dir, "data")
    for raw in sorted(os.listdir(data)):
        with open(os.path.join(data, raw), "rb") as f:
            d = pickle.load(f)
        gt = Pose(**{k: _t(v) for k, v in d["gt"]["poses"].items()})
        pred = Pose(**{k: _t(v) for k, v in d["pred"]["poses"].items()})
        pc = _t(d["pred"]["corners"])
        gc = torch.broadcast_to(_t(d["gt"]["corners"]), pc.shape)
        for metric in ("npcs_iou", "iou", "gt_bbox_iou"):
            b = _grid_bound(metric, gc, pc, gt, pred, OBJS[obj]["sym"])
            for t in range(b.shape[0]):
                row = out.setdefault(f"{raw[:-4]}_{t + 1}", {})
                for j in range(b.shape[1]):
                    row[f"{metric}_{j}"] = b[t, j]
    return out


def test_gt_less_artifacts_are_skipped(tmp_path):
    dirs = _evaluate_both(tmp_path, "bottle", eval_iou=False, gt_less=True)
    jhead, jrows = _read_csv(os.path.join(dirs["jax"], "err.csv"))
    thead, trows = _read_csv(os.path.join(dirs["port"], "err.csv"))
    assert len(os.listdir(os.path.join(dirs["port"], "data"))) == 3
    assert thead == jhead and list(trows) == list(jrows)
    assert not any(name.startswith("traj_2") for name in trows)


def test_flatten_and_write_give_the_jax_files(tmp_path):
    rng = np.random.RandomState(3)
    metrics = {"rdiff": rng.rand(3, 2).astype(np.float32),
               "iou": rng.rand(3, 2).astype(np.float32),
               "theta_diff": rng.rand(3, 1).astype(np.float32),
               "npcs_iou": rng.rand(3, 2).astype(np.float32)}
    rows = {}
    for name in ("b", "a"):
        want = jeval.flatten_per_frame(name, metrics)
        got = teval.flatten_per_frame(name, metrics)
        assert got == want
        rows.update(got)
    assert teval.summarize(rows) == jeval.summarize(rows)
    jeval.write_outputs(rows, str(tmp_path / "jax"))
    teval.write_outputs(rows, str(tmp_path / "port"))
    for name in ("err.csv", "err.pkl"):
        with open(tmp_path / "jax" / name, "rb") as f:
            want = f.read()
        with open(tmp_path / "port" / name, "rb") as f:
            assert f.read() == want, name
