"""The tracking step's CUDA graph (`captra_tpu_torch/tracking/tracker.py`:
`make_track_step`, `eager_reason`, `graph_counts`) and the benchmark's
reader of it (`port_bench/metrics/graph_replay_share.track.py`).

On the CPU: a CPU step never captures; `eager_reason` sends each of its
cases to the eager path; the eager step gives its body's numbers; the
graph path's bookkeeping (input buffers laid out as the inputs, fresh
outputs, launch counts moved from the capture to every replay) through a
fake graph that replays the body in Python; the reader.  On the card
(marker `cuda`, skipped without one), the real graph against the eager
step bit for bit at the benchmark's cells.  This file imports no JAX:

    python -m pytest tests/test_torch_track_graph.py -m cuda -o addopts="" \
        --noconftest -q
"""
import contextlib
import dataclasses
import sys
import types

import numpy as np
import pytest
import torch

from captra_tpu_torch.config import schema
from captra_tpu_torch.config.schema import TrackCfg
from captra_tpu_torch.data.synthetic import (
    batch_trajectories, make_trajectory,
)
from captra_tpu_torch.models.coordnet import CoordNet
from captra_tpu_torch.models.rotnet import RotNet
from captra_tpu_torch.ops import cuda_build, fps, pointops
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking import tracker
from torch_port_helpers import tiny_config

N, B, T = 256, 2, 7
CAMERA = np.array([[120.0, 0.0, 64.0], [0.0, 120.0, 48.0], [0.0, 0.0, 1.0]],
                  np.float32)
CASES = ["points", "otf", "const_vel"]


def _counts() -> dict:
    return dict(tracker.graph_counts)


def _grown(before: dict) -> dict:
    return {k: n - before[k] for k, n in tracker.graph_counts.items()}


def _case(kind: str, device="cpu", coord_wrap=None):
    """A step of tiny seeded nets, its first carry and T frames (points: a
    synthetic trajectory; OTF: a noisy plate on 96 x 128 depth with the
    crop's shifts; const_vel: the points step with the motion model)."""
    cfg = tiny_config(schema, num_points=N)
    if kind == "otf":
        cfg = cfg.replace(track=dataclasses.replace(cfg.track, nocs_otf=True,
                                                    gt_label=True))
    elif kind == "const_vel":
        cfg = cfg.replace(track=dataclasses.replace(
            cfg.track, motion_model="const_vel"))
    g = torch.Generator().manual_seed(0)
    coord = CoordNet(cfg, device=device, generator=g).eval()
    rot = RotNet(cfg, device=device, generator=g).eval()
    coord_fn = coord if coord_wrap is None else coord_wrap(coord)
    P = cfg.obj.num_parts
    if kind == "otf":
        rng = np.random.RandomState(3)
        depth = 1500 + rng.randint(-5, 5, (T, B, 96, 128)).astype(np.int32)
        mask = np.zeros((T, B, 96, 128), bool)
        mask[..., 30:60, 40:80] = True
        depth[mask] = 1000 + rng.randint(-20, 20, int(mask.sum()))
        frames = {"depth": torch.from_numpy(depth),
                  "mask": torch.from_numpy(mask),
                  "shift": torch.from_numpy(rng.randint(0, 96 * 128, (T, B)))}
        pose = Pose(torch.eye(3).expand(B, P, 3, 3).contiguous(),
                    torch.tensor([0.0, 0.0, 1.0]).reshape(1, 1, 3, 1).expand(
                        B, P, 3, 1).contiguous(),
                    torch.full((B, P), 0.3))
        step = tracker.make_track_step(cfg, coord_fn, rot, device=device,
                                       intrinsics=CAMERA)
    else:
        data = batch_trajectories([make_trajectory(
            seed=s, obj=cfg.obj, num_frames=T, num_points=N)
            for s in range(B)])
        frames = {"points": torch.from_numpy(data["points"])}
        pose = data["pose"].map(lambda x: x[0])
        step = tracker.make_track_step(cfg, coord_fn, rot, device=device)
    frames = {k: v.to(device) for k, v in frames.items()}
    pose = pose.map(lambda x: x.to(device))
    carry = step.init_carry(pose) if kind == "const_vel" else pose
    return step, carry, frames, (coord, rot)


def _frame(frames: dict, t: int) -> dict:
    return {k: v[t] for k, v in frames.items()}


def _assert_same(got, want):
    """Bit for bit, in the same layouts."""
    a, b = tracker._leaves(got), tracker._leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.stride() == y.stride()
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the CPU: the eager path and its selection
# ---------------------------------------------------------------------------

def test_a_cpu_step_never_captures():
    step, carry, frames, _ = _case("points")
    before = _counts()
    for t in range(1, 4):
        carry, _ = step(carry, _frame(frames, t))
    assert _grown(before) == {"eager": 3, "captured": 0, "replayed": 0}
    assert step.graphs == {}


_POINTS = {"points": np.zeros((B, N, 3), np.float32)}
_OTF = {"depth": np.zeros((B, 8, 8), np.int32),
        "mask": np.zeros((B, 8, 8), bool)}
_DRAWS = np.zeros((B, 1, 4, N), np.float32)


@pytest.mark.parametrize("device, track, frame, reason", [
    ("cuda", {}, _POINTS, None),
    ("cpu", {}, _POINTS, "not a CUDA step"),
    ("cuda", {"nocs_otf": True}, dict(_OTF, shift=np.zeros(B, np.int64)),
     None),
    ("cuda", {"nocs_otf": True}, _OTF, "the crop draws its shifts"),
    ("cuda", {"fit_ransac": 4}, _POINTS,
     "the fit draws its RANSAC hypotheses"),
    ("cuda", {"fit_ransac": 4}, dict(_POINTS, gumbel_fit=_DRAWS), None),
    ("cuda", {"fit_ransac": 4, "rot_fit": "npcs"},
     dict(_POINTS, gumbel_fit=_DRAWS), "the fit draws its RANSAC hypotheses"),
    ("cuda", {"fit_ransac": 4, "rot_fit": "npcs"},
     dict(_POINTS, gumbel_fit=_DRAWS, gumbel_rot=_DRAWS), None),
    ("cuda", {}, dict(_POINTS, labels=None), "a frame entry is not an array"),
], ids=["points", "cpu", "otf_shift", "otf_draw", "ransac_draw",
        "ransac_given", "rot_ransac_draw", "rot_ransac_given", "not_array"])
def test_eager_reason(device, track, frame, reason):
    cfg = dataclasses.replace(TrackCfg(), **track)
    assert tracker.eager_reason(torch.device(device), cfg, frame) == reason


def test_a_recording_profiler_selects_the_eager_path():
    cuda = torch.device("cuda")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracker.eager_reason(cuda, TrackCfg(), _POINTS) \
            == "a profiler records"
    assert tracker.eager_reason(cuda, TrackCfg(), _POINTS) is None


def test_a_wrapped_fps_entry_selects_the_eager_path(monkeypatch):
    cuda = torch.device("cuda")
    monkeypatch.setattr(pointops, "farthest_point_sample_indices",
                        fps.fps_plain)
    assert tracker.eager_reason(cuda, TrackCfg(), _POINTS) \
        == "the FPS entry is wrapped"


@pytest.mark.parametrize("kind", CASES)
def test_the_eager_step_gives_its_body_s_numbers(kind):
    """The step as built, on the CPU, against the body it wraps (the step
    as it was before the graph), each from its own carry."""
    step, carry, frames, _ = _case(kind)
    want = carry
    for t in range(1, 4):
        carry, aux = step(carry, _frame(frames, t))
        want, want_aux = step.body(want, _frame(frames, t))
        _assert_same((carry, aux), (want, want_aux))


# ---------------------------------------------------------------------------
# the CPU: the graph path's bookkeeping through a fake graph
# ---------------------------------------------------------------------------

class _FakeStream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Replays by running the step's body again on the input buffers and
    writing into the captured outputs (the launch counters held still:
    a real replay makes no Python call)."""

    def __init__(self):
        self.body = self.owner = None

    def replay(self):
        g = self.owner
        was = dict(cuda_build.launch_counts)
        new = self.body(g.carry, g.frame)
        cuda_build.launch_counts.update(was)
        for out, x in zip(tracker._leaves(g.out), tracker._leaves(new)):
            out.copy_(x)


class _NoSync:
    def close(self):
        return 0


@pytest.fixture
def fake_graphs(monkeypatch):
    """CPU steps take the graph path, with `_FakeGraph` for CUDA's."""
    real = tracker.eager_reason
    monkeypatch.setattr(tracker, "eager_reason", lambda device, track, frame:
                        real(torch.device("cuda"), track, frame))
    monkeypatch.setattr(tracker, "SyncCount", _NoSync)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, stream=None:
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())


def _wire(step):
    """Give each fake graph of `step` the body it replays."""
    for g in step.graphs.values():
        if isinstance(g, tracker._Graph):
            g.graph.body, g.graph.owner = step.body, g


def _launching(coord):
    """CoordNet, counting one FPS launch a call (a CPU net launches
    none)."""
    def call(x):
        cuda_build.count("fps_cuda_batched")
        return coord(x)
    return call


@pytest.mark.parametrize("kind", CASES)
def test_the_graph_path_keeps_the_eager_numbers(kind, fake_graphs):
    """Six frames through the graph path against its body, each a closed
    loop: equal bit for bit in the same layouts; every kept answer
    unchanged after the later replays; one launch a step on every path;
    the calls by path (const_vel's first carry, an expanded identity, is
    a signature of its own)."""
    step, carry, frames, _ = _case(kind, coord_wrap=_launching)
    want, kept = carry, []
    before = _counts()
    for t in range(1, T):
        launched = fps.launch_counts["fps_cuda_batched"]
        carry, aux = step(carry, _frame(frames, t))
        assert fps.launch_counts["fps_cuda_batched"] == launched + 1
        _wire(step)
        want, want_aux = step.body(want, _frame(frames, t))
        _assert_same((carry, aux), (want, want_aux))
        kept.append(((carry, aux), [x.clone() for x in
                                    tracker._leaves((carry, aux))]))
    for got, snapshot in kept:
        for x, y in zip(tracker._leaves(got), snapshot):
            assert torch.equal(x, y)
    eager = 2 if kind == "const_vel" else 1
    assert _grown(before) == {"eager": eager, "captured": 1,
                              "replayed": T - 2 - eager}


def test_a_new_layout_is_a_new_signature(fake_graphs):
    step, pose, frames, _ = _case("points")
    frame = _frame(frames, 1)
    for _ in range(3):
        step(pose, frame)
        _wire(step)
    strided = {"points": frame["points"].transpose(1, 2).contiguous()
               .transpose(1, 2)}
    before = _counts()
    got, _ = step(pose, strided)
    assert _grown(before) == {"eager": 1, "captured": 0, "replayed": 0}
    assert len(step.graphs) == 2


# ---------------------------------------------------------------------------
# the benchmark's reader
# ---------------------------------------------------------------------------

def _reader():
    from port_bench.harness import metric_reader
    return metric_reader("graph_replay_share.track")


_TRACED = types.SimpleNamespace(trace=types.SimpleNamespace(kernels=7376))


@pytest.mark.parametrize("module, share", [
    (None, None),
    (types.SimpleNamespace(), None),
    (types.SimpleNamespace(graph_counts={"eager": 0, "captured": 0,
                                         "replayed": 0}), None),
    (types.SimpleNamespace(graph_counts={"eager": 17, "captured": 1,
                                         "replayed": 983}), 983 / 1000),
    (types.SimpleNamespace(graph_counts={"eager": 5, "captured": 0,
                                         "replayed": 0}), 0.0),
], ids=["not_loaded", "no_counter", "no_steps", "share", "all_eager"])
def test_graph_replay_share_reader(module, share, monkeypatch):
    name = "captra_tpu_torch.tracking.tracker"
    if module is None:
        monkeypatch.delitem(sys.modules, name)
    else:
        monkeypatch.setitem(sys.modules, name, module)
    assert _reader()(_TRACED) == share


def test_graph_replay_share_reads_nothing_without_device_work(monkeypatch):
    monkeypatch.setitem(sys.modules, "captra_tpu_torch.tracking.tracker",
                        types.SimpleNamespace(graph_counts={
                            "eager": 1, "captured": 1, "replayed": 9}))
    read = _reader()
    assert read(_TRACED) == 0.9
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(types.SimpleNamespace(
        trace=types.SimpleNamespace(kernels=0))) is None


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _bench_case(card, cell: str, streams=None, track=None):
    """The benchmark's nets and traffic of `cell` (T frames, its streams
    unless given, `track` over its tracking options): (set-up, the port's
    config, first carry as a Pose)."""
    from port_bench.drivers import track as driver
    from port_bench.harness import Clock, Context, find_cell, load_spec
    c = find_cell(load_spec(), cell)
    c.traffic = dict(c.traffic, frames=T)
    if streams is not None:
        c.traffic["streams"] = streams
    if track:
        c.traffic["track"] = {**c.traffic.get("track", {}), **track}
    ctx = Context(cell=c, seed=2 ** 31 + 21, seconds=0.0, trace=False,
                  device=card, clock=Clock(), log=lambda msg: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = driver.setup(ctx)
    pcfg = driver.port_config(c.config, c.traffic.get("track", {}))
    return s, pcfg, Pose(*(s["init"][k] for k in
                           ("rotation", "translation", "scale")))


def _launches() -> dict:
    return dict(cuda_build.launch_counts)


def _launch_growth(before: dict) -> dict:
    return {k: n - before[k] for k, n in cuda_build.launch_counts.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("cell, track", [
    ("bottle_points_b16", None), ("bottle_otf_b16", None),
    ("drawers_points_b8", None),
    ("bottle_points_b16", {"motion_model": "const_vel"}),
], ids=["bottle_points_b16", "bottle_otf_b16", "drawers_points_b8",
        "bottle_points_b16_const_vel"])
def test_the_graphed_step_equals_the_eager_step(card, cell, track):
    """Six frames of a cell's streams through one step (eager, captured,
    then replayed) against its body run eagerly, each a closed loop:
    poses, seg, NPCS and labels equal bit for bit, every step's launch
    counts grown alike, each kept answer unchanged by later replays."""
    s, pcfg, pose = _bench_case(card, cell, track=track)
    step = tracker.make_track_step(pcfg, *s["nets"], device=card)
    cv = hasattr(step, "init_carry")
    carry = step.init_carry(pose) if cv else pose
    want, kept = carry, []
    before = _counts()
    for t in range(1, T):
        frame = _frame(s["frames"], t)
        launched = _launches()
        carry, aux = step(carry, frame)
        grown = _launch_growth(launched)
        launched = _launches()
        want, want_aux = step.body(want, frame)
        assert grown == _launch_growth(launched), t
        for name, a, b in (("pose", carry, want), ("aux", aux, want_aux)):
            for x, y in zip(tracker._leaves(a), tracker._leaves(b)):
                assert torch.equal(x, y), (t, name)
        kept.append(((carry, aux), [x.clone() for x in
                                    tracker._leaves((carry, aux))]))
    torch.cuda.synchronize()
    for got, snapshot in kept:
        for x, y in zip(tracker._leaves(got), snapshot):
            assert torch.equal(x, y)
    eager = 2 if cv else 1
    assert _grown(before) == {"eager": eager, "captured": 1,
                              "replayed": T - 2 - eager}


@pytest.mark.cuda
def test_an_in_place_weight_update_is_followed(card):
    """After the capture, CoordNet's weights loaded anew in place
    (`load_state_dict`): the replay equals a new eager step on the updated
    nets, and differs from the replay before."""
    s, pcfg, pose = _bench_case(card, "bottle_points_b16", streams=2)
    coord, rot = s["nets"]
    step = tracker.make_track_step(pcfg, coord, rot, device=card)
    frame = _frame(s["frames"], 1)
    for _ in range(3):
        old_pose, old_aux = step(pose, frame)
    before = _counts()
    sd = {k: v * 1.01 if v.is_floating_point() else v
          for k, v in coord.state_dict().items()}
    coord.load_state_dict(sd)
    got = step(pose, frame)
    assert _grown(before)["replayed"] == 1
    want = tracker.make_track_step(pcfg, coord, rot, device=card).body(
        pose, frame)
    _assert_same(got, want)
    assert not torch.equal(got[1].nocs, old_aux.nocs)


@pytest.mark.cuda
def test_a_recording_profiler_runs_the_step_eagerly(card):
    """A captured step under a recording profiler: eager, the tracer's
    spans recorded, the answer the replay's."""
    from captra_tpu_torch.utils import profiling
    s, pcfg, pose = _bench_case(card, "bottle_points_b16", streams=2)
    step = tracker.make_track_step(pcfg, *s["nets"], device=card)
    frame = _frame(s["frames"], 1)
    for _ in range(3):
        replayed = step(pose, frame)
    profiling.reset()
    before = _counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        got = step(pose, frame)
    assert _grown(before) == {"eager": 1, "captured": 0, "replayed": 0}
    (root,) = profiling.last_steps("track.step", 1)
    assert [c["name"] for c in root["children"]] == [
        "track.coordnet", "track.rotnet", "track.fit"]
    assert root["counters"] == {"host_syncs": 0}
    profiling.reset()
    _assert_same(got, replayed)


@pytest.mark.cuda
def test_a_step_that_syncs_the_host_stays_eager(card):
    """A CoordNet that reads a number back to the host: the capture's
    warm-up counts the sync, and the signature stays eager."""
    def reading(coord):
        def call(x):
            out = coord(x)
            float(out["seg"].sum())
            return out
        return call
    s, pcfg, pose = _bench_case(card, "bottle_points_b16", streams=2)
    coord, rot = s["nets"]
    step = tracker.make_track_step(pcfg, reading(coord), rot, device=card)
    frame = _frame(s["frames"], 1)
    before = _counts()
    got = [step(pose, frame) for _ in range(4)]
    assert _grown(before) == {"eager": 4, "captured": 0, "replayed": 0}
    assert list(step.graphs.values()) == ["eager"]
    for g in got[1:]:
        _assert_same(g, got[0])
