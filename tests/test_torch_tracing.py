"""The program's tracer (`captra_tpu_torch/utils/profiling.py`) and its
spans in the tracking and training steps, on the CPU at
`torch_port_helpers.tiny_config` sizes.

With no profiler a step records nothing and `annotate` is the shared
no-op; under `profiling.trace` a points step records `track.step` over
`track.coordnet`, `track.rotnet` and `track.fit` (once a pass), each net's
span over its backbone's four `backbone.neighbors` stages, an OTF step
adds `track.crop`, a train step records `train.step` over its forward,
backward and optimizer, and the names show as user annotations in the
Chrome trace; the store keeps its last 1024 roots; poses and losses are
bitwise the same with tracing on and off.  The card-only case reads
device times and counts one host synchronisation (skips without a card).
"""
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from captra_tpu_torch.config import schema
from captra_tpu_torch.data.synthetic import (
    batch_trajectories, make_frame_batch, make_trajectory,
)
from captra_tpu_torch.models.coordnet import CoordNet
from captra_tpu_torch.models.rotnet import RotNet
from captra_tpu_torch.pose.part_dof import Pose
from captra_tpu_torch.tracking.tracker import make_track_step
from captra_tpu_torch.training.trainer import Trainer
from captra_tpu_torch.utils import profiling
from torch_port_helpers import tiny_config

N, B = 256, 2
PASS = ["track.coordnet", "track.rotnet", "track.fit"]
# a backbone's neighbour searches: sa1, sa2, fp2 and fp1 (fp3 broadcasts)
NEIGHBORS = ["backbone.neighbors"] * 4
TRAIN = ["train.forward", "train.backward", "train.optimizer"]
CAMERA = np.array([[120.0, 0.0, 64.0], [0.0, 120.0, 48.0], [0.0, 0.0, 1.0]],
                  np.float32)


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset()
    yield
    profiling.reset()


def _nets(cfg, device="cpu"):
    g = torch.Generator().manual_seed(0)
    return (CoordNet(cfg, device=device, generator=g).eval(),
            RotNet(cfg, device=device, generator=g).eval())


def _points_case(refine_iters=1, device="cpu"):
    """A points step of tiny nets, its first pose and frame."""
    cfg = tiny_config(schema, num_points=N)
    cfg = cfg.replace(track=dataclasses.replace(cfg.track,
                                                refine_iters=refine_iters))
    data = batch_trajectories([make_trajectory(seed=s, obj=cfg.obj,
                                               num_frames=2, num_points=N)
                               for s in range(B)])
    coord, rot = _nets(cfg, device)
    step = make_track_step(cfg, coord, rot, device=device)
    pose = data["pose"].map(lambda x: x[0].to(device))
    return step, pose, {"points": data["points"][1]}


def _otf_case():
    """An OTF step of tiny nets on a 96 x 128 depth frame: a plate at 1 m
    over a background at 1.5 m, with sensor noise."""
    cfg = tiny_config(schema, num_points=N)
    cfg = cfg.replace(track=dataclasses.replace(cfg.track, nocs_otf=True,
                                                gt_label=True))
    rng = np.random.RandomState(3)
    depth = 1500 + rng.randint(-5, 5, (B, 96, 128)).astype(np.int32)
    mask = np.zeros((B, 96, 128), bool)
    mask[:, 30:60, 40:80] = True
    depth[mask] = 1000 + rng.randint(-20, 20, int(mask.sum()))
    coord, rot = _nets(cfg)
    step = make_track_step(cfg, coord, rot, device="cpu", intrinsics=CAMERA)
    P = cfg.obj.num_parts
    pose = Pose(torch.eye(3).expand(B, P, 3, 3),
                torch.tensor([0.0, 0.0, 1.0]).reshape(1, 1, 3, 1).expand(
                    B, P, 3, 1),
                torch.full((B, P), 0.3))
    frame = {"depth": depth, "mask": mask,
             "shift": torch.tensor([5, 4000])}
    return step, pose, frame


def _train_case(device="cpu"):
    """A CoordNet trainer (Adam) on a tiny net, its state and a batch with
    its draws."""
    cfg = tiny_config(schema, num_points=N)
    cfg = cfg.replace(network=dataclasses.replace(
        cfg.network, type="canon_coord", pwm_num=32))
    trainer = Trainer(cfg, steps_per_epoch=2, device=device)
    state = trainer.init_state(generator=torch.Generator().manual_seed(0))
    batch = make_frame_batch(0, cfg.obj, batch=4, num_points=N)
    draws = trainer.draw(batch, torch.Generator(device=device)
                         .manual_seed(1))
    return trainer, state, batch, draws


def _names(span):
    return [c["name"] for c in span["children"]]


def _no_card(span):
    """No device times and no sync counter without CUDA.  (On a machine
    with a card the profiler may initialise CUDA: a root opened after that
    times an idle stream with its events and counts no sync.)"""
    if not torch.cuda.is_available():
        assert span["device_ms"] is None
    if span["device_ms"] is None:
        assert span["counters"] == {}
    else:
        assert span["device_ms"] >= 0
        assert span["counters"] == {"host_syncs": 0}


def test_tracing_off_records_nothing():
    off = profiling.annotate("track.step")
    assert off is profiling.annotate("train.step")
    with off:
        profiling.count("host_syncs")
    step, pose, frame = _points_case()
    step(pose, frame)
    trainer, state, batch, draws = _train_case()
    trainer.train_step(state, batch, draws=draws)
    assert not profiling.TRACER.roots
    assert profiling.last_steps("track.step", 4) == []
    assert profiling.last_steps("train.step", 4) == []


@pytest.mark.parametrize("refine_iters", [1, 2])
def test_points_step_records_its_spans(tmp_path, refine_iters):
    step, pose, frame = _points_case(refine_iters)
    with profiling.trace(str(tmp_path)):
        step(pose, frame)
        step(pose, frame)
    spans = profiling.last_steps("track.step", 2)
    assert [s["step"] for s in spans] == [1, 2]
    for s in spans:
        assert _names(s) == PASS * refine_iters
        _no_card(s)
        assert s["host_ms"] >= sum(c["host_ms"] for c in s["children"]) > 0
        for c in s["children"]:
            assert c["step"] == s["step"]
            assert _names(c) == ([] if c["name"] == "track.fit"
                                 else NEIGHBORS)
            assert all(g["step"] == s["step"] and g["children"] == []
                       for g in c["children"])
    assert profiling.last_steps("track.step", 1) == spans[1:]


def test_otf_step_adds_the_crop(tmp_path):
    step, pose, frame = _otf_case()
    with profiling.trace(str(tmp_path)):
        step(pose, frame)
    span, = profiling.last_steps("track.step", 4)
    assert _names(span) == ["track.crop"] + PASS


def test_train_step_records_its_spans(tmp_path):
    trainer, state, batch, draws = _train_case()
    with profiling.trace(str(tmp_path)):
        trainer.train_step(state, batch, draws=draws)
    span, = profiling.last_steps("train.step", 4)
    assert _names(span) == TRAIN
    _no_card(span)
    assert profiling.last_steps("track.step", 4) == []


def test_span_names_show_in_the_chrome_trace(tmp_path):
    step, pose, frame = _points_case()
    trainer, state, batch, draws = _train_case()
    with profiling.trace(str(tmp_path)):
        step(pose, frame)
        trainer.train_step(state, batch, draws=draws)
    path, = (os.path.join(tmp_path, f) for f in os.listdir(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marked = {e["name"] for e in events
              if e.get("cat") == "user_annotation"}
    assert {"track.step", "train.step", *PASS, *TRAIN} <= marked


def test_the_store_keeps_its_last_roots(tmp_path):
    extra = 6
    with profiling.trace(str(tmp_path)):
        for i in range(profiling.KEEP + extra):
            with profiling.annotate("root"):
                with profiling.annotate("child"):
                    profiling.count("items", i)
                profiling.count("items")
    kept = profiling.last_steps("root", 2 * profiling.KEEP)
    assert len(kept) == len(profiling.TRACER.roots) == profiling.KEEP
    assert [s["step"] for s in kept] == list(
        range(extra + 1, profiling.KEEP + extra + 1))
    last = kept[-1]
    assert last["counters"].pop("host_syncs", 0) == 0
    assert last["counters"] == {"items": 1}
    assert last["children"][0]["counters"] == {
        "items": profiling.KEEP + extra - 1}
    profiling.reset()
    assert profiling.last_steps("root", 1) == []


def _pose_equal(a, b):
    for f in ("rotation", "translation", "scale"):
        torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0,
                                   atol=0, equal_nan=True)


def test_outputs_are_bitwise_equal_with_tracing_on_and_off(tmp_path):
    for case in (_points_case, _otf_case):
        step, pose, frame = case()
        off, aux_off = step(pose, frame)
        with profiling.trace(str(tmp_path)):
            on, aux_on = step(pose, frame)
        _pose_equal(on, off)
        assert torch.equal(aux_on.seg, aux_off.seg)
    runs = []
    for traced in (False, True):
        trainer, state, batch, draws = _train_case()
        if traced:
            with profiling.trace(str(tmp_path)):
                _, loss, _ = trainer.train_step(state, batch, draws=draws)
        else:
            _, loss, _ = trainer.train_step(state, batch, draws=draws)
        runs.append((loss["total_loss"], state.params.clone()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
def test_device_times_and_host_syncs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    step, pose, frame = _points_case(device=dev)
    trainer, state, batch, draws = _train_case(device=dev)
    step(pose, frame)
    trainer.train_step(state, batch, draws=draws)
    with profiling.trace(str(tmp_path)):
        step(pose, frame)
        trainer.train_step(state, batch, draws=draws)
        with profiling.annotate("synced"):
            torch.ones(4, device=dev).sum().item()
        # a sync debug mode set outside: its warnings still reach the caller
        with warnings.catch_warnings(record=True) as outer:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with profiling.annotate("watched"):
                    torch.ones(4, device=dev).sum().item()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    track, = profiling.last_steps("track.step", 1)
    train, = profiling.last_steps("train.step", 1)
    synced, = profiling.last_steps("synced", 1)
    for span in (track, train):
        assert span["device_ms"] > 0
        assert span["counters"]["host_syncs"] >= 0
        children = span["children"]
        assert all(c["device_ms"] > 0 for c in children)
        # a child's interval lies inside its parent's, on one stream
        assert sum(c["device_ms"] for c in children) <= \
            span["device_ms"] + 0.01
    assert _names(track) == PASS and _names(train) == TRAIN
    assert synced["counters"] == {"host_syncs": 1}
    watched, = profiling.last_steps("watched", 1)
    assert watched["counters"] == {"host_syncs": 1}
    assert sum(profiling.SYNC_WARNING in str(w.message) for w in outer) == 1
    assert torch.cuda.get_sync_debug_mode() == 0
