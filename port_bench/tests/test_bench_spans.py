"""The readers of the program's spans and counters (`port_bench/spans.py`,
`metrics/*_span_ms*.py`, `step_self_ms.track`, `host_syncs.*`): each reads
a hand-built store to a known value, and reads nothing (None) on a CPU
run, on the control stand-ins, without a traced window, with too few
roots, without device times, or from a program that has no tracer."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from port_bench.controls import STEPS, TRAIN_PROGRAMS
from port_bench.drivers import track, train
from port_bench.harness import metric_reader
from port_bench.tests.conftest import cpu_context, tiny_cell
from port_bench.tests.test_bench_cells import tiny_train_cell

TRACK = ("crop_span_ms", "coordnet_span_ms", "rotnet_span_ms",
         "fit_span_ms", "step_self_ms.track", "host_syncs.track")
TRAIN = ("forward_span_ms.train", "backward_span_ms.train",
         "optimizer_span_ms.train", "host_syncs.train")


def span(name, device_ms, children=(), **counters):
    return {"name": name, "step": 0, "host_ms": 1.0, "device_ms": device_ms,
            "counters": counters, "children": list(children)}


def track_root(total, crop, passes, syncs):
    kids = [span("track.crop", crop)]
    for c, r, f in passes:
        kids += [span("track.coordnet", c), span("track.rotnet", r),
                 span("track.fit", f)]
    return span("track.step", total, kids, host_syncs=syncs)


def train_root(total, fwd, bwd, opt, syncs):
    return span("train.step", total, [
        span("train.forward", fwd), span("train.backward", bwd),
        span("train.optimizer", opt)], host_syncs=syncs)


# the oldest root of each kind is the profiler's throwaway step: not read
STORE = [track_root(99.0, 9.0, [(9.0, 9.0, 9.0)], 9),
         track_root(25.0, 2.0, [(5.0, 6.0, 1.0), (4.0, 3.0, 0.5)], 1),
         track_root(18.0, 3.0, [(6.0, 7.0, 1.0)], 0),
         train_root(99.0, 9.0, 9.0, 9.0, 9),
         train_root(40.0, 12.0, 20.0, 2.0, 0),
         train_root(44.0, 14.0, 22.0, 3.0, 1)]
WANT = {"crop_span_ms": 2.5, "coordnet_span_ms": 7.5, "rotnet_span_ms": 8.0,
        "fit_span_ms": 1.25, "step_self_ms.track": (3.5 + 1.0) / 2,
        "host_syncs.track": 0.5, "forward_span_ms.train": 13.0,
        "backward_span_ms.train": 21.0, "optimizer_span_ms.train": 2.5,
        "host_syncs.train": 0.5}
TRACED = SimpleNamespace(trace=SimpleNamespace(steps=2))


@pytest.fixture
def store(monkeypatch):
    """`profiling.last_steps` over a list of roots the test holds."""
    from captra_tpu_torch.utils import profiling
    roots = [dict(r) for r in STORE]

    def last_steps(root, n):
        named = [r for r in roots if r["name"] == root]
        return named[max(len(named) - n, 0):]
    monkeypatch.setattr(profiling, "last_steps", last_steps)
    return roots


@pytest.mark.parametrize("name", TRACK + TRAIN)
def test_reader_reads_a_hand_built_store(store, name):
    assert metric_reader(name)(TRACED) == pytest.approx(WANT[name], abs=0,
                                                        rel=1e-12)


@pytest.mark.parametrize("name", TRACK + TRAIN)
def test_reader_reads_nothing_without_what_it_reads(store, monkeypatch,
                                                    name):
    read = metric_reader(name)
    assert read(SimpleNamespace(trace=None)) is None
    assert read(SimpleNamespace(trace=SimpleNamespace(steps=4))) is None
    # a root without device times (the CPU)
    kind = "track.step" if name in TRACK else "train.step"
    i = max(i for i, r in enumerate(store) if r["name"] == kind)
    store[i] = dict(store[i], device_ms=None)
    assert read(TRACED) is None
    # a program without the tracer (the parent of the spans)
    from captra_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "last_steps")
    assert read(TRACED) is None


def test_the_crop_reads_nothing_where_no_step_crops(store):
    for r in store:
        r["children"] = [c for c in r["children"]
                         if c["name"] != "track.crop"]
    assert metric_reader("crop_span_ms")(TRACED) is None
    assert metric_reader("coordnet_span_ms")(TRACED) == 7.5


def _recorded(out, root, program):
    """The traced window's steps left their roots, without device times,
    where the program ran; the control left none."""
    from captra_tpu_torch.utils import profiling
    steps = out.run.trace.steps
    got = profiling.last_steps(root, steps)
    assert len(got) == (steps if program else 0)
    assert all(r["device_ms"] is None for r in got)


@pytest.mark.parametrize("make_step", [None, "control"])
def test_track_readers_read_nothing_on_a_cpu_run(make_step):
    from captra_tpu_torch.utils import profiling
    profiling.reset()
    cell = tiny_cell("bottle_otf_b16")
    ctx = cpu_context(cell, seconds=0.3, trace=True)
    out = (track.run(ctx) if make_step is None
           else track.run(ctx, make_step=STEPS[make_step]))
    _recorded(out, "track.step", make_step is None)
    for name in TRACK:
        assert metric_reader(name)(out.run) is None


@pytest.mark.parametrize("program", [None, "control"])
def test_train_readers_read_nothing_on_a_cpu_run(program):
    from captra_tpu_torch.utils import profiling
    profiling.reset()
    cell = tiny_train_cell()
    ctx = cpu_context(cell, seconds=0.3, trace=True)
    out = (train.run(ctx) if program is None
           else train.run(ctx, make_program=TRAIN_PROGRAMS[program]))
    _recorded(out, "train.step", program is None)
    for name in TRAIN:
        assert metric_reader(name)(out.run) is None
