"""The traced window: `torch.profiler` over a few steps, its Chrome trace
reduced to what the per-layer readers read.

The benchmark's own `record_function` ranges ("bench.step",
"bench.coordnet", "bench.rotnet", "bench.readback") open on the host.  A
kernel (or copy, or memset) belongs to every range its launch lies in: its
launch is the runtime or driver call of the same correlation id; a kernel
with no launch in the trace takes the launch time of the next kernel on
the card's timeline that has one (a stream runs in launch order).
"""
from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


@dataclass
class Summary:
    """One traced window: `steps` steps; seconds of the window and of device
    work in it; device seconds by range (a kernel counts in each range its
    launch lies in) and by step segment ("before_coordnet": launched in a
    step before its CoordNet range opened, "after_rotnet": after its RotNet
    range closed); device seconds by kernel name."""
    steps: int
    window_s: float = 0.0
    busy_s: float = 0.0
    ranges_s: dict = field(default_factory=dict)
    kernels_s: dict = field(default_factory=dict)
    idle_gaps: list = field(default_factory=list)
    unlaunched: int = 0
    kernels: int = 0


def profile(run_step, steps: int, cuda: bool):
    """Run `run_step` `steps` times under the profiler (after one untraced
    profiled step that takes its start-up) -> the trace's events."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with prof_ctx(activities=acts):
        run_step()
    with prof_ctx(activities=acts) as prof:
        for _ in range(steps):
            run_step()
    tmp = tempfile.mkdtemp(prefix="port_bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return events.get("traceEvents", events) if isinstance(events, dict) \
        else events


def _top_level(spans):
    """The spans [(start, end, name)] not inside another, sorted."""
    out = []
    for s in sorted(spans):
        if out and s[0] < out[-1][1]:
            continue
        out.append(s)
    return out


def summarize(events: list, steps: int) -> Summary:
    """Reduce a Chrome trace's events (see the module)."""
    dev, launch, ranges, ops = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", "?"),
                        args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = ts
        elif cat == "user_annotation" and e.get("name", "").startswith(
                "bench."):
            ranges.append((ts, ts + dur, e["name"]))
        elif cat == "cpu_op":
            ops.append((ts, ts + dur, e.get("name", "?")))
    out = Summary(steps=steps)
    step_ranges = sorted(r for r in ranges if r[2] == "bench.step")
    if not dev or not step_ranges:
        return out
    dev.sort()
    # launch time of each device event; the unlaunched take the next
    # launched one's
    at = [launch.get(c) for *_, c in dev]
    out.unlaunched = sum(a is None for a in at)
    nxt = None
    for i in range(len(dev) - 1, -1, -1):
        if at[i] is None:
            at[i] = nxt
        else:
            nxt = at[i]
    lo, hi = step_ranges[0][0], max(r[1] for r in ranges)
    out.window_s = (hi - lo) * 1e-6
    inside = [(d, a) for d, a in zip(dev, at)
              if a is not None and lo <= a <= hi]
    out.kernels = len(inside)
    for (s, e, name, _), _ in inside:
        out.kernels_s[name] = out.kernels_s.get(name, 0.0) + (e - s) * 1e-6

    # device seconds by range and by step segment
    named: dict = {}
    for s, e, name in ranges:
        named.setdefault(name, []).append((s, e))
    for name, spans in named.items():
        spans.sort()
        starts = [s for s, _ in spans]
        total = 0.0
        for (s, e, _, _), a in inside:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a <= spans[i][1]:
                total += (e - s) * 1e-6
        out.ranges_s[name] = total
    coord = sorted(named.get("bench.coordnet", []))
    rot = sorted(named.get("bench.rotnet", []))
    before = after = 0.0
    for s0, e0, _ in step_ranges:
        c = [s for s, _ in coord if s0 <= s <= e0]
        r = [e for _, e in rot if s0 <= e <= e0]
        for (s, e, _, _), a in inside:
            if c and s0 <= a < min(c):
                before += (e - s) * 1e-6
            if r and max(r) < a <= e0:
                after += (e - s) * 1e-6
    if coord:
        out.ranges_s["before_coordnet"] = before
    if rot:
        out.ranges_s["after_rotnet"] = after

    # busy time: the union of the device intervals inside the window
    busy, cur_s, cur_e = 0.0, None, None
    gaps = {}
    top_ops = _top_level(ops)
    op_starts = [s for s, _, _ in top_ops]
    all_ranges = sorted(ranges)
    for (s, e, _, _), a in sorted(inside):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                label = _host_label(a, top_ops, op_starts, all_ranges)
                gaps[label] = gaps.get(label, 0.0) + (s - cur_e) * 1e-6
                busy += (cur_e - cur_s) * 1e-6
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += (cur_e - cur_s) * 1e-6
    out.busy_s = busy
    out.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return out


def _host_label(t, top_ops, op_starts, ranges) -> str:
    """What the host was doing when it launched at `t`: the innermost
    benchmark range and the outermost operator around it."""
    rng = "host"
    for s, e, name in ranges:
        if s <= t <= e:
            rng = name
        elif s > t:
            break
    i = bisect.bisect_right(op_starts, t) - 1
    op = top_ops[i][2] if i >= 0 and t <= top_ops[i][1] else "python"
    return f"{rng}/{op}"


def breakdown(summary: Summary) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time and the longest idle gaps by what the host was doing."""
    ops = sorted(summary.kernels_s.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in summary.idle_gaps]}
