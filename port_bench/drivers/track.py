"""The tracking driver: B streams tracked in lockstep by the port's step
(`captra_tpu_torch.tracking.tracker.make_track_step`), a closed loop.

Set-up makes the weights and the traffic on the card from the seed, builds
the port's nets and step, and warms the step up on the cell's shapes.  The
window then calls the step once a frame for all streams and reads the
poses back to the host before it calls the next; a stream that has tracked
its last frame restarts at its frame-0 pose.  Every step is timed from its
call to its poses on the host.

The answers compared: the window's first step (from the traffic's own
frame-0 poses) and a seeded reservoir sample of the others.  Each is held,
once the window has closed and the program is freed, to the plain
reference's step from the same carried pose on the same frame (the
reference can only follow the program step by step: random nets' tracks
part after some frames, so a free-running reference could not be
compared).  With --trace 1 a profiled window of TRACE_STEPS steps follows
the measured one.
"""
from __future__ import annotations

import gc
import math
import random
import time

import numpy as np
import torch

from port_bench import counts, trace, traffic, weights
from port_bench.harness import Outcome, derive_seed, reference

SAMPLED = 6            # reservoir answers compared, besides the first step
WARMUP_STEPS = 3
TRACE_STEPS = 16
POSE = ("rotation", "translation", "scale")


def port_config(cfg: dict, overrides: dict):
    """The port's `Config` for the configuration file `cfg` with the traffic's
    `track` overrides."""
    from captra_tpu_torch.config.schema import (
        Config, NetworkCfg, ObjCfg, PointNetCfg, SAMsgCfg, TrackCfg, tuplify,
    )

    def sa(d):
        return SAMsgCfg(npoint=d["npoint"],
                        radius_list=tuplify(d["radius_list"]),
                        nsample_list=tuplify(d["nsample_list"]),
                        mlp_list=tuplify(d["mlp_list"]))

    pn = cfg["pointnet"]
    return Config(
        obj=ObjCfg(**{k: tuplify(v) for k, v in cfg["obj"].items()}),
        network=NetworkCfg(**{k: tuplify(v)
                              for k, v in cfg["network"].items()}),
        pointnet=PointNetCfg(sa1=sa(pn["sa1"]), sa2=sa(pn["sa2"]),
                             **{k: tuplify(pn[k]) for k in
                                ("sa3_mlp", "fp3_mlp", "fp2_mlp",
                                 "fp1_mlp")}),
        track=TrackCfg(**{**cfg["track"], **overrides}),
        num_points=cfg["num_points"], data_radius=cfg["data_radius"])


class Ranges:
    """The benchmark's `record_function` ranges, open only while tracing."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return _NULL
        return torch.profiler.record_function(name)

    def wrap(self, name: str, fn):
        def ranged(*args):
            with self(name):
                return fn(*args)
        return ranged


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class FpsRecorder:
    """Records the inputs of every FPS call of the program while on (a
    wrapper around `captra_tpu_torch.ops.pointops`'s entry, which the
    backbone and the crop call)."""

    def __init__(self):
        from captra_tpu_torch.ops import pointops
        self.mod = pointops
        self.orig = pointops.farthest_point_sample_indices
        self.calls = []

    def __enter__(self):
        def rec(xyz, npoint):
            self.calls.append((xyz, int(npoint)))
            return self.orig(xyz, npoint)
        self.mod.farthest_point_sample_indices = rec
        return self

    def __exit__(self, *exc):
        self.mod.farthest_point_sample_indices = self.orig
        return False

    def bound_s(self) -> float:
        """Σ of each call's least time (`counts.fps_bound_s`), its picks
        counted from its inputs' distinct points."""
        total = 0.0
        for xyz, npoint in self.calls:
            B, N, _ = xyz.shape
            picks = sum(min(npoint, int(torch.unique(xyz[b], dim=0)
                                        .shape[0])) for b in range(B))
            total += counts.fps_bound_s(B, N, npoint, picks)
        return total


class Sampler:
    """The first step and a reservoir of SAMPLED others, from the seed."""

    def __init__(self, seed: int):
        self.rng = random.Random(derive_seed(seed, "sample"))
        self.first = None
        self.pool = []
        self.seen = 0

    def offer(self, record) -> None:
        if self.first is None:
            self.first = record
            return
        self.seen += 1
        if len(self.pool) < SAMPLED:
            self.pool.append(record)
        else:
            j = self.rng.randrange(self.seen)
            if j < SAMPLED:
                self.pool[j] = record

    def records(self) -> list:
        return [r for r in [self.first, *self.pool] if r is not None]


class Loop:
    """B streams in lockstep over the traffic's frames."""

    def __init__(self, step, frames: dict, init: dict, Pose):
        self.step = step
        self.frames = frames
        self.init = Pose(*(init[k] for k in POSE))
        self.T = next(iter(frames.values())).shape[0]
        self.reset()

    def reset(self) -> None:
        self.pose, self.f = self.init, 1

    def advance(self, ranges: Ranges):
        """One step and its readback -> (frame index, carried pose, new
        pose, aux, host poses, enqueue s, step s)."""
        f, pose = self.f, self.pose
        frame = {k: v[f] for k, v in self.frames.items()}
        t0 = time.perf_counter()
        with ranges("bench.step"):
            new, aux = self.step(pose, frame)
        t1 = time.perf_counter()
        with ranges("bench.readback"):
            B = new.scale.shape[0]
            host = torch.cat([getattr(new, k).reshape(B, -1)
                              for k in POSE], 1).cpu().numpy()
        t2 = time.perf_counter()
        self.pose, self.f = new, f + 1
        if self.f == self.T:
            self.reset()
        return f, pose, new, aux, host, t1 - t0, t2 - t0


class WindowRun:
    """What the per-layer readers read: the measured window and, with
    --trace 1, the traced one."""

    def __init__(self, steps, seconds, enqueue_s, flops_per_step,
                 summary=None, fps_bound_s=None):
        self.steps = steps
        self.seconds = seconds
        self.enqueue_s = enqueue_s
        self.flops_per_step = flops_per_step
        self.trace = summary
        self.fps_bound_s = fps_bound_s


def _gap(a: torch.Tensor, b: torch.Tensor, rel: bool = False) -> float:
    d = (a.double() - b.double()).abs()
    if rel:
        d = d / b.double().abs()
    v = float(d.max())
    return v if math.isfinite(v) else math.inf


def compare(ref, cfg: dict, w: dict, records: list, frames: dict,
            matmul: str = "float32") -> dict:
    """The widest gap between the program's and the reference's answers
    over the sampled steps: seg probabilities, NPCS, rotation entries,
    translations (m), scales (relative)."""
    pr = ref.Precision(matmul)
    gaps = {k: 0.0 for k in ("seg_gap", "nocs_gap", "rot_gap", "trans_gap",
                             "scale_gap")}
    with torch.no_grad():
        for f, pose_in, new, aux in records:
            carried = {k: getattr(pose_in, k) for k in POSE}
            if "depth" in frames:
                out, seg, nocs = ref.track_depth(
                    pr, w["coord"], w["rot"], cfg, carried,
                    frames["depth"][f], frames["shift"][f])
            else:
                out, seg, nocs = ref.track_points(
                    pr, w["coord"], w["rot"], cfg, carried,
                    frames["points"][f])
            for key, got, want, rel in (
                    ("seg_gap", aux.seg, seg, False),
                    ("nocs_gap", aux.nocs, nocs, False),
                    ("rot_gap", new.rotation, out["rotation"], False),
                    ("trans_gap", new.translation, out["translation"], False),
                    ("scale_gap", new.scale, out["scale"], True)):
                gaps[key] = max(gaps[key], _gap(got, want, rel))
    return gaps


def port_step(pcfg, coord_fn, rot_fn, device, bench):
    """The system under test: the port's tracking step."""
    from captra_tpu_torch.tracking.tracker import make_track_step
    return make_track_step(pcfg, coord_fn, rot_fn, device=device)


def setup(ctx, make_step=port_step):
    """Weights, traffic, the port's nets and step, on the context's device.
    `make_step(port config, coord_fn, rot_fn, device, bench)` builds the
    step; `bench` holds the configuration file ("cfg"), the reference
    ("ref") and the weights ("w")."""
    from captra_tpu_torch.models.coordnet import CoordNet
    from captra_tpu_torch.models.rotnet import RotNet
    cell, dev = ctx.cell, ctx.device
    cfg = dict(cell.config)
    cfg["track"] = {**cfg["track"], **cell.traffic.get("track", {})}
    ref = reference(cfg["reference"])
    marks = [("start", ctx.clock.since_start())]
    w = weights.make(ref.weight_spec(cfg), cfg, ctx.seed, dev)
    marks.append(("weights", ctx.clock.since_start()))
    frames, init = traffic.make(cell.traffic, cfg, ctx.seed, dev)
    marks.append(("traffic", ctx.clock.since_start()))
    weights.calibrate(ref, cfg, w, init, {k: v[1] for k, v in frames.items()})
    marks.append(("calibration", ctx.clock.since_start()))
    pcfg = port_config(cell.config, cell.traffic.get("track", {}))
    coord = CoordNet(pcfg, device=dev)
    rot = RotNet(pcfg, device=dev)
    coord.load_state_dict(w["coord"])
    rot.load_state_dict(w["rot"])
    ranges = Ranges()
    step = make_step(pcfg, ranges.wrap("bench.coordnet", coord),
                     ranges.wrap("bench.rotnet", rot), dev,
                     {"cfg": cfg, "ref": ref, "w": w})
    from captra_tpu_torch.pose.part_dof import Pose
    marks.append(("nets and step", ctx.clock.since_start()))
    return dict(cfg=cfg, ref=ref, w=w, frames=frames, init=init,
                nets=(coord, rot), ranges=ranges, marks=marks,
                loop=Loop(step, frames, init, Pose))


def quiet_collector() -> None:
    """Collect the set-up's garbage and move what survives out of the
    collector's sight, so that the window's collections walk only the
    window's own objects."""
    gc.collect()
    gc.freeze()


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx, make_step=port_step) -> Outcome:
    dev = ctx.device
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    s = setup(ctx, make_step)
    loop, ranges, cfg = s["loop"], s["ranges"], s["cfg"]
    B = s["init"]["scale"].shape[0]
    for _ in range(WARMUP_STEPS):
        loop.advance(ranges)
    loop.reset()
    sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    quiet_collector()
    setup_s = ctx.clock.since_start()
    ctx.log("set-up: " + ", ".join(f"{k} at {v:.3f} s" for k, v in
                                   s["marks"] + [("warm-up", setup_s)]))

    sampler = Sampler(ctx.seed)
    enqueue, step_s, hosts = [], [], []
    start = time.perf_counter()
    deadline = start + ctx.seconds
    while True:
        f, pose_in, new, aux, host, enq, took = loop.advance(ranges)
        enqueue.append(enq)
        step_s.append(took)
        hosts.append(host)
        sampler.offer((f, pose_in, new, aux))
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - start
    steps = len(step_s)

    from captra_tpu_torch.ops import fps
    launches = {k: n for k, n in fps.launch_counts.items() if n}
    summary = bound = None
    if ctx.trace:
        ranges.on = True
        with FpsRecorder() as rec:
            events = trace.profile(lambda: loop.advance(ranges), TRACE_STEPS,
                                   cuda)
        ranges.on = False
        summary = trace.summarize(events, TRACE_STEPS)
        bound = rec.bound_s()
        del rec
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # the program is freed before the reference runs
    records = sampler.records()
    del sampler, loop, s["loop"], s["nets"]
    if cuda:
        torch.cuda.empty_cache()
    gaps = compare(s["ref"], cfg, s["w"], records, s["frames"])

    host = np.stack(hosts)
    failed = int((~np.isfinite(host).all(-1)).sum())
    flops = counts.track_step_flops(cfg, B)
    values = {"setup_s": setup_s,
              "frames_per_s": B * steps / window_s,
              "step_ms_p95": 1e3 * float(np.percentile(step_s, 95))}
    q = np.percentile(step_s, [5, 25, 50, 75, 95, 99]) * 1e3
    ctx.log(f"window: {steps} steps of {B} streams in {window_s:.4f} s, "
            f"step ms p5/25/50/75/95/99 {' / '.join(f'{v:.3f}' for v in q)}, "
            f"enqueue mean {1e3 * float(np.mean(enqueue)):.4f} ms, "
            f"{flops / 1e9:.2f} GFLOP a step, FPS launches {launches}")
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        ctx.log(f"trace: {summary.kernels} device ops in {TRACE_STEPS} "
                f"steps, {summary.unlaunched} without a launch record, "
                f"ranges {summary.ranges_s}")
    run_ = WindowRun(steps, window_s, enqueue, flops, summary, bound)
    return Outcome(attempted=B * steps, failed=failed, values=values,
                   checks=gaps, device=device, run=run_,
                   breakdown=trace.breakdown(summary) if summary else None)
