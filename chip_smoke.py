#!/usr/bin/env python3
"""Smoke run of captra_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Phases (each one fails the run, with a non-zero exit, when it fails):

  1. device  -- the card's name and power limit, torch and CUDA versions;
                TF32 off for matmuls and cuDNN; the CUDA kernels of
                `captra_tpu_torch/csrc/` built from source, with the time.
  2. kernels -- each FPS kernel against the plain PyTorch FPS on the card,
                at the shapes the main path gives it: indices must be
                equal.  Kernel and plain times from CUDA events.
  3. slice   -- the main path: NOCS bottle tracking at full width (4096
                points, the `pointnet2_camera` backbone), random weights
                from a seed, synthetic trajectories of T frames, at B = 1
                (sa1 -> fps_cuda_wide, sa2 -> fps_cuda_batched) and B = 16
                (both -> fps_cuda_batched).  The launch counters are zeroed
                just before and read just after; every kernel must have
                launched, the poses must be finite and equal (1e-4) to the
                same run with the plain FPS on the card.  ms per tracked
                frame, frames/s and the error to the synthetic ground truth
                are printed; so is, for information only, the distance of
                the first tracked frame to the port's CPU run.
  4. summary -- a JSON line of the kernels, then, as the last line,
                {"ok": true, "device": {...}}.

--profile DIR adds a torch.profiler window over a few tracked frames at each
B (kernel time by name and family, the device's busy share, host syncs) and
writes the full tables into DIR.

Without a CUDA device the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
T = 20                      # frames per trajectory (T - 1 tracked)
BATCHES = (1, 16)
REPEATS = 5                 # timed trajectories per B
POSE_TOL = 1e-4
# H100 SXM data-sheet peaks (dense, no sparsity) for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# per point per pick: 3 sub + 3 mul + 2 add for d, 1 min, 1 compare
FPS_OPS_PER_POINT_PICK = 10
REPLACES = {
    "fps_cuda_batched": "captra_tpu/ops/fps_pallas.py:76",   # _fps_kernel
    "fps_cuda_wide": "captra_tpu/ops/fps_pallas.py:103",     # _fps_wide_kernel
}
SOURCE = "captra_tpu_torch/csrc/fps.cu"
# (kernel, B, N, npoint, where the main path gives it this shape)
KERNEL_CASES = (
    ("fps_cuda_batched", 16, 4096, 512, "sa1 at B=16"),
    ("fps_cuda_batched", 16, 512, 128, "sa2 at B=16"),
    ("fps_cuda_batched", 1, 512, 128, "sa2 at B=1"),
    ("fps_cuda_batched", 128, 512, 64, "grouped strata of [16,4096]->512"),
    ("fps_cuda_batched", 1, 4096, 512, "sa1 at B=1 on the batched kernel, "
     "off the path: the wide kernel's yardstick"),
    ("fps_cuda_wide", 1, 4096, 512, "sa1 at B=1"),
    ("fps_cuda_wide", 1, 4100, 512, "ragged N"),
    ("fps_cuda_wide", 2, 16384, 1024, "the wide kernel's bound"),
)
HEADLINE = {"fps_cuda_batched": (16, 4096, 512), "fps_cuda_wide": (1, 4096, 512)}
# kernel families of the profile breakdown: (family, substring of the name)
PROFILE_FAMILIES = (
    ("fps", "fps_"), ("gemm", "gemm"), ("batch_norm", "batch_norm"),
    ("topk", "topk"), ("cat", "CatArray"), ("gather", "scatter_gather"),
    ("reduce", "reduce_kernel"), ("elementwise", "elementwise"),
    ("memcpy/memset", "Mem"),
)
# exact distance ties: integer grids and duplicated clouds
TIE_CASES = (
    ("fps_cuda_batched", 8, "grid", 512),
    ("fps_cuda_wide", 1, "grid", 512),
    ("fps_cuda_batched", 8, "dup", 64),
    ("fps_cuda_wide", 1, "dup", 512),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `reps` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fps_bound(B: int, N: int, npoint: int):
    """Least time for one FPS sweep on this card: xyz read once and the
    indices written once, against npoint - 1 distance updates and argmaxes
    over every point."""
    bytes_ms = (B * N * 3 * 4 + B * npoint * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = (B * N * (npoint - 1) * FPS_OPS_PER_POINT_PICK
              / FP32_OPS_PER_S * 1e3)
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms
                                   else "operations")


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("precision: torch.backends.cuda.matmul.allow_tf32=False "
        "torch.backends.cudnn.allow_tf32=False (full float32)")

    from captra_tpu_torch.ops import cuda_build, fps
    t0 = time.perf_counter()
    cuda_build.build([fps.SOURCE])
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {cuda_build.build_seconds})")
    for line in cuda_build.build_log.get(fps.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    for name in ("fps_cuda_batched", "fps_cuda_wide"):
        log(f"  {name}: at most {fps.max_points(name)} points per cloud")


def _tie_cloud(kind: str, B: int, rng) -> np.ndarray:
    if kind == "grid":   # 16^3 integer grid, shuffled per cloud
        g = np.stack(np.meshgrid(*[np.arange(16)] * 3, indexing="ij"), -1)
        g = g.reshape(-1, 3).astype(np.float32) * 0.1
        return np.stack([g[rng.permutation(len(g))] for _ in range(B)])
    base = rng.randn(B, 1400, 3).astype(np.float32)
    return np.concatenate([base, base, base], axis=1)


def phase_kernels() -> dict:
    from captra_tpu_torch.ops import fps
    rng = np.random.RandomState(SEED)
    results = {name: [] for name in REPLACES}
    for name, B, N, npoint, where in KERNEL_CASES:
        kernel = getattr(fps, name)
        xyz = torch.from_numpy(
            rng.randn(B, N, 3).astype(np.float32) * 0.3).cuda()
        got = kernel(xyz, npoint)
        want = fps.fps_plain(xyz, npoint)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err or got.dtype != torch.int32 or got.shape != (B, npoint):
            raise AssertionError(f"{name} [{B},{N}]->{npoint}: indices differ "
                                 f"from the plain FPS (max |diff| {err})")
        ms = time_ms(lambda: kernel(xyz, npoint), reps=20)
        plain_ms = time_ms(lambda: fps.fps_plain(xyz, npoint), reps=2,
                           warmup=1)
        bound_ms, bound_by = fps_bound(B, N, npoint)
        results[name].append(dict(B=B, N=N, npoint=npoint, where=where,
                                  max_abs_err=float(err), ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by))
        log(f"kernel {name} [{B},{N}]->{npoint} ({where}): equal; "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}), {ms / bound_ms:.0f}x bound")
    for name, B, kind, npoint in TIE_CASES:
        xyz = torch.from_numpy(_tie_cloud(kind, B, rng)).cuda()
        got = getattr(fps, name)(xyz, npoint)
        want = fps.fps_plain(xyz, npoint)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} on a {kind} cloud: tie-break differs"
                                 " from the plain FPS")
        log(f"kernel {name} [{B},{xyz.shape[1]}]->{npoint} ({kind} ties): "
            "equal")
    log(f"kernel launches in this phase (not the main path's): "
        f"{fps.launch_counts}")
    return results


@contextlib.contextmanager
def plain_fps_on_card():
    """Route the point ops' FPS to the plain version for one comparison run
    (the package itself never falls back)."""
    from captra_tpu_torch.ops import fps, pointops
    routed = pointops.farthest_point_sample_indices
    pointops.farthest_point_sample_indices = fps.fps_plain
    try:
        yield
    finally:
        pointops.farthest_point_sample_indices = routed


def _max_pose_diff(a, b) -> dict:
    return {
        "rotation": float((a.rotation - b.rotation).abs().max()),
        "translation": float((a.translation - b.translation).abs().max()),
        "scale_rel": float(((a.scale - b.scale).abs() / b.scale.abs()).max()),
    }


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def phase_slice(cfg, device: str = "cuda", profile: str | None = None
                ) -> dict:
    """Track at each B in BATCHES; returns the FPS launches of the main
    path, per B and in all.  `device` and a small `cfg` let the phase be
    rehearsed on the CPU with the plain FPS."""
    from captra_tpu_torch.data.synthetic import (
        batch_trajectories, make_trajectory,
    )
    from captra_tpu_torch.models.coordnet import CoordNet
    from captra_tpu_torch.models.rotnet import RotNet
    from captra_tpu_torch.ops import fps
    from captra_tpu_torch.pose import metrics
    from captra_tpu_torch.pose.part_dof import Pose
    from captra_tpu_torch.tracking.tracker import (
        make_track_step, track_trajectory,
    )

    dev = torch.device(device)
    gen = torch.Generator().manual_seed(SEED)
    coord = CoordNet(cfg, device=dev, generator=gen)
    rotn = RotNet(cfg, device=dev, generator=gen)
    n_params = sum(p.numel() for m in (coord, rotn) for p in m.parameters())
    log(f"slice: {cfg.obj.name}, {cfg.num_points} points, {n_params} "
        f"parameters (random, seed {SEED}), T={T}, on {dev}")
    step = make_track_step(cfg, coord, rotn, device=dev)

    data, init = {}, {}
    for B in BATCHES:
        d = batch_trajectories([
            make_trajectory(seed=100 * B + i, obj=cfg.obj, num_frames=T,
                            num_points=cfg.num_points) for i in range(B)])
        data[B] = d
        init[B] = Pose(*(torch.from_numpy(d[k][0]).to(dev)
                         for k in ("rotation", "translation", "scale")))

    points = {B: torch.from_numpy(data[B]["points"]).to(dev) for B in BATCHES}

    def track(B, upto=T):
        return track_trajectory(step, init[B], {"points": points[B][:upto]},
                                device=dev)

    for B in BATCHES:                                 # warm-up
        track(B, 3)
    sync(dev)

    # the main path: counters zeroed just before, read just after
    fps.reset_launch_counts()
    runs, per_b = {}, {}
    for B in BATCHES:
        before = dict(fps.launch_counts)
        steps_ms = []
        for _ in range(REPEATS):
            sync(dev)
            t0 = time.perf_counter()
            _, aux = track(B)
            sync(dev)
            steps_ms.append((time.perf_counter() - t0) / (T - 1) * 1e3)
        runs[B] = aux
        per_b[B] = {k: fps.launch_counts[k] - before[k] for k in before}
        ms = float(np.median(steps_ms))
        per_b[B].update(ms_per_step=ms, ms_per_step_runs=steps_ms,
                        frames_per_s=B * 1e3 / ms)
    launches = dict(fps.launch_counts)

    for B in BATCHES:
        c = per_b[B]
        log(f"slice B={B}: {c['ms_per_step']:.2f} ms per tracked step of {B} "
            f"frames (median of {REPEATS} runs of {T - 1} steps; min "
            f"{min(c['ms_per_step_runs']):.2f}, max "
            f"{max(c['ms_per_step_runs']):.2f}), "
            f"{c['ms_per_step'] / B:.3f} ms per tracked frame, "
            f"{c['frames_per_s']:.1f} tracked frames/s; launches wide "
            f"{c['fps_cuda_wide']} batched {c['fps_cuda_batched']}")

    for B in BATCHES:
        pose = runs[B].pose
        for f in ("rotation", "translation", "scale"):
            x = getattr(pose, f)
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"B={B}: non-finite {f}")
        gt = {k: torch.from_numpy(data[B][k][1:]).to(dev)
              for k in ("rotation", "translation", "scale")}
        rdiff = metrics.rot_diff_degree(gt["rotation"], pose.rotation,
                                        yaxis_only=cfg.obj.sym)
        tdiff = metrics.trans_diff(gt["translation"], pose.translation)
        log(f"slice B={B}: error to the synthetic truth (random weights): "
            f"rotation mean {float(rdiff.mean()):.2f} deg, last frame "
            f"{float(rdiff[-1].mean()):.2f} deg; translation mean "
            f"{float(tdiff.mean()):.4f} m")

    with plain_fps_on_card():
        for B in BATCHES:
            _, aux = track(B)
            diff = _max_pose_diff(runs[B].pose, aux.pose)
            log(f"slice B={B}: kernels vs plain FPS on {dev}, max |diff| "
                f"{diff}")
            if max(diff.values()) > POSE_TOL or not torch.equal(
                    runs[B].pred_labels, aux.pred_labels):
                raise AssertionError(f"B={B}: poses with the kernels differ "
                                     f"from the plain FPS by {diff}")

    # information only: GPU and CPU matmuls round differently, which can
    # move a neighbour across a ball-query radius
    cpu_step = make_track_step(cfg, copy.deepcopy(coord).cpu(),
                               copy.deepcopy(rotn).cpu(), device="cpu")
    _, cpu_aux = track_trajectory(
        cpu_step, init[1].to("cpu"),
        {"points": torch.from_numpy(data[1]["points"][:2])}, device="cpu")
    log(f"slice B=1 first tracked frame, card vs CPU (not a gate): "
        f"{_max_pose_diff(runs[1].pose[:1].to('cpu'), cpu_aux.pose)}")

    if profile:
        for B in BATCHES:
            profile_window(lambda: track(B, 4), 3, B, profile)
    return {"launches": launches, "per_b": per_b}


def check_launches(sliced: dict) -> None:
    """Every kernel launched on the main path, 4 sweeps per tracked frame
    split between the kernels by B."""
    from captra_tpu_torch.ops import fps
    tracked = REPEATS * (T - 1)
    for B in BATCHES:
        want = ({"fps_cuda_wide": 2 * tracked, "fps_cuda_batched": 2 * tracked}
                if B < fps.WIDE_MAX_BATCH else
                {"fps_cuda_wide": 0, "fps_cuda_batched": 4 * tracked})
        got = {k: sliced["per_b"][B][k] for k in want}
        if got != want:
            raise AssertionError(f"B={B}: FPS launches {got}, expected {want}")
    for name, n in sliced["launches"].items():
        if n == 0:
            raise AssertionError(f"{name} never launched on the main path")


def profile_window(run, steps: int, B: int, out_dir: str) -> None:
    """Kernel time by name over `run` (`steps` tracked steps), and the
    device's busy share of the window's wall time; the full table goes to
    `out_dir`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    averages = prof.key_averages()
    # kernels, copies and memsets run on the card; the CPU ops that launched
    # them repeat their time and are left out of the sum
    on_card = sorted((e for e in averages
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in on_card)
    syncs = sum(e.count for e in averages
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    log(f"profile B={B}: {steps} steps, wall {wall_us / steps / 1e3:.2f} ms "
        f"per step, device busy {busy / steps / 1e3:.2f} ms per step "
        f"({100 * busy / wall_us:.1f}% of wall), {syncs} host syncs")
    families = {}
    for e in on_card:
        fam = next((f for f, pat in PROFILE_FAMILIES if pat in e.key), "other")
        families[fam] = families.get(fam, 0) + dev_us(e)
    log("  by family: " + ", ".join(
        f"{f} {t / steps / 1e3:.3f}" for f, t in
        sorted(families.items(), key=lambda kv: -kv[1])) + " (ms/step)")
    for e in on_card[:10]:
        log(f"  {dev_us(e) / steps / 1e3:8.3f} ms/step  x{e.count // steps:<5}"
            f" {e.key[:90]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_b{B}.txt"), "w") as f:
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=-1))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="add a torch.profiler window at each B and "
                             "write its tables into DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from captra_tpu_torch.config.presets import nocs_bottle
    phase_device()
    kernels = phase_kernels()
    sliced = phase_slice(nocs_bottle(), profile=args.profile)
    check_launches(sliced)

    line = []
    for name, cases in kernels.items():
        B, N, npoint = HEADLINE[name]
        head = next(c for c in cases
                    if (c["B"], c["N"], c["npoint"]) == (B, N, npoint))
        line.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": sliced["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
            "at": f"[{B},{N}]->{npoint}",
            "shapes": cases,
        })
    log(json.dumps({"slice": {str(B): sliced["per_b"][B] for B in BATCHES}}))
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
