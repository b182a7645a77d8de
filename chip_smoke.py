#!/usr/bin/env python3
"""Smoke run of captra_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--profile DIR]

Phases (each one fails the run, with a non-zero exit, when it fails):

  1. device  -- the card's name and power limit, torch and CUDA versions;
                TF32 off for matmuls and cuDNN; the CUDA kernels of
                `captra_tpu_torch/csrc/` built from source, with the time.
  2. kernels -- each FPS kernel against the plain PyTorch FPS on the card,
                at the shapes the main paths give it, on tie clouds and on
                the OTF crop's own working set: indices must be equal.
                Kernel and plain times from CUDA events; for the blocked
                kernel, the rows its skip rule updates a pick (a plain
                replay on the card).
  3. slice   -- the main path: NOCS bottle tracking at full width (4096
                points, the `pointnet2_camera` backbone), random weights
                from a seed, synthetic trajectories of T frames, in the runs
                of SLICE_RUNS: B = 1 (sa1 -> fps_cuda_wide, sa2 ->
                fps_cuda_batched) and B = 16 (both -> fps_cuda_batched) in
                float32 and in bfloat16, `quality_profile=best` at B = 1
                and B = 16 (3 passes of the nets a frame: three times the
                default step's FPS launches) and the other opt-ins stacked
                at B = 16 (const_vel, conf_weighted_delta, delta_gain,
                scale_clamp, rot_fit=fused, fit_ransac; draws from a
                seeded generator on the card).  Each run (`timed_run`):
                counters zeroed just before and read just after, launches
                per tracked frame as predicted, poses finite and within 1e-4
                of the same run with the plain FPS on the card, ms a step
                (median of REPEATS = 3 runs of T - 1 steps), frames/s and
                the error to the synthetic ground truth; each bfloat16 run
                against its float32 twin (ms a step, the largest pose
                difference); for information only, the first tracked frame
                against the port's CPU run.
  4. otf     -- the OTF tracking path (`nocs_otf`: raw 480x640 depth ->
                backprojection and ball crop on the card -> FPS of the
                20480-point working set to 4096 -> the nets), same weights,
                depth video from `data/depth_frames.py` (OTF_T frames), crop
                shifts from the seed, in the runs of OTF_RUNS: B=1 (crop ->
                fps_cuda_wide's cluster), B=1 with CAPTRA_FPS_BLOCKED=1
                (crop -> fps_cuda_blocked; poses must equal the B=1 run's),
                B=8 (crop -> fps_cuda_batched's cluster) in float32 and in
                bfloat16, and B=1 with otf_fps_mode / network fps_mode
                "grouped".  Each run as in the slice.  Then, for B=1 and
                B=8, the crop's working sets of every tracked frame of the
                video are recorded, and so are the inputs of sa1 (4096
                points) and sa2 (512), the picks each crop needs before its
                first forced 0 printed, and each kernel held against the
                plain FPS on them and timed over the whole video (ms a
                frame: the kernel's time on the main path).
  5. init_search -- the GT-less init on the slice's B=1 trajectory:
                init_pose_from_cloud, search_init_orientation over K=64
                candidates on frame 0 (median of 3 searches, counters zeroed
                around them, the pose against the plain FPS's), then
                tracking from the found pose as a slice run; the search's
                FPS inputs are recorded and the kernel held against the
                plain FPS on them.
  6. cli     -- the track and evaluate CLIs as a user runs them: the seeded
                nets written as a coord and a rot experiment (the JAX
                package's pickle checkpoints), then
                `captra_tpu_torch.cli.track.main` with the CLI's defaults
                (4 synthetic trajectories of T=20 frames at B=4, 4096
                points, `pointnet2_camera`, `--save`) for the SAPIEN laptop
                (2 parts, grid IoU and joint states) and the NOCS bottle
                (symmetric, axis-aligned IoU over the 20-way sweep), each
                followed by `cli.evaluate.main` without and with IoU.
                Counters zeroed just before each track run and read just
                after: FPS launches a tracked frame as `route` predicts;
                4 result pickles, finite poses within 1e-4 of
                `track_trajectory` on the same nets and init draws (the
                checkpoint round trip); err.csv with 4 x 19 rows and every
                metric.  The twin run's FPS inputs are recorded and each
                kernel held against the plain FPS on them.  Frames/s as
                the CLI prints it, ms a step, checkpoint load and evaluate
                seconds, the AVG metrics.  Then a composed checkpoint in
                the reference's torch layout (seeded, the bottle's full
                width), written with `torch.save` and read by
                `convert_track_checkpoint`: its nets track the slice's B=1
                trajectory (-> fps_cuda_wide), poses finite and within
                1e-4 of the same trees loaded as pickle checkpoints.
  7. data    -- the track CLI on datasets on disk, written from the seed
                in a temporary directory with the script's own writers (a
                PNG encoder of its own: no OpenCV): the SAPIEN laptop's
                `test_seq` split (two test instances, one track each of
                obj/num_frames = 100 frames of 480x640 OpenGL depth and
                seg, GT and model-info pickles; B=2), and a NOCS bottle
                `real_test` scene of 30 frames (16-bit depth and mask
                PNGs, meta.txt, the data/*.npz frames, model corners) on
                the OTF crop (-> fps_cuda_wide's cluster at [1,20480] ->
                4096) with the GT masks and with NOCS-2D detections; each
                followed by `cli.evaluate.main` with IoU.  Gates as the
                cli phase's: FPS launches a tracked frame as `route`
                predicts, a result pickle a trajectory, poses finite and
                within 1e-4 of `track_trajectory` on the same nets, batch
                and draws, err.csv with a row a tracked frame and every
                metric, each kernel equal to the plain FPS on the run's
                recorded inputs (the plain FPS once on all of them
                stacked).  Then the host core's FPS of a reader's frame and
                `otf_frame_from_depth` on one frame of the NOCS scene
                against the plain FPS.  Reader seconds a frame cold (the
                CLI's reads, SAPIEN writing its cache) and warm, ms a step
                and frames/s as the CLI prints them.  One SAPIEN laptop
                frame read with `read_cloud(perturb=True)` (the depth-sensor
                augmentation, the blur without OpenCV): seconds and pixels
                relabelled.
  8. preproc -- the offline preprocessing path, then its tree tracked on
                the card: a raw NOCS release written from the seed at
                480x640 (a real_test scene of 30 frames with 16-bit depth,
                a mirrored CAMERA `val` folder of 10 frames with 3-channel
                composed depth; the bottle, the can and the mug, each
                pixel's NOCS coord the exact inverse of its depth) through
                `cli.preproc.main` a stage at a time at num_proc 1 (seconds
                a stage and a frame), every recovered pose within 0.02 /
                0.02 / 5 degrees of the fixture's, the instance lists
                naming every frame, a gather at num_proc 4 into a second
                root equal to the first bit for bit, the host core's
                backprojection of a frame against the numpy path's (ms a
                frame); then `cli.track.main --nocs_otf true` on the
                produced tree's bottle and `cli.evaluate.main`, with the
                data phase's gates (`track_from_disk`).
  9. train   -- training at the configs' full width (SAPIEN laptop,
                batch 12, 4096 points, `pointnet2_camera`; seeded nets, a
                fixed `make_frame_batch` batch, draws from a seeded card
                generator) in the runs of TRAIN_RUNS: the CoordNet (sa1 ->
                fps_cuda_batched [12,4096]->512), the RotNet (24 clouds),
                the NOCS bottle's CoordNet (symmetric: the pairwise NOCS
                loss, the 2D fit) and the CoordNet in bfloat16.  Each run
                (`train_run`): one step against the same step from a copy
                of the state with the plain FPS on the card, under torch's
                deterministic algorithms (losses, gradients, statistics
                equal bit for bit), the kernels held on that step's FPS
                inputs, a warm-up, the host syncs of a
                step (CUDA's sync debug mode), then TRAIN_STEPS timed steps
                with the counters zeroed around them: FPS launches a step
                as `route` predicts, ms a step (median; a sync after each
                step), samples/s, peak memory, the losses finite and
                falling.  Then the CLIs: `cli.train.main --synthetic_data
                --batch_size 4` (sa1 -> fps_cuda_wide) for the CoordNet, a
                resume for a second epoch, the RotNet, `cli.track.main`
                from the two trained experiments and `cli.finetune.main`
                for one epoch on NOCS fixtures written from the seed; each
                CLI's FPS launches as `route` predicts, and the kernels
                held on the first CoordNet run's FPS inputs.
 10. rollout -- on-policy rollout fine-tuning at the JAX script's
                defaults (NOCS bottle, 4096 points, bfloat16, GN,
                traj_batch 16 x 20 frames, minibatch 12, a pool of 512
                geometries; the seeded nets as pickle checkpoints): round 1
                with the kernels against the same round with the plain FPS
                on the card (deterministic algorithms, the same draws:
                logs, parameters, statistics and moments equal bit for
                bit), its FPS launches as `route` predicts (19 tracked
                frames x 4 and 25 minibatches x 4, all fps_cuda_batched),
                the kernels held on its recorded inputs; the host syncs of
                a round; a timed round (the rollout timed apart) and its
                peak memory; then `cli.rollout_finetune.main` for
                ROLLOUT_ROUNDS rounds (the script's 100 cut), evaluated at
                rounds 0 and ROLLOUT_ROUNDS: launches, finite logs,
                EVIDENCE.json, the checkpoints loaded back.
 11. summary -- JSON lines of the paths and of the kernels, then, as the
                last line, {"ok": true, "device": {...}}.

--profile DIR adds a torch.profiler window (`utils/profiling.trace`) over a
few tracked frames to each run and over a fine-tune round (kernel time by
name and family, the device's busy share, FPS's share of the step, host
syncs; in the round, the device time of the forwards of each module family
(GroupNorm, the SA and FP blocks, the heads), of the losses and
of the optimizer step, under `annotate` spans) and writes the full tables
and each window's Chrome trace into DIR.

Without a CUDA device the script exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import io
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
T = 20                      # frames per trajectory (T - 1 tracked)
OTF_T = 12                  # frames of the OTF depth video
REPEATS = 3                 # timed trajectories per B
POSE_TOL = 1e-4
# H100 SXM data-sheet peaks (dense, no sparsity) for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# per point per pick: 3 sub + 3 mul + 2 add for d, 1 min, 1 compare
FPS_OPS_PER_POINT_PICK = 10
REPLACES = {
    "fps_cuda_batched": "captra_tpu/ops/fps_pallas.py:76",   # _fps_kernel
    "fps_cuda_wide": "captra_tpu/ops/fps_pallas.py:103",     # _fps_wide_kernel
    "fps_cuda_batched_cluster": "captra_tpu/ops/fps_pallas.py:76",
    "fps_cuda_wide_cluster": "captra_tpu/ops/fps_pallas.py:103",
    "fps_cuda_blocked": "captra_tpu/ops/fps_pallas.py:142",  # _fps_blocked_kernel
}
SOURCE = "captra_tpu_torch/csrc/fps.cu"
# (kernel, B, N, npoint, where the main path gives it this shape)
KERNEL_CASES = (
    ("fps_cuda_batched", 16, 4096, 512, "sa1 at B=16"),
    ("fps_cuda_batched", 16, 512, 128, "sa2 at B=16"),
    ("fps_cuda_batched", 1, 512, 128, "sa2 at B=1"),
    ("fps_cuda_batched", 128, 512, 64, "grouped strata of [16,4096]->512"),
    ("fps_cuda_batched", 9, 512, 128, "the last CTA of warps part full"),
    ("fps_cuda_batched", 13, 513, 128, "one point past a warp's cloud"),
    ("fps_cuda_wide", 1, 4096, 512, "sa1 at B=1"),
    ("fps_cuda_wide", 4, 4096, 512, "sa1 of the track CLI, B=4"),
    ("fps_cuda_wide", 1, 4100, 512, "ragged N"),
    ("fps_cuda_wide", 2, 16384, 1024, "the wide kernel's one-CTA bound"),
    ("fps_cuda_wide", 1, 20480, 4096, "Gaussian cloud, the OTF crop's "
     "shape at B=1 (cluster)"),
    ("fps_cuda_wide", 1, 16400, 1024, "ragged N, cluster"),
    ("fps_cuda_wide", 1, 65537, 256, "ragged N, a cluster of 16 CTAs "
     "(non-portable)"),
    ("fps_cuda_batched", 8, 20480, 4096, "Gaussian cloud, the OTF crop's "
     "shape at B=8 (cluster)"),
    ("fps_cuda_batched", 8, 2560, 512, "grouped OTF crop strata at B=1"),
    ("fps_cuda_blocked", 1, 20480, 4096, "OTF crop at B=1, "
     "CAPTRA_FPS_BLOCKED=1"),
    ("fps_cuda_blocked", 1, 8192, 1024, "the blocked range's low end"),
    ("fps_cuda_blocked", 2, 24576, 1024, "the blocked kernel's bound"),
    ("fps_cuda_blocked", 1, 9000, 512, "ragged last row"),
    ("fps_cuda_batched", 8, 4096, 512, "sa1 at B=8 (OTF)"),
    ("fps_cuda_batched", 8, 512, 128, "sa2 at B=8 (OTF)"),
    ("fps_cuda_batched", 8, 512, 64, "grouped sa1 strata at B=1 (OTF)"),
    ("fps_cuda_batched", 8, 64, 16, "grouped sa2 strata at B=1 (OTF)"),
)
# each kernel's headline case: (B, N, npoint, where); every kernel is timed
# on the FPS inputs of the tracked OTF video, the data the main path gives
# it: the crop's working sets, sa1's inputs (two a frame: CoordNet and
# RotNet) and sa2's (CROP_SET is frame 0's working set alone)
CROP_SET = "OTF crop's own working set"
CROP_VIDEO = "OTF crop's working sets of the tracked video, ms a frame"
SA_VIDEO = "OTF sa inputs of the tracked video, ms a frame"
HEADLINE = {"fps_cuda_batched": (8, 4096, 512, SA_VIDEO),
            "fps_cuda_wide": (1, 4096, 512, SA_VIDEO),
            "fps_cuda_batched_cluster": (8, 20480, 4096, CROP_VIDEO),
            "fps_cuda_wide_cluster": (1, 20480, 4096, CROP_VIDEO),
            "fps_cuda_blocked": (1, 20480, 4096, CROP_VIDEO)}
# the kernels each path must launch
SLICE_KERNELS = ("fps_cuda_batched", "fps_cuda_wide")
# runs whose name starts so compute in bfloat16 and are compared with the
# float32 run of the name without it
BF16_PREFIX = "bf16_"
BF16 = {"compute_dtype": "bfloat16"}
# the opt-ins stacked in one run: RANSAC draws from the step's generator on
# the card, re-seeded each trajectory so the plain-FPS run sees the same
STACKED = dict(motion_model="const_vel", conf_weighted_delta=True,
               delta_gain=1.5, scale_clamp=0.05, rot_fit="fused",
               fit_ransac=32)
# the points path's runs: (name, B, nocs_bottle's arguments, TrackCfg fields
# set on top, the nets' passes a tracked frame: 4 FPS sweeps a pass)
SLICE_RUNS = (
    ("b1", 1, {}, {}, 1),
    ("b16", 16, {}, {}, 1),
    (BF16_PREFIX + "b1", 1, BF16, {}, 1),
    (BF16_PREFIX + "b16", 16, BF16, {}, 1),
    ("best_b1", 1, {"quality_profile": "best"}, {}, 3),
    ("best_b16", 16, {"quality_profile": "best"}, {}, 3),
    ("stacked_b16", 16, {}, STACKED, 1),
)
# OTF runs: (name, B, fps_mode, CAPTRA_FPS_BLOCKED, nocs_bottle_otf's other
# arguments) and the launches each tracked frame must make (crop + sa1 and
# sa2 of both nets)
OTF_RUNS = (("b1", 1, "exact", False, {}),
            ("b1_blocked", 1, "exact", True, {}),
            ("b8", 8, "exact", False, {}),
            (BF16_PREFIX + "b8", 8, "exact", False, BF16),
            ("b1_grouped", 1, "grouped", False, {}))
OTF_LAUNCHES = {
    "b1": {"fps_cuda_wide_cluster": 1, "fps_cuda_wide": 2,
           "fps_cuda_batched": 2},
    "b1_blocked": {"fps_cuda_blocked": 1, "fps_cuda_wide": 2,
                   "fps_cuda_batched": 2},
    "b8": {"fps_cuda_batched_cluster": 1, "fps_cuda_batched": 4},
    BF16_PREFIX + "b8": {"fps_cuda_batched_cluster": 1,
                         "fps_cuda_batched": 4},
    "b1_grouped": {"fps_cuda_batched": 5},
}
# OTF runs whose FPS inputs are recorded on every tracked frame, and for
# the crop's (20480 points), sa1's (4096) and sa2's (512) inputs the
# wrappers checked and timed on them (the blocked run's video is the b1
# run's: equal poses)
VIDEO_RUNS = {
    "b1": {"crop": ("fps_cuda_wide", "fps_cuda_blocked"),
           "sa1": ("fps_cuda_wide",), "sa2": ("fps_cuda_batched",)},
    "b8": {"crop": ("fps_cuda_batched",), "sa1": ("fps_cuda_batched",),
           "sa2": ("fps_cuda_batched",)},
}
CAMERA_MS = 33.3            # one 30 Hz frame: the B=1 latency limit
# kernel families of the profile breakdown: (family, substring of the name)
PROFILE_FAMILIES = (
    ("fps", "fps_"), ("gemm", "gemm"), ("batch_norm", "batch_norm"),
    ("topk", "topk"), ("cat", "CatArray"), ("gather", "scatter_gather"),
    ("reduce", "reduce_kernel"), ("elementwise", "elementwise"),
    ("memcpy/memset", "Mem"),
)
# exact distance ties: integer grids, duplicated clouds, wrap-fill clouds
# (min(300, N / 8) distinct points, then copies of one of them, as the OTF
# crop makes) and all-equal clouds; N None is the 16^3 grid or 3 x 1400
# points.  The wrap-fill and all-equal clouds reach the kernels' early exit.
TIE_CASES = (
    ("fps_cuda_wide", 1, "wrap", 512, 4096),
    ("fps_cuda_wide", 1, "equal", 512, 4096),
    ("fps_cuda_batched", 8, "wrap", 512, 4096),
    ("fps_cuda_batched", 8, "equal", 512, 4096),
    ("fps_cuda_batched", 8, "wrap", 128, 512),
    ("fps_cuda_batched", 8, "equal", 128, 512),
    ("fps_cuda_wide", 1, "dup", 512, 4096),
    ("fps_cuda_batched", 8, "grid", 128, 512),
    ("fps_cuda_batched", 8, "dup", 128, 512),
    ("fps_cuda_wide", 1, "wrap", 4096, 20480),
    ("fps_cuda_wide", 1, "equal", 4096, 20480),
    ("fps_cuda_batched", 8, "wrap", 4096, 20480),
    ("fps_cuda_batched", 8, "equal", 4096, 20480),
    ("fps_cuda_batched", 8, "grid", 512, None),
    ("fps_cuda_wide", 1, "grid", 512, None),
    ("fps_cuda_batched", 8, "dup", 64, None),
    ("fps_cuda_wide", 1, "dup", 512, None),
    ("fps_cuda_wide", 1, "grid", 2048, 20480),
    ("fps_cuda_wide", 1, "dup", 2048, 20480),
    ("fps_cuda_batched", 8, "grid", 512, 20480),
    ("fps_cuda_batched", 8, "dup", 512, 20480),
    ("fps_cuda_blocked", 1, "grid", 2048, 20480),
    ("fps_cuda_blocked", 1, "dup", 2048, 20480),
    ("fps_cuda_blocked", 2, "dup", 512, 9000),
    ("fps_cuda_blocked", 1, "wrap", 4096, 20480),
    ("fps_cuda_blocked", 1, "equal", 4096, 20480),
    ("fps_cuda_blocked", 1, "wrap", 4096, 24576),
    ("fps_cuda_blocked", 2, "equal", 4096, 24576),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2, launches: int = 1) -> float:
    """Mean device time of `fn` over `reps` calls (CUDA events).  The card
    first sleeps for about 100 us per kernel launch to come (`launches` a
    call), so the host has queued every call before the first event and a
    kernel shorter than its launch's host time is still timed, not the
    host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000 * reps * launches)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def picks_before_zero(idx: torch.Tensor) -> list[int]:
    """Distance updates the data needs for these picks [B, npoint], per
    cloud: one per pick up to the first pick of index 0 after the first
    (from there on every minimum is 0 and every pick is 0), else
    npoint - 1."""
    B, npoint = idx.shape
    zero = (idx[:, 1:] == 0).int()
    first = torch.where(zero.any(1), zero.argmax(1) + 1,
                        torch.full((B,), npoint - 1, device=idx.device))
    return first.tolist()


def sweeps_needed(idx: torch.Tensor) -> int:
    """`picks_before_zero`, summed over the clouds."""
    return sum(picks_before_zero(idx))


def rows_updated(xyz: torch.Tensor, idx: torch.Tensor, row: int) -> float:
    """Mean rows of `row` contiguous points a pick that the blocked kernel's
    skip rule updates, replayed in plain PyTorch on one cloud xyz [N, 3]
    along its plain FPS picks idx [npoint]: a row is updated when the lower
    bound lb^2 * 0.999999 from the pick to the row's box is below the max of
    the row's exact running minima.  The replay stops where the kernel's
    early exit does."""
    N = xyz.shape[0]
    R = -(-N // row)
    pad = R * row - N
    p = torch.cat([xyz, xyz[:1].expand(pad, 3)]).view(R, row, 3)
    valid = (torch.arange(R * row, device=xyz.device) < N).view(R, row, 1)
    lo = torch.where(valid, p, torch.inf).amin(1)
    hi = torch.where(valid, p, -torch.inf).amax(1)
    x, y, z = xyz.unbind(-1)
    dist = torch.full((N,), 1e10, device=xyz.device)
    bm = torch.full((R,), 1e10, device=xyz.device)
    counts = []
    for it in range(idx.shape[0] - 1):
        c = xyz[idx[it]]
        lb = torch.clamp_min(torch.maximum(lo - c, c - hi), 0.0)
        lb2 = (lb[:, 0] * lb[:, 0] + lb[:, 1] * lb[:, 1]
               + lb[:, 2] * lb[:, 2]) * 0.999999
        counts.append((lb2 < bm).sum())
        dx, dy, dz = x - c[0], y - c[1], z - c[2]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        bm = torch.cat([dist, dist.new_zeros(pad)]).view(R, row).amax(1)
        if not bool(bm.max() > 0):
            break
    return float(torch.stack(counts).float().mean())


def log_rows_updated(fps, clouds, wants, where: str) -> float:
    """Mean rows the blocked kernel's skip rule updates a pick on one-cloud
    inputs `clouds` [1, N, 3] along their plain picks `wants`, over every
    pick before the early exit (`rows_updated`, rows as the kernel cuts
    them), logged with the kernel's rows a cloud."""
    row = fps.blocked_row_points()
    means = [rows_updated(xyz[0], want[0], row)
             for xyz, want in zip(clouds, wants)]
    mean = float(np.mean(means))
    rows = -(-clouds[0].shape[1] // row)
    log(f"kernel fps_cuda_blocked {where}: {mean:.2f} of {rows} rows of "
        f"{row} points updated a pick (plain replay of the skip rule)")
    return mean


def fps_bound(B: int, N: int, npoint: int, sweeps: int | None = None):
    """Least time for one FPS sweep on this card: xyz read once and the
    indices written once, against `sweeps` (default B * (npoint - 1))
    distance updates and argmaxes over every point of a cloud."""
    sweeps = B * (npoint - 1) if sweeps is None else sweeps
    bytes_ms = (B * N * 3 * 4 + B * npoint * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = N * sweeps * FPS_OPS_PER_POINT_PICK / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms > ops_ms
                                   else "operations")


def card_name_and_limit() -> str:
    """The card's name and power limit as `nvidia-smi` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def phase_device() -> None:
    log(card_name_and_limit())
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
    for line in cuda_build.ptxas_usage(fps.SOURCE):
        log(f"  ptxas: {line}")
    for name in ("fps_cuda_batched", "fps_cuda_wide"):
        log(f"  {name}: one CTA per cloud up to {fps.single_cta_points(name)} "
            f"points, a cluster up to {fps.max_points(name)} (20480 points: "
            f"{fps.cluster_size(name, 20480)} CTAs of "
            f"{fps.cluster_threads()} threads)")
    log(f"  fps_cuda_blocked: at most {fps.max_points('fps_cuda_blocked')} "
        "points per cloud")


def _tie_cloud(kind: str, B: int, rng, N: int | None = None) -> np.ndarray:
    """A shuffled integer grid (16^3 points, or the first N of the smallest
    cube grid that holds N), a cloud repeated three times (3 x 1400
    points, or cut to N), a wrap-fill cloud (min(300, N / 8) distinct
    points, then copies of its point 7) or an all-equal cloud (N copies of
    one point)."""
    if kind == "wrap":
        d = min(300, N // 8)
        xyz = np.empty((B, N, 3), np.float32)
        xyz[:, :d] = rng.randn(B, d, 3)
        xyz[:, d:] = xyz[:, 7:8]
        return xyz
    if kind == "equal":
        return np.ascontiguousarray(
            np.repeat(rng.randn(B, 1, 3).astype(np.float32), N, axis=1))
    if kind == "grid":
        side = 16 if N is None else int(np.ceil(N ** (1 / 3)))
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
        g = g.reshape(-1, 3).astype(np.float32) * 0.1
        n = len(g) if N is None else N
        return np.stack([g[rng.permutation(len(g))[:n]] for _ in range(B)])
    base = rng.randn(B, 1400 if N is None else -(-N // 3), 3).astype(
        np.float32)
    return np.ascontiguousarray(
        np.concatenate([base, base, base], axis=1)[:, :N])


def _launched(fps, call) -> tuple:
    """Run `call` and return (its result, the one kernel it launched)."""
    before = dict(fps.launch_counts)
    out = call()
    hit = [k for k in before if fps.launch_counts[k] != before[k]]
    if len(hit) != 1:
        raise AssertionError(f"expected one kernel launch, got {hit}")
    return out, hit[0]


def _check_case(fps, results, fn, xyz, npoint, where):
    """Hold one call `fn(xyz, npoint)` of a wrapper against the plain FPS,
    time both, and file the case under the kernel that launched."""
    B, N, _ = xyz.shape
    got, kernel = _launched(fps, lambda: fn(xyz, npoint))
    want = fps.fps_plain(xyz, npoint)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err or got.dtype != torch.int32 or got.shape != (B, npoint):
        raise AssertionError(f"{kernel} [{B},{N}]->{npoint} ({where}): "
                             f"indices differ from the plain FPS (max "
                             f"|diff| {err})")
    ms = time_ms(lambda: fn(xyz, npoint), reps=20)
    plain_ms = time_ms(lambda: fps.fps_plain(xyz, npoint), reps=2, warmup=1)
    sweeps = sweeps_needed(want)
    bound_ms, bound_by = fps_bound(B, N, npoint, sweeps)
    results[kernel].append(dict(B=B, N=N, npoint=npoint, where=where,
                                max_abs_err=float(err), ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, sweeps=sweeps,
                                us_per_pick=ms * 1e3 / (npoint - 1)))
    if kernel == "fps_cuda_blocked" and B == 1:
        results[kernel][-1]["rows_updated"] = log_rows_updated(
            fps, [xyz], [want], f"[{B},{N}]->{npoint} ({where})")
    log(f"kernel {kernel} [{B},{N}]->{npoint} ({where}): equal; "
        f"{ms:.4f} ms ({ms * 1e3 / (npoint - 1):.3f} us a pick), plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}, {sweeps} "
        f"sweeps the data needs), {ms / bound_ms:.0f}x bound")


def check_video(fps, results, wrappers, clouds, npoint, run, frames,
                where, path: str = "otf", unit: str = "frame") -> None:
    """Hold each wrapper against the plain FPS on every input `clouds` that
    one FPS call of a tracked video of `frames` frames was given, and time
    it over the whole video; the case's ms, plain ms, bound and sweeps are
    per frame.  The plain FPS runs once, on all the inputs stacked."""
    F = frames
    calls = len(clouds)
    B, N, _ = clouds[0].shape
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    wants = fps.fps_plain(torch.cat(clouds), npoint).split(
        [len(xyz) for xyz in clouds])
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end) / F
    picks = [picks_before_zero(w) for w in wants]
    sweeps = sum(map(sum, picks))
    flat = sorted(p for call in picks for p in call)
    log(f"{path} {run} [{B},{N}]->{npoint}, {calls} calls in {F} tracked "
        f"{unit}s: picks before the first forced 0, per call summed over the "
        f"clouds {[sum(p) for p in picks]}; per cloud min {flat[0]}, median "
        f"{flat[len(flat) // 2]}, max {flat[-1]}")
    bound_ms, bound_by = fps_bound(B * calls, N, npoint, sweeps)
    for wrapper in wrappers:
        fn = getattr(fps, wrapper)
        err = 0
        for xyz, want in zip(clouds, wants):
            got, kernel = _launched(fps, lambda: fn(xyz, npoint))
            err = max(err, int((got.long() - want.long()).abs().max()))
        if err:
            raise AssertionError(f"{kernel} on the {path} {run} [{B},{N}] "
                                 f"inputs: indices differ from the plain FPS "
                                 f"(max |diff| {err})")
        ms = time_ms(lambda: [fn(xyz, npoint) for xyz in clouds], reps=5,
                     warmup=1, launches=calls) / F
        results[kernel].append(dict(
            B=B, N=N, npoint=npoint, where=where, max_abs_err=0.0,
            ms=ms, plain_ms=plain_ms,
            plain="stacked: one call on the video's inputs",
            bound_ms=bound_ms / F,
            bound_by=bound_by, sweeps=sweeps / F, frames=F, calls=calls,
            us_per_pick=ms * 1e3 * F / calls / (npoint - 1)))
        if kernel == "fps_cuda_blocked" and B == 1:
            results[kernel][-1]["rows_updated"] = log_rows_updated(
                fps, clouds, wants, f"[{B},{N}]->{npoint} ({path} {run}, "
                f"{calls} tracked frames)")
        log(f"kernel {kernel} [{B},{N}]->{npoint} ({where}, {path} {run}): "
            f"equal on all {calls} calls; {ms:.4f} ms a {unit} "
            f"({ms * 1e3 * F / calls / (npoint - 1):.3f} us a pick), plain "
            f"(stacked) {plain_ms:.3f} ms, bound {bound_ms / F:.5f} ms "
            f"({bound_by}, {sweeps / F:.0f} sweeps a {unit} the data needs)")


@contextlib.contextmanager
def recording_fps(calls: dict):
    """Append the input of every FPS call to `calls[(N, npoint)]`; the point
    ops' FPS runs as routed."""
    from captra_tpu_torch.ops import pointops
    routed = pointops.farthest_point_sample_indices

    def record(xyz, npoint):
        calls.setdefault((xyz.shape[1], npoint), []).append(
            xyz.clone(memory_format=torch.contiguous_format))
        return routed(xyz, npoint)

    pointops.farthest_point_sample_indices = record
    try:
        yield
    finally:
        pointops.farthest_point_sample_indices = routed


def crop_working_set_cloud(B: int) -> torch.Tensor:
    """The 20480-point working sets the OTF crop hands FPS at batch B, from
    frame 0 of the depth video at the init pose, as rows [B, W, 3] on the
    card."""
    from captra_tpu_torch.config.presets import nocs_bottle_otf
    from captra_tpu_torch.data import depth_frames, preprocess
    cfg = nocs_bottle_otf()
    depths, masks = depth_frames.make_depth_frames(1, B, seed=SEED)
    pose = depth_frames.otf_init_pose(depths[0, 0], masks[0, 0], B,
                                      cfg.obj.num_parts).to("cuda")
    K = preprocess.intrinsics_tensor(preprocess.NOCS_REAL_INTRINSICS, "cuda")
    pts3, valid = preprocess.backproject_depth_planes(
        torch.from_numpy(depths[0]).cuda(), K)
    shift = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, pts3.shape[-1], (B,))).cuda()
    _, sub3 = preprocess.crop_working_set(
        shift, pts3, valid, pose.translation[:, 0, :, 0],
        cfg.data_radius * pose.scale[:, 0], cfg.num_points,
        cfg.track.otf_work_factor)
    return sub3.transpose(1, 2).contiguous()


def phase_kernels() -> dict:
    from captra_tpu_torch.ops import fps
    rng = np.random.RandomState(SEED)
    results = {name: [] for name in REPLACES}
    for name, B, N, npoint, where in KERNEL_CASES:
        xyz = torch.from_numpy(
            rng.randn(B, N, 3).astype(np.float32) * 0.3).cuda()
        _check_case(fps, results, getattr(fps, name), xyz, npoint, where)
    # a yardstick off the path: the cluster launch (2 CTAs) on sa1's B=1
    # shape, which route() gives one CTA
    xyz = torch.from_numpy(rng.randn(1, 4096, 3).astype(np.float32) * 0.3
                           ).cuda()
    _check_case(fps, results,
                lambda x, n: fps._launch("fps_cuda_wide_cluster", x, n), xyz,
                512, "the cluster launch on sa1's shape, off the path: the "
                "single CTA's yardstick")
    for name, B, kind, npoint, N in TIE_CASES:
        xyz = torch.from_numpy(_tie_cloud(kind, B, rng, N)).cuda()
        got, kernel = _launched(fps, lambda: getattr(fps, name)(xyz, npoint))
        want = fps.fps_plain(xyz, npoint)
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} on a {kind} cloud: tie-break "
                                 "differs from the plain FPS")
        log(f"kernel {kernel} [{B},{xyz.shape[1]}]->{npoint} ({kind} ties): "
            "equal")
    for B, wrappers in ((1, ("fps_cuda_wide", "fps_cuda_blocked")),
                        (8, ("fps_cuda_batched",))):
        sub = crop_working_set_cloud(B)
        distinct = [torch.unique(c, dim=0).shape[0] for c in sub]
        log(f"OTF crop working set [{B},{sub.shape[1]}]: {distinct} "
            "distinct points (the rest are wrap-fill duplicates)")
        for wrapper in wrappers:
            _check_case(fps, results, getattr(fps, wrapper), sub, 4096,
                        CROP_SET)
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


def time_track(track, steps: int, device: torch.device):
    """REPEATS timed calls of `track` (a trajectory of `steps` tracked
    steps, ending in a sync) -> (ms per step of each call, the last aux)."""
    steps_ms = []
    for _ in range(REPEATS):
        sync(device)
        t0 = time.perf_counter()
        _, aux = track()
        sync(device)
        steps_ms.append((time.perf_counter() - t0) / steps * 1e3)
    return steps_ms, aux


def seeded_nets(config, dev: torch.device):
    """`nets(cfg)` -> (CoordNet, RotNet) for cfg's network, every pair with
    the random weights drawn from SEED for `config()`'s nets."""
    from captra_tpu_torch.models.coordnet import CoordNet
    from captra_tpu_torch.models.rotnet import RotNet
    base = config()
    gen = torch.Generator().manual_seed(SEED)
    first = (CoordNet(base, device=dev, generator=gen),
             RotNet(base, device=dev, generator=gen))

    def key(cfg):
        return cfg.network, cfg.pointnet, cfg.obj

    made = {key(base): first}

    def nets(cfg):
        if key(cfg) not in made:
            made[key(cfg)] = (CoordNet(cfg, device=dev),
                              RotNet(cfg, device=dev))
            for src, dst in zip(first, made[key(cfg)]):
                dst.load_state_dict(src.state_dict())
        return made[key(cfg)]

    return nets


def timed_run(name: str, track, B: int, frames: int, dev: torch.device,
              profile: str | None = None):
    """One tracked path, `track(upto)` a trajectory of its first `upto`
    frames: a warm-up, the launch counters zeroed just before its REPEATS
    timed trajectories and read just after, poses finite and within
    POSE_TOL (labels equal) of the same trajectory with the plain FPS on
    the card, and with `profile` a profiler window of 3 steps.  Returns the
    run's record and the last timed trajectory's aux."""
    from captra_tpu_torch.ops import fps
    track(3)                                          # warm-up
    sync(dev)
    fps.reset_launch_counts()
    steps_ms, aux = time_track(lambda: track(frames), frames - 1, dev)
    launches = dict(fps.launch_counts)
    for f in ("rotation", "translation", "scale"):
        if not bool(torch.isfinite(getattr(aux.pose, f)).all()):
            raise AssertionError(f"{name}: non-finite {f}")
    with plain_fps_on_card():
        _, plain = track(frames)
    diff = _max_pose_diff(aux.pose, plain.pose)
    log(f"{name}: kernels vs plain FPS on {dev}, max |diff| {diff}")
    if max(diff.values()) > POSE_TOL or not torch.equal(aux.pred_labels,
                                                        plain.pred_labels):
        raise AssertionError(f"{name}: poses with the kernels differ from "
                             f"the plain FPS by {diff}")
    prof = (profile_window(lambda: track(4), 3, B, profile,
                           tag=name.replace(" ", "_")) if profile else None)
    ms = float(np.median(steps_ms))
    return dict(B=B, launches=launches, ms_per_step=ms,
                ms_per_step_runs=steps_ms, frames_per_s=B * 1e3 / ms,
                plain_fps_diff=diff, profile=prof), aux


def run_msg(name: str, run: dict, frames: int) -> str:
    ms, steps_ms, B = run["ms_per_step"], run["ms_per_step_runs"], run["B"]
    msg = (f"{name}: {ms:.2f} ms per tracked step of {B} frame(s) (median "
           f"of {REPEATS} runs of {frames - 1} steps; min {min(steps_ms):.2f}"
           f", max {max(steps_ms):.2f}), {ms / B:.3f} ms per tracked frame, "
           f"{B * 1e3 / ms:.1f} tracked frames/s")
    if run["profile"]:
        msg += "; card busy ms per step by family " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(
                run["profile"]["families_ms"].items(), key=lambda kv: -kv[1]))
    return msg


def compare_dtypes(path: str, runs: dict, poses: dict) -> dict:
    """Each bfloat16 run of `runs` against its float32 twin of the same call
    (the name without the `bf16_` prefix): ms a step and the largest pose
    difference (information: random nets amplify the rounding)."""
    out = {}
    for name in runs:
        if not name.startswith(BF16_PREFIX):
            continue
        f32, bf16 = runs[name[len(BF16_PREFIX):]], runs[name]
        diff = _max_pose_diff(poses[name], poses[name[len(BF16_PREFIX):]])
        out[name] = dict(max_pose_diff=diff, speedup=(
            f32["ms_per_step"] / bf16["ms_per_step"]))
        log(f"{path} {name}: bfloat16 {bf16['ms_per_step']:.2f} against "
            f"float32 {f32['ms_per_step']:.2f} ms per step "
            f"({f32['ms_per_step'] / bf16['ms_per_step']:.2f}x); largest "
            f"pose difference between the dtypes {diff}")
    return out


def phase_slice(config=None, device: str = "cuda",
                profile: str | None = None, runs=SLICE_RUNS,
                frames: int = T) -> dict:
    """Track each run of `runs` on synthetic trajectories; returns per run
    its launches, ms per step and profile, the FPS launches of the whole
    phase, and each bfloat16 run against its float32 twin.  `device`, a
    short `frames` and a small `config(compute_dtype=, quality_profile=)`
    let the phase be rehearsed on the CPU with the plain FPS."""
    from captra_tpu_torch.config.presets import nocs_bottle
    from captra_tpu_torch.data.synthetic import (
        batch_trajectories, make_trajectory,
    )
    from captra_tpu_torch.ops import fps
    from captra_tpu_torch.pose import metrics
    from captra_tpu_torch.pose.part_dof import Pose
    from captra_tpu_torch.tracking.tracker import (
        make_track_step, track_trajectory,
    )

    dev = torch.device(device)
    config = config or nocs_bottle
    base = config()
    nets = seeded_nets(config, dev)
    n_params = sum(p.numel() for m in nets(base) for p in m.parameters())
    log(f"slice: {base.obj.name}, {base.num_points} points, {n_params} "
        f"parameters (random, seed {SEED}), T={frames}, on {dev}")

    data, init, points = {}, {}, {}
    for B in sorted({r[1] for r in runs}):
        d = batch_trajectories([
            make_trajectory(seed=100 * B + i, obj=base.obj, num_frames=frames,
                            num_points=base.num_points) for i in range(B)])
        data[B] = d
        init[B] = Pose(*(torch.from_numpy(d[k][0]).to(dev)
                         for k in ("rotation", "translation", "scale")))
        points[B] = torch.from_numpy(d["points"]).to(dev)

    out, poses, total = {}, {}, {k: 0 for k in fps.launch_counts}
    for name, B, kwargs, fields, _ in runs:
        cfg = config(**kwargs)
        if fields:
            cfg = cfg.replace(track=dataclasses.replace(cfg.track, **fields))
        step_gen = torch.Generator(device=dev)
        step = make_track_step(cfg, *nets(cfg), device=dev,
                               generator=step_gen)

        def track(upto, step=step, step_gen=step_gen, B=B):
            step_gen.manual_seed(SEED)          # the same draws every run
            return track_trajectory(step, init[B],
                                    {"points": points[B][:upto]}, device=dev)

        out[name], aux = timed_run(f"slice {name}", track, B, frames, dev,
                                   profile)
        for k, n in out[name]["launches"].items():
            total[k] += n
        poses[name] = aux.pose
        gt = {k: torch.from_numpy(data[B][k][1:]).to(dev)
              for k in ("rotation", "translation", "scale")}
        rdiff = metrics.rot_diff_degree(gt["rotation"], aux.pose.rotation,
                                        yaxis_only=cfg.obj.sym)
        tdiff = metrics.trans_diff(gt["translation"], aux.pose.translation)
        log(run_msg(f"slice {name}", out[name], frames) + f"; FPS launches "
            f"{_frame_launches(out[name]['launches'], REPEATS * (frames - 1))}"
            f" a frame; error to the synthetic truth (random weights): "
            f"rotation mean {float(rdiff.mean()):.2f} deg, last frame "
            f"{float(rdiff[-1].mean()):.2f} deg; translation mean "
            f"{float(tdiff.mean()):.4f} m")

    if "b1" in out:
        # information only: GPU and CPU matmuls round differently, which can
        # move a neighbour across a ball-query radius
        cpu_step = make_track_step(base, *(copy.deepcopy(m).cpu()
                                           for m in nets(base)), device="cpu")
        _, cpu_aux = track_trajectory(
            cpu_step, init[1].to("cpu"),
            {"points": torch.from_numpy(data[1]["points"][:2])}, device="cpu")
        log(f"slice b1 first tracked frame, card vs CPU (not a gate): "
            f"{_max_pose_diff(poses['b1'][:1].to('cpu'), cpu_aux.pose)}")
    return {"launches": total, "runs": out,
            "dtype": compare_dtypes("slice", out, poses)}


def check_launches(sliced: dict, runs=SLICE_RUNS, frames: int = T) -> None:
    """Every kernel launched on the main path, each run's launches a tracked
    frame 4 sweeps split between the kernels by B, times its passes."""
    from captra_tpu_torch.ops import fps
    tracked = REPEATS * (frames - 1)
    for name, B, _, _, passes in runs:
        want = ({"fps_cuda_wide": 2, "fps_cuda_batched": 2}
                if B < fps.WIDE_MAX_BATCH else
                {"fps_cuda_wide": 0, "fps_cuda_batched": 4})
        want = {k: n * passes * tracked for k, n in want.items()}
        got = {k: sliced["runs"][name]["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"slice {name}: FPS launches {got}, "
                                 f"expected {want}")
    for name in SLICE_KERNELS:
        if sliced["launches"][name] == 0:
            raise AssertionError(f"{name} never launched on the main path")
    others = {k: n for k, n in sliced["launches"].items()
              if k not in SLICE_KERNELS and n}
    if others:
        raise AssertionError(f"the slice launched {others}")


def profile_window(run, steps: int, B: int, out_dir: str,
                   tag: str | None = None) -> dict:
    """Kernel time by name over `run` (`steps` tracked steps), and the
    device's busy share of the window's wall time; the full table goes to
    `out_dir` as profile_<tag>.txt, beside the window's Chrome trace
    (`utils/profiling.trace`).  Returns ms per step: wall, busy, by
    family, the device time under each `annotate` span (the kernels its
    host ops launched, nested spans included), and the host syncs in the
    window (its own closing sync included)."""
    from captra_tpu_torch.utils.profiling import trace
    tag = tag or f"b{B}"

    torch.cuda.synchronize()
    with trace(out_dir) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    averages = prof.key_averages()
    # kernels, copies and memsets run on the card; the CPU ops that launched
    # them repeat their time and are left out of the sum, and so are the
    # spans' ranges on the card's timeline
    annotation = [getattr(e, "is_user_annotation", False) for e in averages]
    on_card = sorted((e for e, a in zip(averages, annotation)
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not a), key=dev_us, reverse=True)
    spans = {e.key: e.device_time_total / steps / 1e3
             for e, a in zip(averages, annotation)
             if a and e.device_type == torch.autograd.DeviceType.CPU}
    busy = sum(dev_us(e) for e in on_card)
    syncs = sum(e.count for e in averages
                if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    log(f"profile {tag}: {steps} steps, wall {wall_us / steps / 1e3:.2f} ms "
        f"per step, device busy {busy / steps / 1e3:.2f} ms per step "
        f"({100 * busy / wall_us:.1f}% of wall), {syncs} host syncs")
    families = {}
    for e in on_card:
        fam = next((f for f, pat in PROFILE_FAMILIES if pat in e.key), "other")
        families[fam] = families.get(fam, 0) + dev_us(e)
    log("  by family: " + ", ".join(
        f"{f} {t / steps / 1e3:.3f}" for f, t in
        sorted(families.items(), key=lambda kv: -kv[1])) + " (ms/step)")
    if spans:
        log("  by span (device ms/step, share of busy): " + ", ".join(
            f"{k} {v:.3f} ({100 * v * steps * 1e3 / busy:.1f}%)"
            for k, v in sorted(spans.items(), key=lambda kv: -kv[1])))
    for e in on_card[:10]:
        log(f"  {dev_us(e) / steps / 1e3:8.3f} ms/step  x{e.count // steps:<5}"
            f" {e.key[:90]}")
    with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
        f.write(averages.table(sort_by="self_cuda_time_total", row_limit=-1))
    return {"wall_ms": wall_us / steps / 1e3, "busy_ms": busy / steps / 1e3,
            "busy_share": busy / wall_us, "syncs_in_window": syncs,
            "families_ms": {f: t / steps / 1e3 for f, t in families.items()},
            "spans_ms": spans}


# the rollout profile's spans: module families by class (their forwards),
# the heads by attribute name, the losses the trainer calls, the optimizer
SPAN_MODULES = (("GroupNorm", "group_norm"), ("SetAbstractionMsg", "sa"),
                ("SetAbstractionAll", "sa"), ("FeaturePropagation", "fp"))
SPAN_HEADS = ("seg_head", "nocs_head", "regressor")
SPAN_LOSSES = ("miou_loss", "nocs_loss", "sym_nocs_loss", "part_dof_loss",
               "rot_trace_loss", "rot_yaxis_loss", "point_pose_loss",
               "weighted_total")


@contextlib.contextmanager
def module_spans(nets):
    """`annotate` spans over the forwards of each module family of `nets`
    (SPAN_MODULES, SPAN_HEADS; by forward pre- and post-hooks), over the
    losses the trainer calls (outermost call only) and over the
    optimizer's step (wrappers here: the package is not changed).  The
    backward's kernels run outside every span."""
    from captra_tpu_torch.models import losses
    from captra_tpu_torch.training import trainer
    from captra_tpu_torch.utils.profiling import annotate

    handles = []

    def hook(name):
        open_spans = []

        def pre(module, args):
            span = annotate(name)
            span.__enter__()
            open_spans.append(span)

        def post(module, args, out):
            open_spans.pop().__exit__(None, None, None)
        return pre, post

    for net in nets:
        for path, module in net.named_modules():
            name = dict(SPAN_MODULES).get(type(module).__name__)
            if name is None and path.split(".")[-1] in SPAN_HEADS:
                name = "heads"
            if name:
                pre, post = hook(name)
                handles += [module.register_forward_pre_hook(pre),
                            module.register_forward_hook(post)]
    depth = [0]

    def spanned(fn, name):
        def run(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            depth[0] += 1
            try:
                with annotate(name):
                    return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return run

    patched = [(losses, n, getattr(losses, n)) for n in SPAN_LOSSES]
    patched.append((trainer.Optimizer, "step", trainer.Optimizer.step))
    for owner, n, fn in patched:
        setattr(owner, n, spanned(fn, "optimizer" if n == "step"
                                  else "losses"))
    try:
        yield
    finally:
        for owner, n, fn in patched:
            setattr(owner, n, fn)
        for h in handles:
            h.remove()


def phase_otf(device: str = "cuda", profile: str | None = None,
              runs=OTF_RUNS, frames: int = T, config=None,
              kernels: dict | None = None) -> dict:
    """The OTF path: each run of OTF_RUNS tracks a depth video of `frames`
    frames; returns per run the launches of its timed runs, ms per step and
    the profile, and each bfloat16 run against its float32 twin.  With
    `kernels` (phase_kernels' results) the runs of VIDEO_RUNS add their
    kernels' cases on the video's own FPS inputs.  `device`, a short
    `frames` and a small `config(fps_mode=, compute_dtype=)` let the phase
    be rehearsed on the CPU with the plain FPS."""
    from captra_tpu_torch.config.presets import nocs_bottle_otf
    from captra_tpu_torch.data import depth_frames
    from captra_tpu_torch.ops import fps
    from captra_tpu_torch.tracking.tracker import (
        make_track_step, track_trajectory,
    )

    dev = torch.device(device)
    config = config or nocs_bottle_otf
    base = config()
    nets = seeded_nets(config, dev)
    P = base.obj.num_parts

    videos = {}
    for B in sorted({r[1] for r in runs}):
        depths, masks = depth_frames.make_depth_frames(frames, B, seed=SEED)
        H, W = depths.shape[-2:]
        shift = np.random.RandomState(SEED).randint(0, H * W, (frames, B))
        init = depth_frames.otf_init_pose(depths[0, 0], masks[0, 0], B, P)
        videos[B] = ({"depth": torch.from_numpy(depths).to(dev),
                      "mask": torch.from_numpy(masks).to(dev),
                      "shift": torch.from_numpy(shift).to(dev)},
                     init.to(dev))
    log(f"otf: {base.obj.name}, {base.num_points} points from a "
        f"{H}x{W} depth video, work factor {base.track.otf_work_factor}, "
        f"T={frames}, on {dev}")

    out, poses, tracks = {}, {}, {}
    for name, B, mode, blocked, kwargs in runs:
        cfg = config(fps_mode=mode, **kwargs)
        step = make_track_step(cfg, *nets(cfg), device=dev)
        video, init = videos[B]

        def track(upto, step=step, video=video, init=init):
            return track_trajectory(step, init,
                                    {k: v[:upto] for k, v in video.items()},
                                    device=dev)

        with blocked_fps(blocked):
            out[name], aux = timed_run(f"otf {name}", track, B, frames, dev,
                                       profile)
            if kernels is not None and name in VIDEO_RUNS:
                calls = {}
                with recording_fps(calls):
                    track(frames)
                roles = {base.num_points * base.track.otf_work_factor:
                         "crop", base.num_points: "sa1"}
                for (n, npoint), clouds in sorted(calls.items(),
                                                  reverse=True):
                    role = roles.get(n, "sa2")
                    check_video(fps, kernels, VIDEO_RUNS[name][role], clouds,
                                npoint, name, frames - 1,
                                CROP_VIDEO if role == "crop" else SA_VIDEO)
        poses[name] = aux.pose
        tracks[name] = (track, blocked)
        run = out[name]
        run.update(fps_mode=mode, blocked=blocked,
                   compute_dtype=cfg.network.compute_dtype)
        ms, prof = run["ms_per_step"], run["profile"]
        msg = run_msg(f"otf {name}", run, frames)
        if B == 1:
            msg += (f"; {'within' if ms <= CAMERA_MS else 'ABOVE'} the "
                    f"{CAMERA_MS} ms camera limit")
        if prof:
            fps_ms = prof["families_ms"].get("fps", 0.0)
            run.update(fps_share=fps_ms / ms, busy_share=prof["busy_ms"] / ms)
            msg += (f"; profile: FPS {fps_ms:.3f} ms per step on the card "
                    f"= {100 * fps_ms / ms:.1f}% of the timed step, card "
                    f"busy {prof['busy_ms']:.2f} ms = "
                    f"{100 * prof['busy_ms'] / ms:.1f}% of the timed step "
                    f"({100 * prof['busy_share']:.1f}% of the profiled "
                    f"window), {prof['syncs_in_window']} host syncs in the "
                    "3-step window")
        log(msg + f"; launches {run['launches']}")

    if "b1" in poses and "b1_blocked" in poses:
        for f in ("rotation", "translation", "scale"):
            if not torch.equal(getattr(poses["b1"], f),
                               getattr(poses["b1_blocked"], f)):
                raise AssertionError(f"otf: the blocked run's {f} differs "
                                     "from the default run's")
        log("otf b1_blocked: poses equal to the b1 run's")
        # the two B=1 exact runs again, in reverse order: b1, blocked,
        # blocked, b1 on one card
        for name in ("b1_blocked", "b1"):
            track, blocked = tracks[name]
            with blocked_fps(blocked):
                steps_ms, _ = time_track(lambda: track(frames), frames - 1,
                                         dev)
            out[name]["ms_per_step_again"] = float(np.median(steps_ms))
        log("otf b1 vs b1_blocked in turns (ms per step, medians of "
            f"{REPEATS}): b1 {out['b1']['ms_per_step']:.2f}, blocked "
            f"{out['b1_blocked']['ms_per_step']:.2f}, blocked "
            f"{out['b1_blocked']['ms_per_step_again']:.2f}, b1 "
            f"{out['b1']['ms_per_step_again']:.2f}")
    return {"runs": out, "dtype": compare_dtypes("otf", out, poses)}


def check_otf_launches(otf: dict, frames: int = T) -> None:
    """The launches per tracked frame of each OTF run, as predicted."""
    tracked = REPEATS * (frames - 1)
    for name, run in otf["runs"].items():
        want = {k: OTF_LAUNCHES[name].get(k, 0) * tracked
                for k in run["launches"]}
        if run["launches"] != want:
            raise AssertionError(f"otf {name}: FPS launches "
                                 f"{run['launches']}, expected {want}")


@contextlib.contextmanager
def blocked_fps(on: bool):
    """CAPTRA_FPS_BLOCKED=1 for the scope when `on`, else unset."""
    old = os.environ.pop("CAPTRA_FPS_BLOCKED", None)
    if on:
        os.environ["CAPTRA_FPS_BLOCKED"] = "1"
    try:
        yield
    finally:
        os.environ.pop("CAPTRA_FPS_BLOCKED", None)
        if old is not None:
            os.environ["CAPTRA_FPS_BLOCKED"] = old

INIT_SEARCH_K = 64
INIT_SEG_BIAS = 3.0
INIT_SEARCH_WHERE = ("the frame-0 orientation search's CoordNet chunk "
                     f"(K={INIT_SEARCH_K} candidates at B=1), ms a search")


def _frame_launches(launches: dict, tracked: int) -> dict:
    """Launches per tracked frame, kernels that launched only."""
    return {k: n / tracked for k, n in launches.items() if n}


def phase_init_search(config=None, device: str = "cuda",
                      profile: str | None = None, frames: int = T,
                      kernels: dict | None = None) -> dict:
    """The GT-less init on the slice's B=1 trajectory: the cloud's guess
    (`init_pose_from_cloud`), `search_init_orientation` over INIT_SEARCH_K
    candidates on frame 0 (median ms of REPEATS searches, the launch
    counters zeroed just before and read just after, the pose against the
    same search with the plain FPS), then tracking from the found pose.
    With `kernels` the search's FPS inputs are recorded and the kernel held
    against the plain FPS on them.  `device`, a short `frames` and a small
    `config()` let the phase be rehearsed on the CPU with the plain FPS."""
    from captra_tpu_torch.config.presets import nocs_bottle
    from captra_tpu_torch.data.synthetic import (
        batch_trajectories, make_trajectory,
    )
    from captra_tpu_torch.ops import fps
    from captra_tpu_torch.tracking.tracker import (
        init_pose_from_cloud, make_track_step, search_init_orientation,
        track_trajectory,
    )

    dev = torch.device(device)
    config = config or nocs_bottle
    base = config()
    cfg = base.replace(track=dataclasses.replace(
        base.track, init_frame_gt=False, init_search=INIT_SEARCH_K))
    points = torch.from_numpy(batch_trajectories([make_trajectory(
        seed=100, obj=base.obj, num_frames=frames,
        num_points=base.num_points)])["points"]).to(dev)
    cloud0 = points[0]
    guess = init_pose_from_cloud(cloud0, base.obj.num_parts, base.data_radius,
                                 device=dev)
    # The random seg head labels the cloud background, which leaves every
    # candidate without a fit and the search with its guess: its part
    # logits get INIT_SEG_BIAS, so the search fits and chooses
    coord, rotn = seeded_nets(config, dev)(base)
    coord = copy.deepcopy(coord)
    with torch.no_grad():
        coord.seg_head.dense_0.bias[:base.obj.num_parts] += INIT_SEG_BIAS

    def search():
        return search_init_orientation(coord, cloud0, guess, cfg, device=dev)

    search()                                           # warm-up
    sync(dev)
    fps.reset_launch_counts()
    search_ms = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        found = search()
        sync(dev)
        search_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(fps.launch_counts)
    with plain_fps_on_card():
        plain_found = search()
    diff = _max_pose_diff(found, plain_found)
    if max(diff.values()) > POSE_TOL:
        raise AssertionError(f"init_search: the pose with the kernels "
                             f"differs from the plain FPS by {diff}")
    if not bool(torch.isfinite(found.rotation).all()):
        raise AssertionError("init_search: non-finite pose")
    passes = max(cfg.track.init_search_steps, 1)
    want = {**{k: 0 for k in launches},
            "fps_cuda_batched": 2 * passes * REPEATS}
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"init_search: FPS launches {launches}, "
                             f"expected {want}")
    ms = float(np.median(search_ms))
    out = {"search": dict(B=1, K=INIT_SEARCH_K, ms=ms, ms_runs=search_ms,
                          launches=launches, plain_fps_diff=diff)}
    log(f"init_search: K={INIT_SEARCH_K} candidates, {passes} passes, "
        f"{ms:.2f} ms a search (median of {REPEATS}; min {min(search_ms):.2f}"
        f", max {max(search_ms):.2f}); FPS launches a search "
        f"{_frame_launches(launches, REPEATS)}; kernels vs plain FPS, max "
        f"|diff| {diff}; the found rotation's distance to the guess (max "
        f"|diff|) {float((found.rotation - guess.rotation).abs().max()):.3f}")

    step = make_track_step(cfg, coord, rotn, device=dev)

    def track(upto):
        return track_trajectory(step, found, {"points": points[:upto]},
                                device=dev)

    out["track_b1"], _ = timed_run("init_search track_b1", track, 1, frames,
                                   dev, profile)
    log(run_msg("init_search track_b1", out["track_b1"], frames))
    got = _frame_launches(out["track_b1"]["launches"],
                          REPEATS * (frames - 1))
    if dev.type == "cuda" and got != {"fps_cuda_wide": 2.0,
                                      "fps_cuda_batched": 2.0}:
        raise AssertionError(f"init_search track_b1: FPS launches a frame "
                             f"{got}")
    if kernels is not None:
        calls = {}
        with recording_fps(calls):
            search()
        for (n, npoint), clouds in sorted(calls.items(), reverse=True):
            check_video(fps, kernels, ("fps_cuda_batched",), clouds, npoint,
                        "search", 1, INIT_SEARCH_WHERE, path="init_search")
    return out

# the track CLI's runs: (name, flags on top of the CLI's defaults), and the
# FPS launches each tracked frame must make by `route` at B=4: CoordNet's
# sa1 [4,4096] -> wide, sa2 [4,512] -> batched; RotNet's clouds are B x P,
# so the laptop's [8,4096] and [8,512] -> batched, the bottle's as CoordNet's
CLI_RUNS = (("laptop", []),
            ("bottle", ["--obj_config", "obj_info_nocs.yml",
                        "--obj_category", "1"]))
CLI_LAUNCHES = {"laptop": {"fps_cuda_wide": 1, "fps_cuda_batched": 3},
                "bottle": {"fps_cuda_wide": 2, "fps_cuda_batched": 2}}
CLI_TRAJECTORIES = 4        # the CLI's synthetic trajectories ...
CLI_FRAMES = 20             # ... and their frames
CLI_VIDEO = "the track CLI's FPS inputs (B=4), ms a frame"
_BATCH_LINE = re.compile(r"^(\S+): (\d+) frames x (\d+) in ([0-9.]+)s "
                         r"\(([0-9.]+) fps\)$", re.M)


def _printed(fn, *args, **kwargs):
    """(stdout of fn(*args, **kwargs), its result, seconds)."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        ret = fn(*args, **kwargs)
    return out.getvalue(), ret, time.perf_counter() - t0


def _eval_metrics(num_parts: int, iou: bool) -> set:
    """The err.csv columns `eval_trajectory` gives an object."""
    names = ["rdiff", "tdiff", "sdiff", "5deg5cm", "10deg10cm"]
    if iou:
        names += ["npcs_iou", "iou", "gt_bbox_iou"]
    cols = {f"{m}_{j}" for m in names for j in range(num_parts)}
    if num_parts > 1:
        cols |= {f"theta_diff_{j}" for j in range(num_parts - 1)}
    return cols


def write_checkpoints(cfg, dev: torch.device, coord_dir: str,
                      rot_dir: str):
    """The seeded nets of cfg, written as a coord and a rot experiment's
    checkpoints (the JAX package's pickle layout); returns the nets."""
    from captra_tpu_torch.training import checkpoint
    from captra_tpu_torch.training.convert import flax_variables
    nets = seeded_nets(lambda cfg=cfg: cfg, dev)(cfg)
    for exp, net in ((coord_dir, nets[0]), (rot_dir, nets[1])):
        checkpoint.save_checkpoint(os.path.join(exp, "ckpt"), 0,
                                   flax_variables(net))
    return nets


def check_saved_poses(label: str, saved: list, aux) -> dict:
    """The CLI's saved predicted poses (one result a trajectory, in batch
    order) against its twin's `aux`: finite and within POSE_TOL."""
    diff = {}
    for f in ("rotation", "translation", "scale"):
        got = np.stack([r["pred"]["poses"][f] for r in saved], 1)
        if not np.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite {f}")
        diff[f] = float(np.abs(
            got - getattr(aux.pose, f).cpu().numpy()).max())
    log(f"{label}: saved poses against track_trajectory on the same nets, "
        f"batch and draws, max |diff| {diff}")
    if max(diff.values()) > POSE_TOL:
        raise AssertionError(f"{label}: the CLI's poses differ from the "
                             f"direct run by {diff}")
    return diff


def check_evaluate(label: str, argv: list, dev: torch.device, rot_dir: str,
                   rows: int, num_parts: int, iou: bool) -> float:
    """`cli.evaluate.main(argv)`: err.csv with `rows` rows and every metric
    of `_eval_metrics`; returns its seconds."""
    import csv
    from captra_tpu_torch.cli import evaluate
    text, (got, _), seconds = _printed(evaluate.main, argv, device=dev)
    with open(os.path.join(rot_dir, "results", "err.csv")) as fh:
        table = list(csv.reader(fh))
    cols = set(table[0][1:])
    want = _eval_metrics(num_parts, iou)
    if len(table) - 1 != rows or cols != want or len(got) != rows:
        raise AssertionError(f"{label}: {len(table) - 1} rows, columns "
                             f"{sorted(cols ^ want)} differ")
    log(f"{label}: {rows} rows x {len(cols)} metrics in {seconds:.3f} s; "
        + "  ".join(ln.strip() for ln in text.splitlines()))
    return seconds


def phase_cli(kernels: dict) -> dict:
    """The track and evaluate CLIs on the card for each run of CLI_RUNS,
    from checkpoints written in a temporary directory, with the FPS kernels
    held on the run's recorded inputs (into `kernels`); returns per run its
    launches, frames/s, ms a step, load and evaluate seconds and AVG
    metrics."""
    import pickle

    from captra_tpu_torch.cli import track
    from captra_tpu_torch.ops import fps
    from captra_tpu_torch.tracking.tracker import (
        init_pose_from_gt, make_track_step, track_trajectory,
    )

    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory(prefix="captra_cli_") as tmp:
        for name, flags in CLI_RUNS:
            coord_dir = os.path.join(tmp, name, "coord")
            rot_dir = os.path.join(tmp, name, "rot")
            common = ["--experiment_dir", rot_dir, "--coord_exp/dir",
                      coord_dir, *flags]
            argv = ["--synthetic_data", "--save", *common]
            args, cfg = track.parse(argv)
            nets = write_checkpoints(cfg, dev, coord_dir, rot_dir)
            t0 = time.perf_counter()
            cv, rv = track.load_variables(cfg, args)
            load_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            track.build_step(cfg, cv, rv, device=dev)
            sync(dev)
            build_s = time.perf_counter() - t0
            log(f"cli {name}: {cfg.obj.name}, {cfg.obj.num_parts} part(s), "
                f"{cfg.num_points} points, batch size {cfg.batch_size}; "
                f"checkpoints loaded in {load_s:.3f} s, nets built on {dev} "
                f"in {build_s:.3f} s")

            sync(dev)
            fps.reset_launch_counts()
            text, _, track_s = _printed(track.main, argv, device=dev)
            launches = dict(fps.launch_counts)
            for line in text.strip().splitlines():
                log(f"  | {line}")
            batches = _BATCH_LINE.findall(text)
            B = int(batches[0][2])
            if [int(b[1]) for b in batches] != [CLI_FRAMES - 1] or \
                    B != min(cfg.batch_size, CLI_TRAJECTORIES):
                raise AssertionError(f"cli {name}: batches {batches}")
            steps = CLI_FRAMES - 1 + track.WARMUP_FRAMES - 1
            want = {k: CLI_LAUNCHES[name].get(k, 0) * steps
                    for k in launches}
            if launches != want:
                raise AssertionError(f"cli {name}: FPS launches {launches}, "
                                     f"expected {want}")
            total_fps = float(re.search(r"^TOTAL: \d+ frames, ([0-9.]+) fps",
                                        text, re.M).group(1))
            avg = dict(re.findall(r"(\S+)=(\S+)", next(
                ln for ln in text.splitlines() if ln.startswith("AVG: "))))

            data = os.path.join(rot_dir, "results", "data")
            files = sorted(os.listdir(data))
            if len(files) != CLI_TRAJECTORIES:
                raise AssertionError(f"cli {name}: {len(files)} result "
                                     "pickles")
            saved = []
            for f in files:
                with open(os.path.join(data, f), "rb") as fh:
                    saved.append(pickle.load(fh))
            # the twin: the same nets (not through a checkpoint), the same
            # init draws, `track_trajectory` directly; its FPS inputs
            step = make_track_step(cfg, *nets, device=dev)
            _, batch = next(track.synthetic_sequences(cfg))
            init = init_pose_from_gt(batch["pose"][0], cfg,
                                     generator=torch.Generator()
                                     .manual_seed(0))
            calls = {}
            with recording_fps(calls):
                _, aux = track_trajectory(step, init,
                                          {"points": batch["points"]},
                                          device=dev)
            diff = check_saved_poses(f"cli {name}", saved, aux)
            eval_s = {
                label: check_evaluate(
                    f"cli {name} evaluate ({label})",
                    (["--no_iou"] if label == "no_iou" else []) + common,
                    dev, rot_dir, CLI_TRAJECTORIES * (CLI_FRAMES - 1),
                    cfg.obj.num_parts, label == "iou")
                for label in ("no_iou", "iou")}

            by_shape = {}
            for (n, npoint), clouds in calls.items():
                for xyz in clouds:
                    by_shape.setdefault((xyz.shape[0], n, npoint),
                                        []).append(xyz)
            for (b, n, npoint), clouds in sorted(by_shape.items()):
                check_video(fps, kernels, (fps.route(b, n),), clouds,
                            npoint, name, CLI_FRAMES - 1, CLI_VIDEO,
                            path="cli")
            out[name] = dict(
                B=B, launches=launches, frames_per_s=total_fps,
                ms_per_step=float(batches[0][3]) * 1e3 / (CLI_FRAMES - 1),
                track_main_s=track_s, ckpt_load_s=load_s, build_s=build_s,
                evaluate_s=eval_s["iou"], evaluate_no_iou_s=eval_s["no_iou"],
                avg={k: float(v) for k, v in avg.items()},
                twin_max_pose_diff=diff)
            log(f"cli {name}: {total_fps} tracked frames/s as the CLI prints "
                f"it, {out[name]['ms_per_step']:.2f} ms a step of B={B}; "
                f"FPS launches a tracked frame "
                f"{_frame_launches(launches, steps)}")
        out["reference_pt"] = check_reference_checkpoint(tmp, dev)
    return out


def port_helpers():
    """`tests/torch_port_helpers.py` of this checkout, loaded by path (a
    package named `tests` elsewhere on the path may shadow the
    directory); it imports numpy and, in the functions used here, torch."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_port_helpers", os.path.join(ROOT, "tests",
                                           "torch_port_helpers.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_reference_checkpoint(tmp: str, dev: torch.device) -> dict:
    """A composed tracking checkpoint in the reference's torch layout
    (`npcs_net.*`, `net.*`; `tests/torch_port_helpers.py`'s seeded
    reference state dict at the bottle's full width) written with
    `torch.save`, read by `convert_track_checkpoint`, its nets tracking the
    slice's B=1 trajectory on the card (counters zeroed just before, read
    just after: sa1 -> fps_cuda_wide); poses finite and within POSE_TOL of
    the same variables written as pickle checkpoints and loaded back as
    flax trees (`checkpoint.load_track_variables`)."""
    from captra_tpu_torch.config.presets import nocs_bottle
    from captra_tpu_torch.data.synthetic import (
        batch_trajectories, make_trajectory,
    )
    from captra_tpu_torch.ops import fps
    from captra_tpu_torch.pose.part_dof import Pose
    from captra_tpu_torch.tracking.tracker import (
        make_track_step, track_trajectory,
    )
    from captra_tpu_torch.training import checkpoint
    from captra_tpu_torch.training.convert import (
        convert_track_checkpoint, coordnet_from_flax, rotnet_from_flax,
    )
    cfg = nocs_bottle()
    path = os.path.join(tmp, "reference.pt")
    torch.save({"epoch": 0, "iteration": 0,
                "model": port_helpers().reference_track_state_dict(
                    cfg, seed=SEED),
                "optimizer": {"state": {}, "param_groups": []}}, path)
    t0 = time.perf_counter()
    cv, rv = convert_track_checkpoint(path, cfg)
    convert_s = time.perf_counter() - t0
    d = batch_trajectories([make_trajectory(seed=100, obj=cfg.obj,
                                            num_frames=T,
                                            num_points=cfg.num_points)])
    init = Pose(*(torch.from_numpy(d[k][0]).to(dev)
                  for k in ("rotation", "translation", "scale")))
    points = torch.from_numpy(d["points"]).to(dev)

    def track(coord_vars, rot_vars):
        step = make_track_step(cfg, coordnet_from_flax(cfg, coord_vars, dev)
                               .eval(), rotnet_from_flax(cfg, rot_vars, dev)
                               .eval(), device=dev)
        return track_trajectory(step, init, {"points": points}, device=dev)

    sync(dev)
    fps.reset_launch_counts()
    _, aux = track(cv, rv)
    sync(dev)
    launches = dict(fps.launch_counts)
    want = {k: predicted_launches(cfg, 1).get(k, 0) * (T - 1)
            for k in launches}
    if launches != want:
        raise AssertionError(f"cli reference .pt: FPS launches {launches}, "
                             f"expected {want}")
    dirs = [os.path.join(tmp, "reference_pt", n) for n in ("coord", "rot")]
    for d_, v in zip(dirs, (cv, rv)):
        checkpoint.save_checkpoint(d_, 0, v)
    fv = checkpoint.load_track_variables(*(os.path.join(d_, "model_0000")
                                           for d_ in dirs))
    _, twin = track(*fv)
    for f in ("rotation", "translation", "scale"):
        if not bool(torch.isfinite(getattr(aux.pose, f)).all()):
            raise AssertionError(f"cli reference .pt: non-finite {f}")
    diff = _max_pose_diff(aux.pose, twin.pose)
    if max(diff.values()) > POSE_TOL:
        raise AssertionError(f"cli reference .pt: poses differ from the "
                             f"flax trees' by {diff}")
    log(f"cli reference .pt: {os.path.getsize(path) / 2**20:.1f} MiB "
        f"torch.save'd composed checkpoint, read and converted in "
        f"{convert_s:.3f} s; tracked B=1 x {T} frames on {dev}, FPS "
        f"launches a tracked frame {_frame_launches(launches, T - 1)}; "
        f"poses finite, against the flax trees' max |diff| {diff}")
    return dict(launches=launches, convert_s=convert_s, max_pose_diff=diff)


# the data phase: datasets on disk through the track CLI (flags on top of
# the CLI's defaults; "{root}" is the dataset root).  sapien_laptop: the
# SAPIEN laptop's `test_seq` split, DATA_SAPIEN_INSTANCES (two of
# obj_info_sapien.yml's test_list), one track each of obj/num_frames
# frames, tracked as one chunk each at B=2; the NOCS bottle's `real_test`
# scene of DATA_NOCS_FRAMES frames on the OTF crop, with the GT instance
# masks and with NOCS-2D detections.
DATA_SAPIEN_INSTANCES = ("10101", "10270")
DATA_NOCS_FRAMES = 30
DATA_IMAGE_HW = (480, 640)
DATA_NOCS_INSTANCE = "bottle_red_stanford_norm"
DATA_NOCS_OBJ = ["--obj_config", "obj_info_nocs.yml", "--obj_category", "1",
                 "--mode_name", "real_test", "--nocs_otf", "true"]
DATA_RUNS = (("sapien_laptop", ["--mode_name", "test_seq"]),
             ("nocs_bottle_otf", DATA_NOCS_OBJ),
             ("nocs_bottle_nocs2d", [*DATA_NOCS_OBJ,
                                     "--track_cfg/nocs2d_label", "true",
                                     "--track_cfg/nocs2d_path",
                                     "{root}/nocs2d"]))
DATA_VIDEO = "the data phase's recorded FPS inputs, ms a frame"
SAPIEN_NEAR, SAPIEN_FAR = 0.1, 100.0
SAPIEN_K = np.array([[600.0, 0.0, 320.0], [0.0, 600.0, 240.0],
                     [0.0, 0.0, 1.0]])


def png_filter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Scanlines uint8 [H, S] -> the PNG image data [H, 1 + S], row r
    filtered with filter r % 5 (None, Sub, Up, Average, Paeth): the mix a
    libpng writer's adaptive filtering brings a reader."""
    x = rows.astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, bpp:] = x[:, :-bpp]
    b[1:] = x[:-1]
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kinds = np.arange(len(x)) % 5
    pred = np.choose(kinds[:, None], [np.zeros_like(x), a, b, (a + b) >> 1,
                                      paeth])
    return np.concatenate([kinds[:, None], (x - pred) & 0xFF],
                          axis=1).astype(np.uint8)


def png_bytes(img: np.ndarray) -> bytes:
    """A PNG of uint16 grey [H, W] or uint8 RGB [H, W, 3], its rows filtered
    in turn with each of the five filters (`png_filter`)."""
    import struct
    import zlib
    H, W = img.shape[:2]
    if img.dtype == np.uint16:
        color, bits, bpp = 0, 16, 2
        rows = img.astype(">u2").view(np.uint8).reshape(H, -1)
    else:
        color, bits, bpp, rows = 2, 8, 3, img.reshape(H, W * 3)
    raw = png_filter(rows, bpp).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, bits, color, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def _quat(axis, angle: float) -> list:
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return [np.cos(angle / 2), *(np.sin(angle / 2) * axis)]


def write_sapien(root: str, frames: int, rng) -> None:
    """SAPIEN `render_seq` tracks of the laptop's DATA_SAPIEN_INSTANCES:
    per frame an OpenGL depth buffer and seg image (the base and the lid,
    sloped patches at about 1 m with +-2 mm of noise, sliding a pixel a
    frame), the GT camera and link poses, and each instance's model info;
    DATA_IMAGE_HW images."""
    import pickle
    H, W = DATA_IMAGE_HW
    os.makedirs(os.path.join(root, "model_info", "laptop"))
    for k, instance in enumerate(DATA_SAPIEN_INSTANCES):
        base = os.path.join(root, "render_seq", "laptop", instance, "0000")
        for sub in ("cloud", "gt"):
            os.makedirs(os.path.join(base, sub))
        rows = np.arange(H, dtype=np.float64)[:, None]
        for f in range(frames):
            z = np.full((H, W), np.inf)
            seg = np.full((H, W), 2, np.uint8)        # 2: nothing rendered
            c0 = W // 4 + k * W // 32 + f
            parts = ((slice(int(H * 0.5), int(H * 0.75)), 0.95 + 0.0004 *
                      (rows - H * 0.5)),
                     (slice(int(H * 0.2), int(H * 0.5)), 1.05 - 0.0002 *
                      (rows - H * 0.2)))
            for p, (rs, zrow) in enumerate(parts):
                cs = slice(c0, c0 + int(W * 0.4))
                z[rs, cs] = np.broadcast_to(zrow, (H, W))[rs, cs]
                seg[rs, cs] = p
            z = z + rng.uniform(-0.002, 0.002, (H, W))
            depth = np.where(np.isfinite(z), (SAPIEN_NEAR * SAPIEN_FAR / z
                                              - SAPIEN_FAR)
                             / (SAPIEN_NEAR - SAPIEN_FAR), 1.0)
            np.savez_compressed(
                os.path.join(base, "cloud", f"{f}.npz"),
                all_dict={"depth": depth.astype(np.float32), "seg": seg,
                          "camera_matrix": SAPIEN_K, "near": SAPIEN_NEAR,
                          "far": SAPIEN_FAR})
            lid = 0.6 + 0.004 * f
            gt = {"camera_pose": ([0.0, 0.0, 0.0], _quat([1, 0, 0], 0.0)),
                  "link_pose": {0: ([1.0, 0.002 * f, 0.0],
                                    _quat([0, 0, 1], 0.1)),
                                1: ([1.0, 0.002 * f, 0.1],
                                    _quat([0, 1, 0], lid))}}
            with open(os.path.join(base, "gt", f"{f}.pkl"), "wb") as fh:
                pickle.dump(gt, fh)
        corner = [np.array([-0.18, -0.12, -0.01]), np.array([0.18, 0.12,
                                                             0.01])]
        info = {"num_parts": 2, "tree": [-1, 0],
                "corner": [corner, corner], "factor": [2.3, 2.3],
                "obj2link": {0: np.eye(4), 1: np.eye(4)}}
        with open(os.path.join(root, "model_info", "laptop",
                               f"{instance}.pkl"), "wb") as fh:
            pickle.dump(info, fh)


def write_nocs(root: str, frames: int, rng) -> None:
    """One NOCS `real_test` bottle scene: per frame a 16-bit depth PNG
    (background at 1.5 m, an object blob of 3/16 of the height (90 pixels)
    at 1.0 m moving a pixel a frame, +-3 mm of noise), the mask PNG (the
    instance number 7 in red), meta.txt, the preprocessed `data/*.npz`
    frame (the blob's points, the GT pose at their centroid), and a
    NOCS-2D detection pickle (the blob and a detection of another class);
    the instance's model corners; DATA_IMAGE_HW images."""
    import pickle
    from captra_tpu_torch.data.preprocess import (
        NOCS_REAL_INTRINSICS, backproject_depth,
    )
    H, W = DATA_IMAGE_HW
    raw = os.path.join(root, "nocs_full", "real_test", "scene_1")
    data = os.path.join(root, "render", "real_test", "1", DATA_NOCS_INSTANCE,
                        "scene_1", "data")
    for d in (raw, data, os.path.join(root, "nocs2d"),
              os.path.join(root, "model_corners")):
        os.makedirs(d, exist_ok=True)
    np.save(os.path.join(root, "model_corners", f"{DATA_NOCS_INSTANCE}.npy"),
            np.array([[-0.05, -0.12, -0.05], [0.05, 0.12, 0.05]]))
    oy, ox, side = int(H * 0.35), int(W * 0.4), H * 3 // 16
    for f in range(frames):
        mask = np.zeros((H, W), bool)
        mask[oy + f:oy + f + side, ox + f:ox + f + side] = True
        depth = np.where(mask, 1000, 1500) + rng.randint(-3, 4, (H, W))
        depth = depth.astype(np.uint16)
        depth_path = os.path.join(raw, f"{f:04d}_depth.png")
        with open(depth_path, "wb") as fh:
            fh.write(png_bytes(depth))
        rgb = np.zeros((H, W, 3), np.uint8)
        rgb[mask, 0] = 7
        with open(os.path.join(raw, f"{f:04d}_mask.png"), "wb") as fh:
            fh.write(png_bytes(rgb))
        with open(os.path.join(raw, f"{f:04d}_meta.txt"), "w") as fh:
            fh.write(f"3 6 mug_white_green_norm\n7 1 {DATA_NOCS_INSTANCE}\n")
        pts, _ = backproject_depth(torch.from_numpy(depth.astype(np.int32)),
                                   NOCS_REAL_INTRINSICS)
        obj = pts.numpy()[mask.reshape(-1)]
        center = obj.mean(0)
        np.savez(os.path.join(data, f"{f:04d}.npz"), all_dict={
            "points": obj.astype(np.float32),
            "labels": np.ones(len(obj), np.int64),
            "pose": {"rotation": np.eye(3, dtype=np.float32),
                     "translation": center.reshape(3, 1).astype(np.float32),
                     "scale": np.float32(0.25)},
            "path": depth_path})
        other = np.zeros((H, W), bool)
        other[10:60, 10:60] = True
        result = {"pred_class_ids": np.array([3, 1]),
                  "pred_bboxes": np.array([[10, 10, 59, 59],
                                           [oy + f, ox + f, oy + f + side - 1,
                                            ox + f + side - 1]], np.float32),
                  "pred_masks": np.stack([other, mask], axis=-1)}
        with open(os.path.join(root, "nocs2d",
                               f"results_test_scene_1_{f:04d}.pkl"),
                  "wb") as fh:
            pickle.dump(result, fh)


def fps_kernel(B: int, N: int) -> str:
    """The kernel a CUDA cloud batch [B, N] launches: `route`'s wrapper,
    or its cluster above one CTA."""
    from captra_tpu_torch.ops import fps
    name = fps.route(B, N)
    if name != "fps_cuda_blocked" and N > fps.single_cta_points(name):
        name += "_cluster"
    return name


def predicted_launches(cfg, B: int, image_hw=None) -> dict:
    """FPS launches a tracked step of B trajectories: sa1 and sa2 of the
    CoordNet (B clouds) and of the RotNet (B x P clouds), and with an
    image the OTF crop."""
    from collections import Counter
    P, N, n1 = cfg.obj.num_parts, cfg.num_points, cfg.pointnet.sa1.npoint
    shapes = [(B, N), (B, n1), (B * P, N), (B * P, n1)]
    if image_hw is not None:
        shapes.append((B, min(N * cfg.track.otf_work_factor,
                              image_hw[0] * image_hw[1])))
    return dict(Counter(fps_kernel(*s) for s in shapes))


def _timed_reads(sequences, clock: list):
    """`sequences` with the time of each batch's reading and collation
    added to `clock`."""
    def wrapped(cfg, mode=None):
        it = iter(sequences(cfg, mode))
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            clock.append(time.perf_counter() - t0)
            yield item
    return wrapped


def check_sapien_perturb(root: str) -> dict:
    """One SAPIEN laptop frame of the fixtures read with
    `read_cloud(perturb=True)` (depth-sensor noise and the blur of
    `data/blur.py`, draws from a RandomState of SEED): its seconds, and
    the pixels the perturbation moved more than 5 cm (relabelled), counted
    again from a twin RandomState."""
    from captra_tpu_torch.data import sapien
    path = os.path.join(root, "render_seq", "laptop",
                        DATA_SAPIEN_INSTANCES[0], "0000", "cloud", "0.npz")
    cd = np.load(path, allow_pickle=True)["all_dict"].item()
    t0 = time.perf_counter()
    pts, seg = sapien.read_cloud(cd, 4096, np.random.RandomState(SEED),
                                 num_parts=2, perturb=True)
    seconds = time.perf_counter() - t0
    depth = np.asarray(cd["depth"])
    plain, _ = sapien.opengl_depth_to_points(cd)
    pert = dict(cd, depth=sapien.perturb_depth(
        depth.astype(np.float64), depth < 1, np.random.RandomState(SEED)))
    moved, _ = sapien.opengl_depth_to_points(pert, pixel_mask=depth < 1)
    shift = np.linalg.norm(plain - moved, axis=-1)
    relabelled = int((shift > 0.05).sum())
    if pts.shape != (4096, 3) or not np.isfinite(pts).all():
        raise AssertionError(f"data sapien perturb: points {pts.shape}")
    log(f"data sapien perturb: read_cloud(perturb=True) of a "
        f"{depth.shape[0]}x{depth.shape[1]} laptop frame in {seconds:.3f} s; "
        f"{len(plain)} pixels, {relabelled} moved > 5 cm (relabelled), "
        f"median shift {float(np.median(shift)) * 1e3:.3f} mm, max "
        f"{float(shift.max()) * 1e3:.3f} mm")
    return dict(seconds=seconds, pixels=len(plain), relabelled=relabelled,
                median_shift_m=float(np.median(shift)),
                max_shift_m=float(shift.max()))


def track_from_disk(name: str, root: str, flags: list, exp: str,
                    kernels: dict, n_frames: int, want_traj: int,
                    where: str, path: str) -> tuple:
    """`cli.track.main --save` on the dataset at `root` with `flags`, from
    checkpoints of the seeded nets written under `exp` (counters zeroed
    just before, read just after: FPS launches a tracked frame as `route`
    predicts), `want_traj` trajectories of `n_frames` frames in one batch,
    one result pickle a trajectory with finite poses within POSE_TOL of
    `track_trajectory` on the same nets, batch and draws,
    `cli.evaluate.main` with IoU (err.csv with a row a tracked frame and
    every metric); the twin's FPS inputs recorded and each kernel held
    against the plain FPS on them (into `kernels`, under `where`), so a
    run with the plain FPS is this run; reader seconds a frame cold (the
    CLI's own reads) and warm (read again).  Returns (the run's numbers,
    its config)."""
    import pickle
    from captra_tpu_torch.cli import track
    from captra_tpu_torch.data.factory import make_dataset
    from captra_tpu_torch.ops import fps
    from captra_tpu_torch.tracking.tracker import (
        init_pose_from_gt, make_track_step, track_trajectory,
    )

    dev = torch.device("cuda")
    H, W = DATA_IMAGE_HW
    common = ["--basepath", root, "--experiment_dir",
              os.path.join(exp, "rot"), "--coord_exp/dir",
              os.path.join(exp, "coord"),
              *[f.replace("{root}", root) for f in flags]]
    argv = ["--save", *common]
    args, cfg = track.parse(argv)
    nets = write_checkpoints(cfg, dev, os.path.join(exp, "coord"),
                             os.path.join(exp, "rot"))
    otf = cfg.track.nocs_otf

    tracked, reads = [], []
    sequences, dataset_sequences = (track.track_sequences,
                                    track.dataset_sequences)

    def record(cfg, step, seqs, **kwargs):
        tracked.extend(seqs)
        return sequences(cfg, step, tracked, **kwargs)

    track.track_sequences = record
    track.dataset_sequences = _timed_reads(dataset_sequences, reads)
    try:
        sync(dev)
        fps.reset_launch_counts()
        text, _, main_s = _printed(track.main, argv, device=dev)
        launches = dict(fps.launch_counts)
    finally:
        track.track_sequences = sequences
        track.dataset_sequences = dataset_sequences
    for line in text.strip().splitlines():
        log(f"  | {line}")
    batches = _BATCH_LINE.findall(text)
    n_traj = sum(int(b[2]) for b in batches)
    B = int(batches[0][2])
    if (len(batches) != 1 or n_traj != want_traj
            or int(batches[0][1]) != n_frames - 1):
        raise AssertionError(f"{path} {name}: batches {batches}")
    steps = n_frames - 1 + track.WARMUP_FRAMES - 1
    per_step = predicted_launches(cfg, B, (H, W) if otf else None)
    want = {k: per_step.get(k, 0) * steps for k in launches}
    if launches != want:
        raise AssertionError(f"{path} {name}: FPS launches {launches}, "
                             f"expected {want}")
    cold_s = sum(reads) / (n_traj * n_frames)
    t0 = time.perf_counter()
    ds = make_dataset(cfg, args.mode_name)
    for i in range(len(ds)):
        ds[i]
    warm_s = (time.perf_counter() - t0) / len(ds)

    data_dir = os.path.join(exp, "rot", "results", "data")
    names, batch = tracked[0]
    names = (names,) if isinstance(names, str) else names
    files = [n.replace("/", "_") + ".pkl" for n in names]
    if sorted(os.listdir(data_dir)) != sorted(files):
        raise AssertionError(f"{path} {name}: result files "
                             f"{os.listdir(data_dir)}")
    saved = []
    for f in files:
        with open(os.path.join(data_dir, f), "rb") as fh:
            saved.append(pickle.load(fh))
    # the twin: the same nets (not through a checkpoint), the batch the CLI
    # tracked, the CLI's draws (its generator of seed 0: the init noise,
    # then the crop's shifts), `track_trajectory`
    gen = torch.Generator().manual_seed(0)
    init = init_pose_from_gt(
        batch["pose"][0], cfg, generator=gen,
        crop_translation=(batch["crop_translation"][0]
                          if "crop_translation" in batch else None),
        crop_scale=(batch["crop_scale"][0]
                    if "crop_scale" in batch else None))
    if otf:
        T_, B_, H_, W_ = batch["depth"].shape
        frames_in = {"depth": batch["depth"], "mask": batch["mask"],
                     "shift": torch.randint(0, H_ * W_, (T_, B_),
                                            generator=gen)}
        if cfg.track.nocs2d_label:
            for k in ("det_masks", "det_boxes", "det_valid"):
                frames_in[k] = batch[k]
    else:
        frames_in = {"points": batch["points"]}
    step = make_track_step(cfg, *nets, device=dev)
    calls = {}
    with recording_fps(calls):
        _, aux = track_trajectory(
            step, init, {k: v.to(dev) for k, v in frames_in.items()},
            device=dev)
    diff = check_saved_poses(f"{path} {name}", saved, aux)
    eval_s = check_evaluate(f"{path} {name} evaluate (iou)", common, dev,
                            os.path.join(exp, "rot"),
                            n_traj * (n_frames - 1), cfg.obj.num_parts, True)

    by_shape = {}
    for (n, npoint), clouds in calls.items():
        for xyz in clouds:
            by_shape.setdefault((xyz.shape[0], n, npoint), []).append(xyz)
    for (b, n, npoint), clouds in sorted(by_shape.items()):
        check_video(fps, kernels, (fps.route(b, n),), clouds, npoint, name,
                    n_frames - 1, where, path=path)
    run = dict(
        B=B, trajectories=n_traj, frames=n_frames, launches=launches,
        ms_per_step=float(batches[0][3]) * 1e3 / (n_frames - 1),
        frames_per_s=float(batches[0][4]), track_main_s=main_s,
        reader_cold_s_per_frame=cold_s, reader_warm_s_per_frame=warm_s,
        evaluate_s=eval_s, twin_max_pose_diff=diff)
    log(f"{path} {name}: B={B}, {n_traj} trajectories x {n_frames} "
        f"frames; reader {cold_s:.4f} s a frame cold (the CLI's own "
        f"reads), {warm_s:.4f} s warm (read again); CLI tracking "
        f"{run['ms_per_step']:.2f} ms a step, {run['frames_per_s']} tracked "
        f"frames/s as it prints them; main {main_s:.2f} s; FPS launches a "
        f"tracked frame {_frame_launches(launches, steps)}")
    return run, cfg


def phase_data(kernels: dict) -> dict:
    """The track CLI on the card on datasets on disk (DATA_RUNS), written
    at 480x640 in a temporary directory from SEED, each run through
    `track_from_disk`.  Then the host core's FPS of a reader's frame, and
    `otf_frame_from_depth` on one frame of the NOCS scene against the same
    call with the plain FPS."""
    from captra_tpu_torch.cli import track
    from captra_tpu_torch.data import native, preprocess
    from captra_tpu_torch.data.factory import make_dataset
    from captra_tpu_torch.pose.part_dof import Pose

    dev = torch.device("cuda")
    H, W = DATA_IMAGE_HW
    out = {"runs": {}}
    with tempfile.TemporaryDirectory(prefix="captra_data_") as tmp:
        root = os.path.join(tmp, "data")
        rng = np.random.RandomState(SEED)
        t0 = time.perf_counter()
        _, cfg = track.parse(["--basepath", root])
        frames = {"sapien": cfg.obj.num_frames, "nocs": DATA_NOCS_FRAMES}
        write_sapien(root, frames["sapien"], rng)
        write_nocs(root, frames["nocs"], rng)
        log(f"data: fixtures written in {time.perf_counter() - t0:.2f} s "
            f"under a temporary directory: SAPIEN laptop "
            f"{len(DATA_SAPIEN_INSTANCES)} tracks x {frames['sapien']} "
            f"frames, NOCS bottle 1 scene x {frames['nocs']} frames, {H}x{W}")
        for name, flags in DATA_RUNS:
            nocs = "--obj_config" in flags
            out["runs"][name], cfg = track_from_disk(
                name, root, flags, os.path.join(tmp, name), kernels,
                frames["nocs" if nocs else "sapien"],
                1 if nocs else len(DATA_SAPIEN_INSTANCES), DATA_VIDEO,
                "data")

        # the host core's FPS of one reader frame: 5 x 4096 points -> 4096
        cloud = np.random.RandomState(SEED).randn(
            5 * cfg.num_points, 3).astype(np.float32)
        host_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            native.fps(cloud, cfg.num_points)
            host_ms.append((time.perf_counter() - t0) * 1e3)
        out["host_fps_ms"] = float(np.median(host_ms))
        log(f"data: host core FPS [{len(cloud)}]->{cfg.num_points} "
            f"{out['host_fps_ms']:.1f} ms (median of 3; min "
            f"{min(host_ms):.1f}, max {max(host_ms):.1f})")

        out["sapien_perturb"] = check_sapien_perturb(root)

        # otf_frame_from_depth on frame 0 of the NOCS scene, kernels against
        # the plain FPS
        ds = make_dataset(cfg, "real_test")
        item = ds[0]
        pre, pose = item["meta"]["pre_fetched"], item["meta"]["pose"]
        depth = torch.from_numpy(pre["depth"]).to(dev)
        draw = torch.rand(depth.numel(), generator=torch.Generator()
                          .manual_seed(SEED)).to(dev)
        gt = Pose(*(torch.as_tensor(np.asarray(pose[f])).to(dev)
                    for f in ("rotation", "translation", "scale")))
        frame_args = (draw, depth, torch.from_numpy(pre["mask"]).to(dev),
                      preprocess.NOCS_REAL_INTRINSICS, gt.translation[:, 0],
                      cfg.data_radius * gt.scale, gt, cfg.num_points)
        got = preprocess.otf_frame_from_depth(*frame_args)
        with plain_fps_on_card():
            want = preprocess.otf_frame_from_depth(*frame_args)
        for k in ("points", "labels", "nocs"):
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"data otf_frame_from_depth: {k} with "
                                     "the kernels differ from the plain FPS")
        log(f"data otf_frame_from_depth: {H}x{W} frame "
            f"-> {cfg.num_points} points ({int((got['labels'] == 0).sum())} "
            "on the object), equal to the plain FPS's")
    return out


# the preproc phase: a raw NOCS release written from the seed at 480x640
# (`tests/torch_port_helpers.py::write_raw_nocs`: the bottle, the can and
# the mug, blocks of PREPROC_BLOCK pixels at about 1 m, a pixel a frame),
# a real_test scene and a mirrored CAMERA `val` folder, through
# `cli.preproc.main`, then the produced tree tracked on the card
PREPROC_FRAMES = {"real_test": ("scene_1", 30), "val": ("00000", 10)}
PREPROC_BLOCK = (90, 60)
PREPROC_CATEGORIES = "1,4,6"
PREPROC_STAGES = ("poses", "lists", "corners", "gather")
PREPROC_BARS = (0.02, 0.02, 5.0)   # scale, translation, degrees: the JAX
#                                    test's (test_preproc_pipeline.py:116)
PREPROC_RUNS = (("nocs_bottle_otf", DATA_NOCS_OBJ),)
PREPROC_VIDEO = "the preproc phase's tracked tree, ms a frame"


def _render_tree(root: str) -> dict:
    """{path under render/: its all_dict (path made relative to `root`),
    its text, or its link target}."""
    tree = {}
    base = os.path.join(root, "render")
    for d, dirs, files in os.walk(base):
        for n in dirs + files:
            full = os.path.join(d, n)
            rel = os.path.relpath(full, base)
            if os.path.islink(full):
                tree[rel] = ("link", os.readlink(full))
            elif n.endswith(".npz"):
                item = np.load(full, allow_pickle=True)["all_dict"].item()
                item["path"] = os.path.relpath(item["path"], root)
                tree[rel] = item
            elif n.endswith(".txt"):
                with open(full) as fh:
                    tree[rel] = fh.read().replace(root, "<root>")
    return tree


def _same_item(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_same_item(a[k], b[k]) for k in a))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def preproc_release(tmp: str) -> dict:
    """The host half of the preproc phase (it needs no card): the raw
    release written under `tmp`, `cli.preproc.main` a stage at a time at
    `num_proc` 1 (seconds a stage and a frame), the gates (every recovered
    pose within PREPROC_BARS of the fixture's own, the instance lists
    naming every frame, a gather at `num_proc` 4 into a second root from
    the same pose pickles equal to the first bit for bit), and the host
    core's backprojection of a frame against the numpy path's.  Returns
    the numbers and the root."""
    import pickle
    from captra_tpu_torch.cli import preproc
    from captra_tpu_torch.data import native, preproc_nocs
    helpers = port_helpers()
    root = os.path.join(tmp, "nocs")
    t0 = time.perf_counter()
    gt = {}
    for k, (dt, (track, n)) in enumerate(PREPROC_FRAMES.items()):
        gt[dt] = helpers.write_raw_nocs(root, dt, [track], n,
                                        block=PREPROC_BLOCK, seed=SEED + k)
    H, W = DATA_IMAGE_HW
    frames = sum(n for _, n in PREPROC_FRAMES.values())
    out = {"frames": frames, "write_s": time.perf_counter() - t0,
           "stage_s": {}}
    argv = ["--data_path", root, "--data_type", ",".join(PREPROC_FRAMES),
            "--categories", PREPROC_CATEGORIES]
    for stage in PREPROC_STAGES:
        text, _, out["stage_s"][stage] = _printed(
            preproc.main, [*argv, "--stages", stage, "--num_proc", "1"])
        for line in text.strip().splitlines():
            log(f"  | {line}")
    per_frame = {k: v / frames for k, v in out["stage_s"].items()}
    out["stage_s_per_frame"] = per_frame

    worst = np.zeros(3)
    for dt, frames_gt in gt.items():
        for key, poses in frames_gt.items():
            with open(os.path.join(root, "nocs_full", dt, f"{key}_pose.pkl"),
                      "rb") as fh:
                got = pickle.load(fh)
            if sorted(got) != sorted(poses):
                raise AssertionError(f"preproc {dt} {key}: poses of "
                                     f"instances {sorted(got)}")
            for n, pose in poses.items():
                err = np.array(helpers.pose_errors(got[n], pose))
                worst = np.maximum(worst, err)
                if (err >= PREPROC_BARS).any():
                    raise AssertionError(
                        f"preproc {dt} {key} instance {n}: scale, "
                        f"translation, rotation errors {err.tolist()} past "
                        f"{PREPROC_BARS}")
    out["worst_pose_error"] = dict(zip(("scale", "translation",
                                        "rotation_deg"), worst.tolist()))
    for dt, (track, n) in PREPROC_FRAMES.items():
        for _, cls, _, name in helpers.NOCS_RAW_INSTANCES:
            with open(os.path.join(root, "instance_list", dt, str(cls),
                                   f"{name}.txt")) as fh:
                listed = fh.read().split()
            if listed != [f"{track}/{f:04d}" for f in range(n)]:
                raise AssertionError(f"preproc {dt} {name}: the instance "
                                     f"list names {listed}")

    # gather again at num_proc 4 into a second root that shares the raw
    # frames, pose pickles, lists and corners
    root4 = os.path.join(tmp, "nocs4")
    os.makedirs(root4)
    for sub in ("nocs_full", "instance_list", "model_corners", "obj_models"):
        os.symlink(os.path.join(root, sub), os.path.join(root4, sub))
    text, _, out["gather4_s"] = _printed(
        preproc.main, ["--data_path", root4, *argv[2:], "--stages",
                       "gather", "--num_proc", "4"])
    tree, tree4 = _render_tree(root), _render_tree(root4)
    npz = sum(k.endswith(".npz") for k in tree)
    crops = sum(n for _, n in PREPROC_FRAMES.values()) * len(
        helpers.NOCS_RAW_INSTANCES)
    if (sorted(tree) != sorted(tree4) or npz != crops
            or not all(_same_item(tree[k], tree4[k]) for k in tree)):
        raise AssertionError(f"preproc: the gather at num_proc 4 differs "
                             f"from num_proc 1 ({npz} of {crops} crops)")
    points = [v["points"].shape[0] for k, v in tree.items()
              if k.endswith(".npz")]

    # the host core's backprojection of a frame against the numpy path
    depth = preproc_nocs.read_depth(os.path.join(
        root, "nocs_full", "real_test", "scene_1", "0000_depth.png"))
    K = preproc_nocs.REAL_INTRINSICS
    ones = np.ones_like(depth, np.uint8)
    core_ms, numpy_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        got, _ = preproc_nocs.backproject(depth, K, ones)
        core_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        want, _ = preproc_nocs.backproject(depth, K)
        numpy_ms.append((time.perf_counter() - t0) * 1e3)
    diff = float(np.abs(got - want).max())
    if got.shape != want.shape or diff > 1e-6:
        raise AssertionError(f"preproc: the core's backprojection is "
                             f"{diff} from the numpy path's")
    out.update(backproject_core_ms=float(np.median(core_ms)),
               backproject_numpy_ms=float(np.median(numpy_ms)),
               backproject_max_diff=diff, crops=npz,
               crop_points_median=float(np.median(points)))
    log(f"preproc: raw release of {frames} frames ({H}x{W}; real_test "
        f"{PREPROC_FRAMES['real_test'][1]}, CAMERA val "
        f"{PREPROC_FRAMES['val'][1]}; 3 instances a frame) written in "
        f"{out['write_s']:.2f} s; stages at num_proc 1 "
        + ", ".join(f"{k} {v:.2f} s ({per_frame[k]:.4f} s a frame)"
                    for k, v in out["stage_s"].items())
        + f"; gather at num_proc 4 {out['gather4_s']:.2f} s, its {npz} "
        f"crops equal to num_proc 1's (median {np.median(points):.0f} "
        f"points); worst pose error {out['worst_pose_error']} (bars "
        f"{PREPROC_BARS}); host core backprojection "
        f"{out['backproject_core_ms']:.2f} ms a frame, numpy path "
        f"{out['backproject_numpy_ms']:.2f} ms (max |diff| {diff:.2e} m); "
        f"host: {os.cpu_count()} cores")
    return out, root


def phase_preproc(kernels: dict) -> dict:
    """The offline preprocessing path on the card's machine, then the
    produced tree tracked on the card: `preproc_release`, then each run of
    PREPROC_RUNS through `track_from_disk` on the tree (its FPS launches
    as predicted, poses within POSE_TOL of the twin, the kernels equal to
    the plain FPS on the run's inputs, into `kernels`)."""
    with tempfile.TemporaryDirectory(prefix="captra_preproc_") as tmp:
        out, root = preproc_release(tmp)
        track, frames = PREPROC_FRAMES["real_test"]
        out["runs"] = {}
        for name, flags in PREPROC_RUNS:
            out["runs"][name], _ = track_from_disk(
                name, root, flags, os.path.join(tmp, name), kernels, frames,
                1, PREPROC_VIDEO, "preproc")
    return out


# the train phase: (name, training config, `get_config` overrides) at the
# configs' full width (SAPIEN laptop, batch 12, 4096 points,
# pointnet2_camera); the bottle is the NOCS bottle (symmetric: the pairwise
# NOCS loss and the 2D fit), and the bf16 run the JAX bench's dtype
TRAIN_RUNS = (
    ("coord_laptop", "config_coordnet.yml", {}),
    ("rot_laptop", "config_rotnet.yml", {}),
    ("coord_bottle", "config_coordnet.yml",
     {"obj_config": "obj_info_nocs.yml", "obj_category": "1"}),
    ("coord_laptop_bf16", "config_coordnet.yml",
     {"network/compute_dtype": "bfloat16"}),
)
TRAIN_STEPS = 30            # timed steps a run, after the warm-up
TRAIN_WARMUP = 2
TRAIN_WHERE = "a train step's FPS inputs, ms a step"
TRAIN_CLI_BATCH = 4         # sa1 -> fps_cuda_wide [4,4096]->512
TRAIN_CLI_STEPS = 3         # synthetic steps an epoch of the CLI runs
TRAIN_CLI_WHERE = "the train CLI's FPS inputs (B=4), ms a step"
FINETUNE_FRAMES = {"train": 8, "real_train": 8, "real_test": 4}


def train_launches(cfg, B: int) -> dict:
    """FPS launches a train step: sa1 and sa2 of the trained net, on B
    clouds (CoordNet) or B x P (RotNet)."""
    from collections import Counter
    clouds = B * (cfg.obj.num_parts if cfg.network.type == "rot" else 1)
    return dict(Counter(fps_kernel(clouds, n) for n in
                        (cfg.num_points, cfg.pointnet.sa1.npoint)))


def _host_syncs(fn) -> list:
    """The host synchronisations `fn()` makes, as CUDA's sync debug mode
    reports them (one message each)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]


def steps_equal(a, b) -> bool:
    """Two train states after a step hold the same gradients and running
    statistics, bit for bit (the flat gradient buffer, every float
    buffer)."""
    return torch.equal(a.grads, b.grads) and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(
            a.module.named_buffers(), b.module.named_buffers())
        if x.is_floating_point())


@contextlib.contextmanager
def deterministic_algorithms(alerts: set):
    """torch's deterministic algorithms for the comparison steps (the
    gather's backward then adds in a fixed order); an op without one only
    warns, and the warnings' first lines are added to `alerts`."""
    import warnings
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(False)
    alerts.update(str(w.message).splitlines()[0] for w in caught)


def compare_train_step(trainer, state, batch, draws, name):
    """One step of `state` with the kernels and of a copy with the plain
    FPS on the card, the same batch and draws, under torch's deterministic
    algorithms: both take the same FPS indices, so the losses, the
    gradients and the running statistics are equal bit for bit.  Returns
    the kernels' recorded FPS inputs and the ops torch reported without a
    deterministic version."""
    plain = trainer.copy_state(state)
    calls, alerts = {}, set()
    with deterministic_algorithms(alerts):
        with recording_fps(calls):
            _, got, _ = trainer.train_step(state, batch, draws=draws)
        with plain_fps_on_card():
            _, want, _ = trainer.train_step(plain, batch, draws=draws)
    equal = sorted(got) == sorted(want) and all(
        torch.equal(got[k], v) for k, v in want.items()) and steps_equal(
        state, plain)
    log(f"train {name}: the step with the kernels against the plain FPS: "
        f"losses, gradients and running statistics "
        f"{'equal' if equal else 'DIFFER'}; without a deterministic "
        f"version: {sorted(alerts) or 'none'}")
    if not equal:
        raise AssertionError(f"train {name}: the kernels' step differs from "
                             "the plain FPS's")
    return calls, sorted(alerts)


def train_run(name: str, config: str, overrides: dict, dev, kernels: dict
              ) -> dict:
    """One TRAIN_RUNS run on a fixed batch from SEED: the kernels' step
    against the plain FPS's, the kernels held on its FPS inputs, a warm-up,
    then TRAIN_STEPS timed steps (counters zeroed just before, read just
    after; a sync after each step)."""
    from captra_tpu_torch.config import get_config
    from captra_tpu_torch.data.synthetic import make_frame_batch
    from captra_tpu_torch.ops import fps
    from captra_tpu_torch.training.trainer import Trainer, to_device
    cfg = get_config(config, overrides)
    B = cfg.batch_size
    trainer = Trainer(cfg, steps_per_epoch=50, device=dev)
    state = trainer.init_state(
        generator=torch.Generator().manual_seed(SEED))
    batch = to_device(make_frame_batch(SEED, cfg.obj, batch=B,
                                       num_points=cfg.num_points), dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    dtype = cfg.network.compute_dtype
    calls, alerts = compare_train_step(trainer, state, batch,
                                       trainer.draw(batch, gen), name)
    for (n, npoint), clouds in sorted(calls.items()):
        check_video(fps, kernels, (fps.route(clouds[0].shape[0], n),),
                    clouds, npoint, name, 1, TRAIN_WHERE, path="train",
                    unit="step")
    for _ in range(TRAIN_WARMUP):
        trainer.train_step(state, batch, generator=gen)
    sync(dev)
    sync_msgs = _host_syncs(lambda: trainer.train_step(state, batch,
                                                       generator=gen))
    syncs = len(sync_msgs)
    for msg in sorted(set(sync_msgs)):
        log(f"train {name}: host sync in a step: {msg}")
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fps.reset_launch_counts()
    steps_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        _, loss, _ = trainer.train_step(state, batch, generator=gen)
        sync(dev)
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss["total_loss"])
    launches = dict(fps.launch_counts)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {k: v * TRAIN_STEPS for k, v in train_launches(cfg, B).items()}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"train {name}: FPS launches {launches}, "
                             f"expected {want}")
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"train {name}: non-finite losses {losses}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"train {name}: the loss did not fall on the "
                             f"fixed batch ({first} -> {last})")
    ms = float(np.median(steps_ms))
    run = dict(config=config, overrides=overrides, B=B, dtype=dtype,
               clouds=B * (cfg.obj.num_parts if cfg.network.type == "rot"
                           else 1),
               ms_per_step=ms, ms_per_step_min=min(steps_ms),
               ms_per_step_max=max(steps_ms), samples_per_s=B * 1e3 / ms,
               peak_bytes=peak, launches=launches,
               launches_per_step={k: v / TRAIN_STEPS
                                  for k, v in launches.items() if v},
               host_syncs_per_step=syncs, loss_first=losses[0],
               loss_last=losses[-1], loss_first5=float(first),
               loss_last5=float(last), plain_fps_equal=True,
               nondeterministic_ops=alerts)
    log(f"train {name}: {cfg.obj.name} {cfg.network.type} {dtype}, B={B} "
        f"({run['clouds']} clouds) x {cfg.num_points} points: {ms:.2f} ms a "
        f"step (median of {TRAIN_STEPS}; min {min(steps_ms):.2f}, max "
        f"{max(steps_ms):.2f}), {run['samples_per_s']:.1f} samples/s, peak "
        f"{peak / 2**30:.2f} GiB, FPS launches a step "
        f"{run['launches_per_step']}, {syncs} host syncs a step; total loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f})")
    return run


def write_nocs_splits(root: str, rng) -> None:
    """NOCS bottle frames of the splits of FINETUNE_FRAMES (one track each,
    `render/<split>/1/<instance>/0000/data/*.npz`): 5000 points a frame,
    3/4 on the instance's box posed at a random rotation and scale, the
    rest background, and the model corners."""
    os.makedirs(os.path.join(root, "model_corners"), exist_ok=True)
    np.save(os.path.join(root, "model_corners",
                         f"{DATA_NOCS_INSTANCE}.npy"),
            np.array([[-0.05, -0.12, -0.05], [0.05, 0.12, 0.05]]))
    for split, frames in FINETUNE_FRAMES.items():
        data = os.path.join(root, "render", split, "1", DATA_NOCS_INSTANCE,
                            "0000", "data")
        os.makedirs(data, exist_ok=True)
        for f in range(frames):
            R = np.linalg.qr(rng.randn(3, 3))[0]
            R[:, 0] *= np.sign(np.linalg.det(R))
            t = rng.randn(3, 1) * 0.05 + np.array([[0.0], [0.0], [0.8]])
            s = rng.uniform(0.2, 0.3)
            npcs = (rng.rand(5000, 3) - 0.5) * np.array([0.1, 0.24, 0.1])
            seg = (rng.rand(5000) < 0.75).astype(np.int64)
            pts = np.where(seg[:, None] == 1, s * (npcs @ R.T) + t.T,
                           rng.randn(5000, 3) * 0.2 + t.T)
            np.savez(os.path.join(data, f"{f:04d}.npz"), all_dict={
                "points": pts.astype(np.float32), "labels": seg,
                "pose": {"rotation": R.astype(np.float32),
                         "translation": t.astype(np.float32),
                         "scale": np.float32(s)},
                "path": ""})


def phase_train(kernels: dict) -> dict:
    """Training on the card: the runs of TRAIN_RUNS (`train_run`), then the
    CLIs as a user runs them: `cli.train.main --synthetic_data` at batch
    TRAIN_CLI_BATCH for the CoordNet (one epoch, then a resume for a second)
    and the RotNet (one epoch), `cli.track.main` from the two trained
    experiments, and `cli.finetune.main` for one epoch on NOCS fixtures
    written from SEED; counters zeroed around each CLI run."""
    from captra_tpu_torch.cli import finetune as finetune_cli
    from captra_tpu_torch.cli import track as track_cli
    from captra_tpu_torch.cli import train as train_cli
    from captra_tpu_torch.config import get_config
    from captra_tpu_torch.ops import fps
    from captra_tpu_torch.training import checkpoint

    dev = torch.device("cuda")
    out = {"runs": {}, "cli": {}}
    if not _host_syncs(lambda: torch.ones(1, device=dev).sum().item()):
        raise AssertionError("CUDA's sync debug mode reported no sync for "
                             "an .item(): the host-sync count would read 0")
    for name, config, overrides in TRAIN_RUNS:
        out["runs"][name] = train_run(name, config, overrides, dev, kernels)
        torch.cuda.empty_cache()

    def short_epoch(cfg, epoch, steps=50):
        return iter([train_cli.make_frame_batch(
            epoch * TRAIN_CLI_STEPS + i, cfg.obj, batch=cfg.batch_size,
            num_points=cfg.num_points) for i in range(TRAIN_CLI_STEPS)])

    routed = train_cli.synthetic_epoch
    train_cli.synthetic_epoch = short_epoch
    cli_calls = {}
    try:
        with tempfile.TemporaryDirectory(prefix="captra_train_") as tmp:
            coord, rot = (os.path.join(tmp, n) for n in ("coord", "rot"))
            common = ["--synthetic_data", "--batch_size",
                      str(TRAIN_CLI_BATCH)]
            plan = (("coord_epoch0", coord, "config_coordnet.yml", 1),
                    ("coord_resume", coord, "config_coordnet.yml", 2),
                    ("rot_epoch0", rot, "config_rotnet.yml", 1))
            for label, exp, config, epochs in plan:
                argv = ["--config", config, "--experiment_dir", exp,
                        "--total_epoch", str(epochs), *common]
                cfg = get_config(config, {"batch_size": TRAIN_CLI_BATCH})
                sync(dev)
                fps.reset_launch_counts()
                with recording_fps(cli_calls if label == "coord_epoch0"
                                   else {}):
                    text, state, seconds = _printed(train_cli.main, argv,
                                                    device=dev)
                sync(dev)
                launches = {k: v for k, v in fps.launch_counts.items() if v}
                want = {k: v * TRAIN_CLI_STEPS for k, v in
                        train_launches(cfg, TRAIN_CLI_BATCH).items()}
                if launches != want or state.step != epochs * \
                        TRAIN_CLI_STEPS:
                    raise AssertionError(f"train cli {label}: launches "
                                         f"{launches} (expected {want}), "
                                         f"step {state.step}")
                log_text = open(os.path.join(exp, "log", "log.txt")).read()
                epoch = epochs - 1
                total = float(log_text.split(
                    f"Train epoch {epoch} total_loss is ")[1].split()[0])
                if not np.isfinite(total) or (label == "coord_resume" and
                                              "resumed from" not in log_text):
                    raise AssertionError(f"train cli {label}: {log_text}")
                payload = checkpoint.load_checkpoint(os.path.join(
                    exp, "ckpt", f"model_{epoch:04d}"))
                out["cli"][label] = dict(seconds=seconds, launches=launches,
                                         step=payload["step"],
                                         total_loss=total)
                log(f"train cli {label}: {config} --batch_size "
                    f"{TRAIN_CLI_BATCH}, {TRAIN_CLI_STEPS} steps an epoch, "
                    f"epoch {epoch} total_loss {total:.4f}, checkpoint "
                    f"step {payload['step']}, FPS launches {launches}, "
                    f"{seconds:.2f} s")
            for (n, npoint), clouds in sorted(cli_calls.items()):
                check_video(fps, kernels, (fps.route(clouds[0].shape[0], n),),
                            clouds, npoint, "cli coord_epoch0",
                            TRAIN_CLI_STEPS, TRAIN_CLI_WHERE, path="train",
                            unit="step")
            track_argv = ["--experiment_dir", rot, "--coord_exp/dir", coord,
                          "--synthetic_data", "--save"]
            sync(dev)
            fps.reset_launch_counts()
            text, avgs, seconds = _printed(track_cli.main, track_argv,
                                           device=dev)
            launches = {k: v for k, v in fps.launch_counts.items() if v}
            tcfg = track_cli.parse(track_argv)[1]
            want = {}
            for _, frames, b, _, _ in _BATCH_LINE.findall(text):
                steps = int(frames) + track_cli.WARMUP_FRAMES - 1
                for k, v in predicted_launches(tcfg, int(b)).items():
                    want[k] = want.get(k, 0) + v * steps
            files = os.listdir(os.path.join(rot, "results", "data"))
            if len(files) != CLI_TRAJECTORIES or not all(
                    np.isfinite(v).all() for v in avgs.values()):
                raise AssertionError(f"train cli track: {text}")
            if not want or launches != want:
                raise AssertionError(f"train cli track: FPS launches "
                                     f"{launches}, expected {want}")
            out["cli"]["track"] = dict(seconds=seconds, launches=launches,
                                       avg={k: float(np.mean(v))
                                            for k, v in avgs.items()})
            log(f"train cli track: the trained CoordNet and RotNet, "
                f"{len(files)} result pickles, {seconds:.2f} s, FPS "
                f"launches {launches}; "
                + next(ln for ln in text.splitlines()
                       if ln.startswith("AVG: ")))

            root = os.path.join(tmp, "nocs")
            write_nocs_splits(root, np.random.RandomState(SEED))
            exp = os.path.join(tmp, "finetune")
            sync(dev)
            fps.reset_launch_counts()
            text, state, seconds = _printed(finetune_cli.main, [
                "--config", "config_coordnet.yml", "--experiment_dir", exp,
                "--obj_config", "obj_info_nocs.yml", "--obj_category", "1",
                "--basepath", root, "--batch_size",
                str(TRAIN_CLI_BATCH), "--total_epoch", "1"], device=dev)
            launches = {k: v for k, v in fps.launch_counts.items() if v}
            log_text = open(os.path.join(exp, "log", "log.txt")).read()
            want_steps = 2 * FINETUNE_FRAMES["real_train"] // TRAIN_CLI_BATCH
            # the train steps and the real_test evaluation's steps
            evals = FINETUNE_FRAMES["real_test"] // TRAIN_CLI_BATCH
            want = {k: v * (want_steps + evals) for k, v in train_launches(
                get_config("config_coordnet.yml",
                           {"batch_size": TRAIN_CLI_BATCH}),
                TRAIN_CLI_BATCH).items()}
            if state.step != want_steps or not all(
                    f"{tag} epoch 0 total_loss is " in log_text
                    for tag in ("Syn_Train", "Real_Train", "Test")):
                raise AssertionError(f"train cli finetune: step "
                                     f"{state.step}, log {log_text}")
            if launches != want:
                raise AssertionError(f"train cli finetune: FPS launches "
                                     f"{launches}, expected {want}")
            out["cli"]["finetune"] = dict(seconds=seconds, step=state.step,
                                          launches=launches)
            log(f"train cli finetune: NOCS bottle, {state.step} steps "
                f"(synthetic and real) and the real_test evaluation in "
                f"{seconds:.2f} s, FPS launches {launches}")
    finally:
        train_cli.synthetic_epoch = routed
    return out


# the rollout phase: `cli.rollout_finetune.main` at the JAX script's
# defaults (NOCS bottle, 4096 points, `pointnet2_camera`, bfloat16, GN,
# traj_batch 16, 20 frames, minibatch 12, a pool of 512 geometries) for
# ROLLOUT_ROUNDS rounds (the script's default is 100), evaluated at round 0
# and the last
ROLLOUT_ROUNDS = 2
ROLLOUT_WHERE = "a fine-tune round's FPS inputs, ms a round"


def rollout_launches(cfg_track, cfgs: dict, args) -> tuple[dict, dict]:
    """(FPS launches of a fine-tune round, of an evaluation of the
    held-out set) as `route` predicts them: each tracked frame of
    traj_batch trajectories (`predicted_launches`), then each minibatch's
    and plain step's train step of each trained net (`train_launches`)."""
    from collections import Counter
    n_mb = (args.frames - 1) * args.traj_batch // args.minibatch
    nets = ("rot",) if args.freeze_coord else ("canon_coord", "rot")
    per_round = Counter()
    for k, v in predicted_launches(cfg_track, args.traj_batch).items():
        per_round[k] += v * (args.frames - 1)
    for net in nets:
        for k, v in train_launches(cfgs[net], args.minibatch).items():
            per_round[k] += v * (n_mb + args.plain_steps)
    per_eval = {k: v * (args.eval_frames - 1) for k, v in
                predicted_launches(cfg_track, args.eval_trajs).items()}
    return dict(per_round), per_eval


def rollout_states_equal(a: dict, b: dict) -> bool:
    """Two runs' train states hold the same parameters, statistics and
    optimizer moments and steps, bit for bit."""
    for net in a:
        x, y = a[net], b[net]
        if x.step != y.step or not torch.equal(x.params, y.params):
            return False
        for k, v in x.opt_state.items():
            if torch.is_tensor(v) and not torch.equal(v, y.opt_state[k]):
                return False
        if not all(torch.equal(p, q) for (_, p), (_, q) in zip(
                x.module.named_buffers(), y.module.named_buffers())
                if p.is_floating_point()):
            return False
    return True


def phase_rollout(kernels: dict, profile: str | None = None) -> dict:
    """On-policy rollout fine-tuning on the card: the seeded nets written
    as JAX-layout pickle checkpoints, then (1) round 1 of
    `cli.rollout_finetune.setup`'s round from the states and, from copies,
    with the plain FPS on the card, under torch's deterministic algorithms
    and on the same draws: logs, parameters, statistics and moments equal
    bit for bit, FPS launches as `route` predicts (counters zeroed just
    before, read just after), the kernels held on the round's recorded
    inputs; (2) the host syncs of a round (CUDA's sync debug mode); (3) a
    timed round (the rollout's tracking timed apart), its peak memory;
    (4) `cli.rollout_finetune.main` for ROLLOUT_ROUNDS rounds, evaluated
    at round 0 and the last: launches as predicted, finite logs,
    EVIDENCE.json with both points, the round checkpoints loaded back.
    With `profile` a profiler window over round 3."""
    from captra_tpu_torch.cli import rollout_finetune as rcli
    from captra_tpu_torch.ops import fps
    from captra_tpu_torch.training import checkpoint
    from captra_tpu_torch.training import rollout
    from captra_tpu_torch.training.trainer import Trainer

    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory(prefix="captra_rollout_") as tmp:
        paths = {n: os.path.join(tmp, n, "ckpt", "model_0000")
                 for n in ("coord", "rot")}
        argv = ["--coord", paths["coord"], "--rot", paths["rot"], "--out",
                os.path.join(tmp, "out"), "--rounds", str(ROLLOUT_ROUNDS),
                "--eval_at", str(ROLLOUT_ROUNDS)]
        args = rcli.parse(argv)
        cfg_track, cfgs = rcli.configs(args)
        write_checkpoints(cfg_track, dev, os.path.dirname(os.path.dirname(
            paths["coord"])), os.path.dirname(os.path.dirname(paths["rot"])))
        per_round, per_eval = rollout_launches(cfg_track, cfgs, args)
        n_mb = (args.frames - 1) * args.traj_batch // args.minibatch
        steps = n_mb + args.plain_steps
        log(f"rollout: {cfg_track.obj.name}, {cfg_track.num_points} points, "
            f"{args.dtype} {args.norm}, traj_batch {args.traj_batch} x "
            f"{args.frames} frames, {n_mb} minibatches of {args.minibatch} "
            f"+ {args.plain_steps} plain steps a round, pool "
            f"{args.geom_pool}; FPS launches predicted a round {per_round}, "
            f"an evaluation {per_eval}")

        t0 = time.perf_counter()
        run = rcli.setup(args, dev)
        sync(dev)
        setup_s = time.perf_counter() - t0
        round_fn, trainers, states = (run["round_fn"], run["trainers"],
                                      run["states"])
        nets = ("canon_coord", "rot")
        twins = {n: trainers[n].copy_state(states[n]) for n in nets}
        draws = round_fn.draw(rcli.round_generator(dev, 1))
        calls, alerts = {}, set()
        with deterministic_algorithms(alerts):
            sync(dev)
            fps.reset_launch_counts()
            with recording_fps(calls):
                _, _, logs = round_fn(states["canon_coord"], states["rot"],
                                      draws=draws)
            sync(dev)
            launches = {k: v for k, v in fps.launch_counts.items() if v}
            with plain_fps_on_card():
                _, _, plain = round_fn(twins["canon_coord"], twins["rot"],
                                       draws=draws)
        equal = (sorted(logs) == sorted(plain) and all(
            torch.equal(logs[k], v) for k, v in plain.items())
            and rollout_states_equal(states, twins))
        log(f"rollout round 1 with the kernels against the plain FPS "
            f"(deterministic algorithms, the same draws): logs, parameters, "
            f"statistics and moments {'equal' if equal else 'DIFFER'}; "
            f"without a deterministic version: {sorted(alerts) or 'none'}")
        if not equal:
            raise AssertionError("rollout: round 1 with the kernels differs "
                                 "from the plain FPS's")
        if launches != per_round:
            raise AssertionError(f"rollout: FPS launches a round {launches}, "
                                 f"expected {per_round}")
        logs = {k: float(v) for k, v in logs.items()}
        if not np.isfinite(list(logs.values())).all():
            raise AssertionError(f"rollout: non-finite logs {logs}")
        del twins
        by_shape = {}
        for (n, npoint), clouds in calls.items():
            for xyz in clouds:
                by_shape.setdefault((xyz.shape[0], n, npoint),
                                    []).append(xyz)
        for (b, n, npoint), clouds in sorted(by_shape.items()):
            check_video(fps, kernels, (fps.route(b, n),), clouds, npoint,
                        "round 1", 1, ROLLOUT_WHERE, path="rollout",
                        unit="round")
        del calls, by_shape
        torch.cuda.empty_cache()

        def one_round(r):
            return round_fn(states["canon_coord"], states["rot"],
                            generator=rcli.round_generator(dev, r))

        # round 2: wall clock between two syncs, its host syncs, and the
        # rollout's span on the card between two CUDA events (which
        # synchronise nothing)
        spans = []
        collect = rollout.collect_states

        def timed_collect(*a, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            res = collect(*a, **kw)
            end.record()
            spans.append((start, end))
            return res

        sync(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        rollout.collect_states = timed_collect
        try:
            t = time.perf_counter()
            syncs = _host_syncs(lambda: one_round(2))
            sync(dev)
            round_ms = (time.perf_counter() - t) * 1e3
        finally:
            rollout.collect_states = collect
        peak = torch.cuda.max_memory_allocated(dev)
        rollout_ms = [a.elapsed_time(b) for a, b in spans]
        for msg in sorted(set(syncs)):
            log(f"rollout: host sync in a round: {msg}")
        prof = None
        if profile:
            with module_spans([states[n].module for n in nets]):
                prof = profile_window(lambda: one_round(3), 1,
                                      args.traj_batch, profile,
                                      tag="rollout_round")
        step_ms = (round_ms - rollout_ms[0]) / (2 * steps)
        log(f"rollout: a round {round_ms / 1e3:.3f} s: the rollout "
            f"({args.frames - 1} tracked steps of {args.traj_batch}; its "
            f"span on the card) "
            f"{rollout_ms[0]:.1f} ms ({rollout_ms[0] / (args.frames - 1):.2f}"
            f" ms a step), the rest {round_ms - rollout_ms[0]:.1f} ms over "
            f"{2 * steps} train steps ({step_ms:.2f} ms a step, trajectory "
            f"synthesis and harvest included); {len(syncs)} host syncs a "
            f"round; peak {peak / 2**30:.2f} GiB; round 1 logs {logs}; on "
            f"{card_name_and_limit()}")
        del run, states, trainers, round_fn
        torch.cuda.empty_cache()

        sync(dev)
        fps.reset_launch_counts()
        text, report, main_s = _printed(rcli.main, argv, device=dev)
        main_launches = {k: v for k, v in fps.launch_counts.items() if v}
        for line in text.strip().splitlines():
            log(f"  | {line}")
        want = {k: ROLLOUT_ROUNDS * per_round.get(k, 0)
                + 2 * per_eval.get(k, 0)
                for k in set(per_round) | set(per_eval)}
        if main_launches != want:
            raise AssertionError(f"rollout main: FPS launches "
                                 f"{main_launches}, expected {want}")
        printed = [dict((k, float(v)) for k, v in re.findall(
            r"(\w+)=([-0-9.naif]+)", ln)) for ln in text.splitlines()
            if ln.startswith("round ")]
        with open(os.path.join(args.out, "EVIDENCE.json")) as fh:
            evidence = json.load(fh)
        if (not printed or not all(np.isfinite(list(p.values())).all()
                                   for p in printed)
                or sorted(evidence["trend"]) != ["0", str(ROLLOUT_ROUNDS)]
                or evidence != json.loads(json.dumps(report))):
            raise AssertionError(f"rollout main: logs {printed}, trend "
                                 f"{sorted(evidence['trend'])}")
        for point in evidence["trend"].values():
            if not np.isfinite(list(point["full"].values())).all():
                raise AssertionError(f"rollout main: evaluation {point}")
        loaded = {}
        for n in nets:
            payload = checkpoint.load_checkpoint(os.path.join(
                args.out, f"round_{ROLLOUT_ROUNDS}", n, "ckpt",
                "model_0000"))
            state = checkpoint.restore_state(payload, Trainer(
                cfgs[n], device=dev).init_state(
                    generator=torch.Generator().manual_seed(SEED)))
            loaded[n] = state.step
        if loaded != {n: ROLLOUT_ROUNDS * steps for n in nets}:
            raise AssertionError(f"rollout main: checkpoint steps {loaded}")
        out = dict(
            rounds=ROLLOUT_ROUNDS, traj_batch=args.traj_batch,
            frames=args.frames, minibatch=args.minibatch,
            dtype=args.dtype, norm=args.norm, setup_s=setup_s,
            round_s=round_ms / 1e3, rollout_ms=rollout_ms[0],
            rollout_ms_per_step=rollout_ms[0] / (args.frames - 1),
            train_ms_per_step=step_ms, host_syncs_per_round=len(syncs),
            host_syncs=sorted(set(syncs)), peak_bytes=peak,
            launches_per_round=per_round, launches_per_eval=per_eval,
            launches=launches, main_launches=main_launches,
            main_s=main_s, round1_logs=logs, plain_fps_equal=True,
            nondeterministic_ops=sorted(alerts),
            eval={k: v["full"] for k, v in evidence["trend"].items()},
            checkpoint_steps=loaded, profile=prof)
        log(f"rollout main: {ROLLOUT_ROUNDS} rounds and 2 evaluations in "
            f"{main_s:.2f} s, FPS launches {main_launches}; evaluation "
            f"(full) at round 0 {evidence['trend']['0']['full']}, at round "
            f"{ROLLOUT_ROUNDS} {evidence['trend'][str(ROLLOUT_ROUNDS)]['full']}"
            f"; checkpoints of round {ROLLOUT_ROUNDS} loaded back at steps "
            f"{loaded}; on {card_name_and_limit()}")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="add a torch.profiler window at each B and "
                             "OTF run and over a fine-tune round, and write "
                             "its tables into DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    t0 = time.perf_counter()
    seconds = {}

    def lap(phase):
        seconds[phase] = time.perf_counter() - t0 - sum(seconds.values())
        log(f"phase {phase}: {seconds[phase]:.1f} s")

    phase_device()
    lap("device")
    kernels = phase_kernels()
    lap("kernels")
    sliced = phase_slice(profile=args.profile)
    check_launches(sliced)
    lap("slice")
    otf = phase_otf(profile=args.profile, kernels=kernels, frames=OTF_T)
    check_otf_launches(otf, OTF_T)
    lap("otf")
    init = phase_init_search(profile=args.profile, kernels=kernels)
    lap("init_search")
    cli = phase_cli(kernels=kernels)
    lap("cli")
    data = phase_data(kernels=kernels)
    lap("data")
    pre = phase_preproc(kernels=kernels)
    lap("preproc")
    train = phase_train(kernels=kernels)
    lap("train")
    roll = phase_rollout(kernels=kernels, profile=args.profile)
    lap("rollout")

    line = []
    for name, cases in kernels.items():
        B, N, npoint, where = HEADLINE[name]
        head = next(c for c in cases if (c["B"], c["N"], c["npoint"],
                                         c["where"]) == (B, N, npoint, where))
        by_path = {**{f"slice_{r}": v["launches"][name]
                      for r, v in sliced["runs"].items()},
                   **{f"otf_{r}": v["launches"][name]
                      for r, v in otf["runs"].items()},
                   **{f"init_{r}": v["launches"][name]
                      for r, v in init.items()},
                   **{f"cli_{r}": v["launches"][name]
                      for r, v in cli.items()},
                   **{f"data_{r}": v["launches"][name]
                      for r, v in data["runs"].items()},
                   **{f"preproc_{r}": v["launches"][name]
                      for r, v in pre["runs"].items()},
                   **{f"train_{r}": v["launches"].get(name, 0)
                      for r, v in train["runs"].items()},
                   **{f"train_cli_{r}": v["launches"].get(name, 0)
                      for r, v in train["cli"].items()},
                   "rollout_round1": roll["launches"].get(name, 0),
                   "rollout_main": roll["main_launches"].get(name, 0)}
        line.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
            "at": f"[{B},{N}]->{npoint}, {where}",
            "launches_by_path": by_path,
            "shapes": cases,
        })
    log(json.dumps({"slice": sliced}))
    log(json.dumps({"otf": otf}))
    log(json.dumps({"init_search": init}))
    log(json.dumps({"cli": cli}))
    log(json.dumps({"data": data}))
    log(json.dumps({"preproc": pre}))
    log(json.dumps({"train": train}))
    log(json.dumps({"rollout": roll}))
    log(json.dumps({"seconds": seconds}))
    log(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
