"""The CUDA FPS kernels on the card, against the plain PyTorch FPS.

These tests need an NVIDIA card and the CUDA toolkit: the kernels have no
CPU mode, so without a card each test skips with that reason.  This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -o addopts="" -q
"""
import os

import fps_edge_clouds
import numpy as np
import pytest
import torch

from captra_tpu_torch import ops
from captra_tpu_torch.ops import fps

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the FPS kernels have no CPU mode")
    return torch.device("cuda")


def _cloud(seed, B, N, device):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(B, N, 3).astype(np.float32)).to(device)


def _wrap_distinct(N):
    """Distinct points of a wrap-fill cloud of N points: fewer than the
    picks the tests ask of it, so every minimum reaches 0 before the end."""
    return min(300, N // 8)


def _tie_cloud(kind, B, N, seed, device):
    """Exact distance ties: a shuffled integer grid, a cloud repeated three
    times (cut to N points), a wrap-fill cloud (`_wrap_distinct(N)` distinct
    points, then copies of its point 7, as the OTF crop makes) or an
    all-equal cloud."""
    rng = np.random.RandomState(seed)
    if kind in ("wrap", "equal"):
        clouds = np.repeat(rng.randn(B, 1, 3).astype(np.float32), N, axis=1)
        if kind == "wrap":
            d = _wrap_distinct(N)
            clouds[:, :d] = rng.randn(B, d, 3)
            clouds[:, d:] = clouds[:, 7:8]
    elif kind == "grid":
        side = int(np.ceil(N ** (1 / 3)))
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
        g = g.reshape(-1, 3).astype(np.float32) * 0.1
        clouds = [g[rng.permutation(len(g))[:N]] for _ in range(B)]
    else:
        base = rng.randn(B, -(-N // 3), 3).astype(np.float32)
        clouds = np.concatenate([base, base, base], axis=1)[:, :N]
    return torch.from_numpy(np.ascontiguousarray(np.stack(clouds))).to(device)


# every items threshold of the single-CTA policy (fps.cu: one warp per cloud
# up to 512 points, at 1, 2, 4, 8 or 16 points a lane; 512-thread CTAs at
# 2, 4, 5, 8, 12 or 16 points a thread up to 8192; 1024-thread CTAs at 12 or
# 16 above), and one point past it
_BATCHED_THRESHOLDS = (32, 64, 128, 256, 512, 1024, 2048, 2560, 4096, 6144)
_WIDE_THRESHOLDS = (8192, 12288)


@pytest.mark.parametrize("name,B,N,npoint", [
    ("fps_cuda_batched", 9, 700, 40),      # one partly filled thread
    *[("fps_cuda_batched", 3, n + d, min(64, n)) for n in _BATCHED_THRESHOLDS
      for d in (0, 1)],
    *[("fps_cuda_wide", 2, n + d, 64) for n in _WIDE_THRESHOLDS
      for d in (0, 1)],
    ("fps_cuda_batched", 9, 512, 128),     # the last CTA of warps part full
    ("fps_cuda_batched", 13, 512, 128),
    ("fps_cuda_batched", 3, 512, 128),     # fewer clouds than a CTA's warps
    ("fps_cuda_batched", 128, 512, 64),    # the grouped strata of B=16
    ("fps_cuda_batched", 2, 512, 1),       # one pick
    ("fps_cuda_wide", 1, 4096, 1),
    ("fps_cuda_batched", 3, 64, 64),       # every point
    ("fps_cuda_batched", 2, 700, 700),
    ("fps_cuda_wide", 1, 4096, 512),       # sa1 at B=1
    ("fps_cuda_wide", 4, 4096, 512),       # sa1 of the track CLI at B=4
    ("fps_cuda_batched", 16, 4096, 512),   # sa1 at B=16
    ("fps_cuda_batched", 8, 8192, 64),     # the batched kernel's one-CTA bound
    ("fps_cuda_wide", 1, 1024, 128),
    ("fps_cuda_wide", 2, 1100, 48),        # ragged N
    ("fps_cuda_wide", 1, 16384, 256),      # the wide kernel's one-CTA bound
    # cluster launches (N above one CTA)
    ("fps_cuda_wide", 1, 20480, 4096),     # the OTF crop at B=1
    ("fps_cuda_wide", 1, 16400, 1024),     # ragged, 2 CTAs
    ("fps_cuda_wide", 3, 40000, 256),      # 4 CTAs, ragged slices
    ("fps_cuda_batched", 8, 20480, 4096),  # the OTF crop at B=8
    ("fps_cuda_batched", 9, 8193, 64),     # one point past one CTA
    # the blocked kernel
    ("fps_cuda_blocked", 1, 20480, 4096),  # the OTF crop under its opt-in
    ("fps_cuda_blocked", 1, 8192, 1024),
    ("fps_cuda_blocked", 2, 24576, 1024),  # its bound
    ("fps_cuda_blocked", 1, 9000, 512),    # ragged last row
    ("fps_cuda_blocked", 3, 1100, 64),
    # every points-a-thread step of the blocked kernel (512 threads, 8 more
    # points a thread each 4096 points, up to 20480; 256 threads at 88 and
    # 96 above; rows of 256), one point past it, and its bound
    *[("fps_cuda_blocked", 2, n + d, 128)
      for n in (4096, 8192, 12288, 16384, 20480, 22528) for d in (0, 1)],
    ("fps_cuda_blocked", 2, 24575, 128),
    ("fps_cuda_blocked", 1, 256, 64),      # one row
    ("fps_cuda_blocked", 1, 257, 64),
    # the frame-0 orientation search's CoordNet chunks (K = 64 candidates
    # at B = 1 and 2): sa1 and sa2
    ("fps_cuda_batched", 64, 4096, 512),
    ("fps_cuda_batched", 128, 4096, 512),
    ("fps_cuda_batched", 64, 512, 128),
])
def test_kernel_matches_plain(card, name, B, N, npoint):
    xyz = _cloud(B + N, B, N, card)
    got = getattr(fps, name)(xyz, npoint)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    assert torch.equal(got, fps.fps_plain(xyz, npoint))


@pytest.mark.parametrize("name,B,N,npoint", [
    ("fps_cuda_wide", 1, 4096, 512),
    ("fps_cuda_batched", 8, 4096, 512),
    ("fps_cuda_batched", 8, 512, 128),
    ("fps_cuda_wide", 1, 20480, 2048),
    ("fps_cuda_batched", 8, 20480, 512),
    ("fps_cuda_blocked", 1, 20480, 2048),
    ("fps_cuda_blocked", 2, 9000, 512),
])
@pytest.mark.parametrize("kind", ["grid", "dup"])
def test_kernel_ties_match_plain(card, name, B, N, npoint, kind):
    xyz = _tie_cloud(kind, B, N, 5, card)
    got = getattr(fps, name)(xyz, npoint)
    torch.cuda.synchronize()
    assert torch.equal(got, fps.fps_plain(xyz, npoint))


@pytest.mark.parametrize("name,B,N,npoint,kernel", [
    ("fps_cuda_wide", 1, 20480, 4096, "fps_cuda_wide_cluster"),
    ("fps_cuda_batched", 8, 20480, 4096, "fps_cuda_batched_cluster"),
    ("fps_cuda_wide", 1, 4096, 512, "fps_cuda_wide"),
    ("fps_cuda_batched", 8, 4096, 512, "fps_cuda_batched"),
    ("fps_cuda_batched", 8, 512, 128, "fps_cuda_batched"),
    ("fps_cuda_blocked", 1, 20480, 4096, "fps_cuda_blocked"),
    ("fps_cuda_blocked", 2, 9000, 512, "fps_cuda_blocked"),
])
@pytest.mark.parametrize("kind", ["wrap", "equal"])
def test_degenerate_clouds_match_plain(card, name, B, N, npoint, kernel,
                                       kind):
    # every minimum reaches 0 after the distinct points: the picks from
    # there on are all index 0, which the kernels write without sweeping
    xyz = _tie_cloud(kind, B, N, 6, card)
    fps.reset_launch_counts()
    got = getattr(fps, name)(xyz, npoint)
    torch.cuda.synchronize()
    assert fps.launch_counts[kernel] == 1
    want = fps.fps_plain(xyz, npoint)
    assert torch.equal(got, want)
    distinct = _wrap_distinct(N) if kind == "wrap" else 1
    assert distinct < npoint and not want[:, distinct:].any()


@pytest.mark.parametrize("order", ["scan", "shuffled"])
def test_blocked_kernel_at_the_skip_edge(card, order):
    # rows whose lower bound at pick 1 lies on their max or one ulp from it
    # (tests/fps_edge_clouds.py); shuffled, the same points in incoherent
    # rows
    clouds = []
    for seed in (0, 1):
        xyz = fps_edge_clouds.skip_edge_cloud(seed)
        if order == "shuffled":
            xyz = xyz[np.random.RandomState(seed).permutation(len(xyz))]
        clouds.append(xyz)
    xyz = torch.from_numpy(np.stack(clouds)).to(card)
    got = fps.fps_cuda_blocked(xyz, 256)
    torch.cuda.synchronize()
    assert torch.equal(got, fps.fps_plain(xyz, 256))


@pytest.mark.parametrize("name,B", [("fps_cuda_wide", 1),
                                    ("fps_cuda_batched", 8)])
def test_cluster_ragged_past_each_size(card, name, B):
    # one point past the single CTA, and one past each cluster size the
    # dispatch chooses, up to the bound
    lo, hi = fps.single_cta_points(name) + 1, fps.max_points(name)
    sizes = [fps.cluster_size(name, n) for n in range(lo, hi + 1)]
    firsts = [lo] + [lo + i for i in range(1, len(sizes))
                     if sizes[i] != sizes[i - 1]]
    assert len(firsts) >= 2 and 0 not in sizes
    for n in firsts:
        xyz = _cloud(n, B, n, card)
        got = getattr(fps, name)(xyz, 128)
        torch.cuda.synchronize()
        assert torch.equal(got, fps.fps_plain(xyz, 128)), n


@pytest.mark.parametrize("name,B", [("fps_cuda_wide", 1),
                                    ("fps_cuda_batched", 8)])
def test_cluster_runs_at_its_bound(card, name, B):
    n = fps.max_points(name)
    xyz = _cloud(3, B, n, card)
    got = getattr(fps, name)(xyz, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, fps.fps_plain(xyz, 64))


@pytest.mark.parametrize("name", ["fps_cuda_batched", "fps_cuda_wide",
                                  "fps_cuda_blocked"])
def test_kernel_refuses_clouds_above_its_bound(card, name):
    bound = fps.max_points(name)
    with pytest.raises(ValueError, match="at most"):
        getattr(fps, name)(_cloud(0, 1, bound + 1, card), 8)


@pytest.mark.parametrize("B,N,blocked,kernel", [
    (1, 4096, False, "fps_cuda_wide"),
    (1, 512, False, "fps_cuda_batched"),
    (8, 4096, False, "fps_cuda_batched"),
    (1, 20480, False, "fps_cuda_wide_cluster"),
    (8, 20480, False, "fps_cuda_batched_cluster"),
    (1, 20480, True, "fps_cuda_blocked"),
    (1, 4096, True, "fps_cuda_wide"),         # below the blocked range
    (8, 20480, True, "fps_cuda_batched_cluster"),
])
def test_dispatch_counts_the_kernel_it_launches(card, B, N, blocked, kernel,
                                                monkeypatch):
    if blocked:
        monkeypatch.setenv("CAPTRA_FPS_BLOCKED", "1")
    else:
        monkeypatch.delenv("CAPTRA_FPS_BLOCKED", raising=False)
    fps.reset_launch_counts()
    idx = ops.farthest_point_sample(_cloud(1, B, N, card), 64)
    torch.cuda.synchronize()
    assert idx.shape == (B, 64)
    assert fps.launch_counts[kernel] == 1
    assert sum(fps.launch_counts.values()) == 1


def test_cluster_sizes(card):
    # CTAs of 512 threads, at most 5 points a thread up to the portable 8
    # CTAs (the OTF crop's 20480 points), then up to 16 points a thread at
    # 8 CTAs, then 16 CTAs (the wide kernel's largest clouds)
    assert fps.cluster_threads() == 512
    for name in ("fps_cuda_wide", "fps_cuda_batched"):
        assert fps.cluster_size(name, 8193) == 4
        assert fps.cluster_size(name, 10240) == 4
        assert fps.cluster_size(name, 10241) == 8
        assert fps.cluster_size(name, 20480) == 8
        assert fps.cluster_size(name, 65536) == 8
        assert fps.cluster_size(name, fps.max_points(name) + 1) == 0
    assert fps.cluster_size("fps_cuda_wide", 65537) == 16
    assert fps.cluster_size("fps_cuda_wide", 131072) == 16


def test_grouped_mode_matches_plain(card):
    xyz = _cloud(2, 2, 4096, card)
    got = ops.farthest_point_sample(xyz, 512, mode="grouped")
    want = ops.farthest_point_sample(xyz.cpu(), 512, mode="grouped")
    assert torch.equal(got.cpu(), want)


def test_bf16_coordnet_on_the_card_matches_its_cpu_copy(card):
    """The full-width bottle CoordNet in bfloat16 on the card against the
    same net on the CPU: max |card - cpu| <= 2 max |cpu_bf16 - cpu_f32| +
    one bfloat16 ulp of the largest |cpu_f32| (the bound
    tests/test_torch_bf16.py holds the port to against the JAX package),
    for seg and NPCS; the FPS inputs are float32 on both."""
    import copy

    from captra_tpu_torch.config.presets import nocs_bottle
    from captra_tpu_torch.models.coordnet import CoordNet

    cfg = nocs_bottle("bfloat16")
    net = CoordNet(cfg, device=card,
                   generator=torch.Generator().manual_seed(0))
    cpu = copy.deepcopy(net).cpu()
    cpu32 = CoordNet(nocs_bottle(), device="cpu")
    cpu32.load_state_dict(cpu.state_dict())
    pts = _cloud(7, 2, cfg.num_points, "cpu") * 0.3
    with torch.no_grad():
        got = net(pts.to(card))
        want = cpu(pts)
        want32 = cpu32(pts)
    for k in ("seg", "nocs"):
        g, w, w32 = (x[k].double().cpu() for x in (got, want, want32))
        err = float((w - w32).abs().max())
        eps = 2.0 ** -8 * float(w32.abs().max())
        assert err > 0
        assert float((g - w).abs().max()) <= 2 * err + eps, k


def test_track_sequences_on_the_card_matches_the_cpu(card, tmp_path):
    """The track CLI's loop on the card against the same nets on the CPU:
    a tiny bottle, two synthetic trajectories of 3 frames at B=2, saved
    results and averages within 1e-3 (the card's float32 sums round
    otherwise than the CPU's)."""
    import contextlib
    import copy
    import io
    import pickle

    from captra_tpu_torch.cli import track
    from captra_tpu_torch.config import schema
    from captra_tpu_torch.models.coordnet import CoordNet
    from captra_tpu_torch.models.rotnet import RotNet
    from captra_tpu_torch.tracking.tracker import make_track_step
    from torch_port_helpers import tiny_config

    cfg = tiny_config(schema, num_points=128).replace(batch_size=2)
    gen = torch.Generator().manual_seed(0)
    cpu_nets = (CoordNet(cfg, device="cpu", generator=gen),
                RotNet(cfg, device="cpu", generator=gen))
    out = {}
    for dev, nets in (("cpu", cpu_nets),
                      (card, [copy.deepcopy(m).to(card) for m in cpu_nets])):
        exp = str(tmp_path / str(dev))
        run_cfg = cfg.replace(experiment_dir=exp)
        step = make_track_step(run_cfg, *nets, device=dev)
        with contextlib.redirect_stdout(io.StringIO()):
            avgs = track.track_sequences(
                run_cfg, step, track.synthetic_sequences(run_cfg, count=2,
                                                         num_frames=3),
                save=True, device=dev)
        with open(f"{exp}/results/data/synthetic_0001.pkl", "rb") as f:
            out[str(dev)] = (avgs, pickle.load(f))
    (cpu_avg, cpu_res), (gpu_avg, gpu_res) = out["cpu"], out[str(card)]
    for k in cpu_avg:
        np.testing.assert_allclose(gpu_avg[k], cpu_avg[k], atol=1e-3)
    for k, v in cpu_res["pred"]["poses"].items():
        np.testing.assert_allclose(gpu_res["pred"]["poses"][k], v, atol=1e-3)
    np.testing.assert_array_equal(gpu_res["gt"]["corners"],
                                  cpu_res["gt"]["corners"])


def test_grid_iou_on_the_card_equals_the_cpu(card):
    """The grid IoU's arithmetic is separate float32 multiplies and adds, so
    the card classifies every grid point as the CPU does."""
    from captra_tpu_torch.pose import bbox
    from captra_tpu_torch.pose.part_dof import Pose
    from captra_tpu_torch.pose.rotations import quat_to_matrix

    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(2, 4, 4).astype(np.float32))
    rot = quat_to_matrix(q / q.norm(dim=-1, keepdim=True))
    center = torch.from_numpy(rng.uniform(-0.05, 0.05, (2, 4, 3)))
    half = torch.from_numpy(rng.uniform(0.05, 0.2, (2, 4, 3)))
    corners = torch.stack([center - half, center + half], -2).float()
    pose = Pose(rot, torch.from_numpy(rng.uniform(
        -0.05, 0.05, (2, 4, 3, 1)).astype(np.float32)),
        torch.ones(2, 4))
    boxes = bbox.posed_bbox_from_part(pose, corners)
    want = bbox.iou_3d(boxes[0], boxes[1])
    got = bbox.iou_3d(boxes[0].to(card), boxes[1].to(card))
    assert (want > 0).any()
    assert torch.equal(got.cpu(), want)


def test_host_data_core_builds_and_loads(card):
    """The readers' C++ core (g++, no card code) on the card's machine:
    built from `csrc/pointops_host.cpp`, its FPS equal to the plain FPS."""
    from captra_tpu_torch.data import native
    rng = np.random.RandomState(4)
    xyz = rng.randn(3000, 3).astype(np.float32)
    got = native.fps(xyz, 256)
    want = fps.fps_plain(torch.from_numpy(xyz)[None], 256)[0]
    np.testing.assert_array_equal(got, want.numpy())


def test_otf_frame_from_depth_on_the_card_equals_plain_fps(card):
    """The dataset path's crop of a 480x640 frame on the card: its FPS of
    the [1, 20480] working set (the wide cluster) against the same call
    with the plain FPS on the card; indices, points and labels equal."""
    from captra_tpu_torch.data import depth_frames, preprocess
    from captra_tpu_torch.ops import pointops
    from captra_tpu_torch.pose.part_dof import Pose
    depth, mask = depth_frames.make_depth_frames(1, 1, seed=0)
    depth = torch.from_numpy(depth[0, 0]).to(card)
    mask = torch.from_numpy(mask[0, 0]).to(card)
    pose = depth_frames.otf_init_pose(depth.cpu().numpy(),
                                      mask.cpu().numpy(), 1, 1)
    pose = Pose(pose.rotation[0, 0], pose.translation[0, 0],
                pose.scale[0, 0]).to(card)
    draw = torch.rand(depth.numel(), generator=torch.Generator().manual_seed(
        0)).to(card)
    args = (draw, depth, mask, preprocess.NOCS_REAL_INTRINSICS,
            pose.translation[:, 0], 0.6 * pose.scale, pose, 4096)
    fps.reset_launch_counts()
    got = preprocess.otf_frame_from_depth(*args)
    assert fps.launch_counts["fps_cuda_wide_cluster"] == 1
    routed = pointops.farthest_point_sample_indices
    pointops.farthest_point_sample_indices = fps.fps_plain
    try:
        want = preprocess.otf_frame_from_depth(*args)
    finally:
        pointops.farthest_point_sample_indices = routed
    for k in ("points", "labels", "nocs"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("config", ["config_coordnet.yml",
                                    "config_rotnet.yml"])
def test_full_width_train_step_matches_plain_fps(card, config, monkeypatch):
    """One train step at the config's full width (SAPIEN laptop, batch 12,
    4096 points; sa1 -> fps_cuda_batched on 12 or 24 clouds) against the
    same step, from a copy of the same state, with the plain FPS on the
    card, under torch's deterministic algorithms.  Both take the same FPS
    indices, so the losses, the gradients and the running statistics are
    equal bit for bit."""
    from captra_tpu_torch.config import get_config
    from captra_tpu_torch.data.synthetic import make_frame_batch
    from captra_tpu_torch.ops import pointops
    from captra_tpu_torch.training.trainer import Trainer
    cfg = get_config(config)
    trainer = Trainer(cfg, 50, device=card)
    state = trainer.init_state(generator=torch.Generator().manual_seed(0))
    twin = trainer.copy_state(state)
    batch = make_frame_batch(0, cfg.obj, batch=cfg.batch_size,
                             num_points=cfg.num_points)
    draws = trainer.draw(batch, torch.Generator(card).manual_seed(1))
    fps.reset_launch_counts()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, losses, _ = trainer.train_step(state, batch, draws=draws)
        torch.cuda.synchronize()
        assert fps.launch_counts["fps_cuda_batched"] == 2
        assert sum(fps.launch_counts.values()) == 2
        monkeypatch.setattr(pointops, "farthest_point_sample_indices",
                            fps.fps_plain)
        _, plain, _ = trainer.train_step(twin, batch, draws=draws)
    finally:
        torch.use_deterministic_algorithms(False)
    assert sorted(losses) == sorted(plain)
    for k, v in plain.items():
        assert torch.equal(losses[k], v), k
    assert torch.equal(state.grads, twin.grads)
    for (name, a), (_, b) in zip(state.module.named_buffers(),
                                 twin.module.named_buffers()):
        if a.is_floating_point():
            assert torch.equal(a, b), name


def test_device_pose_batch_on_the_card_matches_the_cpu(card):
    from captra_tpu_torch.config import get_config
    from captra_tpu_torch.data.synthetic import (
        device_pose_batch, draw_pose_batch, geometry_pool,
    )
    cfg = get_config("config_coordnet.yml")
    pool = geometry_pool(0, cfg.obj, count=12, num_points=4096)
    draws = draw_pose_batch(12, 4096, cfg.obj.num_parts,
                            torch.Generator(card).manual_seed(0))
    args = [torch.from_numpy(pool[k]) for k in ("npcs", "labels",
                                                  "corners")]
    got = device_pose_batch(*[a.to(card) for a in args], cfg.obj,
                            draws=draws)
    want = device_pose_batch(*args, cfg.obj,
                             draws={k: v.cpu() for k, v in draws.items()})
    assert got["points"].is_cuda
    for k in ("points", "nocs", "corners"):
        assert float((got[k].cpu() - want[k]).abs().max()) <= 1e-6, k
    for f in ("rotation", "translation", "scale"):
        assert float((getattr(got["pose"], f).cpu()
                      - getattr(want["pose"], f)).abs().max()) <= 1e-6, f


def test_device_trajectory_batch_on_the_card_matches_the_cpu(card):
    from captra_tpu_torch.config.presets import nocs_bottle
    from captra_tpu_torch.data.synthetic import (
        device_trajectory_batch, draw_trajectory_batch, geometry_pool,
    )
    cfg = nocs_bottle()
    B, T = 16, 20
    pool = geometry_pool(0, cfg.obj, count=B, num_points=cfg.num_points)
    draws = draw_trajectory_batch(B, cfg.num_points, cfg.obj.num_parts, T,
                                  torch.Generator(card).manual_seed(0))
    args = [torch.from_numpy(pool[k]) for k in ("npcs", "labels",
                                                  "corners")]
    got = device_trajectory_batch(*[a.to(card) for a in args], cfg.obj,
                                  num_frames=T, draws=draws)
    want = device_trajectory_batch(*args, cfg.obj, num_frames=T,
                                   draws={k: v.cpu() for k, v in
                                          draws.items()})
    assert got["points"].is_cuda and got["points"].shape == (
        T, B, cfg.num_points, 3)
    for k in ("points", "nocs", "corners"):
        assert float((got[k].cpu() - want[k]).abs().max()) <= 1e-6, k
    for f in ("rotation", "translation", "scale"):
        assert float((getattr(got["pose"], f).cpu()
                      - getattr(want["pose"], f)).abs().max()) <= 1e-6, f


def test_rollout_round_on_the_card_matches_plain_fps(card, monkeypatch):
    """A small fine-tune round (2 trajectories of 3 frames, minibatches of
    2) of the full-width bottle nets with the FPS kernels against the same
    round, from copies of the states, with the plain FPS on the card,
    under torch's deterministic algorithms: equal bit for bit (logs,
    parameters, statistics, moments).  FPS launches as `route` predicts:
    2 tracked frames and 2 minibatches x 2 nets, 2 sweeps a net each."""
    from captra_tpu_torch.config import get_config
    from captra_tpu_torch.config.presets import nocs_bottle
    from captra_tpu_torch.data.synthetic import geometry_pool
    from captra_tpu_torch.ops import pointops
    from captra_tpu_torch.training.rollout import make_finetune_round
    from captra_tpu_torch.training.trainer import Trainer
    over = {"obj_config": "obj_info_nocs.yml", "obj_category": "1"}
    cfg = nocs_bottle()
    trainers = [Trainer(get_config(c, over), 100, device=card)
                for c in ("config_coordnet.yml", "config_rotnet.yml")]
    gen = torch.Generator().manual_seed(0)
    states = [t.init_state(generator=gen) for t in trainers]
    twins = [t.copy_state(s) for t, s in zip(trainers, states)]
    pool = geometry_pool(0, cfg.obj, count=8, num_points=cfg.num_points)
    round_fn = make_finetune_round(cfg, *trainers, pool, traj_batch=2,
                                   traj_frames=3, minibatch=2, device=card)
    draws = round_fn.draw(torch.Generator(card).manual_seed(1))
    fps.reset_launch_counts()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, _, logs = round_fn(*states, draws=draws)
        torch.cuda.synchronize()
        launches = {k: v for k, v in fps.launch_counts.items() if v}
        monkeypatch.setattr(pointops, "farthest_point_sample_indices",
                            fps.fps_plain)
        _, _, plain = round_fn(*twins, draws=draws)
    finally:
        torch.use_deterministic_algorithms(False)
    assert launches == {"fps_cuda_wide": 8, "fps_cuda_batched": 8}
    assert sorted(logs) == sorted(plain)
    for k, v in plain.items():
        assert torch.isfinite(v) and torch.equal(logs[k], v), k
    for s, t in zip(states, twins):
        assert s.step == t.step == 2
        assert torch.equal(s.params, t.params)
        for name in ("mu", "nu"):
            assert torch.equal(s.opt_state[name], t.opt_state[name])
        for (name, a), (_, b) in zip(s.module.named_buffers(),
                                     t.module.named_buffers()):
            if a.is_floating_point():
                assert torch.equal(a, b), name


def test_reference_checkpoint_nets_on_the_card(card, tmp_path):
    """A reference-layout composed `.pt` through `convert_track_checkpoint`:
    the nets on the card track the bottle at B=1 (sa1 -> fps_cuda_wide)
    within 1e-4 of the same nets on the CPU."""
    from torch_port_helpers import reference_track_state_dict

    from captra_tpu_torch.config.presets import nocs_bottle
    from captra_tpu_torch.data.synthetic import (
        batch_trajectories, make_trajectory,
    )
    from captra_tpu_torch.tracking.tracker import (
        make_track_step, track_trajectory,
    )
    from captra_tpu_torch.training.convert import (
        convert_track_checkpoint, coordnet_from_flax, rotnet_from_flax,
    )
    cfg = nocs_bottle()
    path = str(tmp_path / "ref.pt")
    torch.save({"epoch": 0, "iteration": 0,
                "model": reference_track_state_dict(cfg, seed=0),
                "optimizer": {"state": {}, "param_groups": []}}, path)
    cv, rv = convert_track_checkpoint(path, cfg)
    data = batch_trajectories([make_trajectory(0, cfg.obj, num_frames=4,
                                               num_points=cfg.num_points)])
    poses = {}
    fps.reset_launch_counts()
    for dev in (card, torch.device("cpu")):
        step = make_track_step(cfg, coordnet_from_flax(cfg, cv, dev).eval(),
                               rotnet_from_flax(cfg, rv, dev).eval(),
                               device=dev)
        _, aux = track_trajectory(step, data["pose"][0],
                                  {"points": data["points"]}, device=dev)
        poses[dev.type] = aux.pose
    assert fps.launch_counts["fps_cuda_wide"] == 2 * 3
    for f in ("rotation", "translation", "scale"):
        got = getattr(poses["cuda"], f).cpu()
        assert torch.isfinite(got).all(), f
        assert float((got - getattr(poses["cpu"], f)).abs().max()) <= 1e-4, f


def _track_preprocessed_tree(root, device, exp):
    """Tiny seeded nets (made on the CPU, moved to `device`) tracking the
    bottle of the preprocessed tree at `root` on the OTF crop at B=1, with
    the track CLI's loop; returns the saved result."""
    import contextlib
    import dataclasses
    import io
    import pickle

    from captra_tpu_torch.cli import track
    from captra_tpu_torch.config import schema
    from captra_tpu_torch.models.coordnet import CoordNet
    from captra_tpu_torch.models.rotnet import RotNet
    from captra_tpu_torch.tracking.tracker import make_track_step
    from torch_port_helpers import tiny_config

    cfg = tiny_config(schema, num_points=128)
    cfg = cfg.replace(
        obj=dataclasses.replace(cfg.obj, nocs_data=True, basepath=root),
        track=dataclasses.replace(cfg.track, nocs_otf=True), batch_size=1,
        experiment_dir=exp)
    gen = torch.Generator().manual_seed(0)
    nets = [CoordNet(cfg, device="cpu", generator=gen).to(device),
            RotNet(cfg, device="cpu", generator=gen).to(device)]
    step = make_track_step(cfg, *nets, device=device)
    with contextlib.redirect_stdout(io.StringIO()):
        track.track_sequences(cfg, step, track.dataset_sequences(cfg),
                              save=True, device=device)
    (name,) = os.listdir(os.path.join(exp, "results", "data"))
    with open(os.path.join(exp, "results", "data", name), "rb") as f:
        return pickle.load(f)


def test_preprocessed_tree_tracks_on_the_card_as_the_plain_fps(card,
                                                                tmp_path):
    """A raw NOCS release (3 real_test frames of three instances, from
    `torch_port_helpers.write_raw_nocs`) through the port's preprocessing,
    then its bottle tracked on the OTF crop at B=1 on the card: with the
    kernels (each launched) and with the plain FPS on the card, the saved
    poses finite and within 1e-4."""
    from captra_tpu_torch.data.preproc_pipeline import run_pipeline
    from captra_tpu_torch.ops import pointops
    from torch_port_helpers import write_raw_nocs

    root = str(tmp_path / "nocs")
    write_raw_nocs(root, "real_test", ["scene_1"], 3)
    run_pipeline(root, data_types=("real_test",), categories=[1],
                 log=lambda *_: None)
    fps.reset_launch_counts()
    got = _track_preprocessed_tree(root, card, str(tmp_path / "kernels"))
    assert sum(fps.launch_counts.values()) > 0
    routed = pointops.farthest_point_sample_indices
    pointops.farthest_point_sample_indices = fps.fps_plain
    try:
        want = _track_preprocessed_tree(root, card, str(tmp_path / "plain"))
    finally:
        pointops.farthest_point_sample_indices = routed
    for k, v in want["pred"]["poses"].items():
        assert np.isfinite(got["pred"]["poses"][k]).all(), k
        np.testing.assert_allclose(got["pred"]["poses"][k], v, atol=1e-4,
                                   err_msg=k)
