"""The CUDA kernels on the card: FPS against the plain PyTorch FPS, the
fused set-abstraction scale against the module chain, the neighbour
selection against the chain's ball query and 3-NN.

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
from captra_tpu_torch.ops import cuda_build, fps

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
    cuda_build.reset_launch_counts()
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
    cuda_build.reset_launch_counts()
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
    cuda_build.reset_launch_counts()
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
    cuda_build.reset_launch_counts()
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
    cuda_build.reset_launch_counts()
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
    cuda_build.reset_launch_counts()
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
    cuda_build.reset_launch_counts()
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


def test_nccl_one_rank_step_is_the_plain_step(card, tmp_path):
    """Data parallelism through `parallel.mesh` with one NCCL rank in this
    process (BatchNorm's and the gradient's all-reduces issued) against
    the plain single-process steps of the full-width CoordNet laptop:
    losses within 1e-5 relative over 3 steps."""
    import torch.distributed as dist
    from captra_tpu_torch.parallel import mesh
    from torch_port_helpers import dp_card_steps
    want = dp_card_steps(card, 3)
    mesh.init_data_parallel(0, 1, f"file://{tmp_path}/store", "nccl")
    try:
        dp = mesh.data_parallel_mesh()
        assert dp.world == 1
        got = dp_card_steps(card, 3, dp)
    finally:
        dist.destroy_process_group()
    for k, v in want["losses"].items():
        assert abs(got["losses"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
    assert got["launches"] == want["launches"]


def test_two_gloo_ranks_on_one_card_step_as_the_global_batch(card):
    """Two gloo ranks sharing the card (CUDA tensors), each on 6 of the 12
    rows: step 1's losses within 1e-4 relative of the single-process step
    and its flat gradient within 2e-2 of max |g| (float32 BN's backward
    at this size: the single-process float32 gradient itself lies ~6e-3
    of max |g| from the float64 step; tests/test_torch_parallel.py holds
    the semantics at 1e-9 in float64); parameters and BN statistics equal
    bit for bit on both ranks after 3 steps; each rank's step launches
    fps_cuda_wide ([6,4096]->512) and fps_cuda_batched ([6,512]->128)
    once."""
    from captra_tpu_torch.parallel import mesh
    from torch_port_helpers import dp_card_rank, dp_card_steps
    want = dp_card_steps(card, 1)
    ranks = mesh.launch(dp_card_rank, 2, card, args=(3,), backend="gloo",
                        cards=(0, 0), timeout=600)
    for k, v in want["losses"].items():
        assert abs(ranks[0]["losses"][k] - v) <= 1e-4 * max(1.0, abs(v)), k
    g = want["grads"]
    assert np.abs(ranks[0]["grads"] - g).max() <= 2e-2 * np.abs(g).max()
    np.testing.assert_array_equal(ranks[1]["params"], ranks[0]["params"])
    for k, v in ranks[0]["stats"].items():
        np.testing.assert_array_equal(ranks[1]["stats"][k], v, err_msg=k)
    for r in ranks:
        assert r["launches"] == [{"fps_cuda_wide": 1,
                                  "fps_cuda_batched": 1}] * 3


# ---------------------------------------------------------------------------
# the fused set-abstraction scale (csrc/sa_mlp.cu)
# ---------------------------------------------------------------------------

# The kernel sums each output's products in another order than cuBLAS (one
# float32 FMA chain from channel 0 up), so its outputs differ from the
# chain's by float32 rounding, amplified by the BatchNorms' 1/std: both are
# held to a float64 copy of the chain, the kernel to within 4 x the chain's
# own distance from it (a tolerance of the summation order, not of the
# arithmetic) plus 2e-6 of the largest output.
SA_ORDER_FACTOR = 4.0
SA_FLOOR = 2e-6


def _sa_module(sa_cfg, cf, seed, device, dims=None, nsample=None):
    """`torch_port_helpers.seeded_sa` on `device`; with `dims`, one scale of
    `nsample` neighbours and those widths in place of `sa_cfg`."""
    from torch_port_helpers import seeded_sa

    from captra_tpu_torch.config.schema import SAMsgCfg
    if dims is not None:
        sa_cfg = SAMsgCfg(npoint=4, radius_list=(0.3,),
                          nsample_list=(nsample,), mlp_list=(dims,))
    return seeded_sa(sa_cfg, cf, seed, device)


def _sa_inputs(B, N, cf, seed, device):
    rng = np.random.RandomState(seed)
    xyz = torch.from_numpy((rng.rand(B, N, 3) - 0.5).astype(np.float32)
                           ).to(device)
    feats = None if cf == 0 else torch.from_numpy(
        np.abs(rng.randn(B, N, cf)).astype(np.float32)).to(device)
    return xyz, feats


def _sa_layers(mlp, dtype=torch.float32, device="cpu"):
    """`scale_layers(mlp)` copied to `device` in `dtype`."""
    from captra_tpu_torch.models.backbone import scale_layers
    from captra_tpu_torch.ops import sa_mlp
    return [sa_mlp.Layer(*(t.detach().to(device, dtype) for t in L[:6]),
                         L.eps) for L in scale_layers(mlp)]


def _check_scales(m, xyz, feats, new_xyz):
    """Each scale of module m: the kernel against the chain on the card
    (`sa_mlp_plain`, cuBLAS) and both against a float64 copy on the CPU;
    where `sa_mlp.factored` picks the scale, its factored route (from the
    stage's table) equal to the gathered one bit for bit."""
    from captra_tpu_torch.ops import sa_mlp
    B, S = new_xyz.shape[:2]
    cf = 0 if feats is None else feats.shape[-1]
    table = None if cf == 0 else sa_mlp.sa_table_cuda(
        feats, [getattr(m, f"scale_{i}").dense_0.weight.detach()
                for i in range(len(m.cfg.nsample_list))])
    col = 0
    for i, (radius, k) in enumerate(zip(m.cfg.radius_list,
                                        m.cfg.nsample_list)):
        mlp = getattr(m, f"scale_{i}")
        idx = ops.ball_query(radius, k, xyz, new_xyz)
        layers = _sa_layers(mlp, device=xyz.device)
        out = torch.full((B, S, mlp.out_dim + 5), -7.0, device=xyz.device)
        sa_mlp.sa_mlp_cuda(xyz, new_xyz, feats, idx, layers, out, 3)
        if table is not None and sa_mlp.factored(xyz.shape[1], S, k, cf):
            fact = torch.full_like(out, -7.0)
            sa_mlp.sa_mlp_cuda(xyz, new_xyz, feats, idx, layers, fact, 3,
                               table, col)
            assert torch.equal(fact, out), i
        col += mlp.dense_0.weight.shape[0]
        chain = sa_mlp.sa_mlp_plain(xyz, new_xyz, feats, idx, layers)
        torch.cuda.synchronize()
        ref = sa_mlp.sa_mlp_plain(
            xyz.cpu().double(), new_xyz.cpu().double(),
            None if feats is None else feats.cpu().double(), idx.cpu(),
            _sa_layers(mlp, torch.float64))
        got = out[..., 3:3 + mlp.out_dim].cpu().double()
        assert (out[..., :3] == -7.0).all() and (out[..., -2:] == -7.0).all()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        err_chain = float((chain.cpu().double() - ref).abs().max())
        print(f"scale {i} K={k} widths {[L.weight.shape for L in layers]}: "
              f"kernel {err / scale:.3g}, chain {err_chain / scale:.3g} "
              f"of {scale:.3g}")
        assert err <= SA_ORDER_FACTOR * err_chain + SA_FLOOR * scale, i


@pytest.mark.parametrize("B,cf", [(16, 3), (16, 0), (8, 3), (32, 0)])
@pytest.mark.parametrize("stage", ["sa1", "sa2"])
def test_sa_kernel_matches_the_chain_at_the_cells_shapes(card, B, cf, stage):
    # the tracking cells' set abstractions: CoordNet (sa1 features xyz,
    # cf 3) and RotNet (no features) on 16 clouds (bottle), CoordNet on 8
    # and RotNet on 32 (drawers: 8 streams x 4 parts); sa2 takes sa1's 320
    from captra_tpu_torch.config.presets import nocs_bottle
    pn = nocs_bottle().pointnet
    sa_cfg, N, cf = ((pn.sa1, 4096, cf) if stage == "sa1"
                     else (pn.sa2, pn.sa1.npoint, 320))
    m = _sa_module(sa_cfg, cf, B + cf, card)
    xyz, feats = _sa_inputs(B, N, cf, B, card)
    new_xyz = ops.gather_xyz(xyz, ops.farthest_point_sample(
        xyz, sa_cfg.npoint))
    _check_scales(m, xyz, feats, new_xyz)


@pytest.mark.parametrize("S,K,dims,cf", [
    (37, 32, (32, 32, 64), 3),        # a last tile of 1 centre in 4
    (5, 128, (64, 96, 128), 0),       # one centre a tile
    (9, 48, (40, 196), 320),          # K dividing no tile: 2 centres, 96 rows
    (21, 8, (16, 32), 3),             # 16 centres a tile, two layers
    (3, 1, (130,), 5),                # one layer, two column chunks
    (11, 16, (8, 200, 260), 0),       # three layers, ragged widths
])
def test_sa_kernel_ragged_tiles_and_widths(card, S, K, dims, cf):
    from captra_tpu_torch.config.schema import SAMsgCfg
    sa_cfg = SAMsgCfg(npoint=S, radius_list=(0.3,), nsample_list=(K,),
                      mlp_list=(dims,))
    m = _sa_module(sa_cfg, cf, S + K, card)
    xyz, feats = _sa_inputs(3, 300, cf, S, card)
    new_xyz = ops.gather_xyz(xyz, ops.farthest_point_sample(xyz, S))
    _check_scales(m, xyz, feats, new_xyz)


def _sa1_features(B, use_xyz_feat, seed, device):
    """What sa2 reads in a tracking step: a cloud of 4096 points through a
    seeded sa1 (CoordNet's with the cloud as its features, RotNet's with
    none) on the kernels' route, -> (sa1's centres, their 320 channels)."""
    from captra_tpu_torch.config.presets import nocs_bottle
    pn = nocs_bottle().pointnet
    cf = 3 if use_xyz_feat else 0
    sa1 = _sa_module(pn.sa1, cf, seed, device)
    xyz = _sa_inputs(B, 4096, 0, seed, device)[0]
    with torch.no_grad():
        return sa1(xyz, xyz if use_xyz_feat else None)


def _table_against_its_twin(feats, weights):
    """The table kernel against its twin (`sa_table_plain`, cuBLAS), both
    against a float64 copy: the kernel within SA_ORDER_FACTOR x the twin's
    distance plus SA_FLOOR of the largest entry.  Returns the table."""
    from captra_tpu_torch.ops import sa_mlp
    got = sa_mlp.sa_table_cuda(feats, weights)
    twin = sa_mlp.sa_table_plain(feats, weights)
    torch.cuda.synchronize()
    ref = sa_mlp.sa_table_plain(feats.cpu().double(),
                                [w.cpu().double() for w in weights])
    scale = float(ref.abs().max())
    err = float((got.cpu().double() - ref).abs().max())
    err_twin = float((twin.cpu().double() - ref).abs().max())
    print(f"table {tuple(got.shape)}: kernel {err / scale:.3g}, twin "
          f"{err_twin / scale:.3g} of {scale:.3g}")
    assert err <= SA_ORDER_FACTOR * err_twin + SA_FLOOR * scale
    return got


@pytest.mark.parametrize("B", [8, 16, 32, 64])
@pytest.mark.parametrize("net", ["coordnet", "rotnet"])
def test_sa2_factored_route_is_the_gathered_route_bit_for_bit(card, B, net):
    # sa2 at every batch the paths give it (drawers CoordNet 8, bottle 16,
    # drawers RotNet 32, the init search 64) on sa1's own outputs: the
    # module (factored on the card) equals each scale's gathered launch
    from captra_tpu_torch.config.presets import nocs_bottle
    from captra_tpu_torch.ops import sa_mlp
    pn = nocs_bottle().pointnet
    l1_xyz, l1 = _sa1_features(B, net == "coordnet", B, card)
    sa2 = _sa_module(pn.sa2, 320, B + 1, card)
    weights = [getattr(sa2, f"scale_{i}").dense_0.weight.detach()
               for i in range(2)]
    table = _table_against_its_twin(l1, weights)
    cuda_build.reset_launch_counts()
    with torch.no_grad():
        new_xyz, got = sa2(l1_xyz, l1)
    assert sa_mlp.launch_counts["sa_mlp_cuda"] == 2
    assert sa_mlp.launch_counts["sa_table_cuda"] == 1
    col = off = 0
    for i, (radius, k) in enumerate(zip(pn.sa2.radius_list,
                                        pn.sa2.nsample_list)):
        assert sa_mlp.factored(l1.shape[1], pn.sa2.npoint, k, 320)
        idx = ops.ball_query(radius, k, l1_xyz, new_xyz)
        layers = _sa_layers(getattr(sa2, f"scale_{i}"), device=card)
        width = layers[-1].weight.shape[0]
        gathered = torch.empty(B, pn.sa2.npoint, width, device=card)
        factored = torch.empty_like(gathered)
        sa_mlp.sa_mlp_cuda(l1_xyz, new_xyz, l1, idx, layers, gathered)
        sa_mlp.sa_mlp_cuda(l1_xyz, new_xyz, l1, idx, layers, factored, 0,
                           table, col)
        assert torch.equal(factored, gathered), i
        assert torch.equal(got[..., off:off + width], gathered), i
        col += layers[0].weight.shape[0]
        off += width


@pytest.mark.parametrize("B,N,S,nsample,mlps,cf", [
    (3, 300, 43, (7,), ((40, 24),), 20),      # S.K = 301, just above N
    (2, 200, 9, (48, 32), ((130,), (64, 32)), 33),   # one layer, 2 chunks
    (1, 129, 5, (128,), ((64, 96, 128),), 16),  # one chunk of features
    (3, 300, 21, (64, 30), ((200, 32), (24, 196, 40)), 45),
])
def test_sa_factored_route_ragged(card, B, N, S, nsample, mlps, cf):
    # features not a multiple of a chunk, B x N not a multiple of the
    # table's 128 rows, columns in several chunks and several scales
    from captra_tpu_torch.config.schema import SAMsgCfg
    from captra_tpu_torch.ops import sa_mlp
    sa_cfg = SAMsgCfg(npoint=S, radius_list=(0.3, 0.5)[:len(nsample)],
                      nsample_list=nsample, mlp_list=mlps)
    m = _sa_module(sa_cfg, cf, S + cf, card)
    xyz, feats = _sa_inputs(B, N, cf, S, card)
    new_xyz = ops.gather_xyz(xyz, ops.farthest_point_sample(xyz, S))
    assert all(sa_mlp.factored(N, S, k, cf) for k in nsample)
    _table_against_its_twin(feats, [getattr(m, f"scale_{i}").dense_0
                                    .weight.detach()
                                    for i in range(len(nsample))])
    _check_scales(m, xyz, feats, new_xyz)


def test_sa_module_launches_one_kernel_a_scale(card):
    # CoordNet's sa1 as the tracker calls it: the cloud and its features a
    # [B, N, 3] view of [B, 3, N] (the ball query keeps that layout)
    from captra_tpu_torch.config.presets import nocs_bottle
    from captra_tpu_torch.ops import sa_mlp
    pn = nocs_bottle().pointnet
    m = _sa_module(pn.sa1, 3, 0, card)
    xyz = _sa_inputs(2, 4096, 3, 0, card)[0].transpose(1, 2).contiguous(
        ).transpose(1, 2)
    feats = xyz
    cuda_build.reset_launch_counts()
    with torch.no_grad():
        assert m.fused(xyz, feats)
        new_xyz, got = m(xyz, feats)
    assert sa_mlp.launch_counts["sa_mlp_cuda"] == len(pn.sa1.nsample_list)
    want = m(xyz, feats)[1]           # grad enabled: the module chain
    assert sa_mlp.launch_counts["sa_mlp_cuda"] == len(pn.sa1.nsample_list)
    torch.cuda.synchronize()
    scale = float(want.detach().abs().max())
    assert float((got - want.detach()).abs().max()) <= 1e-4 * scale


def test_sa_kernel_refuses_what_it_cannot_take(card):
    from captra_tpu_torch.ops import sa_mlp
    m = _sa_module(None, 0, 0, card, dims=(16, 32), nsample=8)
    xyz, _ = _sa_inputs(1, 64, 0, 0, card)
    layers = _sa_layers(m.scale_0, device=card)
    new_xyz = xyz[:, :4].contiguous()
    out = torch.empty(1, 4, 32, device=card)
    idx = torch.zeros(1, 4, 129, dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="beyond the kernel"):
        sa_mlp.sa_mlp_cuda(xyz, new_xyz, None, idx, layers, out)
    with pytest.raises(TypeError):
        sa_mlp.sa_mlp_cuda(xyz, new_xyz, None, idx[..., :8].int(), layers,
                           out)
    with pytest.raises(ValueError, match="no room"):
        sa_mlp.sa_mlp_cuda(xyz, new_xyz, None, idx[..., :8].contiguous(),
                           layers, out, 1)
    with pytest.raises(ValueError, match="CUDA"):
        sa_mlp.sa_mlp_cuda(xyz.cpu(), new_xyz.cpu(), None,
                           idx[..., :8].cpu(), layers, out.cpu())
    # the module routes a scale beyond the kernel to it, which raises
    wide = _sa_module(None, 0, 0, card, dims=(16, 32), nsample=160)
    with torch.no_grad(), pytest.raises(ValueError, match="beyond the kernel"):
        wide(_sa_inputs(1, 256, 0, 0, card)[0], None)


def _eager_step(s, cell, card, pose, f):
    """The bench loop's step from `pose` on frame `f`, made anew from the
    loop's nets: its one call runs eagerly, so it takes a route the test
    patched (the loop's own step replays the graph it captured)."""
    from port_bench.drivers import track

    from captra_tpu_torch.tracking.tracker import make_track_step
    pcfg = track.port_config(cell.config, cell.traffic.get("track", {}))
    step = make_track_step(pcfg, *s["nets"], device=card)
    return step(pose, {k: v[f] for k, v in s["frames"].items()})


@pytest.mark.parametrize("cell", ["bottle_points_b16", "drawers_points_b8"])
def test_track_step_with_the_kernel_is_within_the_bench_limits(
        card, cell, monkeypatch):
    """The benchmark's nets and traffic cut to 2 streams: a tracking step
    with the fused scales against the same step through the module chain
    (the path before the kernel), frame by frame from the same carried
    pose, every gap within the cell's limits (port_bench/limits)."""
    import json

    from port_bench.drivers import track
    from port_bench.harness import Clock, Context, find_cell, load_spec

    from captra_tpu_torch.models.backbone import SetAbstractionMsg
    from captra_tpu_torch.ops import sa_mlp
    c = find_cell(load_spec(), cell)
    c.traffic = dict(c.traffic, streams=2, frames=4)
    ctx = Context(cell=c, seed=2 ** 31 + 5, seconds=0.0, trace=False,
                  device=card, clock=Clock(), log=lambda msg: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    s = track.setup(ctx)
    loop, ranges = s["loop"], s["ranges"]
    with open(f"port_bench/limits/{cell}.json") as f:
        limits = json.load(f)["limits"]
    cuda_build.reset_launch_counts()
    for _ in range(3):
        pose_in, f = loop.pose, loop.f
        got = loop.advance(ranges)
        launched = sa_mlp.launch_counts["sa_mlp_cuda"]
        with monkeypatch.context() as mp:
            mp.setattr(SetAbstractionMsg, "fused",
                       lambda self, xyz, feats: False)
            ref_new, ref_aux = _eager_step(s, c, card, pose_in, f)
        assert sa_mlp.launch_counts["sa_mlp_cuda"] == launched
        new, aux = got[2], got[3]
        gaps = {"seg_gap": (aux.seg, ref_aux.seg, False),
                "nocs_gap": (aux.nocs, ref_aux.nocs, False),
                "rot_gap": (new.rotation, ref_new.rotation, False),
                "trans_gap": (new.translation, ref_new.translation, False),
                "scale_gap": (new.scale, ref_new.scale, True)}
        for k, (a, b, rel) in gaps.items():
            d = (a.double() - b.double()).abs()
            if rel:
                d = d / b.double().abs()
            print(f"frame {f} {k}: {float(d.max()):.3g} "
                  f"(limit {limits[k]})")
            assert float(d.max()) <= limits[k], k
    # CoordNet's and RotNet's sa1 and sa2: 5 scales a net a step, and
    # one table a net for sa2's factored first layers
    assert sa_mlp.launch_counts["sa_mlp_cuda"] == 3 * 2 * 5
    assert sa_mlp.launch_counts["sa_table_cuda"] == 3 * 2


# ---------------------------------------------------------------------------
# the neighbour selection (csrc/neighbors.cu)
# ---------------------------------------------------------------------------

# the batches the paths give a backbone: bottle CoordNet and RotNet (16),
# drawers CoordNet (8) and RotNet (32 = 8 streams x 4 parts), training
# (12), the GT-less init's search (64 candidates)
NBR_BATCHES = (16, 8, 32, 12, 64)


def _nbr_cloud(B, N, seed, device, strided=False):
    """B clouds of N points in a box of side 0.6 (the radii's scale);
    `strided`: a [B, N, 3] view of [B, 3, N], CoordNet's cloud."""
    rng = np.random.RandomState(seed)
    planes = torch.from_numpy(((rng.rand(B, 3, N) - 0.5) * 0.6)
                              .astype(np.float32)).to(device)
    xyz = planes.transpose(1, 2)
    return xyz if strided else xyz.contiguous()


def _nbr_centres(xyz, S):
    return ops.gather_xyz(xyz, ops.farthest_point_sample(xyz.contiguous(),
                                                         S))


def _through_the_chain(mp):
    """Run a backbone's neighbour searches through the chain the kernels
    replaced: `pointops.ball_query` a radius (its product a radius),
    `pointops.three_nn`."""
    from captra_tpu_torch.ops import neighbors, pointops

    def ball_query_stage(radii, nsamples, xyz, new_xyz):
        return [pointops.ball_query(r, k, xyz, new_xyz)
                for r, k in zip(radii, nsamples)]
    mp.setattr(neighbors, "ball_query_stage", ball_query_stage)
    mp.setattr(neighbors, "three_nn_stage", pointops.three_nn)


def _equal_or_nan(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("B", NBR_BATCHES)
@pytest.mark.parametrize("stage,strided", [("sa1", False), ("sa1", True),
                                           ("sa2", False)])
def test_nbr_ball_kernel_equals_the_chain_at_the_paths_shapes(card, B, stage,
                                                              strided):
    from captra_tpu_torch.config.presets import nocs_bottle
    from captra_tpu_torch.ops import neighbors, pointops
    pn = nocs_bottle().pointnet
    cfg, N = (pn.sa1, 4096) if stage == "sa1" else (pn.sa2, pn.sa1.npoint)
    xyz = _nbr_cloud(B, N, B + N, card, strided)
    new_xyz = _nbr_centres(xyz, cfg.npoint)
    terms = pointops.distance_terms(new_xyz, xyz)
    got = neighbors.ball_query_cuda(*terms, cfg.radius_list,
                                    cfg.nsample_list)
    chain = [pointops.ball_query(r, k, xyz, new_xyz)
             for r, k in zip(cfg.radius_list, cfg.nsample_list)]
    plain = neighbors.ball_query_plain(*terms, cfg.radius_list,
                                       cfg.nsample_list)
    for g, c, p in zip(got, chain, plain):
        assert g.dtype == torch.int64 and torch.equal(g, c)
        assert torch.equal(g, p)


@pytest.mark.parametrize("B", NBR_BATCHES)
@pytest.mark.parametrize("stage,strided", [("fp1", False), ("fp1", True),
                                           ("fp2", False)])
def test_nbr_three_nn_kernel_equals_the_chain_at_the_paths_shapes(
        card, B, stage, strided):
    from captra_tpu_torch.ops import neighbors, pointops
    N, M = (4096, 512) if stage == "fp1" else (512, 128)
    xyz1 = _nbr_cloud(B, N, B + M, card, strided)
    xyz2 = _nbr_centres(xyz1, M)
    terms = pointops.distance_terms(xyz1, xyz2)
    d, i = neighbors.three_nn_cuda(*terms)
    want_d, want_i = pointops.three_nn(xyz1, xyz2)
    assert i.dtype == torch.int64 and torch.equal(i, want_i)
    assert d.dtype == torch.float32 and torch.equal(d, want_d)


@pytest.mark.parametrize("case", ["edge", "empty", "few", "ragged",
                                  "unaligned", "four_radii", "k_is_n"])
def test_nbr_ball_kernel_edges(card, case):
    from captra_tpu_torch.ops import neighbors, pointops
    radii, ks = (0.05, 0.1, 0.2), (32, 64, 128)
    if case == "edge":
        # exact arithmetic: d = 0.25 = r^2 for the points at 1.0 e_x
        xyz = torch.tensor([[[1.0, 0.0, 0.0], [1.0 + 2 ** -20, 0.0, 0.0],
                             [0.0, 3.0, 0.0], [1.0, 0.0, 0.0]] * 40],
                           device=card)
        new_xyz = torch.tensor([[[0.5, 0.0, 0.0], [1.0, 0.0, 0.0]]],
                               device=card)
        radii, ks = (0.5, 0.4999), (50, 3)
    else:
        xyz = _nbr_cloud(3, {"ragged": 1001, "few": 700}.get(case, 512), 9,
                         card)
        new_xyz = _nbr_centres(xyz, 37)
        if case == "empty":
            new_xyz = new_xyz + 10.0
        elif case == "few":
            radii = (0.005, 0.01, 0.02)
        elif case == "four_radii":
            radii, ks = (0.02, 0.05, 0.1, 0.3), (1, 5, 64, 100)
        elif case == "k_is_n":
            radii, ks = (0.1, 2.0), (512, 512)
    terms = list(pointops.distance_terms(new_xyz, xyz))
    if case == "unaligned":
        # the product one float past a 16-byte boundary: scalar loads
        off = torch.empty(terms[0].numel() + 1, device=card)[1:]
        terms[0] = off.view(terms[0].shape).copy_(terms[0])
        assert terms[0].data_ptr() % 16
    got = neighbors.ball_query_cuda(*terms, radii, ks)
    want = neighbors.ball_query_plain(*terms, radii, ks)
    chain = [pointops.ball_query(r, k, xyz, new_xyz)
             for r, k in zip(radii, ks)]
    for g, w, c in zip(got, want, chain):
        assert torch.equal(g, w) and torch.equal(g, c)
    if case == "empty":
        assert all(bool((g == 0).all()) for g in got)
    if case == "edge":
        assert got[0][0, 0, :3].tolist() == [0, 3, 4]
        assert got[1][0, 0].tolist() == [0, 0, 0]


@pytest.mark.parametrize("case", ["ties", "m1", "m2", "m3", "ragged",
                                  "inf", "nan"])
def test_nbr_three_nn_kernel_edges(card, case):
    from captra_tpu_torch.ops import neighbors, pointops
    if case == "ties":
        g = torch.arange(4, dtype=torch.float32, device=card) * 0.25
        coarse = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1
                             ).reshape(1, -1, 3)
        xyz2 = torch.cat([coarse, coarse], 1)
        xyz1 = xyz2[:, :64] + torch.tensor([0.125, 0.0, 0.0], device=card)
    else:
        M = {"m1": 1, "m2": 2, "m3": 3, "ragged": 130}.get(case, 64)
        xyz1 = _nbr_cloud(2, 301, 11, card)
        xyz2 = _nbr_centres(xyz1, M)
    terms = list(pointops.distance_terms(xyz1, xyz2))
    if case in ("inf", "nan"):
        # distances of +inf (-2 x a product of -inf; fewer than 3 finite
        # entries in some rows) or NaN
        bad = float("-inf") if case == "inf" else float("nan")
        prod = terms[0]
        prod[:, ::3, 2:] = bad
        prod[:, 1::3, :] = bad
        prod[:, 2::7, 5] = bad
    d, i = neighbors.three_nn_cuda(*terms)
    want_d, want_i = neighbors.three_nn_plain(*(t.clone() for t in terms))
    assert torch.equal(i, want_i)
    _equal_or_nan(d, want_d)
    if case not in ("inf", "nan"):
        chain_d, chain_i = pointops.three_nn(xyz1, xyz2)
        assert torch.equal(i, chain_i) and torch.equal(d, chain_d)


def test_nbr_kernels_refuse_what_they_cannot_take(card):
    from captra_tpu_torch.ops import neighbors, pointops
    xyz = _nbr_cloud(1, 64, 0, card)
    prod, rs, cs = pointops.distance_terms(xyz[:, :4].contiguous(), xyz)
    with pytest.raises(ValueError, match="CUDA"):
        neighbors.ball_query_cuda(prod.cpu(), rs.cpu(), cs.cpu(), (0.1,),
                                  (4,))
    with pytest.raises(TypeError):
        neighbors.three_nn_cuda(prod.double(), rs, cs)
    with pytest.raises(ValueError, match="contiguous"):
        neighbors.three_nn_cuda(prod.transpose(1, 2).contiguous()
                                .transpose(1, 2), rs, cs)
    with pytest.raises(ValueError, match="1..N"):
        neighbors.ball_query_cuda(prod, rs, cs, (0.1,), (65,))
    with pytest.raises(ValueError, match="radii"):
        neighbors.ball_query_cuda(prod, rs, cs, (0.1,) * 5, (4,) * 5)
    with pytest.raises(ValueError, match="agree"):
        neighbors.three_nn_cuda(prod, rs, cs[:, :8].contiguous())


@pytest.mark.parametrize("use_xyz_feat", [True, False])
def test_nbr_backbone_launches_a_kernel_a_stage(card, use_xyz_feat,
                                                monkeypatch):
    # the pointnet2_camera backbone as the tracker calls it (CoordNet's
    # cloud a [B, N, 3] view of [B, 3, N]) against the same net through the
    # chain: equal bit for bit; a cloud that takes a gradient keeps the
    # ball-query kernel (its clouds detached) and takes the 3-NN's twin
    from captra_tpu_torch.config.presets import nocs_bottle
    from captra_tpu_torch.models.backbone import PointNet2Msg
    from captra_tpu_torch.ops import neighbors
    torch.manual_seed(0)
    net = PointNet2Msg(nocs_bottle().pointnet, 128,
                       use_xyz_feat=use_xyz_feat).to(card).eval()
    xyz = _nbr_cloud(2, 4096, 3, card, strided=use_xyz_feat)
    cuda_build.reset_launch_counts()
    with torch.no_grad():
        got = net(xyz)
    assert neighbors.launch_counts == {"ball_query_cuda": 2,
                                       "three_nn_cuda": 2}
    with monkeypatch.context() as mp, torch.no_grad():
        _through_the_chain(mp)
        want = net(xyz)
    assert torch.equal(got, want)
    grad_xyz = xyz.detach().clone().requires_grad_(True)
    got = net(grad_xyz)
    assert neighbors.launch_counts == {"ball_query_cuda": 4,
                                       "three_nn_cuda": 2}
    with monkeypatch.context() as mp:
        _through_the_chain(mp)
        want = net(grad_xyz)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell", ["bottle_points_b16", "drawers_points_b8"])
def test_track_step_with_the_neighbour_kernels_equals_the_chain(
        card, cell, monkeypatch):
    """The benchmark's nets and traffic cut to 2 streams: a tracking step
    with the neighbour kernels against the same step through the chain
    (the path before the kernels), frame by frame from the same carried
    pose: every output equal bit for bit, so every gap the benchmark
    measures (port_bench/limits) equals the chain's."""
    from port_bench.drivers import track
    from port_bench.harness import Clock, Context, find_cell, load_spec

    from captra_tpu_torch.ops import neighbors
    c = find_cell(load_spec(), cell)
    c.traffic = dict(c.traffic, streams=2, frames=4)
    ctx = Context(cell=c, seed=2 ** 31 + 7, seconds=0.0, trace=False,
                  device=card, clock=Clock(), log=lambda msg: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    s = track.setup(ctx)
    loop, ranges = s["loop"], s["ranges"]
    cuda_build.reset_launch_counts()
    for _ in range(3):
        pose_in, f = loop.pose, loop.f
        got = loop.advance(ranges)
        launched = dict(neighbors.launch_counts)
        with monkeypatch.context() as mp:
            _through_the_chain(mp)
            ref_new, ref_aux = _eager_step(s, c, card, pose_in, f)
        assert neighbors.launch_counts == launched
        new, aux = got[2], got[3]
        for name, a, b in (("seg", aux.seg, ref_aux.seg),
                           ("nocs", aux.nocs, ref_aux.nocs),
                           ("rotation", new.rotation, ref_new.rotation),
                           ("translation", new.translation,
                            ref_new.translation),
                           ("scale", new.scale, ref_new.scale)):
            print(f"frame {f} {name}: max |diff| "
                  f"{float((a.double() - b.double()).abs().max()):.3g}")
            assert torch.equal(a, b), name
    # CoordNet's and RotNet's two ball-query and two 3-NN stages a step
    assert neighbors.launch_counts == {"ball_query_cuda": 3 * 2 * 2,
                                       "three_nn_cuda": 3 * 2 * 2}


# ---------------------------------------------------------------------------
# the kernels' one launch registry (ops/cuda_build.py)
# ---------------------------------------------------------------------------

def _total(span, name):
    return span["counters"].get(name, 0) + sum(
        _total(child, name) for child in span["children"])


def test_a_replayed_step_counts_the_launches_of_a_traced_one(card, tmp_path):
    """The benchmark's bottle nets and traffic cut to 2 streams: one step
    traced (a recording profiler keeps it eager), then the same step called
    until it replays its graph: the one launch registry grows alike for
    the traced and the replayed call, kernel by kernel, and each traced net
    pass counts 5 fused scales of 5 (2 of them factored, from 1 table) and
    4 fused neighbour stages of 4."""
    from port_bench.drivers import track
    from port_bench.harness import Clock, Context, find_cell, load_spec

    from captra_tpu_torch.tracking import tracker
    from captra_tpu_torch.utils import profiling
    c = find_cell(load_spec(), "bottle_points_b16")
    c.traffic = dict(c.traffic, streams=2, frames=4)
    ctx = Context(cell=c, seed=2 ** 31 + 22, seconds=0.0, trace=False,
                  device=card, clock=Clock(), log=lambda msg: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    s = track.setup(ctx)
    pcfg = track.port_config(c.config, c.traffic.get("track", {}))
    step = tracker.make_track_step(pcfg, *s["nets"], device=card)
    pose = s["loop"].pose
    frame = {k: v[1] for k, v in s["frames"].items()}

    def launched():
        cuda_build.reset_launch_counts()
        step(pose, frame)
        torch.cuda.synchronize()
        return {k: n for k, n in cuda_build.launch_counts.items() if n}
    profiling.reset()
    with profiling.trace(str(tmp_path)):
        traced = launched()
    root, = profiling.last_steps("track.step", 1)
    profiling.reset()
    step(pose, frame)                 # the signature's first call: eager
    step(pose, frame)                 # captured
    replays = tracker.graph_counts["replayed"]
    replayed = launched()
    assert tracker.graph_counts["replayed"] == replays + 1
    assert replayed == traced
    nets = [n for n in root["children"]
            if n["name"] in ("track.coordnet", "track.rotnet")]
    assert len(nets) >= 2
    for net in nets:
        assert {k: _total(net, k) for k in (
            "sa_scales", "sa_fused", "sa_factored", "nbr_stages",
            "nbr_fused")} == {"sa_scales": 5, "sa_fused": 5,
                              "sa_factored": 2, "nbr_stages": 4,
                              "nbr_fused": 4}
    assert traced["sa_mlp_cuda"] == 5 * len(nets)
    assert traced["sa_table_cuda"] == len(nets)
    assert traced["ball_query_cuda"] == traced["three_nn_cuda"] \
        == 2 * len(nets)
