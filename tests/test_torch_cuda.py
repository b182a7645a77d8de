"""The CUDA FPS kernels on the card, against the plain PyTorch FPS.

These tests need an NVIDIA card and the CUDA toolkit: the kernels have no
CPU mode, so without a card each test skips with that reason.  This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda -o addopts="" -q
"""
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


def _tie_cloud(kind, B, N, seed, device):
    """Exact distance ties: a shuffled integer grid, or a cloud repeated
    three times (cut to N points)."""
    rng = np.random.RandomState(seed)
    if kind == "grid":
        side = int(np.ceil(N ** (1 / 3)))
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
        g = g.reshape(-1, 3).astype(np.float32) * 0.1
        clouds = [g[rng.permutation(len(g))[:N]] for _ in range(B)]
    else:
        base = rng.randn(B, -(-N // 3), 3).astype(np.float32)
        clouds = np.concatenate([base, base, base], axis=1)[:, :N]
    return torch.from_numpy(np.ascontiguousarray(np.stack(clouds))).to(device)


@pytest.mark.parametrize("name,B,N,npoint", [
    ("fps_cuda_batched", 9, 700, 40),      # one partly filled thread
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
])
def test_kernel_matches_plain(card, name, B, N, npoint):
    xyz = _cloud(B + N, B, N, card)
    got = getattr(fps, name)(xyz, npoint)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    assert torch.equal(got, fps.fps_plain(xyz, npoint))


@pytest.mark.parametrize("name,B,N,npoint", [
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
    assert fps.cluster_size("fps_cuda_wide", 20480) == 2
    assert fps.cluster_size("fps_cuda_batched", 20480) == 4
    assert fps.cluster_size("fps_cuda_wide", fps.max_points("fps_cuda_wide")
                            + 1) == 0


def test_grouped_mode_matches_plain(card):
    xyz = _cloud(2, 2, 4096, card)
    got = ops.farthest_point_sample(xyz, 512, mode="grouped")
    want = ops.farthest_point_sample(xyz.cpu(), 512, mode="grouped")
    assert torch.equal(got.cpu(), want)
