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


@pytest.mark.parametrize("name,B,N,npoint", [
    ("fps_cuda_batched", 9, 700, 40),      # one partly filled thread
    ("fps_cuda_batched", 8, 8192, 64),     # the batched kernel's bound
    ("fps_cuda_wide", 1, 1024, 128),
    ("fps_cuda_wide", 2, 1100, 48),        # ragged N
    ("fps_cuda_wide", 1, 16384, 256),      # the wide kernel's bound
])
def test_kernel_matches_plain(card, name, B, N, npoint):
    xyz = _cloud(B + N, B, N, card)
    got = getattr(fps, name)(xyz, npoint)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    assert torch.equal(got, fps.fps_plain(xyz, npoint))


@pytest.mark.parametrize("name", ["fps_cuda_batched", "fps_cuda_wide"])
def test_kernel_refuses_clouds_above_its_bound(card, name):
    bound = fps.max_points(name)
    with pytest.raises(ValueError, match="at most"):
        getattr(fps, name)(_cloud(0, 1, bound + 1, card), 8)


@pytest.mark.parametrize("B,N,kernel", [(1, 4096, "fps_cuda_wide"),
                                        (1, 512, "fps_cuda_batched"),
                                        (8, 4096, "fps_cuda_batched")])
def test_dispatch_counts_the_kernel_it_launches(card, B, N, kernel):
    fps.reset_launch_counts()
    idx = ops.farthest_point_sample(_cloud(1, B, N, card), 64)
    torch.cuda.synchronize()
    assert idx.shape == (B, 64)
    assert fps.launch_counts[kernel] == 1
    assert sum(fps.launch_counts.values()) == 1


def test_grouped_mode_matches_plain(card):
    xyz = _cloud(2, 2, 4096, card)
    got = ops.farthest_point_sample(xyz, 512, mode="grouped")
    want = ops.farthest_point_sample(xyz.cpu(), 512, mode="grouped")
    assert torch.equal(got.cpu(), want)
