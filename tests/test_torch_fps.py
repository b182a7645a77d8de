"""The port's plain FPS against the JAX package's: bit-identical picks.

The CUDA kernels (fps_cuda_batched, fps_cuda_wide) are held against this
same plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py; here the plain version is held against the Pallas kernels in
interpret mode, in both of their layouts, and against the XLA loop, exact
and grouped."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu import ops as jops
from captra_tpu.ops.fps_pallas import fps_pallas_t
from captra_tpu_torch import ops
from captra_tpu_torch.ops import fps


def _planes(xyz):
    return jnp.asarray(np.swapaxes(xyz, -1, -2))


@pytest.mark.parametrize("B,N,npoint", [
    (8, 512, 32),     # packed layout (_fps_kernel)
    (1, 1024, 64),    # wide layout (_fps_wide_kernel)
    (2, 1024, 48),
    (1, 1100, 48),    # wide with a ragged N (padded with point 0 in JAX)
    (2, 1100, 64),
])
def test_plain_fps_matches_pallas_interpret(B, N, npoint):
    xyz = np.random.RandomState(B * 7 + N).randn(B, N, 3).astype(np.float32)
    want = np.asarray(fps_pallas_t(_planes(xyz), npoint, interpret=True))
    got = fps.fps_plain(torch.from_numpy(xyz), npoint)
    assert got.dtype == torch.int32 and got.shape == (B, npoint)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["exact", "grouped"])
@pytest.mark.parametrize("npoint", [8, 64])
def test_farthest_point_sample_matches_xla(mode, npoint):
    xyz = np.random.RandomState(1).randn(3, 256, 3).astype(np.float32)
    want = np.asarray(jops.farthest_point_sample(
        jnp.asarray(xyz), npoint, use_pallas=False, mode=mode))
    got = ops.farthest_point_sample(torch.from_numpy(xyz), npoint, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)


def test_grouped_planes_matches_xla():
    from captra_tpu.ops.pointops import farthest_point_sample_grouped_t
    xyz = np.random.RandomState(2).randn(2, 512, 3).astype(np.float32)
    want = np.asarray(farthest_point_sample_grouped_t(
        _planes(xyz), 64, use_pallas=False))
    got = ops.farthest_point_sample_grouped_t(
        torch.from_numpy(np.swapaxes(xyz, -1, -2).copy()), 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ties_take_the_smallest_index():
    # duplicated points make exact ties in the running min
    base = np.random.RandomState(3).randn(1, 16, 3).astype(np.float32)
    xyz = np.concatenate([base, base, base], axis=1)
    want = np.asarray(fps_pallas_t(_planes(xyz), 24, interpret=True))
    got = fps.fps_plain(torch.from_numpy(xyz), 24).numpy()
    np.testing.assert_array_equal(got, want)
    # every first copy before any second copy; then all-zero distances
    assert sorted(got[0, :16]) == list(range(16))
    assert (got[0, 16:] == 0).all()


def test_cpu_tensor_dispatches_to_plain(monkeypatch):
    calls = []
    monkeypatch.setattr(fps, "fps_plain",
                        lambda x, n: calls.append((tuple(x.shape), n))
                        or torch.zeros(x.shape[0], n, dtype=torch.int32))
    fps.reset_launch_counts()
    ops.farthest_point_sample(torch.zeros(2, 2048, 3), 16)
    assert calls == [((2, 2048, 3), 16)]
    assert fps.launch_counts == {"fps_cuda_batched": 0, "fps_cuda_wide": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 1024, 3)
    for kernel in (fps.fps_cuda_batched, fps.fps_cuda_wide):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(x, 8)

