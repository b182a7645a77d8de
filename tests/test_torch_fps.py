"""The port's plain FPS against the JAX package's: bit-identical picks.

The CUDA kernels (fps_cuda_batched, fps_cuda_wide and their cluster
launches, fps_cuda_blocked) are held against this same plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py; here the plain version
is held against the Pallas kernels in interpret mode, in all three of their
layouts, and against the XLA loop, exact and grouped."""
import fps_edge_clouds
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu import ops as jops
from captra_tpu.ops.fps_pallas import fps_pallas_blocked_t, fps_pallas_t
from captra_tpu_torch import ops
from captra_tpu_torch.ops import cuda_build, fps


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


@pytest.mark.parametrize("B,N,npoint", [
    (1, 1100, 64),    # ragged: padded with point 0 to 2 tiles in JAX
    (2, 2048, 128),
])
def test_plain_fps_matches_blocked_pallas_interpret(B, N, npoint):
    xyz = np.random.RandomState(B * 11 + N).randn(B, N, 3).astype(np.float32)
    want = np.asarray(fps_pallas_blocked_t(_planes(xyz), npoint,
                                           interpret=True))
    got = fps.fps_plain(torch.from_numpy(xyz), npoint)
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


def _degenerate_cloud(kind, B, N, distinct, seed):
    """A wrap-fill cloud (`distinct` points, then copies of its point 7, as
    the OTF crop fills buckets with no in-ball pixel; "wrap0": copies of its
    point 0, as the crop's FPS output hands sa1) or an all-equal cloud."""
    rng = np.random.RandomState(seed)
    xyz = np.repeat(rng.randn(B, 1, 3).astype(np.float32), N, axis=1)
    if kind in ("wrap", "wrap0"):
        copied = 7 if kind == "wrap" else 0
        xyz[:, :distinct] = rng.randn(B, distinct, 3)
        xyz[:, distinct:] = xyz[:, copied:copied + 1]
    return xyz


@pytest.mark.parametrize("pallas", [fps_pallas_t, fps_pallas_blocked_t])
@pytest.mark.parametrize("kind", ["wrap", "equal", "wrap0"])
@pytest.mark.parametrize("B,N,npoint,distinct", [
    (1, 2048, 512, 60),
    (2, 1100, 64, 60),
    (8, 512, 128, 60),    # fps_pallas_t: the packed layout (_fps_kernel)
    (9, 512, 128, 60),    # ... padded to two tiles of 8 clouds
])
def test_plain_fps_matches_pallas_on_degenerate_clouds(pallas, kind, B, N,
                                                       npoint, distinct):
    xyz = _degenerate_cloud(kind, B, N, distinct, B + N)
    want = np.asarray(pallas(_planes(xyz), npoint, interpret=True))
    got = fps.fps_plain(torch.from_numpy(xyz), npoint).numpy()
    np.testing.assert_array_equal(got, want)
    # once every distinct point is picked, every minimum is 0 and every
    # later pick is index 0
    picked = min(distinct, npoint) if kind != "equal" else 1
    assert len(set(got[0, :picked])) == picked
    assert (got[:, picked:] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("order", ["scan", "shuffled"])
def test_plain_fps_matches_blocked_pallas_at_the_skip_edge(order, seed):
    # at pick 1, the lower bound of every row inside the cloud's blocks is
    # exactly on the row's max, one ulp above it or one ulp below it, for
    # the TPU kernel's rows of 128 points and any aligned row of up to 512;
    # shuffled, the same points make incoherent rows
    xyz = fps_edge_clouds.skip_edge_cloud(seed)
    if order == "shuffled":
        xyz = xyz[np.random.RandomState(seed).permutation(len(xyz))]
    else:
        for row in (32, 128, 256, 512):
            assert set(fps_edge_clouds.edge_offsets(xyz, row)) == {-1, 0, 1}
    want = np.asarray(fps_pallas_blocked_t(_planes(xyz[None]), 256,
                                           interpret=True))
    got = fps.fps_plain(torch.from_numpy(xyz[None].copy()), 256).numpy()
    np.testing.assert_array_equal(got, want)
    if order == "scan":
        assert list(got[0, :2]) == [0, 1]


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
    monkeypatch.setenv("CAPTRA_FPS_BLOCKED", "1")
    cuda_build.reset_launch_counts()
    ops.farthest_point_sample(torch.zeros(2, 2048, 3), 16)
    ops.farthest_point_sample(torch.zeros(1, 20480, 3), 16)
    assert calls == [((2, 2048, 3), 16), ((1, 20480, 3), 16)]
    assert set(fps.launch_counts) == {
        "fps_cuda_batched", "fps_cuda_wide", "fps_cuda_batched_cluster",
        "fps_cuda_wide_cluster", "fps_cuda_blocked"}
    assert not any(fps.launch_counts.values())


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("B,N,plain,opt_in", [
    (1, 20480, "fps_cuda_wide", "fps_cuda_blocked"),    # the OTF crop, B=1
    (1, 8192, "fps_cuda_wide", "fps_cuda_blocked"),
    (1, 24576, "fps_cuda_wide", "fps_cuda_blocked"),
    (1, 8191, "fps_cuda_wide", "fps_cuda_wide"),
    (1, 24577, "fps_cuda_wide", "fps_cuda_wide"),
    (7, 20480, "fps_cuda_wide", "fps_cuda_blocked"),
    (8, 20480, "fps_cuda_batched", "fps_cuda_batched"),  # the crop, B=8
    (1, 4096, "fps_cuda_wide", "fps_cuda_wide"),         # sa1 at B=1
    (1, 512, "fps_cuda_batched", "fps_cuda_batched"),    # sa2
    (8, 2560, "fps_cuda_batched", "fps_cuda_batched"),   # grouped crop
])
def test_route_mirrors_fps_pallas_t(B, N, plain, opt_in, blocked,
                                    monkeypatch):
    if blocked:
        monkeypatch.setenv("CAPTRA_FPS_BLOCKED", "1")
    else:
        monkeypatch.delenv("CAPTRA_FPS_BLOCKED", raising=False)
    assert fps.route(B, N) == (opt_in if blocked else plain)


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 1024, 3)
    for kernel in (fps.fps_cuda_batched, fps.fps_cuda_wide,
                   fps.fps_cuda_blocked):
        with pytest.raises(ValueError, match="CUDA"):
            kernel(x, 8)

