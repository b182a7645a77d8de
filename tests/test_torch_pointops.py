"""The port's point ops against the JAX package's (exact routes).

Indices must match exactly; floats at atol 1e-5 (the [B, S, 3] x [B, 3, N]
distance matmul may round differently in the last bit)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu import ops as jops
from captra_tpu_torch import ops

ATOL = 1e-5


def _pair(rng, B=2, N=256, S=32):
    xyz = rng.rand(B, N, 3).astype(np.float32)
    return xyz, xyz[:, :S].copy()


def test_square_distance():
    rng = np.random.RandomState(0)
    a, b = rng.randn(2, 30, 3).astype(np.float32), rng.randn(
        2, 20, 3).astype(np.float32)
    np.testing.assert_allclose(
        ops.square_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jops.square_distance(jnp.asarray(a), jnp.asarray(b))),
        atol=ATOL)


@pytest.mark.parametrize("radius,nsample", [(0.05, 8), (0.1, 16),
                                            (0.2, 32), (0.4, 64)])
def test_ball_query_matches_jax(radius, nsample):
    xyz, q = _pair(np.random.RandomState(1))
    want = np.asarray(jops.ball_query(radius, nsample, jnp.asarray(xyz),
                                      jnp.asarray(q), method="exact"))
    got = ops.ball_query(radius, nsample, torch.from_numpy(xyz),
                         torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ball_query_no_hits_pads_with_zero():
    xyz = torch.ones(1, 16, 3) * 100.0
    got = ops.ball_query(0.1, 4, xyz, torch.zeros(1, 2, 3))
    assert (got == 0).all()


@pytest.mark.parametrize("with_feats", [True, False])
def test_ball_group_matches_jax(with_feats):
    rng = np.random.RandomState(2)
    xyz, q = _pair(rng)
    feats = rng.randn(2, 256, 5).astype(np.float32) if with_feats else None
    want = np.asarray(jops.ball_group(
        0.2, 16, jnp.asarray(xyz), jnp.asarray(q),
        None if feats is None else jnp.asarray(feats), method="exact"))
    got = ops.ball_group(0.2, 16, torch.from_numpy(xyz), torch.from_numpy(q),
                         None if feats is None else torch.from_numpy(feats))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_three_nn_matches_jax():
    rng = np.random.RandomState(3)
    xyz1 = rng.randn(2, 200, 3).astype(np.float32)
    xyz2 = rng.randn(2, 24, 3).astype(np.float32)
    jd, ji = jops.three_nn(jnp.asarray(xyz1), jnp.asarray(xyz2))
    d, i = ops.three_nn(torch.from_numpy(xyz1), torch.from_numpy(xyz2))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL)


def test_interpolations_match_jax():
    rng = np.random.RandomState(4)
    B, M, C, N = 2, 24, 7, 40
    feats = rng.randn(B, M, C).astype(np.float32)
    idx = rng.randint(0, M, (B, N, 3))
    w = rng.rand(B, N, 3).astype(np.float32)
    np.testing.assert_allclose(
        ops.three_interp_rows(torch.from_numpy(feats), torch.from_numpy(idx),
                              torch.from_numpy(w)).numpy(),
        np.asarray(jops.three_interp_rows(jnp.asarray(feats),
                                          jnp.asarray(idx), jnp.asarray(w),
                                          method="gather")), atol=ATOL)
    planes = np.swapaxes(feats, 1, 2).copy()
    np.testing.assert_allclose(
        ops.three_interpolate(torch.from_numpy(planes), torch.from_numpy(idx),
                              torch.from_numpy(w)).numpy(),
        np.asarray(jops.three_interpolate(jnp.asarray(planes),
                                          jnp.asarray(idx), jnp.asarray(w))),
        atol=ATOL)


def test_gathers_match_jax():
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 4, 32).astype(np.float32)
    idx = rng.randint(0, 32, (2, 8))
    gidx = rng.randint(0, 32, (2, 8, 5))
    f, i, g = (torch.from_numpy(a) for a in (feats, idx, gidx))
    np.testing.assert_array_equal(
        ops.gather_points(f, i).numpy(),
        np.asarray(jops.gather_points(jnp.asarray(feats), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        ops.group_points(f, g).numpy(),
        np.asarray(jops.group_points(jnp.asarray(feats), jnp.asarray(gidx))))
    xyz = np.swapaxes(feats[:, :3], 1, 2).copy()
    np.testing.assert_array_equal(
        ops.gather_xyz(torch.from_numpy(xyz), i).numpy(),
        np.asarray(jops.gather_xyz(jnp.asarray(xyz), jnp.asarray(idx))))
