"""The port's host data core (`captra_tpu_torch/data/native.py`, built by
g++ from `csrc/pointops_host.cpp`) and `data/numpy_ops.py` against the JAX
package's (`captra_tpu/data/native.py`, `numpy_ops.py`).

Tolerances: FPS indices equal to the JAX core's and to the plain numpy
sweep, on clouds that include wrap-filled duplicates and exact ties; PNG
unfiltering the exact inverse of the specification's filters; the numpy
ops' outputs and their random draws equal on the same seeds.  A failed
build or load raises."""
import os

import numpy as np
import pytest

from captra_tpu.data import native as jnative
from captra_tpu.data import numpy_ops as jnops
from captra_tpu_torch.data import native, numpy_ops
from captra_tpu_torch.ops import cuda_build
from tests.torch_port_helpers import png_filter_row


def _cloud(kind, rng, n):
    if kind == "gauss":
        return rng.randn(n, 3).astype(np.float32)
    if kind == "wrap":            # the readers' duplicate-to-num_points fill
        base = rng.randn(n // 5, 3).astype(np.float32)
        return np.concatenate([base] * 5 + [base[:n - 5 * len(base)]])
    if kind == "grid":            # exact distance ties
        side = int(np.ceil(n ** (1 / 3)))
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
        return (g.reshape(-1, 3)[rng.permutation(side ** 3)[:n]]
                .astype(np.float32) * 0.1)
    return np.repeat(rng.randn(1, 3).astype(np.float32), n, axis=0)


@pytest.mark.parametrize("kind", ["gauss", "wrap", "grid", "equal"])
@pytest.mark.parametrize("n,npoint", [(700, 64), (2000, 300)])
def test_fps_equals_jax_core_and_numpy(kind, n, npoint):
    xyz = _cloud(kind, np.random.RandomState(n), n)
    got = native.fps(xyz, npoint)
    assert got.dtype == np.int64 and got.shape == (npoint,)
    np.testing.assert_array_equal(got, jnative.fps(xyz, npoint))
    np.testing.assert_array_equal(got, numpy_ops._fps_numpy(xyz, npoint))
    np.testing.assert_array_equal(
        native.fps(xyz, npoint, start=5), jnative.fps(xyz, npoint, start=5))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_inverts_every_filter(bpp):
    """Rows filtered byte by byte with filters 0-4 in a random order (flat
    runs included, where the predictors tie) come back exactly."""
    rng = np.random.RandomState(bpp)
    rows = rng.randint(0, 256, (12, 5 * bpp)).astype(np.uint8)
    rows[3:6, :2 * bpp] = rows[2, :2 * bpp]
    kinds = rng.permutation(np.arange(12) % 5)
    raw, prev = b"", bytes(rows.shape[1])
    for kind, row in zip(kinds, rows):
        raw += bytes([kind]) + png_filter_row(kind, row.tobytes(), prev, bpp)
        prev = row.tobytes()
    got = native.png_unfilter(raw + b"tail", len(rows), rows.shape[1], bpp)
    assert got.dtype == np.uint8 and got.shape == rows.shape
    np.testing.assert_array_equal(got, rows)


def test_bad_input_raises():
    with pytest.raises(ValueError, match="fps"):
        native.fps(np.zeros((0, 3), np.float32), 4)
    raw = bytes([0, 1, 2, 3, 4, 1, 3, 0, 5, 9])   # None Up Paeth Average
    assert native.png_unfilter(raw[:8], 4, 1, 1).tolist() == [[1], [4], [5],
                                                             [2]]
    with pytest.raises(ValueError, match="unknown PNG filter 5 in row 4"):
        native.png_unfilter(raw, 5, 1, 1)
    with pytest.raises(ValueError, match="too short"):
        native.png_unfilter(raw[:7], 4, 1, 1)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """A build directory and source directory of the test's own, and no
    loaded host core."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path / "csrc"))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(native, "_LIB", None)
    os.makedirs(tmp_path / "csrc")
    return tmp_path


def test_build_failure_raises_with_the_compiler_output(fresh_build):
    (fresh_build / "csrc" / native.SOURCE).write_text(
        "extern \"C\" void captra_host_fps( {\n")
    with pytest.raises(RuntimeError, match="build failed for "
                       "pointops_host.cpp:(.|\n)*error"):
        native.fps(np.zeros((8, 3), np.float32), 2)


def test_missing_compiler_raises(fresh_build, monkeypatch):
    with open(os.path.join(os.path.dirname(cuda_build.__file__), "..",
                           "csrc", native.SOURCE)) as f:
        (fresh_build / "csrc" / native.SOURCE).write_text(f.read())
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.lib()


def test_build_is_named_by_source_and_flags():
    src, lib = cuda_build._target(native.SOURCE)
    assert src.endswith(os.path.join("csrc", "pointops_host.cpp"))
    assert lib.startswith(cuda_build.BUILD_DIR)
    assert "-ffp-contract=off" in cuda_build.HOST_FLAGS
    native.lib()
    assert os.path.exists(lib)


@pytest.mark.parametrize("n", [300, 5000])
def test_farthest_point_sample_equals_jax(n):
    """With and without the 5x random pre-subsample: the same indices and
    the same draws (the generators end in the same state)."""
    xyz = np.random.RandomState(n).randn(n, 3).astype(np.float32)
    got_rng, want_rng = np.random.RandomState(9), np.random.RandomState(9)
    got = numpy_ops.farthest_point_sample(xyz, 256, got_rng)
    want = jnops.farthest_point_sample(xyz, 256, want_rng)
    np.testing.assert_array_equal(got, want)
    assert got_rng.randint(1 << 30) == want_rng.randint(1 << 30)


@pytest.mark.parametrize("radius,num_points", [(0.3, 64), (0.01, 64),
                                               (1e-4, 32), (0.8, 128)])
def test_crop_ball_from_pts_equals_jax(radius, num_points):
    rng = np.random.RandomState(2)
    pts = (rng.randn(400, 3) * 0.3).astype(np.float32)
    center = pts[7] + 0.01
    got = numpy_ops.crop_ball_from_pts(pts, center, radius, num_points,
                                       np.random.RandomState(4))
    want = jnops.crop_ball_from_pts(pts, center, radius, num_points,
                                    np.random.RandomState(4))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["normal", "uniform", "exact"])
def test_random_vectors_equal_jax(kind):
    for shape in ((), (4,), (2, 3)):
        np.testing.assert_array_equal(
            numpy_ops.random_vector(0.1, shape, kind,
                                    np.random.RandomState(1)),
            jnops.random_vector(0.1, shape, kind, np.random.RandomState(1)))
        np.testing.assert_array_equal(
            numpy_ops.random_translation(0.1, shape, kind,
                                         np.random.RandomState(1)),
            jnops.random_translation(0.1, shape, kind,
                                     np.random.RandomState(1)))
    with pytest.raises(ValueError, match="unsupported"):
        numpy_ops.random_vector(0.1, (2,), "cauchy", np.random.RandomState())
