"""The port's offline NOCS preprocessing blocks
(`captra_tpu_torch/data/preproc_nocs.py`) against the JAX package's
(`captra_tpu/data/preproc_nocs.py`) on the same seeded inputs.

Tolerances: none.  The Umeyama fits and the RANSAC (same `RandomState`),
the PNG reads (files `cv2.imwrite` wrote), the backprojection (the port's
host core against the JAX package's, and the numpy path), the frame poses,
the instance crops and the instance occurrence scan are all equal bit for
bit."""
import os
from os.path import join as pjoin

import numpy as np
import pytest

from captra_tpu.data import preproc_nocs as jpp
from captra_tpu_torch.data import preproc_nocs as pp
from tests.torch_port_helpers import (
    NOCS_RAW_INSTANCES, assert_tree_equal, random_rotation, write_raw_nocs,
)

cv2 = pytest.importorskip("cv2")


def _pair(seed, n, noise=0.0):
    rng = np.random.RandomState(seed)
    R = random_rotation(rng)
    src = (rng.rand(n, 3) - 0.5) * 0.8
    tgt = 0.3 * src @ R.T + rng.randn(1, 3) * 0.1
    return src, tgt + rng.randn(n, 3) * noise


def test_umeyama_equals_jax():
    src, tgt = _pair(0, 4 * 50, noise=1e-3)
    src, tgt = src.reshape(4, 50, 3), tgt.reshape(4, 50, 3)
    for got, want in zip(pp.umeyama(src, tgt), jpp.umeyama(src, tgt)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,noise,th", [(200, 0.0, 1e-3), (300, 2e-3, 1e-3),
                                        (2, 0.0, 1e-3), (50, 0.5, 1e-4)])
def test_umeyama_ransac_equals_jax(n, noise, th):
    """Exact, noisy, too few points (None), no 3 inliers (None); the
    generators end in the same state."""
    src, tgt = _pair(n, n, noise)
    if n == 300:
        tgt[::4] += 0.5                                 # 25% gross outliers
    got_rng, want_rng = np.random.RandomState(5), np.random.RandomState(5)
    got = pp.umeyama_ransac(src, tgt, inlier_th=th, rng=got_rng)
    want = jpp.umeyama_ransac(src, tgt, inlier_th=th, rng=want_rng)
    if n == 2 or noise == 0.5:
        assert got is None and want is None
    else:
        assert want is not None
        assert_tree_equal(got, want)
    assert got_rng.randint(1 << 30) == want_rng.randint(1 << 30)


@pytest.mark.parametrize("layout", ["grey16", "composed"])
def test_read_depth_equals_jax(tmp_path, layout):
    rng = np.random.RandomState(1)
    depth = rng.randint(0, 4000, (40, 56)).astype(np.uint16)
    if layout == "composed":                    # CAMERA: G * 256 + R
        img = np.stack([rng.randint(0, 256, depth.shape), depth >> 8,
                        depth & 255], -1).astype(np.uint8)
    else:
        img = depth
    path = str(tmp_path / "d.png")
    cv2.imwrite(path, img)
    got, want = pp.read_depth(path), jpp.read_depth(path)
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, depth)


@pytest.mark.parametrize("flip", [False, True])
def test_read_coord_map_equals_jax(tmp_path, flip):
    img = np.random.RandomState(2).randint(0, 256, (40, 56, 3)).astype(
        np.uint8)
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, img)
    got, want = pp.read_coord_map(path, flip), jpp.read_coord_map(path, flip)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [0.001, 0.0005])
def test_backproject_equals_jax(scale):
    """The masked frame through both host cores; the unmasked one through
    both numpy paths (float64)."""
    rng = np.random.RandomState(3)
    depth = rng.randint(0, 3000, (480, 640)).astype(np.uint16)
    depth[rng.rand(480, 640) < 0.2] = 0
    mask = rng.rand(480, 640) < 0.5
    for K in (pp.REAL_INTRINSICS, pp.SYNTHETIC_INTRINSICS):
        for m in (mask, None):
            (got, gidx), (want, widx) = (
                pp.backproject(depth, K, m, scale),
                jpp.backproject(depth, K, m, scale))
            assert got.dtype == want.dtype == (
                np.float32 if m is not None else np.float64)
            np.testing.assert_array_equal(got, want)
            for g, w in zip(gidx, widx):
                np.testing.assert_array_equal(g, w)


def test_intrinsics_are_float64_and_jax_own():
    np.testing.assert_array_equal(pp.REAL_INTRINSICS, jpp.REAL_INTRINSICS)
    np.testing.assert_array_equal(pp.SYNTHETIC_INTRINSICS,
                                  jpp.SYNTHETIC_INTRINSICS)
    assert pp.REAL_INTRINSICS.dtype == np.float64


@pytest.fixture(scope="module")
def raw_frames(tmp_path_factory):
    """Two real frames and two mirrored CAMERA frames of the three
    instances (small blocks), the PNGs written by the port."""
    root = str(tmp_path_factory.mktemp("preproc_nocs"))
    write_raw_nocs(root, "real_test", ["scene_1"], 2, block=(40, 28))
    write_raw_nocs(root, "val", ["00000"], 2, block=(40, 28), seed=1)
    return root


def _read_frame(root, data_type, track, prefix, flip):
    """The frame as the JAX pipeline reads it (OpenCV)."""
    tdir = pjoin(root, "nocs_full", data_type, track)
    name = "depth" if data_type.startswith("real") else "composed"
    depth = jpp.read_depth(pjoin(tdir, f"{prefix}_{name}.png"))
    mask = cv2.imread(pjoin(tdir, f"{prefix}_mask.png"))[:, :, 2]
    coord = jpp.read_coord_map(pjoin(tdir, f"{prefix}_coord.png"), flip)
    if flip:
        depth, mask = depth[:, ::-1], mask[:, ::-1]
    return depth, mask, coord


@pytest.mark.parametrize("data_type,track,flip,K", [
    ("real_test", "scene_1", False, "REAL_INTRINSICS"),
    ("val", "00000", True, "SYNTHETIC_INTRINSICS")])
def test_frame_poses_and_crops_equal_jax(raw_frames, data_type, track, flip,
                                         K):
    """`frame_poses` (one RandomState a package, both frames in turn), then
    `crop_instance_frame` of each instance with its recovered pose and
    float32 corners, and with float64 corners (rounded to float32 before
    the box, as the JAX package's `jnp.asarray` does)."""
    K = getattr(pp, K)
    got_rng, want_rng = np.random.RandomState(0), np.random.RandomState(0)
    corners32 = np.array([[-0.3, -0.4, -0.3], [0.3, 0.4, 0.3]], np.float32)
    crops = 0
    for prefix in ("0000", "0001"):
        depth, mask, coord = _read_frame(raw_frames, data_type, track,
                                         prefix, flip)
        got = pp.frame_poses(depth, coord, mask, 3, K, rng=got_rng)
        want = jpp.frame_poses(depth, coord, mask, 3, K, rng=want_rng)
        assert sorted(want) == [1, 2, 3]
        assert_tree_equal(got, want)
        for n, pose in want.items():
            for corners in (corners32, corners32.astype(np.float64) * 1.01):
                g = pp.crop_instance_frame(depth, mask, n, pose, corners, K)
                w = jpp.crop_instance_frame(depth, mask, n, pose, corners, K)
                assert_tree_equal(g, w)
                assert w["labels"].any() and not w["labels"].all()
                crops += 1
    assert crops == 12


@pytest.mark.parametrize("real", [True, False])
def test_instance_occurrences_equal_jax(raw_frames, tmp_path, real):
    """The scan over the fixture's RGB masks, and over grey copies of them
    (a grey PNG reads as its value in every channel)."""
    data_type, track = ("real_test", "scene_1") if real else ("val", "00000")
    src = pjoin(raw_frames, "nocs_full", data_type)
    grey = tmp_path / "grey"
    os.makedirs(grey / track)
    for name in os.listdir(pjoin(src, track)):
        img = cv2.imread(pjoin(src, track, name), -1) \
            if name.endswith(".png") else None
        if name.endswith("_mask.png"):
            cv2.imwrite(str(grey / track / name), img[:, :, 2])
        elif name.endswith((".txt", "color.png")):
            with open(pjoin(src, track, name), "rb") as f:
                (grey / track / name).write_bytes(f.read())
    for root in (src, str(grey)):
        got = pp.instance_occurrences(root, [track, "missing"], real)
        want = jpp.instance_occurrences(root, [track, "missing"], real)
        assert got == want
        names = sorted(name for *_, name in NOCS_RAW_INSTANCES)
        assert sorted(k for v in want.values() for k in v) == names
