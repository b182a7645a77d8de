"""The port's articulated offline preprocessing
(`captra_tpu_torch/data/preproc_arti.py`) and PNG writer
(`data/image_io.write_png`) against the JAX package and OpenCV.

Tolerances: none.  `point_cloud_from_depth`, `bmvc_frame` (the same
`RandomState`, generators left in the same state) and
`process_capture_pickle`'s npz files equal the JAX package's bit for bit;
every PNG the port writes decodes, under `cv2.imread(path, -1)`, under
`cv2.imread(path)` and under the port's `read_png`, to the pixels of the
file `cv2.imwrite` writes from the same array (the bytes differ: the
compression is not OpenCV's)."""
import os
import pickle
from os.path import join as pjoin

import numpy as np
import pytest

from captra_tpu.data import preproc_arti as jarti
from captra_tpu_torch.data import preproc_arti as arti
from captra_tpu_torch.data.image_io import read_png, write_png
from tests.torch_port_helpers import assert_tree_equal, random_rotation

cv2 = pytest.importorskip("cv2")

K = np.array([[100.0, 0, 20], [0, 100.0, 15], [0, 0, 1]])


def _scene(rng):
    depth = rng.uniform(0.8, 1.6, (30, 40))
    depth[rng.rand(30, 40) < 0.1] = 0.0
    m0 = np.zeros((30, 40))
    m0[3:17, 4:22] = 1
    m1 = np.zeros((30, 40))
    m1[15:28, 18:36] = 1
    return depth, [m0, m1]


def test_point_cloud_from_depth_equals_jax():
    depth, _ = _scene(np.random.RandomState(0))
    got = arti.point_cloud_from_depth(depth, K)
    want = jarti.point_cloud_from_depth(depth, K)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_points", [None, 100])
def test_bmvc_frame_equals_jax(num_points):
    rng = np.random.RandomState(1)
    depth, masks = _scene(rng)
    poses = {}
    for p in range(2):
        mat = np.eye(4)
        mat[:3, :3] = random_rotation(rng)
        mat[:3, 3] = rng.randn(3) * 0.1
        poses[p] = mat
    info = {"corner": [[rng.uniform(-1, -0.5, 3), rng.uniform(0.5, 1, 3)]
                       for _ in range(2)], "factor": [0.5, 0.7]}
    got_rng, want_rng = np.random.RandomState(2), np.random.RandomState(2)
    got = arti.bmvc_frame(depth, masks, poses, info, K, num_points, got_rng)
    want = jarti.bmvc_frame(depth, masks, poses, info, K, num_points,
                            want_rng)
    assert_tree_equal(got, want)
    if num_points:
        assert np.bincount(want["labels"]).tolist() == [num_points] * 2
    assert got_rng.randint(1 << 30) == want_rng.randint(1 << 30)


def _decoded_equal(port_path, cv2_path):
    for flag in (-1, cv2.IMREAD_COLOR):
        got, want = cv2.imread(port_path, flag), cv2.imread(cv2_path, flag)
        assert got.dtype == want.dtype and got.shape == want.shape, flag
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(read_png(port_path, flag == -1), want)


def test_process_capture_pickle_equals_jax(tmp_path):
    """Three frames, the second without an image: the npz files equal the
    JAX package's, and each RGB PNG decodes to the JAX-written file's
    pixels."""
    rng = np.random.RandomState(3)
    raw = list(rng.randn(3, 12, 16, 3).astype(np.float32))
    images = [rng.randint(0, 256, (12, 16, 3)).astype(np.uint8), None,
              rng.randint(0, 256, (12, 16, 3)).astype(np.uint8)]
    pkl = str(tmp_path / "0_kinect2.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"point_cloud": raw, "image": images}, f)
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert arti.process_capture_pickle(pkl, got_dir) == 3
    assert jarti.process_capture_pickle(pkl, want_dir) == 3
    for sub in ("cloud", "rgb"):
        assert sorted(os.listdir(pjoin(got_dir, sub))) == sorted(
            os.listdir(pjoin(want_dir, sub)))
    assert sorted(os.listdir(pjoin(got_dir, "rgb"))) == ["0.png", "2.png"]
    for i in range(3):
        got = np.load(pjoin(got_dir, "cloud", f"{i}.npz"))["point"]
        want = np.load(pjoin(want_dir, "cloud", f"{i}.npz"))["point"]
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for i in (0, 2):
        _decoded_equal(pjoin(got_dir, "rgb", f"{i}.png"),
                       pjoin(want_dir, "rgb", f"{i}.png"))


@pytest.mark.parametrize("shape,dtype", [((37, 53), np.uint8),
                                         ((37, 53), np.uint16),
                                         ((21, 30, 3), np.uint8),
                                         ((21, 30, 3), np.uint16),
                                         ((1, 1), np.uint16)])
def test_write_png_decodes_as_cv2_imwrite(tmp_path, shape, dtype):
    """Grey 8 and 16 bits and BGR 8 and 16 bits (full-range samples, and
    runs where the Up filter leaves zeros) round-trip as OpenCV's own
    file does."""
    rng = np.random.RandomState(len(shape))
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    img[: shape[0] // 2] = img[:1]
    port_path, cv2_path = str(tmp_path / "port.png"), str(tmp_path / "cv.png")
    write_png(port_path, img)
    assert cv2.imwrite(cv2_path, img)
    _decoded_equal(port_path, cv2_path)
    np.testing.assert_array_equal(read_png(port_path, unchanged=True), img)


def test_write_png_refuses_other_images(tmp_path):
    for img in (np.zeros((4, 4), np.float32), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 2), np.uint8), np.zeros(4, np.uint8)):
        with pytest.raises(ValueError, match="write_png"):
            write_png(str(tmp_path / "x.png"), img)
    assert not os.path.exists(tmp_path / "x.png")
