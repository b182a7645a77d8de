"""The port's visualisers (`captra_tpu_torch/eval/visualize.py`,
`eval/raster.py`, `cli/visualize.py`) against the JAX package's, which
draws with OpenCV and plots with matplotlib.

Pixel equality throughout: the numpy raster against `cv2.line` on random
segments (thickness 1 to 3, end points inside, across and far outside the
image), the box overlays against `draw_boxes_on_image`, and the decoded
PNGs of both packages' scene walkthroughs and 3D plots written from the
same result pickles."""
import os
import pickle
import sys
from os.path import join as pjoin

import cv2
import numpy as np
import pytest

from captra_tpu.cli import visualize as jcli
from captra_tpu.eval import visualize as jvis
from captra_tpu_torch.cli import visualize as tcli
from captra_tpu_torch.data.image_io import read_png, write_png
from captra_tpu_torch.eval import raster
from captra_tpu_torch.eval import visualize as tvis

K = np.array([[591.0125, 0.0, 322.525], [0.0, 590.16775, 244.11084],
              [0.0, 0.0, 1.0]], np.float32)
COLOR = (255, 80, 0)


def _segment(rng, W, H, scale):
    return (int(rng.uniform(-W * (scale - 1), W * scale)),
            int(rng.uniform(-H * (scale - 1), H * scale)))


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_draw_line_equals_cv2(thickness):
    """400 segments a thickness: inside the image, across its border, and
    with end points up to 2e9 pixels away (boxes behind the camera)."""
    rng = np.random.RandomState(thickness)
    H, W = 48, 64
    for i in range(400):
        if i % 5 == 4:
            mag = 10.0 ** rng.uniform(2, 9.3)
            p0 = (int(rng.uniform(-mag, mag)), int(rng.uniform(-mag, mag)))
            p1 = _segment(rng, W, H, 1)
        else:
            scale = (1, 1.5, 4, 50)[i % 4]
            p0, p1 = _segment(rng, W, H, scale), _segment(rng, W, H, scale)
        want = np.zeros((H, W, 3), np.uint8)
        got = want.copy()
        cv2.line(want, p0, p1, COLOR, thickness)
        raster.draw_line(got, p0, p1, COLOR, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{p0} {p1}")


def _box(center, half):
    c, h = np.asarray(center, np.float64), np.asarray(half, np.float64)
    signs = np.array([[(i % 4) // 2, i // 4, i % 2] for i in range(8)])
    return c + (2 * signs - 1) * h


# boxes in front of the camera (z < 0): inside the 480 x 640 image, across
# its border, outside it or reaching past it from near the camera, and one
# with vertices behind the camera
PLACEMENTS = {
    "inside": [_box([0.0, 0.0, -1.0], [0.1, 0.08, 0.12]),
               _box([0.12, -0.05, -0.8], [0.05, 0.06, 0.04])],
    "across": [_box([0.3, 0.1, -0.9], [0.15, 0.1, 0.1]),
               _box([-0.05, -0.4, -1.1], [0.1, 0.12, 0.1])],
    "outside": [_box([2.0, 0.0, -1.0], [0.1, 0.1, 0.1]),
                _box([0.1, 0.0, -0.5], [0.2, 0.2, 0.45]),
                _box([0.0, 0.05, -0.1], [0.1, 0.1, 0.2])],
}


def test_project_box_2d_equals_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        box = _box(rng.uniform(-0.3, 0.3, 3) + [0, 0, -1.0],
                   rng.uniform(0.02, 0.2, 3)).astype(np.float32)
        np.testing.assert_array_equal(tvis.project_box_2d(box, K, 480),
                                      jvis.project_box_2d(box, K, 480))


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_draw_boxes_on_image_equals_jax(placement, thickness):
    img = np.random.RandomState(1).randint(0, 255, (480, 640, 3)).astype(
        np.uint8)
    src = img.copy()
    boxes = np.stack(PLACEMENTS[placement]).astype(np.float32)
    with np.errstate(invalid="ignore"):   # vertices behind the camera
        want = jvis.draw_boxes_on_image(img, boxes, K, thickness=thickness)
        got = tvis.draw_boxes_on_image(img, boxes, K, thickness=thickness)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(img, got)
    np.testing.assert_array_equal(img, src)   # the input is not drawn on


def _pose(rng, T, P, z=-1.0):
    from captra_tpu_torch.pose.part_dof import Pose
    from captra_tpu_torch.pose.rotations import rotvec_to_matrix
    import torch
    rot = rotvec_to_matrix(torch.as_tensor(
        rng.normal(0, 0.3, (T, P, 3)).astype(np.float32)))
    t = np.tile(np.array([0.0, 0.0, z], np.float32).reshape(1, 1, 3, 1),
                (T, P, 1, 1)) + rng.normal(0, 0.02, (T, P, 3, 1)).astype(
                    np.float32)
    s = rng.uniform(0.8, 1.2, (T, P)).astype(np.float32)
    return Pose(rotation=rot, translation=torch.as_tensor(t),
                scale=torch.as_tensor(s))


def _write_scene(root):
    """Two instances of scene_1 (one entering at frame 1, one with
    non-finite predicted corners at its first frame: the GT fallback), one
    of scene_10, and scene_1's colour and depth frames (4-digit names, and
    frame 3 unpadded)."""
    from captra_tpu_torch.tracking.results import save_track_result
    rng = np.random.RandomState(5)
    T, P = 3, 1
    corners = np.array([[[-0.1, -0.12, -0.08], [0.1, 0.12, 0.08]]],
                       np.float32)
    results = str(root / "results")
    for ins, frames, bad0 in [("bottle_a_scene_1", [0, 1, 2], True),
                              ("can_b_scene_1", [1, 2, 3], False),
                              ("mug_c_scene_10", [0, 1, 2], False)]:
        pose, gt = _pose(rng, T, P), _pose(rng, T, P)
        pred_corners = np.tile(corners, (T, 1, 1, 1)) * rng.uniform(
            0.8, 1.2, (T, 1, 1, 1)).astype(np.float32)
        if bad0:
            pred_corners[0] = np.nan
        save_track_result(results, ins, pose, gt, pred_corners, corners,
                          frame_nums=[[f] for f in frames])
    img_dir = root / "imgs" / "scene_1"
    img_dir.mkdir(parents=True)
    for f in range(4):
        stem = f"{f:04d}" if f < 3 else str(f)
        write_png(str(img_dir / f"{stem}_color.png"),
                  rng.randint(0, 255, (480, 640, 3)).astype(np.uint8))
        write_png(str(img_dir / f"{stem}_depth.png"),
                  rng.randint(400, 3000, (480, 640)).astype(np.uint16))
    return results, str(root / "imgs")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return _write_scene(tmp_path_factory.mktemp("vis"))


def _same_pngs(got, want):
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        a, b = read_png(g, unchanged=True), cv2.imread(w, -1)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=g)


@pytest.mark.parametrize("depth,draw_gt", [(False, True), (True, False)])
def test_visualize_scene_images_equals_jax(scene, tmp_path, depth, draw_gt):
    results, img_dir = scene
    kw = dict(depth=depth, draw_gt=draw_gt)
    want = jvis.visualize_scene_images(results, img_dir, "scene_1",
                                       out_dir=str(tmp_path / "jax"), **kw)
    got = tvis.visualize_scene_images(results, img_dir, "scene_1",
                                      out_dir=str(tmp_path / "port"), **kw)
    assert len(got) == 4       # the union of both instances' frames
    _same_pngs(got, want)
    # the boxes were drawn: frame 1 differs from its source image
    src = read_png(pjoin(img_dir, "scene_1", "0001_"
                         + ("depth" if depth else "color") + ".png"),
                   unchanged=True)
    assert not np.array_equal(read_png(got[1], unchanged=True)[..., 0],
                              src if depth else src[..., 0])
    assert tvis.visualize_scene_images(results, img_dir, "scene_") == []


def test_visualize_results_dir_equals_jax(scene, tmp_path):
    results, _ = scene
    want = jvis.visualize_results_dir(results, str(tmp_path / "jax"),
                                      max_frames=1)
    got = tvis.visualize_results_dir(results, str(tmp_path / "port"),
                                     max_frames=1)
    assert len(got) == 3        # one frame of each trajectory
    _same_pngs(got, want)


def test_visualize_cli_equals_jax(scene, tmp_path, capsys):
    """Both modes of `main` against the JAX CLI (printed lines and PNGs),
    `discover_scenes`, and the SystemExits."""
    results, img_dir = scene
    assert tcli.discover_scenes(results) == jcli.discover_scenes(results) \
        == ["scene_1", "scene_10"]
    assert tcli.discover_scenes(str(tmp_path / "none")) == []
    for mode in (["--img_path", img_dir, "--draw_gt"],
                 ["--max_frames", "1"]):
        outs = {}
        for name, main in (("jax", jcli.main), ("port", tcli.main)):
            out = str(tmp_path / name / mode[0])
            assert main(["--results_dir", results, "--output_path", out,
                         *mode]) == 0
            outs[name] = (capsys.readouterr().out, sorted(
                pjoin(d, f) for d, _, fs in os.walk(out) for f in fs))
        assert outs["port"][0].replace(str(tmp_path / "port"), "") == \
            outs["jax"][0].replace(str(tmp_path / "jax"), "")
        _same_pngs(outs["port"][1], outs["jax"][1])
    exp = tmp_path / "exp"
    with pytest.raises(SystemExit, match="no results directory"):
        tcli.main(["--experiment_dir", str(exp)])
    (exp / "results" / "data").mkdir(parents=True)
    with pytest.raises(SystemExit, match="no scenes found"):
        tcli.main(["--experiment_dir", str(exp), "--img_path", img_dir])
    with pytest.raises(SystemExit, match="no results directory"):
        tcli.main([])


def test_matplotlib_missing_raises_naming_it(scene, tmp_path, monkeypatch):
    results, _ = scene
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tvis.visualize_results_dir(results, str(tmp_path))
    with pytest.raises(ImportError, match="matplotlib"):
        tvis.plot_point_clouds([[np.zeros((2, 3))]])
    # the overlay needs no plotting package
    assert len(tvis.visualize_scene_images(results, scene[1], "scene_1",
                                           out_dir=str(tmp_path))) == 4


def test_result_pickles_are_the_jax_format(scene):
    """The fixture's pickles (the port's writer) hold what the JAX
    visualisers read."""
    results, _ = scene
    with open(pjoin(results, "data", "bottle_a_scene_1.pkl"), "rb") as f:
        data = pickle.load(f)
    assert sorted(data) == ["frame_nums", "gt", "pred"]
    assert not np.isfinite(data["pred"]["corners"][0]).any()
