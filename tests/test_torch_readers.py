"""The port's dataset readers (`captra_tpu_torch/data/{nocs,nocs2d,sapien,
urdf,real_arti,factory}.py`) against the JAX package's on the same on-disk
fixtures (the JAX tests' writers), each package on a root of its own (the
SAPIEN reader writes cache pickles).

Tolerance: bit for bit.  Items (points, labels, nocs, poses, corners, the
pre-fetched depth, mask and NOCS-2D detections), split files, caches and
`model_info` are equal in type, dtype, shape and value; paths equal once
the roots are swapped.  Where the JAX readers drop a failure without a
word (an unreadable PNG), the port raises."""
import dataclasses
import json
import os
import pickle
import shutil
from os.path import join as pjoin

import numpy as np
import pytest

from captra_tpu.config import schema as jschema
from captra_tpu.data import factory as jfactory
from captra_tpu.data import nocs as jnocs
from captra_tpu.data import nocs2d as jnocs2d
from captra_tpu.data import real_arti as jreal
from captra_tpu.data import sapien as jsapien
from captra_tpu.data import urdf as jurdf
from captra_tpu.data.preproc_nocs import REAL_INTRINSICS, _project
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.data import blur, factory, nocs, nocs2d, real_arti
from captra_tpu_torch.data import sapien
from captra_tpu_torch.data import urdf
from tests.test_data import _write_fake_nocs
from tests.test_sapien_data import (  # noqa: F401 (fixture)
    _fake_cloud_dict, _model_info, fake_sapien_root,
)
from tests.test_track_paths import (
    _write_bmvc_root, _write_otf_root, _write_real_root,
)
from tests.test_urdf import _make_tree
from tests.torch_port_helpers import assert_tree_equal, tiny_config


def _roots(tmp_path, write, **kw):
    """(port root, JAX root), each written by `write(root, **kw)`."""
    out = []
    for pkg in ("port", "jax"):
        root = str(tmp_path / pkg)
        os.makedirs(root, exist_ok=True)
        out.append(write(root, **kw) or root)
    return tuple(out)


def _nocs_obj(schema):
    return schema.ObjCfg(category="1", num_parts=1, num_joints=0,
                         tree=(-1,), sym=True, extra_dims=1)


def _both_items(tds, jds, roots):
    assert len(tds) == len(jds) > 0
    for i in range(len(jds)):
        assert_tree_equal(tds[i], jds[i], [roots], f"item {i}")
    assert tds.track_index() == jds.track_index()


@pytest.mark.parametrize("perturb", [None, "normal", "uniform"])
def test_nocs_items_and_splits_equal_jax(tmp_path, perturb):
    roots = _roots(tmp_path, _write_fake_nocs)
    kw = dict(num_points=128, mode="real_test", radius=0.6, seed=3)
    tds = nocs.NOCSDataset(
        roots[0], "1", _nocs_obj(tschema), **kw, perturb=perturb and
        tschema.PerturbCfg(t=0.01, s=0.01, kind=perturb))
    jds = jnocs.NOCSDataset(
        roots[1], "1", _nocs_obj(jschema), **kw, perturb=perturb and
        jschema.PerturbCfg(t=0.01, s=0.01, kind=perturb))
    _both_items(tds, jds, roots)
    split = pjoin("splits", "1", "exp", "real_test.txt")
    with open(pjoin(roots[0], split)) as f, open(pjoin(roots[1], split)) as g:
        assert f.read().replace(roots[0], roots[1]) == g.read()
    # the category sub-splits filter by keyword; downsampling and
    # truncation cut the list
    for mode in ("real_test_bottle", "real_test_can"):
        assert (nocs.split_nocs_dataset(roots[0], "1", "exp", mode)
                == jnocs.split_nocs_dataset(roots[1], "1", "exp", mode))
    cut = dict(kw, downsampling=2, truncate_length=4)
    assert [nocs.NOCSDataset(roots[0], "1", _nocs_obj(tschema), **cut)
            .frame_meta(i)[1:] for i in range(4)] == [
        jnocs.NOCSDataset(roots[1], "1", _nocs_obj(jschema), **cut)
        .frame_meta(i)[1:] for i in range(4)]


@pytest.mark.parametrize("dets", [False, True])
def test_nocs_prefetch_equals_jax(tmp_path, dets):
    """Depth (int32 from the 16-bit PNG), the instance mask (the mask
    PNG's red channel at the meta.txt number) and, for NOCS-2D, the
    same-class detections bit-packed along W (K = 16)."""
    roots = _roots(tmp_path, _write_otf_root, frames=3)
    ds = [mod.NOCSDataset(
        root, "1", _nocs_obj(schema), num_points=64, mode="real_test",
        nocs2d_path=pjoin(root, "nocs2d") if dets else None)
        for mod, schema, root in ((nocs, tschema, roots[0]),
                                  (jnocs, jschema, roots[1]))]
    _both_items(*ds, roots)
    pre = ds[0][0]["meta"]["pre_fetched"]
    assert pre["depth"].dtype == np.int32 and pre["mask"].sum() == 144
    assert ("det_masks" in pre) == dets


def test_nocs_prefetch_failures(tmp_path):
    """No depth file: no pre-fetch in either package.  A depth PNG that
    exists but cannot be read: the JAX reader drops the pre-fetch without a
    word (nocs.py:209-210); the port raises, naming the file."""
    roots = _roots(tmp_path, _write_otf_root, frames=2)
    raw = pjoin("nocs_full", "real_test", "scene_1")
    for root in roots:
        os.remove(pjoin(root, raw, "0000_depth.png"))
        with open(pjoin(root, raw, "0001_depth.png"), "r+b") as f:
            f.truncate(60)
    tds, jds = [mod.NOCSDataset(root, "1", _nocs_obj(schema), num_points=64,
                                mode="real_test")
                for mod, schema, root in ((nocs, tschema, roots[0]),
                                          (jnocs, jschema, roots[1]))]
    assert_tree_equal(tds[0], jds[0], [roots])
    assert "pre_fetched" not in tds[0]["meta"]
    assert "pre_fetched" not in jds[1]["meta"]
    with pytest.raises(ValueError, match="0001_depth.png"):
        tds[1]


def test_nocs2d_helpers_equal_jax(tmp_path):
    np.testing.assert_array_equal(nocs2d.REAL_INTRINSICS, REAL_INTRINSICS)
    rng = np.random.RandomState(0)
    pts = rng.randn(20, 3) * 0.2 + [0, 0, -1.0]
    np.testing.assert_array_equal(nocs2d._project(pts.copy(),
                                                  REAL_INTRINSICS),
                                  _project(pts.copy(), REAL_INTRINSICS))
    H, W = 48, 64
    boxes = np.sort(rng.uniform(0, 48, (5, 4)).reshape(5, 2, 2), 1).reshape(
        5, 4).astype(np.float32)
    masks = rng.rand(H, W, 5) < 0.3
    result = {"pred_class_ids": np.array([1, 3, 1, 1, 2]),
              "pred_bboxes": boxes, "pred_masks": masks}
    for center, radius in (([0.01, 0.0, -1.0], 0.05), ([0.2, 0.1, -0.8],
                                                       0.3)):
        center = np.asarray(center)
        np.testing.assert_array_equal(
            nocs2d.projected_track_bbox((H, W), center, radius),
            jnocs2d.projected_track_bbox((H, W), center, radius))
        np.testing.assert_array_equal(
            nocs2d.compute_2d_bbox_iou(boxes[0], boxes),
            jnocs2d.compute_2d_bbox_iou(boxes[0], boxes))
        for cat in (1, 2, 7):
            got = nocs2d.select_nocs2d_mask(result, cat, (H, W), center,
                                            radius)
            want = jnocs2d.select_nocs2d_mask(result, cat, (H, W), center,
                                              radius)
            assert (got is None) == (want is None)
            if want is not None:
                np.testing.assert_array_equal(got, want)
    with open(tmp_path / "results_test_scene_1_0003.pkl", "wb") as f:
        pickle.dump(result, f)
    depth = "x/scene_1/0003_depth.png"
    assert_tree_equal(nocs2d.load_nocs2d_result(str(tmp_path), depth),
                      jnocs2d.load_nocs2d_result(str(tmp_path), depth))
    assert nocs2d.load_nocs2d_result(str(tmp_path), "x/scene_2/0000") is None


def _laptop_obj(schema):
    return schema.ObjCfg(category="laptop", num_parts=2, num_joints=1,
                         tree=(-1, 0), test_list=("10101",))


def _sapien_pair(roots, mode="test", synthetic=True):
    return (sapien.SAPIENDataset(roots[0], "laptop", _laptop_obj(tschema),
                                 num_points=256, mode=mode,
                                 synthetic=synthetic, seed=5,
                                 model_info_loader=lambda ins: _model_info()),
            jsapien.SAPIENDataset(roots[1], "laptop", _laptop_obj(jschema),
                                  num_points=256, mode=mode,
                                  synthetic=synthetic, seed=5,
                                  model_info_loader=lambda ins: _model_info()))


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("synthetic", [True, False])
def test_sapien_items_and_caches_equal_jax(fake_sapien_root, tmp_path,
                                           synthetic):
    """Items cold (caches written) and warm (caches read), both cache
    tiers' pickles, and each package reading the other's cache."""
    roots = (str(tmp_path / "port"), fake_sapien_root)
    shutil.copytree(fake_sapien_root, roots[0])
    tds, jds = _sapien_pair(roots, synthetic=synthetic)
    _both_items(tds, jds, roots)
    _both_items(tds, jds, roots)                       # warm
    cache = pjoin("preproc", "laptop", "10101", "0000")
    for tier in ("cloud", "full"):
        for f in ("0.pkl", "1.pkl"):
            assert_tree_equal(_load(pjoin(roots[0], cache, tier, f)),
                              _load(pjoin(roots[1], cache, tier, f)),
                              where=f"{tier}/{f}")
    # swap the caches: each reads the other's, and the items stay equal
    shutil.rmtree(pjoin(roots[0], "preproc"))
    shutil.copytree(pjoin(roots[1], "preproc"), pjoin(roots[0], "preproc"))
    os.remove(pjoin(roots[0], cache, "full", "1.pkl"))     # cloud tier only
    _both_items(*_sapien_pair(roots, synthetic=synthetic), roots)


def test_sapien_splits_and_modes_equal_jax(fake_sapien_root, tmp_path):
    roots = (str(tmp_path / "port"), fake_sapien_root)
    shutil.copytree(fake_sapien_root, roots[0])
    for root in roots:
        shutil.copytree(pjoin(root, "render"), pjoin(root, "render_seq"))
    for mode in ("train", "test", "test_seq", "train_seq"):
        tds, jds = _sapien_pair(roots, mode)
        assert [p.replace(roots[0], roots[1]) for p in tds.file_list] == \
            jds.file_list, mode
    _both_items(*_sapien_pair(roots, "test_seq"), roots)
    assert os.path.isdir(pjoin(roots[0], "preproc_seq"))


def test_sapien_helpers_equal_jax(tmp_path):
    rng = np.random.RandomState(4)
    cd = _fake_cloud_dict(rng)
    assert_tree_equal(sapien.opengl_depth_to_points(cd),
                      jsapien.opengl_depth_to_points(cd))
    for num_parts in (None, 2, 3):
        assert_tree_equal(
            sapien.read_cloud(cd, 600, np.random.RandomState(1),
                              synthetic=True, num_parts=num_parts),
            jsapien.read_cloud(cd, 600, synthetic=True, num_parts=num_parts,
                               rng=np.random.RandomState(1)))
    pq = (rng.randn(3), rng.randn(4))
    np.testing.assert_array_equal(sapien.pose_pq_to_mat(pq),
                                  jsapien.pose_pq_to_mat(pq))
    info = _model_info()
    info["corner"] = [[np.full(3, -0.4), np.full(3, 0.6)]] * 2
    assert_tree_equal(sapien._norm_corners(info), jsapien._norm_corners(info))
    link2world = {p: sapien.pose_pq_to_mat((rng.randn(3), rng.randn(4)))
                  for p in range(2)}
    cam2world = sapien.pose_pq_to_mat((rng.randn(3), rng.randn(4)))
    pts, seg = rng.randn(50, 3).astype(np.float32), rng.randint(0, 2, 50)
    assert_tree_equal(
        sapien.base_generate_data(info, pts, seg, cam2world, link2world),
        jsapien.base_generate_data(info, pts, seg, cam2world, link2world))


@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_gaussian_blur_matches_opencv(ksize):
    """`data/blur.py` against `cv2.GaussianBlur(img, (k, k), sigmaX)` on
    float64 depth (sigma 0.2, the augmentation's, and a wide 1.5), within
    1e-12; OpenCV is imported by this test only."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(ksize)
    for shape in ((32, 40), (5, 9), (120, 160)):
        img = rng.uniform(0.3, 1.0, shape)
        img[rng.rand(*shape) < 0.3] = 1.0
        for sigma in (0.2, 1.5):
            np.testing.assert_allclose(
                blur.gaussian_blur(img, ksize, sigma),
                cv2.GaussianBlur(img, (ksize, ksize), sigmaX=sigma),
                rtol=0, atol=1e-12, err_msg=f"{shape} sigma {sigma}")
        np.testing.assert_allclose(
            blur.gaussian_kernel(ksize, 0.2),
            cv2.getGaussianKernel(ksize, 0.2, ktype=cv2.CV_64F)[:, 0],
            rtol=0, atol=1e-15)


def _noisy_cloud_dict(seed):
    """The SAPIEN test frame with per-pixel depth noise (a flat patch
    backprojects to a lattice of FPS near-ties)."""
    rng = np.random.RandomState(seed)
    cd = _fake_cloud_dict(rng, H=48, W=64)
    valid = cd["depth"] < 1
    cd["depth"][valid] += rng.uniform(0, 0.01, valid.sum()).astype(
        np.float32)
    return cd


def test_sapien_perturb_depth_matches_jax():
    """The JAX function with OpenCV (this machine has it): the same draws
    from the same RandomState (the pixel mask, the std, the normals, the
    kernel size), the blur within 1e-12."""
    pytest.importorskip("cv2")
    for seed in range(4):
        cd = _noisy_cloud_dict(seed)
        depth = cd["depth"].astype(np.float64)
        got_rng, want_rng = (np.random.RandomState(seed) for _ in range(2))
        got = sapien.perturb_depth(depth, depth < 1, got_rng)
        want = jsapien.perturb_depth(depth, depth < 1, want_rng)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert got_rng.randint(1 << 30) == want_rng.randint(1 << 30)
        assert not np.array_equal(got, depth)


@pytest.mark.parametrize("num_parts", [None, 2])
def test_sapien_read_cloud_perturbed_matches_jax(num_parts):
    """`read_cloud(perturb=True)`: the FPS indices (so the labels, the
    relabelled clutter included) equal, the points within 1e-6."""
    pytest.importorskip("cv2")
    for seed in range(3):
        cd = _noisy_cloud_dict(seed)
        got_rng, want_rng = (np.random.RandomState(seed) for _ in range(2))
        got = sapien.read_cloud(cd, 600, got_rng, synthetic=True,
                                num_parts=num_parts, perturb=True)
        want = jsapien.read_cloud(cd, 600, synthetic=True,
                                  num_parts=num_parts, rng=want_rng,
                                  perturb=True)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
        assert got_rng.randint(1 << 30) == want_rng.randint(1 << 30)
        plain = sapien.read_cloud(cd, 600, np.random.RandomState(seed),
                                  synthetic=True, num_parts=num_parts)
        assert not np.array_equal(got[0], plain[0])


def test_urdf_model_info_equals_jax(tmp_path):
    root = _make_tree(tmp_path)
    path = pjoin(root, "urdf", "laptop", "10101")
    assert_tree_equal(urdf.parse_urdf(path), jurdf.parse_urdf(path))
    assert_tree_equal(urdf.generate_instance_info(root, "laptop", "10101"),
                      jurdf.generate_instance_info(root, "laptop", "10101"))
    # the SAPIEN reader's model info: the URDF without a pickle, the
    # pickle when there is one
    for info in (None, _model_info()):
        if info is not None:
            os.makedirs(pjoin(root, "model_info", "laptop"))
            with open(pjoin(root, "model_info", "laptop", "10101.pkl"),
                      "wb") as f:
                pickle.dump(info, f)
        ds = [mod.SAPIENDataset.__new__(mod.SAPIENDataset)
              for mod in (sapien, jsapien)]
        for d in ds:
            d.root_dset, d.obj_category = root, "laptop"
        assert_tree_equal(ds[0]._load_model_info("10101"),
                          ds[1]._load_model_info("10101"))


def _write_real_gt(root, frames=4):
    """Annotated poses for `_write_real_root`'s track (the layout of
    `tests/test_real_arti.py`)."""
    pdir = pjoin(root, "real_pose", "drawers", "0")
    os.makedirs(pdir, exist_ok=True)
    rng = np.random.RandomState(2)
    meta = {name: {"size": list(rng.uniform(0.1, 0.4, 3))}
            for name in ("drawer1", "drawer2", "drawer3", "body")}
    poses = [{name: {"R": np.linalg.qr(rng.randn(3, 3))[0].ravel().tolist(),
                     "t": list(rng.randn(3))} for name in meta}
             for _ in range(frames)]
    with open(pjoin(pdir, "0.json"), "w") as f:
        json.dump(poses, f)
    with open(pjoin(pdir, "meta.json"), "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("gt", [False, True])
def test_real_capture_items_equal_jax(tmp_path, gt):
    roots = _roots(tmp_path, _write_real_root, n=300)
    if gt:
        for root in roots:
            _write_real_gt(root)
    _both_items(real_arti.SAPIENRealDataset(roots[0], "drawers",
                                            num_points=128, seed=2),
                jreal.SAPIENRealDataset(roots[1], "drawers", num_points=128,
                                        seed=2), roots)
    # more points than frames hold: duplicated, then the 5x presample
    _both_items(real_arti.SAPIENRealDataset(roots[0], "drawers",
                                            num_points=512),
                jreal.SAPIENRealDataset(roots[1], "drawers",
                                        num_points=512), roots)


def test_bmvc_items_equal_jax(tmp_path):
    roots = _roots(tmp_path, _write_bmvc_root)
    _both_items(real_arti.BMVCDataset(roots[0], "laptop"),
                jreal.BMVCDataset(roots[1], "laptop"), roots)
    assert len(real_arti.BMVCDataset(roots[0], "laptop",
                                     truncate_length=2)) == 2


def test_factory_dispatch_equals_jax(tmp_path, fake_sapien_root):
    """The backend and the default split each package picks."""
    bmvc = _write_bmvc_root(str(tmp_path / "bmvc"))
    real = _write_real_root(str(tmp_path / "real"))
    nocs_root = _write_fake_nocs(str(tmp_path / "nocs"))
    cases = [("bottle", nocs_root, "real_test", {}),
             ("laptop", bmvc, "bmvc_0", {}),
             ("laptop", real, "real_test", {"category": "drawers"}),
             ("laptop", fake_sapien_root, "test", {})]
    for obj, root, mode, extra in cases:
        cfgs = []
        for schema in (tschema, jschema):
            cfg = tiny_config(schema, obj)
            kw = dict(basepath=root, **extra)
            if obj == "bottle":
                kw["nocs_data"] = True
            else:
                kw["test_list"] = ("10101",)
            cfgs.append(cfg.replace(obj=dataclasses.replace(cfg.obj, **kw)))
        assert (factory.default_track_mode(cfgs[0])
                == jfactory.default_track_mode(cfgs[1]))
        tds = factory.make_dataset(cfgs[0], mode)
        jds = jfactory.make_dataset(cfgs[1], mode)
        assert type(tds).__name__ == type(jds).__name__, mode
        assert len(tds) == len(jds) and tds.track_index() == \
            jds.track_index()
    with pytest.raises(ValueError, match="downsampling"):
        factory.make_dataset(cfgs[0].replace(obj=dataclasses.replace(
            cfgs[0].obj, basepath=bmvc)), "bmvc_0", downsampling=2)
