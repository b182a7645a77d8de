"""The port's trajectory batches (`captra_tpu_torch/data/loader.py`) and
the dataset path's crop (`data/preprocess.py::crop_ball`,
`otf_frame_from_depth`) against the JAX package's.

Tolerances: collated batches bit for bit (every key, every value; the port
keeps the items' numpy dtypes, where JAX narrows int64 to int32); the
`sequence_batches` names and grouping equal; the row crop (both methods,
fed the JAX draws) and the OTF frame: indices, points and labels equal,
nocs within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from captra_tpu.config import schema as jschema
from captra_tpu.data import loader as jloader
from captra_tpu.data import nocs as jnocs
from captra_tpu.data import preprocess as jprep
from captra_tpu.data import real_arti as jreal
from captra_tpu.pose.part_dof import Pose as JPose
from captra_tpu_torch.config import schema as tschema
from captra_tpu_torch.data import loader, nocs, preprocess, real_arti
from captra_tpu_torch.pose.part_dof import Pose
from tests.test_data import _write_fake_nocs
from tests.test_torch_otf import _scene
from tests.test_track_paths import _write_bmvc_root, _write_real_root
from tests.test_torch_readers import _nocs_obj, _roots, _write_otf_root

FIELDS = ("rotation", "translation", "scale")


def _assert_batch_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k == "pose":
            assert isinstance(g, Pose)
            pairs = [(getattr(g, f), getattr(w, f)) for f in FIELDS]
        else:
            pairs = [(g, w)]
        for gv, wv in pairs:
            assert isinstance(gv, torch.Tensor) and gv.device.type == "cpu"
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv),
                                          err_msg=k)


def _pair(mod_t, mod_j, roots, **kw):
    return mod_t(roots[0], **kw[0]), mod_j(roots[1], **kw[1])


def _nocs_pair(roots, **kw):
    return (nocs.NOCSDataset(roots[0], "1", _nocs_obj(tschema),
                             num_points=64, mode="real_test",
                             perturb=tschema.PerturbCfg(), **kw),
            jnocs.NOCSDataset(roots[1], "1", _nocs_obj(jschema),
                              num_points=64, mode="real_test",
                              perturb=jschema.PerturbCfg(), **kw))


def test_collate_frames_equals_jax(tmp_path):
    """NOCS frames (crop pose, corners), BMVC frames (per-part poses), bare
    GT-less captures and a mix, where only the shared keys collate."""
    roots = _roots(tmp_path / "nocs", _write_fake_nocs)
    tds, jds = _nocs_pair(roots)
    _assert_batch_equal(loader.collate_frames([tds[i] for i in (0, 3, 5)]),
                        jloader.collate_frames([jds[i] for i in (0, 3, 5)]))
    got = loader.collate_frames([tds[0]])
    assert got["labels"].dtype == torch.int64
    assert got["crop_translation"].shape == (1, 1, 3, 1)
    broots = _roots(tmp_path / "bmvc", _write_bmvc_root)
    tb = real_arti.BMVCDataset(broots[0], "laptop")
    jb = jreal.BMVCDataset(broots[1], "laptop")
    _assert_batch_equal(loader.collate_frames([tb[0], tb[2]]),
                        jloader.collate_frames([jb[0], jb[2]]))
    rroots = _roots(tmp_path / "real", _write_real_root)
    tr = real_arti.SAPIENRealDataset(rroots[0], "drawers", num_points=256)
    jr = jreal.SAPIENRealDataset(rroots[1], "drawers", num_points=256)
    _assert_batch_equal(loader.collate_frames([tr[1]]),
                        jloader.collate_frames([jr[1]]))
    _assert_batch_equal(loader.collate_frames([tb[0], tr[0]]),
                        jloader.collate_frames([jb[0], jr[0]]))


@pytest.mark.parametrize("batch_size,num_frames", [(1, None), (2, None),
                                                   (3, None), (2, 2),
                                                   (4, 1)])
def test_sequence_batches_equal_jax(tmp_path, batch_size, num_frames):
    roots = _roots(tmp_path, _write_fake_nocs)
    tds, jds = _nocs_pair(roots)
    got = list(loader.sequence_batches(tds, num_frames, batch_size))
    want = list(jloader.sequence_batches(jds, num_frames, batch_size))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        _assert_batch_equal(g, w)


class _Frames:
    """A dataset of numpy items in memory: tracks of `lengths` frames; the
    frames of track `bare` lack their pre-fetched depth."""

    def __init__(self, lengths, bare=()):
        self.items, self.tracks = [], {}
        rng = np.random.RandomState(0)
        for t, n in enumerate(lengths):
            for _ in range(n):
                self.tracks.setdefault(f"ins/{t}", []).append(len(self.items))
                meta = {"pose": {"rotation": np.eye(3, dtype=np.float32),
                                 "translation": rng.randn(3, 1),
                                 "scale": np.float32(rng.rand())}}
                if t not in bare:
                    meta["pre_fetched"] = {
                        "depth": rng.randint(0, 9, (4, 5)).astype(np.int32),
                        "mask": rng.rand(4, 5) < 0.5}
                self.items.append({"data": {"points": rng.randn(8, 3).astype(
                    np.float32)}, "meta": meta})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def track_index(self):
        return self.tracks


@pytest.mark.parametrize("batch_size", [2, 3])
def test_sequence_batches_group_and_flush_as_jax(batch_size):
    """Tracks of unequal lengths group by length, in order; a track whose
    collated keys differ (no pre-fetched depth) flushes the pending batch."""
    ds = _Frames([3, 3, 2, 3, 2, 3, 3], bare=(3,))
    got = list(loader.sequence_batches(ds, None, batch_size))
    want = list(jloader.sequence_batches(ds, None, batch_size))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        _assert_batch_equal(g, w)
    assert any("depth" not in b for _, b in got)


def _jax_draw(key, method, M):
    if method == "sort":
        return torch.from_numpy(np.array(jax.random.uniform(key, (M,))))
    return torch.tensor(int(jax.random.randint(key, (), 0, M)))


@pytest.mark.parametrize("method", ["sort", "bucket"])
@pytest.mark.parametrize("num_points,radius", [(64, 0.1), (256, 0.3),
                                               (32, 0.001)])
def test_crop_ball_equals_jax(method, num_points, radius):
    """Rows layout, each method fed the JAX draw: ball, working set and FPS
    picks equal (a tiny radius grows, then wrap-fills duplicates)."""
    H, W = 48, 64
    depth, mask = _scene(1, H, W)
    K = np.asarray(jprep.NOCS_REAL_INTRINSICS)
    jpts, jvalid = jprep.backproject_depth(jnp.asarray(depth), jnp.asarray(K))
    pts, valid = preprocess.backproject_depth(torch.from_numpy(depth), K)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    center = np.asarray(jpts).reshape(H, W, 3)[mask].mean(0)
    key = jax.random.PRNGKey(num_points)
    want_pts, want_idx = jprep.crop_ball(key, jpts, jvalid,
                                         jnp.asarray(center),
                                         jnp.float32(radius), num_points,
                                         method=method)
    got_pts, got_idx = preprocess.crop_ball(
        _jax_draw(key, method, H * W), pts, valid, torch.from_numpy(center),
        torch.tensor(radius), num_points, method=method)
    assert got_idx.dtype == torch.int64
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_pts.numpy(), np.asarray(want_pts))


def test_otf_frame_from_depth_equals_jax(tmp_path):
    """One frame of the NOCS OTF fixture through both packages' dataset
    crop, at its GT pose, with the JAX package's uniform draw."""
    roots = _roots(tmp_path, _write_otf_root, frames=1)
    item = nocs.NOCSDataset(roots[0], "1", _nocs_obj(tschema), num_points=64,
                            mode="real_test")[0]
    pre, pose = item["meta"]["pre_fetched"], item["meta"]["pose"]
    K = np.asarray(jprep.NOCS_CAMERA_INTRINSICS)
    center = pose["translation"].reshape(3)
    radius = np.float32(0.6 * pose["scale"])
    key = jax.random.PRNGKey(3)
    want = jprep.otf_frame_from_depth(
        key, jnp.asarray(pre["depth"]), jnp.asarray(pre["mask"]),
        jnp.asarray(K), jnp.asarray(center), jnp.asarray(radius),
        JPose(*(jnp.asarray(pose[f]) for f in FIELDS)), num_points=64)
    got = preprocess.otf_frame_from_depth(
        _jax_draw(key, "sort", pre["depth"].size),
        torch.from_numpy(pre["depth"]), torch.from_numpy(pre["mask"]), K,
        torch.from_numpy(center), torch.tensor(radius),
        Pose(*(torch.as_tensor(pose[f]) for f in FIELDS)), 64)
    for k in ("points", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["nocs"].numpy(), np.asarray(want["nocs"]),
                               rtol=0, atol=1e-6)
    assert 0 < int((got["labels"] == 0).sum()) < 64


def test_intrinsics_inverse_equals_jax():
    for K in (jprep.NOCS_REAL_INTRINSICS, jprep.NOCS_CAMERA_INTRINSICS,
              jnp.array([[500.3, 0.0, 33.7], [0.0, 480.1, 22.9],
                         [0.0, 0.0, 1.0]])):
        np.testing.assert_array_equal(
            preprocess.intrinsics_inverse(torch.from_numpy(
                np.asarray(K, np.float32))).numpy(),
            np.asarray(jnp.linalg.inv(K)))


@pytest.mark.parametrize("shuffle,start_batch,seed", [(True, 0, 0),
                                                      (True, 1, 3),
                                                      (False, 0, 1)])
def test_single_frame_batches_equal_jax(tmp_path, shuffle, start_batch,
                                        seed):
    """The frame order and each batch's point shuffle for the same seed
    (each package reads its own fresh dataset, whose crop draws follow the
    read order), the tail dropped."""
    roots = _roots(tmp_path, _write_fake_nocs)
    tds, jds = _nocs_pair(roots)
    got = list(loader.single_frame_batches(tds, 2, shuffle=shuffle,
                                           seed=seed,
                                           start_batch=start_batch))
    want = list(jloader.single_frame_batches(jds, 2, shuffle=shuffle,
                                             seed=seed,
                                             start_batch=start_batch))
    assert len(got) == len(want) == len(tds) // 2 - start_batch
    for g, w in zip(got, want):
        _assert_batch_equal(g, w)
    with pytest.raises(ValueError, match="rng"):
        loader.collate_frames([tds[0]], shuffle_points=True)


def test_prefetch_keeps_order_raises_and_stops_on_abandon():
    import threading
    assert list(loader.prefetch(iter(range(7)), size=2)) == list(range(7))

    def failing():
        yield 1
        raise KeyError("worker")

    it = loader.prefetch(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="worker"):
        next(it)
    before = threading.active_count()
    it = loader.prefetch(iter(range(1000)), size=1)
    assert next(it) == 0
    it.close()                       # the consumer abandons the stream
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


def test_mixture_draws_as_jax():
    its = {name: iter(range(100)) for name in ("syn", "real")}
    jits = {name: iter(range(100)) for name in ("syn", "real")}
    got = loader.Mixture(its, {"syn": 3, "real": 1}, seed=5)
    want = jloader.Mixture(jits, {"syn": 3, "real": 1}, seed=5)
    assert [next(got) for _ in range(40)] == [next(want) for _ in range(40)]
