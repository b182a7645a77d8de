"""The port's offline NOCS pipeline (`captra_tpu_torch/data/
preproc_pipeline.py`, `cli/preproc.py`) against the JAX package's on two
copies of one raw release, built pixel first
(`tests/torch_port_helpers.py::write_raw_nocs`: a real_test scene and a
mirrored CAMERA folder with 3-channel composed depth, three instances).

Tolerances: none.  The pose pickles, instance lists, model corners and
every render npz (points, labels, pose; `path` relative to its root) are
equal bit for bit, and so is the test link; `remove_border` equals the
JAX package's `cv2.dilate`.  The recovered poses are within the JAX
test's bars of the fixture's own (scale and translation 0.02, rotation
5 degrees).  The multi-process cases run in a subprocess that imports only
the port (a fork of a process that holds XLA's threads can hang)."""
import os
import pickle
import shutil
import subprocess
import sys
import textwrap
from os.path import join as pjoin

import numpy as np
import pytest

from captra_tpu.data import preproc_pipeline as jpipe
from captra_tpu_torch.cli.preproc import main
from captra_tpu_torch.data import preproc_pipeline as pipe
from tests.torch_port_helpers import (
    assert_tree_equal, pose_errors, write_raw_nocs,
)

cv2 = pytest.importorskip("cv2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = (40, 28)
TYPES = ("real_test", "val")
CATEGORIES = [1, 4, 6]


def _files(root, sub):
    base = pjoin(root, sub)
    return sorted(os.path.relpath(pjoin(d, f), base)
                  for d, _, fs in os.walk(base) for f in fs)


def _pose_pickle(root, data_type, key):
    with open(pjoin(root, "nocs_full", data_type, f"{key}_pose.pkl"),
              "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def released(tmp_path_factory):
    """(port root, JAX root, fixture poses) after both `run_pipeline`s at
    num_proc 1 and img_per_folder 2 (3 CAMERA frames: two folders)."""
    base = tmp_path_factory.mktemp("preproc_pipeline")
    port, jax_root = str(base / "port"), str(base / "jax")
    gt = write_raw_nocs(port, "real_test", ["scene_1"], 3, block=BLOCK)
    gt.update(write_raw_nocs(port, "val", ["00000"], 3, block=BLOCK, seed=1))
    shutil.copytree(port, jax_root)
    quiet = dict(data_types=TYPES, categories=CATEGORIES, num_proc=1,
                 img_per_folder=2, log=lambda *_: None)
    pipe.run_pipeline(port, **quiet)
    jpipe.run_pipeline(jax_root, **quiet)
    return port, jax_root, gt


def test_pose_pickles_equal_jax_and_recover_the_fixture(released):
    port, jax_root, gt = released
    for key, frame in gt.items():
        dt = "real_test" if key.startswith("scene") else "val"
        got, want = [_pose_pickle(r, dt, key) for r in (port, jax_root)]
        assert_tree_equal(got, want, where=key)
        assert sorted(got) == sorted(frame)
        for n, pose in frame.items():
            ds, dt_, dr = pose_errors(got[n], pose)
            assert ds < 0.02 and dt_ < 0.02 and dr < 5.0, (key, n)


def test_lists_corners_and_link_equal_jax(released):
    port, jax_root, _ = released
    for sub in ("instance_list", "model_corners"):
        files = _files(port, sub)
        assert files == _files(jax_root, sub) and files
        for name in files:
            if name.endswith(".txt"):
                with open(pjoin(port, sub, name)) as g, \
                        open(pjoin(jax_root, sub, name)) as w:
                    assert g.read() == w.read(), name
            else:
                got = np.load(pjoin(port, sub, name))
                want = np.load(pjoin(jax_root, sub, name))
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    with open(pjoin(port, "instance_list", "real_test", "1",
                    "bottle_red_stanford_norm.txt")) as f:
        assert f.read().split() == [f"scene_1/{i:04d}" for i in range(3)]
    assert os.readlink(pjoin(port, "render", "test")) == os.readlink(
        pjoin(jax_root, "render", "test")) == "val"


def test_render_npz_equal_jax(released):
    port, jax_root, _ = released
    files = _files(port, "render/real_test") + _files(port, "render/val")
    assert files == (_files(jax_root, "render/real_test")
                     + _files(jax_root, "render/val"))
    assert "1/bottle_red_stanford_norm/0001/data/00.npz" in files
    assert "1/bottle_red_stanford_norm/scene_1/meta.txt" in files
    npz = 0
    for dt in ("real_test", "val"):
        for name in _files(port, f"render/{dt}"):
            got_path = pjoin(port, "render", dt, name)
            want_path = pjoin(jax_root, "render", dt, name)
            if name.endswith("meta.txt"):
                with open(got_path) as g, open(want_path) as w:
                    assert g.read().replace(port, jax_root) == w.read()
                continue
            got = np.load(got_path, allow_pickle=True)["all_dict"].item()
            want = np.load(want_path, allow_pickle=True)["all_dict"].item()
            assert got["path"].startswith(port)
            assert_tree_equal(got, want, roots=((port, jax_root),),
                              where=name)
            npz += 1
    assert npz == 3 * 3 + 3 * 3


@pytest.mark.parametrize("k", [1, 2, 3])
def test_remove_border_equals_cv2_dilate(k):
    """Random instance masks with 255 runs, some touching every border."""
    rng = np.random.RandomState(k)
    for _ in range(5):
        mask = rng.choice([1, 2, 255], (37, 53),
                          p=[0.47, 0.47, 0.06]).astype(np.uint8)
        mask[0, 3] = mask[-1, 7] = mask[5, 0] = mask[9, -1] = 255
        got = pipe.remove_border(mask, kernel_size=k)
        np.testing.assert_array_equal(got, jpipe.remove_border(mask, k))
        grow = cv2.dilate((mask == 255).astype(np.uint8),
                          np.ones((2 * k, 2 * k), np.uint8))
        np.testing.assert_array_equal(pipe.dilate(mask == 255, k),
                                      grow.astype(bool))


def test_render_tree_feeds_the_ports_nocs_dataset(released):
    from captra_tpu_torch.config.schema import ObjCfg
    from captra_tpu_torch.data.nocs import NOCSDataset
    port, _, gt = released
    obj_cfg = ObjCfg(num_parts=1, num_joints=0, tree=(-1,), sym=True)
    ds = NOCSDataset(port, "1", obj_cfg, num_expr="pipe_test",
                     num_points=256, mode="val")
    assert len(ds) == 3
    item = ds[0]
    data, meta = item["data"], item["meta"]
    assert data["points"].shape == (256, 3)
    assert set(np.unique(data["labels"])) <= {0, 1}
    obj = data["nocs"][data["labels"] == 0]
    assert len(obj) and np.abs(obj).max() < 0.55
    np.testing.assert_allclose(float(meta["pose"]["scale"]),
                               gt["00000/0000"][1]["scale"], atol=0.02)


def test_cli_stages_subset_and_rejections(released, capsys):
    port, _, _ = released
    main(["--data_path", port, "--data_type", "real_test,val",
          "--categories", "1", "--stages", "lists"])
    out = capsys.readouterr().out
    assert "[lists] real_test: cls1=1 cls4=1 cls6=1" in out
    assert "[lists] val:" in out and "[poses]" not in out
    for argv in (["--data_type", "nope"], ["--stages", "poses,nope"]):
        with pytest.raises(SystemExit):
            main(["--data_path", port, *argv])


def _port_only(code: str) -> subprocess.CompletedProcess:
    """`code` in a fresh interpreter that cannot import JAX, flax, OpenCV
    or the JAX package."""
    prelude = textwrap.dedent("""
        import sys, importlib.abc
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split('.')[0] in ('jax', 'flax', 'captra_tpu',
                                          'cv2'):
                    raise ImportError('blocked: ' + name)
        sys.meta_path.insert(0, Block())
        """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c",
                           prelude + textwrap.dedent(code)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)


def test_two_processes_equal_jax_per_track_runs(tmp_path):
    """`num_proc` 2 on two tracks: each worker's chunk is one track, posed
    from its own `RandomState(0)`, so each track equals the JAX package's
    `gt_poses_for_tracks` of that track alone."""
    port, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    write_raw_nocs(port, "real_test", ["scene_1", "scene_2"], 2,
                   block=BLOCK)
    shutil.copytree(port, jax_root)
    out = _port_only(f"""
        from captra_tpu_torch.cli.preproc import main
        main(["--data_path", {port!r}, "--data_type", "real_test",
              "--stages", "poses", "--num_proc", "2"])
        """)
    assert out.returncode == 0, out.stderr
    raw = pjoin(jax_root, "nocs_full", "real_test")
    for track in ("scene_1", "scene_2"):
        assert jpipe.gt_poses_for_tracks(raw, [track], "real_test") == 2
        for prefix in ("0000", "0001"):
            got, want = [_pose_pickle(r, "real_test", f"{track}/{prefix}")
                         for r in (port, jax_root)]
            assert_tree_equal(got, want, where=f"{track}/{prefix}")


def test_a_failing_worker_raises_naming_its_chunk():
    """A worker that raises, and one that exits with a code of its own:
    `run_parallel` raises once all are joined (the JAX package's
    `run_parallel` returns as if the chunk had been done)."""
    out = _port_only("""
        import os
        from captra_tpu_torch.data.preproc_nocs import run_parallel
        done = []
        def work(chunk):
            if "bad" in chunk:
                raise ValueError("broken frame")
            if "gone" in chunk:
                os._exit(3)
        for items in (["a", "b", "bad", "c"], ["a", "b", "c", "gone"]):
            try:
                run_parallel(work, items, num_proc=2)
            except RuntimeError as err:
                print("RAISED", err)
        run_parallel(work, ["a", "b", "c"], num_proc=3)
        print("CLEAN")
        """)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("RAISED") and "chunk 1 (2 items, 'bad' .. " \
        "'c'): exit code 1" in lines[0] and "chunk 0" not in lines[0]
    assert lines[1].startswith("RAISED") and "'gone'): exit code 3" in \
        lines[1]
    assert lines[2] == "CLEAN"
    assert "ValueError: broken frame" in out.stderr
