"""The port's utilities (`captra_tpu_torch/utils/{misc,profiling}.py`) and
the last loose functions (`ops/pointops.knn`, `pose/part_dof.
{tree_children, convert_pred_rtvec_to_matrix}`) against the JAX package.

Tolerances: the dict helpers, `get_ith_from_batch` and `tree_children`
equal; `knn` indices equal on tie-free clouds, distances within 1e-6;
`convert_pred_rtvec_to_matrix` within 1e-6.  The profiler helpers run on
the CPU here: an `annotate` span shows in the trace's averages and in the
Chrome trace file `trace` writes (the tracer's spans in the program's steps
are `tests/test_torch_tracing.py`'s)."""
import json
import os

import numpy as np
import pytest
import torch

from captra_tpu.ops import pointops as jpointops
from captra_tpu.pose import part_dof as jpart_dof
from captra_tpu.utils import misc as jmisc
from captra_tpu_torch.ops import pointops
from captra_tpu_torch.pose import part_dof
from captra_tpu_torch.utils import misc, profiling

LOSSES = ({"loss": 1.0, "seg": {"a": 2.0, "b": np.float32(0.5)}, "n": 3},
          {"loss": 0.25, "seg": {"a": 1.0, "b": 1.5}, "n": 1},
          {"loss": torch.tensor(2.0), "seg": {"a": 0.5, "b": 0.0}, "n": 2})


def test_add_divide_and_log_equal_jax():
    got, want = {}, {}
    for new in LOSSES:
        misc.add_dict(got, new)
        jmisc.add_dict(want, new)
    assert got == want
    assert misc.divide_dict(got, 3) == jmisc.divide_dict(want, 3)
    logged, jlogged = [], []
    misc.log_loss_summary(got, 4, lambda *kv: logged.append(kv))
    jmisc.log_loss_summary(want, 4, lambda *kv: jlogged.append(kv))
    assert logged == jlogged == [("loss", 3.25 / 4), ("n", 6 / 4),
                                 ("seg_a", 3.5 / 4), ("seg_b", 2.0 / 4)]


def test_timer(capsys):
    assert misc.Timer(on=False).tick("x") == 0.0
    timer = misc.Timer()
    assert timer.tick() >= 0.0 and timer.tick("step") >= 0.0
    assert capsys.readouterr().out.startswith("[timer] step: ")


def test_get_ith_from_batch_equals_jax_on_numpy_and_torch():
    rng = np.random.RandomState(0)
    batch = {"points": rng.randn(3, 5, 3).astype(np.float32),
             "ids": np.arange(3), "meta": [np.array([0.5, 1.5, 2.5]),
                                           (rng.randn(3, 2),)],
             "scalar": np.float32(7.0)}
    tensors = {"points": torch.from_numpy(batch["points"]),
               "ids": torch.arange(3), "meta": [
                   torch.tensor([0.5, 1.5, 2.5], dtype=torch.float64),
                   (torch.from_numpy(batch["meta"][1][0]),)],
               "scalar": torch.tensor(7.0)}
    for i in range(3):
        for single in (True, False):
            want = jmisc.get_ith_from_batch(batch, i, single)
            for data in (batch, tensors):
                got = misc.get_ith_from_batch(data, i, single)
                assert sorted(got) == sorted(want)
                np.testing.assert_array_equal(got["points"], want["points"])
                assert type(got["ids"]) is type(want["ids"])
                assert got["ids"] == want["ids"]
                assert got["meta"][0] == want["meta"][0]
                np.testing.assert_array_equal(got["meta"][1][0],
                                              want["meta"][1][0])
                assert got["scalar"] == want["scalar"]


def test_annotate_spans_show_in_a_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("captra_span"):
            (x @ x).sum()
    names = {e.key for e in prof.key_averages()}
    assert "captra_span" in names and "aten::matmul" in names
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith(f"trace_{os.getpid()}_")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "captra_span" for e in events)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_knn_equals_jax(k):
    rng = np.random.RandomState(k)
    query = rng.randn(2, 24, 3).astype(np.float32)
    data = rng.randn(2, 40, 3).astype(np.float32)
    want_d, want_i = (np.asarray(a) for a in jpointops.knn(k, query, data))
    got_d, got_i = pointops.knn(k, torch.from_numpy(query),
                                torch.from_numpy(data))
    assert got_i.dtype == torch.int64 and got_d.shape == (2, 24, k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0, atol=1e-6)
    # nearest first, and the distances are the points' own
    near = np.take_along_axis(data[:, None], want_i[..., None], axis=2)
    np.testing.assert_allclose(
        np.linalg.norm(near - query[:, :, None], axis=-1), want_d, atol=1e-5)


@pytest.mark.parametrize("tree", [(-1,), (-1, 0), (2, 2, -1), (-1, 0, 0, 1),
                                  (1, -1, 1, 2, 2)])
def test_tree_children_equals_jax(tree):
    assert part_dof.tree_children(tree) == jpart_dof.tree_children(tree)


@pytest.mark.parametrize("sym", [True, False])
def test_convert_pred_rtvec_to_matrix_equals_jax(sym):
    rng = np.random.RandomState(int(sym))
    pred = rng.randn(4, 2, 3 if sym else 9).astype(np.float32)
    want = np.asarray(jpart_dof.convert_pred_rtvec_to_matrix(pred, sym))
    got = part_dof.convert_pred_rtvec_to_matrix(torch.from_numpy(pred), sym)
    assert got.shape == (4, 2, 3, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    eye = got.transpose(-1, -2) @ got
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(3),
                                                            eye.shape),
                               atol=1e-5)


def test_written_whole_shows_the_whole_file_or_none(tmp_path):
    """A reader sees nothing at the path while the block writes, the whole
    file after it; an error in the block leaves the old file and no
    temporary behind (the ranks of a data-parallel run cache the same
    dataset files)."""
    path = str(tmp_path / "split.txt")
    with misc.written_whole(path) as f:
        f.write("a\n")
        f.flush()
        assert not os.path.exists(path)
    assert open(path).read() == "a\n"
    with pytest.raises(RuntimeError):
        with misc.written_whole(path) as f:
            f.write("partial")
            raise RuntimeError("stop")
    assert open(path).read() == "a\n"
    assert os.listdir(tmp_path) == ["split.txt"]
