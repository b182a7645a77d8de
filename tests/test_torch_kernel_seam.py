"""The hand-written kernels' one seam (`captra_tpu_torch/ops/cuda_build.py`)
on the CPU: the one launch registry every kernel module registers into,
its count call and its one reset; a launch through `Kernels` (its stream,
its error path, its counting) with a stand-in library and stream; and
`bind`'s check of the built constants.  The kernels themselves run only on
the card (`tests/test_torch_cuda.py`).  This file imports no JAX."""
import contextlib
import types

import pytest
import torch

from captra_tpu_torch.ops import cuda_build, fps, neighbors, sa_mlp
from captra_tpu_torch.utils import profiling

KERNELS = {
    fps: ("fps_cuda_batched", "fps_cuda_wide", "fps_cuda_batched_cluster",
          "fps_cuda_wide_cluster", "fps_cuda_blocked"),
    sa_mlp: ("sa_mlp_cuda", "sa_table_cuda"),
    neighbors: ("ball_query_cuda", "three_nn_cuda"),
}
CASES = [(m, k) for m, names in KERNELS.items() for k in names]


@pytest.mark.parametrize("module,kernel", CASES,
                         ids=[k for _, k in CASES])
def test_the_one_registry_counts_every_kernel(module, kernel):
    """Each kernel is in the registry from import on; the seam's count call
    grows it there and in its module's view, with no card; the one reset
    clears every kernel."""
    registry = cuda_build.launch_counts
    assert set(module.launch_counts) == set(KERNELS[module])
    assert set(KERNELS[module]) <= set(registry)
    cuda_build.reset_launch_counts()
    cuda_build.count(kernel)
    cuda_build.count(kernel)
    assert registry[kernel] == module.launch_counts[kernel] == 2
    assert sum(registry.values()) == 2
    cuda_build.reset_launch_counts()
    assert not any(registry.values())
    assert module.launch_counts[kernel] == 0


class _Entry:
    def __init__(self, ret):
        self.ret, self.calls = ret, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


@pytest.fixture
def seam(monkeypatch):
    """A registry of the test's own, and a CPU stand-in for the current
    CUDA stream (a launch names the stream it was given)."""
    monkeypatch.setattr(cuda_build, "launch_counts", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=1234))


def _kernels(ret, counter=None):
    k = cuda_build.Kernels("x.cu", {"x_cuda": ("captra_x", cuda_build.PTR)},
                           error="captra_x_error_string", counter=counter)
    k.lib = types.SimpleNamespace(captra_x=_Entry(ret),
                                  captra_x_error_string=lambda err: b"bad")
    return k


@pytest.mark.parametrize("counter", [None, "x_fused", {"x_cuda": "x_fused"},
                                     {"y_cuda": "y_fused"}])
def test_a_launch_passes_the_stream_and_counts_once(seam, counter):
    k = _kernels(0, counter)
    assert cuda_build.launch_counts == {"x_cuda": 0}
    assert dict(k.launch_counts) == {"x_cuda": 0}
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("track.step"):
            k.launch("x_cuda", torch.device("cuda"), 7)
    root = profiling.last_steps("track.step", 1)[0]
    profiling.reset()
    assert k.lib.captra_x.calls == [(7, 1234)]
    assert cuda_build.launch_counts == {"x_cuda": 1}
    # a dict names each kernel's own counter, none for a kernel it leaves
    # out
    named = counter.get("x_cuda") if isinstance(counter, dict) else counter
    want = {} if named is None else {named: 1}
    assert {c: n for c, n in root["counters"].items()
            if c != "host_syncs"} == want


def test_a_failed_launch_raises_the_library_s_error_and_counts_nothing(seam):
    k = _kernels(3, "x_fused")
    with pytest.raises(RuntimeError, match=r"x_cuda launch failed: bad \(3\)"):
        k.launch("x_cuda", torch.device("cuda"), 7)
    assert cuda_build.launch_counts == {"x_cuda": 0}


def test_bind_checks_the_built_constants(monkeypatch):
    class Fn:
        def __init__(self, value):
            self.value = value

        def __call__(self):
            return self.value
    lib = types.SimpleNamespace(a=Fn(1), b=Fn(2))
    monkeypatch.setattr(cuda_build, "load", lambda source: lib)
    assert cuda_build.bind("x.cu", {}, {"a": 1, "b": 2}) is lib
    assert lib.a.restype is cuda_build.INT and lib.a.argtypes == []
    with pytest.raises(RuntimeError, match=r"x.cu was built with \(a, b\) "
                       r"\(1, 2\), the wrapper expects \(1, 3\)"):
        cuda_build.bind("x.cu", {}, {"a": 1, "b": 3})
