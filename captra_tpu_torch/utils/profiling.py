"""Profiling helpers (counterpart of `captra_tpu/utils/profiling.py`).

`trace` records a `torch.profiler` window over the host and, where this
build of torch can trace one, the card, and writes it as a Chrome trace
(Perfetto and `chrome://tracing` open it); `annotate` names a region of
that trace; `block_time` is a synchronised wall clock of a callable.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write `log_dir/trace_<pid>_<ns>.json`:

        with trace("/tmp/prof") as prof:
            run()
        prof.key_averages()

    It records CPU and CUDA activity (CUDA where torch supports it)."""
    os.makedirs(log_dir, exist_ok=True)
    supported = torch.profiler.supported_activities()
    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in supported]
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region inside a trace: `with annotate("gn"): ...`."""
    return record_function(name)


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for v in out:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def _wait(out) -> None:
    """Wait for the card that holds the first tensor of `out` (found
    depth first through dicts, lists and tuples); nothing for a CPU
    output."""
    t = _first_tensor(out)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def block_time(fn, *args, iters: int = 10, warmup: int = 1, **kwargs):
    """Seconds an iteration of `fn(*args, **kwargs)`: `warmup` calls, then
    `iters` timed calls, each run ending in a wait for the output's card."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _wait(out)
    return (time.perf_counter() - t0) / iters
