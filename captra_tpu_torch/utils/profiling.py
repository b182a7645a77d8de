"""Profiling and the program's tracer (counterpart of
`captra_tpu/utils/profiling.py`).

`trace` records a `torch.profiler` window over the host and, where this
build of torch can trace one, the card, and writes it as a Chrome trace
(Perfetto and `chrome://tracing` open it).

`annotate(name)` opens a span of the program's tracer.  Tracing is on
exactly while a torch profiler records (`trace`, or any
`torch.profiler.profile` window); off, `annotate` returns one shared no-op
context after a flag check.  On, a span records its name, its parent (the
innermost open span of its thread), the index of the root step it belongs
to, its host start and end and, where CUDA is initialised, a pair of
timing events on the current stream.  It also opens a
`record_function(name)`, so the span lies in the profiler's Chrome trace on
the kernels' clock.  A root span (opened with no span open on its thread)
counts the host synchronisations made inside it as `host_syncs`: CUDA's
sync debug mode warns at each, and the warnings are caught (not kept on
the CPU).  `count` adds to the innermost open span's counters.

The last `KEEP` roots are kept in memory with their descendants (older
ones drop out and their events are reused); `last_steps` reads them and
`reset` empties the store.  The tracer writes nothing to disk: the
profiler's Chrome trace carries the spans.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
import warnings

import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function

KEEP = 1024
SYNC_WARNING = "called a synchronizing CUDA operation"


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


class SyncCount:
    """From construction to `close()`: CUDA's sync debug mode set to warn
    (where it was off) and the warnings caught.  `close` restores both and
    returns the number of synchronising calls; it passes on every other
    warning, and the sync warnings too where the mode was already on."""

    def __init__(self):
        self.mode = torch.cuda.get_sync_debug_mode()
        if self.mode == 0:
            torch.cuda.set_sync_debug_mode("warn")
        self.catch = warnings.catch_warnings(record=True)
        self.caught = self.catch.__enter__()
        warnings.simplefilter("always")

    def close(self) -> int:
        self.catch.__exit__(None, None, None)
        if self.mode == 0:
            torch.cuda.set_sync_debug_mode(0)
        syncs = 0
        for w in self.caught:
            sync = SYNC_WARNING in str(w.message)
            syncs += sync
            if not sync or self.mode != 0:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno, source=w.source)
        return syncs


class Span:
    """One open or closed span (see the module)."""

    __slots__ = ("tracer", "name", "parent", "step", "children", "counters",
                 "t0", "t1", "events", "_range", "_syncs")

    def __init__(self, tracer: Tracer, name: str):
        self.tracer = tracer
        self.name = name
        self.children = []
        self.counters = {}
        self.events = None
        self._syncs = None

    def __enter__(self):
        tracer = self.tracer
        stack = tracer.open_spans()
        self.parent = stack[-1] if stack else None
        if self.parent is None:
            tracer.roots_opened += 1
            self.step = tracer.roots_opened
        else:
            self.step = self.parent.step
        self.t0 = time.perf_counter_ns()
        self._range = record_function(self.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            self.events = tracer.take_events()
            self.events[1].record()
            if self.parent is None:
                self._syncs = SyncCount()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        tracer = self.tracer
        tracer.open_spans().remove(self)
        if self._syncs is not None:
            syncs = self._syncs.close()
            self._syncs = None
            self.counters["host_syncs"] = \
                self.counters.get("host_syncs", 0) + syncs
        if self.events is not None:
            self.events[2].record()
        self._range.__exit__(*exc)
        self._range = None
        self.t1 = time.perf_counter_ns()
        if self.parent is None:
            tracer.keep(self)
        else:
            self.parent.children.append(self)
        return False

    def record(self) -> dict:
        """The closed span as plain values: name, step, host_ms, device_ms
        (None without events), counters and children, recursively.  The
        events must have completed."""
        device_ms = None
        if self.events is not None:
            device_ms = self.events[1].elapsed_time(self.events[2])
        return {"name": self.name, "step": self.step,
                "host_ms": (self.t1 - self.t0) * 1e-6,
                "device_ms": device_ms, "counters": dict(self.counters),
                "children": [c.record() for c in self.children]}


class Tracer:
    """The store of closed root spans (the last `KEEP`), the stacks of open
    spans by thread, and the pool of timing-event pairs by device."""

    def __init__(self):
        self.roots = collections.deque()
        self.roots_opened = 0
        self.pool = {}
        self.local = threading.local()

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def take_events(self) -> tuple:
        """(device index, start event, end event), from the pool of the
        current device."""
        device = torch.cuda.current_device()
        free = self.pool.setdefault(device, [])
        if free:
            return free.pop()
        return (device, torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def release(self, span: Span) -> None:
        """Give the events of `span` and its descendants back to the
        pool."""
        if span.events is not None:
            self.pool[span.events[0]].append(span.events)
            span.events = None
        for child in span.children:
            self.release(child)

    def keep(self, root: Span) -> None:
        self.roots.append(root)
        while len(self.roots) > KEEP:
            self.release(self.roots.popleft())

    def last_steps(self, root: str, n: int) -> list:
        """The last `n` closed root spans named `root`, oldest first, as
        `Span.record` gives them (the card synchronised once before the
        events are read)."""
        named = [s for s in self.roots if s.name == root]
        picked = named[max(len(named) - n, 0):] if n > 0 else []
        if any(s.events is not None for s in picked):
            torch.cuda.synchronize()
        return [s.record() for s in picked]

    def reset(self) -> None:
        while self.roots:
            self.release(self.roots.popleft())
        self.roots_opened = 0


TRACER = Tracer()
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span of the program's tracer, `with annotate("track.step"): ...`;
    the shared no-op context while no profiler records."""
    if not _profiler_enabled():
        return _OFF
    return Span(TRACER, name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the innermost open span of this
    thread, while tracing is on."""
    if not _profiler_enabled():
        return
    stack = TRACER.open_spans()
    if stack:
        counters = stack[-1].counters
        counters[name] = counters.get(name, 0) + n


def last_steps(root: str, n: int) -> list:
    """The last `n` root spans named `root` the tracer keeps, oldest first:
    each a dict of name, step, host_ms, device_ms (None without CUDA),
    counters and children, recursively."""
    return TRACER.last_steps(root, n)


def reset() -> None:
    """Empty the tracer's store."""
    TRACER.reset()
