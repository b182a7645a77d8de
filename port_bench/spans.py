"""The program's own spans and counters (`captra_tpu_torch.utils.profiling`)
as the per-layer readers read them.

A reader takes the last `run.trace.steps` root spans of its kind that the
program's tracer keeps: the traced window's steps (the profiler's
throwaway first step is older, the measured window was not traced).  It
reads nothing (None) without a traced window, where the program has no
tracer (no `profiling.last_steps`), where fewer roots were kept, or where
a span it reads has no device time (no CUDA).  A span's device ms is its
interval on the stream, between the events it records at its open and
its close: its kernels and the card's idle between them.
"""
from __future__ import annotations


def roots(run, root: str):
    """The traced window's root spans named `root`, or None."""
    steps = getattr(getattr(run, "trace", None), "steps", 0)
    if not steps:
        return None
    from captra_tpu_torch.utils import profiling
    last_steps = getattr(profiling, "last_steps", None)
    if last_steps is None:
        return None
    got = last_steps(root, steps)
    if len(got) < steps or any(r["device_ms"] is None for r in got):
        return None
    return got


def _named(span: dict, name: str) -> list:
    """The spans named `name` below `span` (not looking inside them)."""
    out = []
    for child in span["children"]:
        out.extend([child] if child["name"] == name
                   else _named(child, name))
    return out


def span_ms(run, root: str, name: str):
    """Σ device ms of the spans `name` inside a root `root`, the mean over
    the traced steps; None where no root holds one."""
    got = roots(run, root)
    if got is None:
        return None
    spans = [s for r in got for s in _named(r, name)]
    if not spans or any(s["device_ms"] is None for s in spans):
        return None
    return sum(s["device_ms"] for s in spans) / len(got)


def self_ms(run, root: str):
    """A root's device ms minus its children's, the mean over the traced
    steps: the root's own work and the card's idle in it."""
    got = roots(run, root)
    if got is None or any(c["device_ms"] is None for r in got
                          for c in r["children"]):
        return None
    return sum(r["device_ms"] - sum(c["device_ms"] for c in r["children"])
               for r in got) / len(got)


def counter(run, root: str, name: str):
    """The counter `name` of a root `root`, the mean over the traced
    steps."""
    got = roots(run, root)
    if got is None or any(name not in r["counters"] for r in got):
        return None
    return sum(r["counters"][name] for r in got) / len(got)
