"""Small shared utilities (counterpart of `captra_tpu/utils/misc.py`):
nested-dict accumulation and averaging for loss logs, a wall-clock tick
timer, and element i of a batched nested structure."""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


def add_dict(total: dict, new: dict) -> None:
    """Accumulate (possibly nested) numeric dicts in place."""
    for k, v in new.items():
        if isinstance(v, dict):
            total.setdefault(k, {})
            add_dict(total[k], v)
        else:
            total[k] = total.get(k, 0.0) + float(v)


def divide_dict(d: dict, cnt: int) -> dict:
    """Element-wise divide a nested dict."""
    return {k: (divide_dict(v, cnt) if isinstance(v, dict) else v / cnt)
            for k, v in d.items()}


def log_loss_summary(loss_dict: dict, cnt: int, log_fn) -> None:
    """Flatten (keys joined by `_`, in sorted order), average over `cnt`
    and emit each value as `log_fn(name, value)`."""
    def walk(prefix, d):
        for k, v in sorted(d.items()):
            name = f"{prefix}_{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(name, v)
            else:
                log_fn(name, v / cnt)

    walk("", loss_dict)


class Timer:
    """Wall-clock tick timer: `tick(tag)` returns the seconds since the
    last tick (or construction) and prints them in ms when tagged."""

    def __init__(self, on: bool = True):
        self.on = on
        if on:
            self.last = time.perf_counter()

    def tick(self, tag: str | None = None) -> float:
        if not self.on:
            return 0.0
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        if tag:
            print(f"[timer] {tag}: {dt * 1e3:.2f} ms")
        return dt


def get_ith_from_batch(data, i: int, to_single: bool = True):
    """Element i of a batched nested structure (dicts, lists, tuples of
    arrays, tensors or scalars); a 0-d result becomes a Python scalar when
    `to_single`.  A tensor (on any device) is copied to the host first."""
    if isinstance(data, dict):
        return {k: get_ith_from_batch(v, i, to_single) for k, v in
                data.items()}
    if isinstance(data, (list, tuple)):
        return [get_ith_from_batch(v, i, to_single) for v in data]
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    arr = np.asarray(data)
    if arr.ndim == 0:
        return arr.item() if to_single else arr
    out = arr[i]
    if to_single and out.ndim == 0:
        return out.item()
    return out


@contextlib.contextmanager
def written_whole(path: str, mode: str = "w"):
    """Open a file of this process beside `path` for writing, and rename it
    onto `path` when the block ends without an error: a reader in another
    process (the ranks of a data-parallel run read and cache the same
    dataset) sees the whole file or none."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, mode) as f:
            yield f
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
