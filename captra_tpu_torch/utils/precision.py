"""Matmul-precision control (counterpart of `captra_tpu/utils/precision.py`).

Pose algebra, Procrustes and metrics must run in full float32: 3x3 products
in TF32 (10-bit mantissa) put ~1e-3 errors into rotations, which compound
over the tracking recurrence.  `f32_precision` turns TF32 off for both
`torch.backends.cuda.matmul.allow_tf32` and `torch.backends.cudnn.allow_tf32`
for its scope and restores both afterwards.  It works as a decorator and as
a context manager.
"""
from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def _no_tf32():
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def f32_precision(fn=None):
    """`@f32_precision` on a function, or `with f32_precision():`."""
    if fn is None:
        return _no_tf32()

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _no_tf32():
            return fn(*args, **kwargs)
    return wrapped
