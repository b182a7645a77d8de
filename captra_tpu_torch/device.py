"""Device resolution for the port's entry points, and device constants."""
from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as given, else CUDA.  Never falls back to the CPU quietly:
    with no card and no explicit device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "captra_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """A small constant tensor, made once per (values, dtype, device).

    Building it with `torch.tensor(..., device="cuda")` inside a step copies
    from pageable host memory, which blocks the host until the card drains
    its queue; a cached copy keeps the step free of such synchronisations.
    Callers must not write into it."""
    return torch.tensor(values, dtype=dtype, device=device)
