"""NN building blocks, channels-last (counterpart of
`captra_tpu/models/blocks.py`).

1x1 convolutions over [B, C, N] are `nn.Linear` over the trailing channel of
[B, ..., C], the same matmul as the JAX package's `nn.Dense`.  Submodules are
named after the flax tree (`dense_0`, `norm_0`, ...) so that
`training/convert.py` is a plain walk over it.

Momentum convention for later training: flax BatchNorm keeps
`running = m * running + (1 - m) * batch` (m = `bn_momentum`, 0.9), torch
keeps `running += m_torch * (batch - running)`; the port stores
`momentum = 1 - bn_momentum`.  The slice runs the nets in eval mode only.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

_ACTIVATIONS = {
    "relu": F.relu,
    "none": lambda x: x,
}


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the trailing channel of [B, ..., C] (eps 1e-5, as
    flax's default)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class GroupNorm(nn.Module):
    """Flax-semantics GroupNorm, channels-last: groups of `group_size`
    channels, statistics per leading sample over every other axis, and
    flax's `(x - mean) * (rsqrt(var + eps) * scale) + bias` order.  The
    reference uses 2 channels per group and torch's eps 1e-5.

    The variance is two-pass, E[(x - mean)^2].  Flax's fast variance,
    E[x^2] - E[x]^2, cancels in float32 on groups whose variance is small
    next to their mean (measured: 1e-3 relative error at var 2e-5); the
    two-pass form keeps the port near the exact value, so its distance to
    the JAX output is about the JAX error alone."""

    def __init__(self, channels: int, group_size: int = 2, eps: float = 1e-5):
        super().__init__()
        if channels % group_size:
            raise ValueError(f"{channels} channels do not split into groups "
                             f"of {group_size}")
        self.group_size = group_size
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        G, gs = C // self.group_size, self.group_size
        g = x.reshape(B, -1, G, gs)
        mean = g.mean(dim=(1, 3), keepdim=True)              # [B, 1, G, 1]
        var = torch.square(g - mean).mean(dim=(1, 3), keepdim=True)
        mean = mean.expand(B, 1, G, gs).reshape(B, 1, C)
        mul = torch.rsqrt(var + self.eps).expand(B, 1, G, gs).reshape(
            B, 1, C) * self.weight
        y = (x.reshape(B, -1, C) - mean) * mul + self.bias
        return y.reshape(x.shape)


class PointMLP(nn.Module):
    """Stack of per-point Linear layers: linear -> norm -> activation.

    dims: all layer widths including the output layer.  norm 'bn' | 'gn' |
    'none' applies to every layer except the last (unless last_norm);
    final_acti applies to the last layer only, relu to the others."""

    def __init__(self, in_dim: int, dims: Sequence[int], norm: str = "bn",
                 final_acti: str = "none", last_norm: bool = False,
                 bn_momentum: float = 0.9):
        super().__init__()
        if norm not in ("bn", "gn", "none"):
            raise ValueError(f"unknown norm {norm!r} (bn|gn|none)")
        if final_acti not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {final_acti!r} "
                             f"({'|'.join(_ACTIVATIONS)})")
        self.num_layers = len(dims)
        self.final_acti = final_acti
        last_dim = in_dim
        for i, d in enumerate(dims):
            last = i == len(dims) - 1
            self.add_module(f"dense_{i}", nn.Linear(last_dim, d))
            layer_norm = norm if (not last or last_norm) else "none"
            if layer_norm == "bn":
                self.add_module(f"norm_{i}", BatchNorm(
                    d, eps=1e-5, momentum=1.0 - bn_momentum))
            elif layer_norm == "gn":
                self.add_module(f"norm_{i}", GroupNorm(d))
            last_dim = d
        self.out_dim = last_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"dense_{i}")(x)
            norm = getattr(self, f"norm_{i}", None)
            if norm is not None:
                x = norm(x)
            last = i == self.num_layers - 1
            x = _ACTIVATIONS["relu" if not last else self.final_acti](x)
        return x


@torch.no_grad()
def init_xavier_(module: nn.Module,
                 generator: torch.Generator | None = None) -> nn.Module:
    """Flax's initialisation for every Linear in `module`: xavier-uniform
    kernels, zero biases; `generator` (on the parameters' device) makes the
    draw explicit."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            fan_out, fan_in = m.weight.shape
            a = (6.0 / (fan_in + fan_out)) ** 0.5
            m.weight.uniform_(-a, a, generator=generator)
            m.bias.zero_()
    return module


def check_network_supported(cfg) -> None:
    """Raise for network options this slice of the port does not carry."""
    net = cfg.network
    if net.compute_dtype != "float32":
        raise NotImplementedError(
            f"network/compute_dtype={net.compute_dtype!r} is not ported "
            "(float32 only)")
    if net.basin_head:
        raise NotImplementedError("network/basin_head is not ported")
