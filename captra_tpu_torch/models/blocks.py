"""NN building blocks, channels-last (counterpart of
`captra_tpu/models/blocks.py`).

1x1 convolutions over [B, C, N] are `nn.Linear` over the trailing channel of
[B, ..., C], the same matmul as the JAX package's `nn.Dense`.  Submodules are
named after the flax tree (`dense_0`, `norm_0`, ...) so that
`training/convert.py` is a plain walk over it.

Compute dtype (`network/compute_dtype`, float32 | bfloat16 | float16), as
flax's `dtype` with float32 `param_dtype`: `PointMLP` casts its input to
the dtype; each Linear computes in it from float32 parameters cast at the
call; BatchNorm and GroupNorm normalise in float32 (float32 running or
group statistics, flax's `_normalize` promotion) and return the dtype;
activations run in it.

Momentum convention: flax BatchNorm keeps `running = m * running + (1 - m)
* batch` (m = `bn_momentum`, 0.9), torch keeps `running += m_torch * (batch
- running)`; the port stores `momentum = 1 - bn_momentum` and, in train
mode, writes the running statistics in flax's formula itself (`BatchNorm`).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from captra_tpu_torch.parallel import mesh

_ACTIVATIONS = {
    "relu": F.relu,
    "none": lambda x: x,
}


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    # flax's statistics dtype: at least float32 (float64 stays float64)
    return torch.promote_types(dtype, torch.float32)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or in its own dtype when that is wider."""
    return x.to(_stat_dtype(x.dtype))


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the trailing channel of [B, ..., C] (eps 1e-5, as
    flax's default).  A bfloat16 / float16 input is normalised in float32
    from the float32 statistics and parameters and returned in its own
    dtype (torch's mixed-dtype batch norm: flax's order and rounding).

    In train mode the output is torch's, normalised with the batch
    statistics, and the running statistics are written here as flax
    writes them, not as torch does: the variance is the biased
    E[x^2] - E[x]^2 in float32, clamped at 0 (flax's `use_fast_variance`;
    torch's is unbiased, n / (n - 1) larger), mixed in with flax's momentum
    `1 - self.momentum`, and an entry that comes out non-finite keeps its
    old value (the JAX trainer's guard, trainer.py:352-354).

    In train mode under an active data-parallel group
    (`parallel.mesh.active`), the statistics are the global batch's, as
    under the JAX package's mesh.  Each rank puts its rows' mean and
    centred sum of squares in its own slot of a [ranks, 2, C] tensor, and
    one differentiable all-reduce (its backward carries every rank's
    gradient of the statistics back to each rank's rows, as
    SyncBatchNorm's does) gives every rank all of them; the global mean
    and biased variance follow from them exactly (Chan et al.'s
    combination: the sum of the ranks' centred sums plus each rank's rows
    times the square of its mean's distance to the global mean).  A
    single [sum, sum of squares] all-reduce, E[x^2] - E[x]^2, cancels in
    float32: at batch 12 x 4096 on the card it moved the CoordNet's
    losses by 2.4e-3 of the single-process step's.  The output and the
    running statistics use the global statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(
                x.reshape(-1, x.shape[-1])).reshape(x.shape)
        flat = x.reshape(-1, x.shape[-1]).to(_stat_dtype(x.dtype))
        dp = mesh.current()
        if dp is None:
            y = F.batch_norm(flat, None, None, self.weight, self.bias,
                             training=True, eps=self.eps)
            with torch.no_grad():
                mean = flat.mean(dim=0)
                var = torch.clamp_min(
                    (flat * flat).mean(dim=0) - mean * mean, 0.0)
        else:
            mean, var = _global_moments(flat, dp)
            y = ((flat - mean) * (torch.rsqrt(var + self.eps) * self.weight)
                 + self.bias)
            mean, var = mean.detach(), var.detach()
        with torch.no_grad():
            m = 1.0 - self.momentum
            for stat, batch in ((self.running_mean, mean),
                                (self.running_var, var)):
                new = m * stat + (1.0 - m) * batch
                stat.copy_(torch.where(torch.isfinite(new), new, stat))
        return y.reshape(x.shape).to(x.dtype)


def _global_moments(flat: torch.Tensor, dp):
    """The mean and biased variance [C] of the rows of `flat` [n, C] on
    every rank of `dp` (equal n a rank), differentiable, from one
    all-reduce of each rank's (mean, centred sum of squares)."""
    local_mean = flat.mean(dim=0)
    m2 = torch.square(flat - local_mean).sum(dim=0)
    slots = torch.zeros((dp.world, 2, flat.shape[1]), dtype=flat.dtype,
                        device=flat.device)
    slots = slots.index_copy(0, torch.tensor([dp.rank], device=flat.device),
                             torch.stack([local_mean, m2])[None])
    means, m2s = dp.all_reduce(slots).unbind(1)        # [ranks, C] each
    mean = means.mean(dim=0)
    n = flat.shape[0]
    var = (m2s.sum(dim=0) + n * torch.square(means - mean).sum(dim=0)) / (
        n * dp.world)
    return mean, var


def set_bn_momentum(module: nn.Module, bn_momentum: float) -> None:
    """Give every `BatchNorm` of `module` the flax momentum `bn_momentum`
    (the epoch schedule of the trainer); nothing is rebuilt."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.momentum = 1.0 - bn_momentum


class GroupNorm(nn.Module):
    """Flax-semantics GroupNorm, channels-last: groups of `group_size`
    channels, statistics per leading sample over every other axis, and
    flax's `(x - mean) * (rsqrt(var + eps) * scale) + bias` order.  The
    reference uses 2 channels per group and torch's eps 1e-5.

    The variance is two-pass, E[(x - mean)^2].  Flax's fast variance,
    E[x^2] - E[x]^2, cancels in float32 on groups whose variance is small
    next to their mean (measured: 1e-3 relative error at var 2e-5); the
    two-pass form keeps the port near the exact value, so its distance to
    the JAX output is about the JAX error alone.  Statistics and the
    normalisation run in at least float32 whatever the input's dtype
    (flax's default), and the output takes the input's dtype."""

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
        dtype = x.dtype
        x = x.to(_stat_dtype(dtype))
        g = x.reshape(B, -1, G, gs)
        mean = g.mean(dim=(1, 3), keepdim=True)              # [B, 1, G, 1]
        var = torch.square(g - mean).mean(dim=(1, 3), keepdim=True)
        mean = mean.expand(B, 1, G, gs).reshape(B, 1, C)
        mul = torch.rsqrt(var + self.eps).expand(B, 1, G, gs).reshape(
            B, 1, C) * self.weight
        y = (x.reshape(B, -1, C) - mean) * mul + self.bias
        return y.reshape(x.shape).to(dtype)


class PointMLP(nn.Module):
    """Stack of per-point Linear layers: linear -> norm -> activation.

    dims: all layer widths including the output layer.  norm 'bn' | 'gn' |
    'none' applies to every layer except the last (unless last_norm);
    final_acti applies to the last layer only, relu to the others.  dtype
    (None: float32) is the compute dtype; parameters stay float32."""

    def __init__(self, in_dim: int, dims: Sequence[int], norm: str = "bn",
                 final_acti: str = "none", last_norm: bool = False,
                 bn_momentum: float = 0.9, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
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
        dt = self.dtype
        if dt is not None:
            x = x.to(dt)
        for i in range(self.num_layers):
            dense = getattr(self, f"dense_{i}")
            x = (dense(x) if dt is None else
                 F.linear(x, dense.weight.to(dt), dense.bias.to(dt)))
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


# flax's truncated normal keeps draws within 2 standard deviations, and
# `variance_scaling` divides its stddev by the truncated normal's own stddev
# (jax.nn.initializers.variance_scaling)
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_lecun_normal_(linear: nn.Linear,
                       generator: torch.Generator | None = None
                       ) -> nn.Linear:
    """Flax's default `Dense` initialisation for one Linear: a lecun-normal
    kernel (a normal truncated at 2 standard deviations, of variance
    1 / fan_in once truncated) and a zero bias, drawn from `generator`."""
    fan_in = linear.weight.shape[1]
    std = (1.0 / fan_in) ** 0.5 / _TRUNCATED_STD
    nn.init.trunc_normal_(linear.weight, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)
    linear.bias.zero_()
    return linear


# `network/compute_dtype` -> the torch compute dtype (None: float32, the
# modules' own); the JAX package takes any name `jnp.dtype` reads and uses
# it where it is not "float32"
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}


def compute_dtype(cfg) -> torch.dtype | None:
    """The compute dtype `cfg.network.compute_dtype` names: None for
    float32, else bfloat16 or float16.  Any other name raises."""
    name = cfg.network.compute_dtype
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"network/compute_dtype={name!r} is not one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]
