"""JAX (flax) variables -> the port's modules.

Takes a flax variable tree `{"params": ..., "batch_stats": ...}` as nested
dicts of numpy arrays (what `jax.tree.map(np.asarray, variables)` gives) and
loads it into `CoordNet` / `RotNet`.  The port's submodules are named after
the flax tree (`backbone.sa1.scale_0.dense_0`, ...), so this is a plain
walk:

  Dense   kernel [Cin, Cout] -> Linear weight [Cout, Cin]; bias -> bias
  BN      scale/bias -> weight/bias; batch_stats mean/var -> running_mean/
          running_var
  GN      scale/bias -> weight/bias
  `heads` (the JAX RotNet's part-vmapped head) carries a leading [P] axis on
          every leaf; part p loads into `regressor.heads.{p}`.

Loading the reference's torch `.pt` checkpoints is a later slice.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from captra_tpu_torch.config.schema import Config
from captra_tpu_torch.models.coordnet import CoordNet
from captra_tpu_torch.models.rotnet import RotNet

_PARAM = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT = {"mean": "running_mean", "var": "running_var"}
_STACKED = "heads"


def _leaves(tree: Mapping, path: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value, np.float32)


def _torch_leaf(name: str, value: np.ndarray) -> np.ndarray:
    return np.swapaxes(value, -1, -2) if name == "kernel" else value


def flax_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """The port state_dict that a flax variable tree maps to."""
    state = {}
    for collection, names in (("params", _PARAM), ("batch_stats", _STAT)):
        for path, value in _leaves(variables.get(collection, {})):
            *mods, leaf = path
            value = _torch_leaf(leaf, value)
            if _STACKED in mods:
                at = mods.index(_STACKED) + 1
                for p in range(value.shape[0]):
                    key = ".".join(mods[:at] + [str(p)] + mods[at:])
                    state[f"{key}.{names[leaf]}"] = torch.tensor(value[p])
            else:
                state[".".join(mods) + f".{names[leaf]}"] = torch.tensor(value)
    return state


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy a flax variable tree into `module` (any device).  Every
    parameter and BN statistic of the module must be covered, and every
    flax leaf must land somewhere."""
    state = flax_state_dict(variables)
    own = module.state_dict()
    missing = [k for k in own if k not in state
               and not k.endswith("num_batches_tracked")]
    unexpected = [k for k in state if k not in own]
    if missing or unexpected:
        raise ValueError(f"flax tree does not match {type(module).__name__}:"
                         f" missing {missing[:5]}, unexpected "
                         f"{unexpected[:5]}")
    for key, value in state.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: port shape {tuple(own[key].shape)} vs "
                             f"flax {tuple(value.shape)}")
    module.load_state_dict(state, strict=False)
    return module


def coordnet_from_flax(cfg: Config, variables: Mapping,
                       device=None) -> CoordNet:
    """A `CoordNet` on `device` (CUDA unless given) holding flax
    variables."""
    return load_flax_variables(CoordNet(cfg, device=device), variables)


def rotnet_from_flax(cfg: Config, variables: Mapping, device=None) -> RotNet:
    """A `RotNet` on `device` (CUDA unless given) holding flax variables."""
    return load_flax_variables(RotNet(cfg, device=device), variables)
