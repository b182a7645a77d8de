"""Checkpoint files of the JAX package, read and written without JAX (the
reading half of `captra_tpu/training/checkpoint.py`, and its pickle writer).

A checkpoint is `<exp>/ckpt/model_%04d`: a pickle of {params, batch_stats,
opt_state, step, epoch[, extra]}, the variable trees as nested dicts of
numpy arrays in flax names.  `opt_state` holds optax `NamedTuple`s, so a
plain `pickle.load` would import optax and JAX; `load_checkpoint` reads
with `_CheckpointUnpickler`, which maps every optax / JAX / flax / orbax
class to an inert stub, allows exactly the names that numpy's array, scalar
and dtype pickles use and refuses every other name (`numpy.memmap` too,
which could create a file).  The trees it returns feed
`convert.coordnet_from_flax` / `rotnet_from_flax`, and
`convert.flax_variables` makes them from a port module, so the port writes
checkpoints that the JAX package reads.

The orbax format (a directory) raises `NotImplementedError`; restoring an
optimizer state waits for the training port.
"""
from __future__ import annotations

import importlib.util
import os
import pickle
import re
from os.path import join as pjoin
from typing import Mapping

import numpy as np

_CKPT_RE = re.compile(r"model_(\d{4,})$")
# classes of the JAX stack that a checkpoint's opt_state names
_STUBBED = ("optax", "jax", "jaxlib", "flax", "orbax")
# what numpy's array, scalar and dtype pickles name: its array and scalar
# reconstructors in either spelling of its core package (protocol 5 writes
# contiguous arrays through `_frombuffer`), the two classes, and protocol 2's
# bytes codec; `numpy.dtypes` adds its `*DType` classes
_ALLOWED = ({(f"numpy.{core}.{module}", name)
             for core in ("_core", "core")
             for module, name in (("multiarray", "_reconstruct"),
                                  ("multiarray", "scalar"),
                                  ("numeric", "_frombuffer"))}
            | {("numpy", "ndarray"), ("numpy", "dtype"),
               ("_codecs", "encode")})


class InertState:
    """Stands in for an optax / JAX / flax / orbax class in a checkpoint:
    keeps whatever it was built from and does nothing."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs = args, kwargs
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return f"{type(self).__name__}{self.args!r}"


def _numpy_module(module: str) -> str:
    """`numpy._core...` is `numpy.core...` on a numpy without `_core`
    (before 2.0); numpy 2 still imports the old spelling."""
    if module.startswith("numpy._core") and \
            importlib.util.find_spec("numpy._core") is None:
        return "numpy.core" + module[len("numpy._core"):]
    return module


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root in _STUBBED:
            return type(name, (InertState,), {"__module__": module})
        if (module, name) in _ALLOWED or (module == "numpy.dtypes"
                                          and name.endswith("DType")):
            return super().find_class(_numpy_module(module), name)
        raise pickle.UnpicklingError(
            f"a checkpoint may not name {module}.{name}")


def latest_checkpoint(ckpt_dir: str, epoch: int | None = None) -> str | None:
    """The newest `model_%04d` under ckpt_dir, or the one of `epoch` when it
    is given and >= 0; None when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            cands.append((int(m.group(1)), pjoin(ckpt_dir, name)))
    if not cands:
        return None
    if epoch is not None and epoch >= 0:
        for e, p in cands:
            if e == epoch:
                return p
        return None
    return max(cands)[1]


def load_checkpoint(path: str) -> dict:
    """The payload of a pickle checkpoint; its optimizer state comes back as
    `InertState` stubs."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"ckpt_format=orbax ({path} is an orbax checkpoint directory; "
            "the port reads the pickle format)")
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def _numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def load_track_variables(coord_ckpt_path: str, rot_ckpt_path: str):
    """Tracking-time variables from two training experiments: ({"params",
    "batch_stats"} of the CoordNet, the same of the RotNet), numpy trees in
    flax names."""
    def vars_of(path):
        ckpt = load_checkpoint(path)
        return {"params": _numpy_tree(ckpt["params"]),
                "batch_stats": _numpy_tree(ckpt["batch_stats"])}

    return vars_of(coord_ckpt_path), vars_of(rot_ckpt_path)


def save_checkpoint(ckpt_dir: str, epoch: int, variables: Mapping,
                    opt_state=(), step: int = 0,
                    extra: dict | None = None) -> str:
    """Write {params, batch_stats, opt_state, step, epoch[, extra]} to
    ckpt_dir/model_%04d in the JAX package's pickle layout (a temporary file,
    then a rename).  variables: {"params", "batch_stats"} numpy trees, e.g.
    `convert.flax_variables(module)`; opt_state is stored as given."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = pjoin(ckpt_dir, f"model_{epoch:04d}")
    payload = {
        "params": _numpy_tree(variables["params"]),
        "batch_stats": _numpy_tree(variables.get("batch_stats", {})),
        "opt_state": opt_state,
        "step": int(step),
        "epoch": int(epoch),
    }
    if extra:
        payload["extra"] = extra
    with open(path + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(path + ".tmp", path)
    return path
