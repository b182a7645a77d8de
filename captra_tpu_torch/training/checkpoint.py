"""Checkpoint files of the JAX package, read and written without JAX (the
counterpart of `captra_tpu/training/checkpoint.py`), in both of its
formats behind the same `<exp>/ckpt/model_%04d` naming:

  * "pickle" (the default): one file, a pickle of {params, batch_stats,
    opt_state, step, epoch[, extra]}, the variable trees as nested dicts
    of numpy arrays in flax names.  A JAX checkpoint's `opt_state` holds
    optax `NamedTuple`s, so a plain `pickle.load` would import optax and
    JAX; `load_checkpoint` reads with `_CheckpointUnpickler`, which maps
    every optax / JAX / flax / orbax class to an inert stub, allows
    exactly the names that numpy's array, scalar and dtype pickles use and
    refuses every other name (`numpy.memmap` too, which could create a
    file).
  * "orbax": an orbax `PyTreeCheckpointer` directory of {params,
    batch_stats, opt_state_leaves, step, epoch}, read and written through
    tensorstore (`orbax_io.py`), with `extra` in `captra_extra.json`
    beside it.  `opt_state_leaves` holds the optax chain's flat leaves
    under zero-padded flatten indices ("0000", ...), ordered numerically.

`save_checkpoint` writes {params, batch_stats} trees; `save_train_state`
writes a port training state: its net through `convert.flax_variables`,
its optimizer state in the port's own plain layout, numpy trees in flax
names ({"count", "mu", "nu"} for Adam, `convert.optimizer_tree`), or in
the orbax format as the JAX chain's flat leaves (`convert.optax_leaves`).
`restore_state` reads the port's layout, a JAX pickle's optax state
(`convert.restore_optimizer`) and the orbax leaves
(`convert.restore_optax_leaves`), and falls back to fresh moments on any
structure it cannot map, as the JAX function does; the JAX
`restore_state` reads a port checkpoint's params and statistics (and, in
the orbax format, its moments).

`load_checkpoint` tells the formats apart as the JAX function does: an
orbax checkpoint is a directory.
"""
from __future__ import annotations

import importlib.util
import json
import os
import pickle
import re
from os.path import join as pjoin
from typing import Mapping

import numpy as np

_CKPT_RE = re.compile(r"model_(\d{4,})$")
_EXTRA_JSON = "captra_extra.json"
FORMATS = ("pickle", "orbax")
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
    """The payload of a checkpoint of either format.  A pickle's optimizer
    state comes back as `InertState` stubs; an orbax directory's as
    `opt_state_leaves` {"%04d": array}, with its `extra` read from
    `captra_extra.json` and `step` / `epoch` as ints."""
    if os.path.isdir(path):
        from captra_tpu_torch.training.orbax_io import read_tree
        payload = read_tree(path)
        extra_path = pjoin(path, _EXTRA_JSON)
        if os.path.exists(extra_path):
            with open(extra_path) as f:
                payload["extra"] = json.load(f)
        payload["step"] = int(payload.get("step", 0))
        payload["epoch"] = int(payload.get("epoch", 0))
        return payload
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
                    extra: dict | None = None,
                    format: str = "pickle") -> str:
    """Write {params, batch_stats, opt_state, step, epoch[, extra]} to
    ckpt_dir/model_%04d in the JAX package's layout of `format` ("pickle":
    a temporary file, then a rename; "orbax": `orbax_io.write_tree`, which
    replaces an older directory of the epoch).  variables: {"params",
    "batch_stats"} numpy trees, e.g. `convert.flax_variables(module)`;
    opt_state is stored as given, and in the orbax format must be the
    optax chain's flat leaves (a sequence, `convert.optax_leaves`)."""
    if format not in FORMATS:
        raise ValueError(f"unknown checkpoint format {format!r}")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = pjoin(ckpt_dir, f"model_{epoch:04d}")
    if format == "orbax":
        from captra_tpu_torch.training.orbax_io import write_tree
        write_tree(path, {
            "params": _numpy_tree(variables["params"]),
            "batch_stats": _numpy_tree(variables.get("batch_stats", {})),
            "opt_state_leaves": {f"{i:04d}": np.asarray(leaf)
                                 for i, leaf in enumerate(opt_state)},
            "step": np.asarray(int(step), np.int64),
            "epoch": np.asarray(int(epoch), np.int64)})
        if extra:
            with open(pjoin(path, _EXTRA_JSON), "w") as f:
                json.dump(extra, f)
        return path
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


def save_train_state(ckpt_dir: str, epoch: int, state,
                     format: str = "pickle", grad_clip: float = 0.0) -> str:
    """`save_checkpoint` of a `trainer.TrainState`: its net's variables,
    its optimizer state and its step.  The optimizer state is in the
    port's layout (`convert.optimizer_tree`) in a pickle, and the JAX
    chain's flat leaves in the orbax format, whose layout depends on
    whether the chain clips (`grad_clip`, the config's
    `optim.grad_clip`)."""
    from captra_tpu_torch.training.convert import (
        flax_variables, optax_leaves, optimizer_tree,
    )
    if format not in FORMATS:
        raise ValueError(f"unknown checkpoint format {format!r}")
    opt_state = (optax_leaves(state, grad_clip) if format == "orbax"
                 else optimizer_tree(state))
    return save_checkpoint(ckpt_dir, epoch, flax_variables(state.module),
                           opt_state, state.step, format=format)


def restore_state(ckpt: dict, state):
    """Load a checkpoint payload into a `trainer.TrainState` (in place, and
    returned): params and batch statistics (every one must match), the
    step, and the optimizer state (the state's own optimizer, Adam or SGD)
    from the port's layout, a JAX pickle's optax state or an orbax
    checkpoint's `opt_state_leaves` (ordered by their integer keys); a
    structure that does not map leaves the state's own (fresh) moments."""
    from captra_tpu_torch.training.convert import (
        load_flax_variables, restore_optax_leaves, restore_optimizer,
    )
    load_flax_variables(state.module, {
        "params": _numpy_tree(ckpt["params"]),
        "batch_stats": _numpy_tree(ckpt.get("batch_stats", {}))})
    try:
        if "opt_state_leaves" in ckpt:
            saved = ckpt["opt_state_leaves"]
            state.opt_state = restore_optax_leaves(
                [saved[k] for k in sorted(saved, key=int)], state)
        else:
            state.opt_state = restore_optimizer(ckpt.get("opt_state"),
                                                state)
    except Exception:  # noqa: BLE001 - any mismatch: fresh moments
        pass
    state.step = int(ckpt.get("step", 0))
    return state
