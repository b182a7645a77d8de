"""The orbax `PyTreeCheckpointer` directory format, read and written with
tensorstore alone (no JAX, no orbax).

A checkpoint directory holds:

  * `_METADATA` (JSON): `tree_metadata`, one entry a leaf, keyed by the
    leaf's path as a tuple string ("('params', 'a', 'w')") with its
    `key_metadata` (the path's dict keys) and `value_metadata`; plus the
    storage flags (`use_ocdbt`, `use_zarr3`, ...);
  * `_CHECKPOINT_METADATA` (JSON): the handler that wrote it and the
    timestamps;
  * the leaves, each a zarr v2 array inside one OCDBT key-value store at
    the directory's root, under its path joined by "." ("params.a.w").

orbax writes each process's arrays behind `ocdbt.process_<i>/` and links
them from the root manifest; tensorstore reads them through the root in
either layout.  `write_tree` writes one array a leaf, the whole array as
one chunk, zstd level 1 (orbax's default), into a temporary directory that
it renames into place, replacing an older checkpoint of the same name (the
JAX package saves with `force=True`).

tensorstore is imported when a function is called, not when this module
is imported; without it the call raises `ImportError` naming it.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Mapping

import numpy as np

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
           "PyTreeCheckpointHandler")
# orbax's key type of a dict key (`KeyType.DICT`)
_DICT_KEY = 2


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "the orbax checkpoint format needs the tensorstore package, "
            "which is not installed") from e
    return tensorstore


def _leaf_spec(directory: str, key: str) -> dict:
    return {"driver": "zarr",
            "kvstore": {"driver": "ocdbt",
                        "base": "file://" + os.path.abspath(directory),
                        "path": key}}


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def read_tree(directory: str) -> dict:
    """The nested dict of numpy arrays an orbax `PyTreeCheckpointer`
    directory holds (0-d leaves as 0-d arrays).  A directory without orbax
    metadata raises FileNotFoundError or ValueError."""
    ts = _tensorstore()
    path = os.path.join(directory, METADATA)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{directory} is no orbax checkpoint: it "
                                f"has no {METADATA}")
    with open(path) as f:
        meta = json.load(f)
    if "tree_metadata" not in meta:
        raise ValueError(f"{path}: orbax metadata without a tree_metadata")
    tree: dict = {}
    context = ts.Context()       # the store's database opened once
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        store = ts.open(_leaf_spec(directory, ".".join(keys)),
                        context=context).result()
        _put(tree, keys, np.asarray(store.read().result()))
    return tree


def _leaves(tree: Mapping, path: tuple = ()):
    for key, value in tree.items():
        if not isinstance(key, str):
            raise TypeError(f"{path + (key,)}: orbax trees here have string "
                            "keys")
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), np.asarray(value)


def _zarr_metadata(value: np.ndarray) -> dict:
    return {"shape": list(value.shape), "chunks": list(value.shape),
            "dtype": value.dtype.str, "compressor": {"id": "zstd",
                                                     "level": 1},
            "fill_value": None, "filters": None, "order": "C",
            "dimension_separator": "."}


def write_tree(directory: str, tree: Mapping) -> str:
    """Write `tree` (nested dicts of arrays, string keys) as an orbax
    `PyTreeCheckpointer` directory at `directory`, atomically: into a
    temporary sibling first, then renamed into place; an existing
    checkpoint there is replaced.  Returns the directory."""
    ts = _tensorstore()
    directory = os.path.abspath(directory)
    parent = os.path.dirname(directory)
    os.makedirs(parent, exist_ok=True)
    stamp = time.time_ns()
    tmp = f"{directory}.orbax-checkpoint-tmp-{stamp}"
    os.makedirs(tmp)
    try:
        # one transaction: the database commits once, not once a leaf
        context, txn = ts.Context(), ts.Transaction()
        tree_meta, writes = {}, []
        for path, value in _leaves(tree):
            store = ts.open(dict(_leaf_spec(tmp, ".".join(path)),
                                 metadata=_zarr_metadata(value)),
                            create=True, context=context,
                            transaction=txn).result()
            writes.append(store.write(value))
            tree_meta[str(tuple(path))] = {
                "key_metadata": [{"key": k, "key_type": _DICT_KEY}
                                 for k in path],
                "value_metadata": {"value_type": "np.ndarray",
                                   "skip_deserialize": False}}
        for w in writes:
            w.result()
        txn.commit_sync()
        with open(os.path.join(tmp, METADATA), "w") as f:
            json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                       "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True,
                       "custom_metadata": None}, f)
        with open(os.path.join(tmp, CHECKPOINT_METADATA), "w") as f:
            json.dump({"item_handlers": HANDLER, "metrics": {},
                       "performance_metrics": {},
                       "init_timestamp_nsecs": stamp,
                       "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        old = None
        if os.path.exists(directory):
            old = f"{directory}.orbax-checkpoint-old-{stamp}"
            os.rename(directory, old)
        os.rename(tmp, directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        shutil.rmtree(old)
    return directory
