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

`flax_variables` is the inverse: a port module back to the flax tree, so
the port writes checkpoints in the JAX package's layout
(`training/checkpoint.py`).  `optimizer_tree` / `restore_optimizer` map a
training state's optimizer moments to and from flax-named trees (the port's
checkpoint layout) and read a JAX checkpoint's optax state;
`optax_leaves` / `restore_optax_leaves` map them to and from the flat leaf
list of the JAX package's optax chain (the orbax format's
`opt_state_leaves`).

The reference's released torch checkpoints (`.pt` / `.tar`: {epoch,
iteration, model: state_dict, optimizer}, reference trainer.py:196-210) map
onto the same flax trees through `load_torch_state_dict` and the
`convert_*` functions, numpy for numpy the JAX package's
(`captra_tpu/training/convert.py`), so they reach the port's nets through
`load_flax_variables` like any flax tree.  Key layout of the reference's
modules:

  CoordNet:    net.backbone.* / net.seg_head.* / net.nocs_head.*
               (networks.py:19-32, backbones.py:15-53)
  RotationNet: net.regress_net.encoder.* /
               net.regress_net.pose_pred.rtvec_head.{p}.model.*
               (networks.py:113-121, blocks.py:168-179)

torch's 1x1 Conv1d / Conv2d weights [Cout, Cin, 1(, 1)] become Dense
kernels [Cin, Cout]; BN running statistics become batch_stats; the P
rotation heads stack on the leading axis of `heads`.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from captra_tpu_torch.config.schema import Config, PointNetCfg
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
            value = np.asarray(value)
            # float64 trees (a JAX state under x64) keep their precision
            yield path + (key,), (value if value.dtype == np.float64
                                  else value.astype(np.float32))


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


def flax_variables(module: nn.Module) -> dict:
    """The flax variable tree {"params", "batch_stats"} of a port module, as
    nested dicts of float32 numpy arrays (the inverse of `flax_state_dict`):
    Linear weights transposed back to kernels, norm weights named scale,
    `heads.{p}` stacked on a leading [P] axis; a trained module's running
    statistics are its batch_stats."""
    return _flax_tree(module.state_dict().items())


def _flax_tree(items) -> dict:
    """{"params", "batch_stats"} from (port state_dict key, tensor) pairs."""
    tree: dict = {"params": {}, "batch_stats": {}}
    stacked: dict = {}
    for key, value in items:
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        # a copy: `.numpy()` of a CPU tensor shares its memory
        value = np.array(value.detach().cpu().float().numpy())
        if leaf in ("running_mean", "running_var"):
            collection, name = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight":
            collection, name = "params", ("kernel" if value.ndim == 2
                                          else "scale")
        else:
            collection, name = "params", leaf
        value = _torch_leaf(name, value)
        if _STACKED in mods:
            at = mods.index(_STACKED) + 1
            path = (collection, *mods[:at], *mods[at + 1:], name)
            stacked.setdefault(path, {})[int(mods[at])] = value
            continue
        _put(tree, (collection, *mods, name), value)
    for path, parts in stacked.items():
        _put(tree, path, np.stack([parts[p] for p in range(len(parts))]))
    return tree


# ---------------------------------------------------------------------------
# optimizer state
# ---------------------------------------------------------------------------

# the flat moment buffers of each optimizer, in the order of their optax
# state's fields after `count` (ScaleByAdamState(count, mu, nu),
# TraceState(trace), which has no count)
_MOMENTS = {"adam": ("mu", "nu"), "sgd": ("trace",)}
_OPTAX_STATE = {"adam": "ScaleByAdamState", "sgd": "TraceState"}


def optimizer_tree(state) -> dict:
    """A `training.trainer.TrainState`'s optimizer state in the port's
    checkpoint layout: {"count": int32, "mu": tree, "nu": tree} (Adam) or
    {"count", "trace": tree} (SGD), each tree the params' flax tree of
    float32 numpy arrays."""
    out = {"count": np.asarray(state.opt_state["count"], np.int32)}
    for name in state.opt_state:
        if name != "count":
            out[name] = flat_tree(state, state.opt_state[name])
    return out


def flat_tree(state, flat: torch.Tensor) -> dict:
    """A buffer of a TrainState's flat parameter layout (its params, grads
    or a moment) as the params' flax tree of float32 numpy arrays."""
    return _flax_tree(state.param_views(flat).items())["params"]


def _find_optax_state(tree, class_name: str):
    """The first stub of optax class `class_name` in a JAX checkpoint's
    opt_state (tuples, lists, dicts and stubs' arguments searched depth
    first), or None."""
    if type(tree).__name__ == class_name and hasattr(tree, "args"):
        return tree
    children = (tree.args if hasattr(tree, "args") and hasattr(tree, "kwargs")
                else tree.values() if isinstance(tree, Mapping)
                else tree if isinstance(tree, (tuple, list)) else ())
    for child in children:
        hit = _find_optax_state(child, class_name)
        if hit is not None:
            return hit
    return None


def restore_optimizer(opt_state, state) -> dict:
    """The optimizer state of `state` (a TrainState; Adam or SGD, as its
    own state's moments say) rebuilt from a checkpoint's `opt_state`: the
    port's layout (`optimizer_tree`), or a JAX checkpoint's optax chain
    (stubs of `checkpoint.load_checkpoint`: ScaleByAdamState's count / mu
    / nu, or the SGD TraceState's trace and ScaleByScheduleState's count).
    Raises ValueError on any structure it cannot map."""
    kind = "adam" if "mu" in state.opt_state else "sgd"
    names = _MOMENTS[kind]
    if isinstance(opt_state, Mapping):
        count, trees = opt_state["count"], [opt_state[n] for n in names]
    else:
        stub = _find_optax_state(opt_state, _OPTAX_STATE[kind])
        if stub is None:
            raise ValueError(f"no {_OPTAX_STATE[kind]} in the optimizer "
                             "state")
        if kind == "adam":
            count, *trees = stub.args
        else:
            trees = list(stub.args)
            sched = _find_optax_state(opt_state, "ScaleByScheduleState")
            if sched is None:
                raise ValueError("no ScaleByScheduleState in the optimizer "
                                 "state")
            count = sched.args[0]
    out = {"count": int(np.asarray(count))}
    for name, tree in zip(names, trees):
        tensors = flax_state_dict({"params": tree})
        flat = torch.zeros_like(state.params)
        views = state.param_views(flat)
        if sorted(tensors) != sorted(views):
            raise ValueError(f"optimizer {name} does not match the "
                             "parameters")
        for key, value in tensors.items():
            if tuple(value.shape) != tuple(views[key].shape):
                raise ValueError(f"optimizer {name}: {key} has shape "
                                 f"{tuple(value.shape)}")
            views[key].copy_(value)
        out[name] = flat
    return out


def _sorted_leaves(tree: Mapping, path: tuple = ()):
    """(path, leaf) of a nested dict in JAX's flatten order (keys sorted
    at every level)."""
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, Mapping):
            yield from _sorted_leaves(value, path + (key,))
        else:
            yield path + (key,), value


def optax_leaves(state, grad_clip: float) -> list[np.ndarray]:
    """The flat leaves (`jax.tree.leaves`) of the JAX package's optax
    chain state (`captra_tpu/training/trainer.py::make_optimizer`) that
    holds a TrainState's moments.  The chain is `zero_nans`, `clip`,
    `clip_by_global_norm` (only when `grad_clip` > 0, the config's
    `optim.grad_clip`), `add_decayed_weights`, `scale_by_adam` or
    `trace`, `scale_by_learning_rate`; its leaves are, each tree in
    sorted key order: ZeroNansState's `found_nan` (one bool a parameter,
    written False: the port does not keep it), ScaleByAdamState's count,
    mu, nu (or TraceState's trace), then ScaleByScheduleState's count."""
    kind = "adam" if "mu" in state.opt_state else "sgd"
    params = list(_sorted_leaves(flat_tree(state, state.params)))
    count = np.asarray(state.opt_state["count"], np.int32)
    leaves = [np.asarray(False)] * len(params) if grad_clip > 0 else []
    if kind == "adam":
        leaves.append(count)
    for name in _MOMENTS[kind]:
        leaves += [v for _, v in _sorted_leaves(
            flat_tree(state, state.opt_state[name]))]
    leaves.append(count)
    return leaves


def restore_optax_leaves(leaves, state) -> dict:
    """The optimizer state of `state` (Adam or SGD) rebuilt from the flat
    optax leaves `optax_leaves` describes, in flatten order; whether the
    chain clips is read from their count.  Raises ValueError when the
    count fits neither layout."""
    kind = "adam" if "mu" in state.opt_state else "sgd"
    paths = [p for p, _ in _sorted_leaves(flat_tree(state, state.params))]
    n, names = len(paths), _MOMENTS[kind]
    body = len(names) * n + (2 if kind == "adam" else 1)
    if len(leaves) not in (body, body + n):
        raise ValueError(f"{len(leaves)} optimizer leaves fit no {kind} "
                         f"chain over {n} parameters")
    rest = list(leaves[len(leaves) - body:])
    count = rest.pop(0) if kind == "adam" else rest[-1]
    trees = {}
    for i, name in enumerate(names):
        tree: dict = {}
        for path, value in zip(paths, rest[i * n:(i + 1) * n]):
            _put(tree, path, value)
        trees[name] = tree
    return restore_optimizer({"count": count, **trees}, state)


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def coordnet_from_flax(cfg: Config, variables: Mapping,
                       device=None) -> CoordNet:
    """A `CoordNet` on `device` (CUDA unless given) holding flax
    variables."""
    return load_flax_variables(CoordNet(cfg, device=device), variables)


def rotnet_from_flax(cfg: Config, variables: Mapping, device=None) -> RotNet:
    """A `RotNet` on `device` (CUDA unless given) holding flax variables."""
    return load_flax_variables(RotNet(cfg, device=device), variables)


# ---------------------------------------------------------------------------
# the reference's torch checkpoints
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> dict:
    """A reference checkpoint's model state_dict as numpy arrays.  Read
    with `weights_only=True`: tensors and plain containers only, so the
    file cannot name arbitrary classes."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _dense(sd, key):
    w = np.asarray(sd[f"{key}.weight"])
    w = w.reshape(w.shape[0], w.shape[1])  # drop 1x1 conv spatial dims
    return {"kernel": w.T.astype(np.float32),
            "bias": np.asarray(sd[f"{key}.bias"], np.float32)}


def _norm(sd, key):
    return ({"scale": np.asarray(sd[f"{key}.weight"], np.float32),
             "bias": np.asarray(sd[f"{key}.bias"], np.float32)},
            {"mean": np.asarray(sd.get(f"{key}.running_mean", 0.0),
                                np.float32),
             "var": np.asarray(sd.get(f"{key}.running_var", 1.0),
                               np.float32)})


def _point_mlp(sd, conv_keys, norm_keys):
    """One PointMLP's (params, batch_stats) from torch layer keys (None in
    `norm_keys`: no norm for that layer)."""
    params, stats = {}, {}
    for j, ck in enumerate(conv_keys):
        params[f"dense_{j}"] = _dense(sd, ck)
    for j, nk in enumerate(norm_keys):
        if nk is None:
            continue
        p, s = _norm(sd, nk)
        params[f"norm_{j}"] = p
        if f"{nk}.running_mean" in sd:
            stats[f"norm_{j}"] = s
    return params, stats


def convert_backbone(sd: dict, prefix: str, pn: PointNetCfg):
    """A torch PointNet2Msg state_dict subtree -> (params, batch_stats)."""
    params, stats = {}, {}

    for name, sa in (("sa1", pn.sa1), ("sa2", pn.sa2)):
        p_sa, s_sa = {}, {}
        for i, mlp in enumerate(sa.mlp_list):
            convs = [f"{prefix}.{name}.conv_blocks.{i}.{j}"
                     for j in range(len(mlp))]
            norms = [f"{prefix}.{name}.bn_blocks.{i}.{j}"
                     for j in range(len(mlp))]
            p, s = _point_mlp(sd, convs, norms)
            p_sa[f"scale_{i}"] = p
            s_sa[f"scale_{i}"] = s
        params[name] = p_sa
        stats[name] = s_sa

    def seq(name, mlp_len, conv_fmt, norm_fmt):
        convs = [conv_fmt.format(j) for j in range(mlp_len)]
        norms = [norm_fmt.format(j) for j in range(mlp_len)]
        p, s = _point_mlp(sd, convs, norms)
        params[name] = {"mlp": p}
        stats[name] = {"mlp": s}

    seq("sa3", len(pn.sa3_mlp), f"{prefix}.sa3.mlp_convs.{{}}",
        f"{prefix}.sa3.mlp_bns.{{}}")
    for fp, mlp in (("fp3", pn.fp3_mlp), ("fp2", pn.fp2_mlp),
                    ("fp1", pn.fp1_mlp)):
        seq(fp, len(mlp), f"{prefix}.{fp}.mlp_convs.{{}}",
            f"{prefix}.{fp}.mlp_bns.{{}}")

    p, s = _point_mlp(sd, [f"{prefix}.conv1"], [f"{prefix}.bn1"])
    params["out"] = p
    stats["out"] = s
    return params, stats


def convert_coordnet(sd: dict, cfg: Config, prefix: str = "net") -> dict:
    """A reference CoordNet state_dict -> flax variables {params,
    batch_stats}."""
    bb_p, bb_s = convert_backbone(sd, f"{prefix}.backbone", cfg.pointnet)
    # seg head: one conv (get_point_mlp(in, out, []), blocks.py:29)
    seg_p, _ = _point_mlp(sd, [f"{prefix}.seg_head.0"], [None])
    # nocs head: [conv, BN, ReLU] per hidden layer, then conv (, Sigmoid)
    convs, norms = [], []
    idx = 0
    for _ in range(len(cfg.network.nocs_head_dims)):
        convs.append(f"{prefix}.nocs_head.{idx}")
        norms.append(f"{prefix}.nocs_head.{idx + 1}")
        idx += 3
    convs.append(f"{prefix}.nocs_head.{idx}")
    norms.append(None)
    nocs_p, nocs_s = _point_mlp(sd, convs, norms)
    return {
        "params": {"backbone": bb_p, "seg_head": seg_p,
                   "nocs_head": nocs_p},
        "batch_stats": {"backbone": bb_s, "nocs_head": nocs_s},
    }


def convert_rotnet(sd: dict, cfg: Config, prefix: str = "net") -> dict:
    """A reference PartCanonNet state_dict -> flax variables."""
    enc_p, enc_s = convert_backbone(sd, f"{prefix}.regress_net.encoder",
                                    cfg.pointnet)
    # per-part heads: MLPConv1d Sequential [conv, GN, ReLU] x 3 + [conv] ->
    # module indices 0, 1 / 3, 4 / 6, 7 / 9 (blocks.py:147-165)
    P = cfg.obj.num_parts
    heads_p: dict = {}
    for j, (ci, ni) in enumerate(zip((0, 3, 6, 9), (1, 4, 7, None))):
        kernels, biases, scales, nbiases = [], [], [], []
        for p in range(P):
            base = f"{prefix}.regress_net.pose_pred.rtvec_head.{p}.model"
            d = _dense(sd, f"{base}.{ci}")
            kernels.append(d["kernel"])
            biases.append(d["bias"])
            if ni is not None:
                n, _ = _norm(sd, f"{base}.{ni}")
                scales.append(n["scale"])
                nbiases.append(n["bias"])
        heads_p[f"dense_{j}"] = {"kernel": np.stack(kernels),
                                 "bias": np.stack(biases)}
        if ni is not None:
            heads_p[f"norm_{j}"] = {"scale": np.stack(scales),
                                    "bias": np.stack(nbiases)}
    return {
        "params": {"encoder": enc_p, "regressor": {"heads": heads_p}},
        "batch_stats": {"encoder": enc_s},
    }


def convert_track_checkpoint(path: str, cfg: Config):
    """A composed tracking checkpoint (the CoordNet under `npcs_net.`, the
    rotation net under `net.`, reference trainer.py:159-170) -> (coord
    variables, rot variables)."""
    sd = load_torch_state_dict(path)
    return (convert_coordnet(sd, cfg, prefix="npcs_net"),
            convert_rotnet(sd, cfg, prefix="net"))
