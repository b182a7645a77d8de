"""One set-abstraction scale fused: a hand-written CUDA kernel and its plain
PyTorch twin.

A scale of `SetAbstractionMsg` (counterpart of the MSG scale in
`captra_tpu/models/backbone.py`, which has no Pallas kernel) is ball query
-> grouping -> shared MLP (Linear, eval-mode BatchNorm, ReLU after every
layer) -> max over the neighbours.  `sa_scale` takes the ball query's
indices and does the rest:

  sa_mlp_cuda   the kernel of `csrc/sa_mlp.cu`, built at first use: a CTA
                owns 128 neighbour rows, gathers them, keeps every layer's
                activations in shared memory and writes only the pooled
                [B, S, C_out] rows (its note gives the design and bound).
  sa_mlp_plain  the same function in plain PyTorch: `ops.group_ball`
                (`ops.ball_group`'s grouping), then `F.linear`,
                `F.batch_norm` with the running statistics, `F.relu` and
                `torch.amax`, the calls the module chain makes, so on the
                CPU it gives today's chain's numbers bit for bit.

On the kernel's route, a scale whose first layer reads many more
neighbour rows than its stage has points takes that layer factored
(`factored` is the rule, by shape): the products of the feature channels
depend on the point alone, so `sa_table_cuda` computes them once a point
for every such scale of a stage (one launch, the chain's own fmaf order;
its twin `sa_table_plain`), and `sa_mlp_cuda` given that table starts each
neighbour row's sum from its point's entry and adds the offset channels
(its twin `sa_mlp_factored_plain`): the gathered route's sums, bit for
bit.

`sa_scale` routes by the seam's one rule (`cuda_build.takes_kernel`):
float32 CUDA clouds that take no gradient launch the kernel, any other
input takes `sa_mlp_plain`; there is no fallback.  The kernels launch
through `cuda_build.Kernels`, which counts each launch in the one registry
(`launch_counts` is its view here) and each scale's in the tracer's
`sa_fused` counter (`utils/profiling.count`), a factored scale's in
`sa_factored` too: the counters count kernels, not the CPU twins.  `fits`
says whether the kernel takes a scale's shape; the kernel's wrapper raises
on any other.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch
from torch.nn import functional as F

from captra_tpu_torch.ops import cuda_build, pointops
from captra_tpu_torch.utils import profiling

SOURCE = "sa_mlp.cu"
# the kernel's tiling (csrc/sa_mlp.cu): neighbour rows a CTA, floats a
# channel's row in shared memory, channels a staged chunk, the widest
# chunk of output columns
ROWS = 128
STRIDE = ROWS + 4
DEPTH = 16
CHUNK = 128
MAX_LAYERS = 3
HEADER_FLOATS = ROWS + 4 * ROWS
# a double-buffered stage of DEPTH channel rows (the gather's, the weights')
STAGE_FLOATS = 2 * DEPTH * STRIDE
# the dynamic shared memory a CTA may take on an H100
SMEM_LIMIT = 232448
# factored scales a table launch takes
MAX_TABLE_SCALES = 4


class Layer(NamedTuple):
    """One layer of a scale's MLP: nn.Linear's weight [cout, cin] and bias,
    then BatchNorm's weight, bias, running mean and variance, and eps."""
    weight: torch.Tensor
    bias: torch.Tensor
    gamma: torch.Tensor
    beta: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    eps: float


class _CLayer(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("gamma", ctypes.c_void_p), ("beta", ctypes.c_void_p),
                ("mean", ctypes.c_void_p), ("var", ctypes.c_void_p),
                ("eps", ctypes.c_float), ("cin", ctypes.c_int),
                ("cout", ctypes.c_int), ("unused", ctypes.c_int)]


class _CArgs(ctypes.Structure):
    _fields_ = [("xyz", ctypes.c_void_p), ("centres", ctypes.c_void_p),
                ("feats", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("table", ctypes.c_void_p),
                *[(n, ctypes.c_int) for n in (
                    "B", "N", "S", "K", "cf", "out_stride", "out_offset",
                    "layers", "centres_per_tile", "x_floats", "y_floats",
                    "smem_bytes", "table_stride", "table_offset")],
                ("layer", _CLayer * MAX_LAYERS)]


class _CTableScale(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("ld", ctypes.c_int),
                ("cin", ctypes.c_int), ("cout", ctypes.c_int),
                ("offset", ctypes.c_int)]


class _CTableArgs(ctypes.Structure):
    _fields_ = [("feats", ctypes.c_void_p), ("out", ctypes.c_void_p),
                *[(n, ctypes.c_int) for n in ("rows", "cf", "stride",
                                              "scales")],
                ("scale", _CTableScale * MAX_TABLE_SCALES)]


_KERNELS = cuda_build.Kernels(
    SOURCE, {"sa_mlp_cuda": ("captra_sa_mlp", cuda_build.PTR),
             "sa_table_cuda": ("captra_sa_table", cuda_build.PTR)},
    error="captra_sa_mlp_error_string", counter={"sa_mlp_cuda": "sa_fused"},
    expect={"captra_sa_mlp_rows": ROWS,
            "captra_sa_mlp_max_layers": MAX_LAYERS,
            "captra_sa_mlp_header_floats": HEADER_FLOATS,
            "captra_sa_mlp_stage_floats": STAGE_FLOATS,
            "captra_sa_mlp_args_bytes": ctypes.sizeof(_CArgs),
            "captra_sa_table_max_scales": MAX_TABLE_SCALES,
            "captra_sa_table_args_bytes": ctypes.sizeof(_CTableArgs)})
launch_counts = _KERNELS.launch_counts


def _padded(c: int) -> int:
    return -(-c // DEPTH) * DEPTH


def layout(K: int, couts: Sequence[int]) -> tuple[int, int, int, int]:
    """The kernel's shared-memory layout for a scale of K neighbours and
    layer widths `couts`: (centres a tile, floats of buffer X, floats of
    buffer Y, bytes in all).  Layer i writes its activations (cout padded
    to whole chunks of DEPTH, a row of STRIDE floats a channel) into X for
    even i and Y for odd i; the last layer writes its pool (centres x
    CHUNK ints) there instead; the first layer's gather stages in Y; after
    the header, X and Y come the weights' stages."""
    cpt = ROWS // K
    x, y = 0, STAGE_FLOATS
    for i, c in enumerate(couts):
        last = i == len(couts) - 1
        size = cpt * CHUNK if last else _padded(c) * STRIDE
        if i % 2:
            y = max(y, size)
        else:
            x = max(x, size)
    floats = HEADER_FLOATS + x + y + STAGE_FLOATS
    return cpt, x, y, 4 * floats


def fits(K: int, couts: Sequence[int]) -> bool:
    """Whether the kernel takes a scale of K neighbours and layer widths
    `couts`: K at most ROWS (a centre's rows in one CTA), 1 to MAX_LAYERS
    layers, and the layout within one CTA's shared memory."""
    if not 1 <= K <= ROWS or not 1 <= len(couts) <= MAX_LAYERS:
        return False
    return layout(K, couts)[3] <= SMEM_LIMIT


def factored(N: int, S: int, K: int, cf: int) -> bool:
    """Whether a scale of S centres x K neighbours over N points with cf
    feature channels takes its first layer factored: the features at least
    one staged chunk wide and more neighbour rows than points, so the
    table's products are fewer than the gathered layer's."""
    return cf >= DEPTH and S * K > N


def sa_table_plain(feats: torch.Tensor,
                   weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """feats [B, N, cf], each factored scale's first Linear weight [cout,
    cf + 3] -> the table [B, N, sum of cout]: each scale's products of the
    feature channels alone, no bias, its columns after the previous
    scale's."""
    cf = feats.shape[-1]
    return torch.cat([F.linear(feats, w[:, :cf]) for w in weights], dim=-1)


def sa_mlp_factored_plain(xyz: torch.Tensor, new_xyz: torch.Tensor,
                          idx: torch.Tensor, table: torch.Tensor,
                          offset: int,
                          layers: Sequence[Layer]) -> torch.Tensor:
    """`sa_mlp_plain` with the first layer factored: each neighbour's entry
    of table[..., offset:offset + cout] plus the offset channels' products
    (the first weight's last three columns), then the bias and the rest as
    `sa_mlp_plain`."""
    L0 = layers[0]
    cout = L0.weight.shape[0]
    x = pointops.group_ball(idx, xyz, new_xyz,
                            table[..., offset:offset + cout])
    x = x[..., :cout] + F.linear(x[..., cout:], L0.weight[:, -3:], L0.bias)
    return _mlp_max(x, layers, first_linear=False)


def _mlp_max(x: torch.Tensor, layers: Sequence[Layer],
             first_linear: bool = True) -> torch.Tensor:
    """Each layer's Linear (the first layer's only with `first_linear`),
    eval BatchNorm and ReLU, then the max over K."""
    for i, L in enumerate(layers):
        if i or first_linear:
            x = F.linear(x, L.weight, L.bias)
        shape = x.shape
        x = F.batch_norm(x.reshape(-1, shape[-1]), L.mean, L.var, L.gamma,
                         L.beta, False, 0.0, L.eps).reshape(shape)
        x = F.relu(x)
    return torch.amax(x, dim=2)


def sa_mlp_plain(xyz: torch.Tensor, new_xyz: torch.Tensor,
                 feats: torch.Tensor | None, idx: torch.Tensor,
                 layers: Sequence[Layer]) -> torch.Tensor:
    """xyz [B, N, 3], centres new_xyz [B, S, 3], feats [B, N, C] or None,
    ball-query indices idx [B, S, K] -> [B, S, C_out]: the neighbours'
    (features..., xyz - centre), each layer's Linear, eval BatchNorm and
    ReLU, the max over K."""
    return _mlp_max(pointops.group_ball(idx, xyz, new_xyz, feats), layers)


def _check(xyz, new_xyz, feats, idx, layers, out, offset, table,
           table_offset) -> list[int]:
    """Raise on what the kernel does not take; return the layers' widths."""
    name = "sa_mlp_cuda"
    tensors = [xyz, new_xyz, idx, out, *(t for L in layers for t in L[:6])]
    tensors += [t for t in (feats, table) if t is not None]
    cuda_build.check_operands(name, *tensors, ints=(idx,))
    B, N, _ = xyz.shape
    _, S, K = idx.shape
    cin = 3 if feats is None else feats.shape[-1] + 3
    if (xyz.dim() != 3 or xyz.shape[-1] != 3 or new_xyz.shape != (B, S, 3)
            or idx.shape[0] != B
            or (feats is not None and feats.shape[:2] != (B, N))):
        fshape = None if feats is None else tuple(feats.shape)
        raise ValueError(f"{name}: shapes xyz {tuple(xyz.shape)}, new_xyz "
                         f"{tuple(new_xyz.shape)}, idx {tuple(idx.shape)}, "
                         f"feats {fshape} do not agree")
    widths = []
    for i, L in enumerate(layers):
        cout = L.weight.shape[0]
        if L.weight.shape != (cout, cin) or any(
                t.shape != (cout,) for t in L[1:6]):
            raise ValueError(f"{name}: layer {i} takes {cin} channels; its "
                             f"weight is {tuple(L.weight.shape)}")
        widths.append(cout)
        cin = cout
    if (out.dim() != 3 or out.shape[:2] != (B, S)
            or not 0 <= offset <= out.shape[2] - cin):
        raise ValueError(f"{name}: out {tuple(out.shape)} has no room for "
                         f"{cin} columns at {offset}")
    if not fits(K, widths):
        raise ValueError(f"{name}: K={K} with widths {widths} is beyond the "
                         f"kernel (K <= {ROWS}, <= {MAX_LAYERS} layers, "
                         f"{SMEM_LIMIT} bytes of shared memory)")
    if B * N >= 2 ** 31 or B < 1 or S < 1 or N < 1:
        raise ValueError(f"{name}: B={B}, N={N}, S={S} out of range")
    if table is not None and (
            feats is None or table.dim() != 3 or table.shape[:2] != (B, N)
            or not 0 <= table_offset <= table.shape[2] - widths[0]):
        raise ValueError(f"{name}: table {tuple(table.shape)} has no "
                         f"{widths[0]} columns at {table_offset} for "
                         f"{B} x {N} points with features")
    return widths


def sa_mlp_cuda(xyz: torch.Tensor, new_xyz: torch.Tensor,
                feats: torch.Tensor | None, idx: torch.Tensor,
                layers: Sequence[Layer], out: torch.Tensor,
                offset: int = 0, table: torch.Tensor | None = None,
                table_offset: int = 0) -> torch.Tensor:
    """The kernel: writes `sa_mlp_plain`'s [B, S, C_out] into out[...,
    offset:offset + C_out] (out [B, S, C], float32) and returns out.  The
    indices are `ball_query`'s, each in [0, N) (the kernel reads them as
    they are).  With `table` ([B, N, T], `sa_table_cuda`'s, this scale's
    columns from `table_offset`) the first layer is factored: the same
    outputs, bit for bit."""
    widths = _check(xyz, new_xyz, feats, idx, layers, out, offset, table,
                    table_offset)
    B, N, _ = xyz.shape
    _, S, K = idx.shape
    cpt, x, y, smem = layout(K, widths)
    args = _CArgs(xyz.data_ptr(), new_xyz.data_ptr(),
                  None if feats is None else feats.data_ptr(),
                  idx.data_ptr(), out.data_ptr(),
                  None if table is None else table.data_ptr(), B, N, S, K,
                  0 if feats is None else feats.shape[-1], out.shape[2],
                  offset, len(layers), cpt, x, y, smem,
                  0 if table is None else table.shape[2], table_offset)
    for i, L in enumerate(layers):
        args.layer[i] = _CLayer(
            L.weight.data_ptr(), L.bias.data_ptr(), L.gamma.data_ptr(),
            L.beta.data_ptr(), L.mean.data_ptr(), L.var.data_ptr(),
            float(L.eps), L.weight.shape[1], L.weight.shape[0], 0)
    _KERNELS.launch("sa_mlp_cuda", xyz.device, ctypes.byref(args))
    if table is not None:
        profiling.count("sa_factored")
    return out


def sa_table_cuda(feats: torch.Tensor,
                  weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The table kernel: `sa_table_plain`'s [B, N, sum of cout] in one
    launch, each entry the fmaf chain of the scale kernel's gathered first
    layer cut after the feature channels."""
    name = "sa_table_cuda"
    cuda_build.check_operands(name, feats, *weights)
    B, N, cf = feats.shape
    if (not 1 <= len(weights) <= MAX_TABLE_SCALES or cf < 1
            or B * N >= 2 ** 31
            or any(w.dim() != 2 or w.shape[1] < cf for w in weights)):
        raise ValueError(f"{name}: feats {tuple(feats.shape)} with weights "
                         f"{[tuple(w.shape) for w in weights]} (1 to "
                         f"{MAX_TABLE_SCALES} scales of >= {cf} channels)")
    out = torch.empty((B, N, sum(w.shape[0] for w in weights)),
                      dtype=feats.dtype, device=feats.device)
    args = _CTableArgs(feats.data_ptr(), out.data_ptr(), B * N, cf,
                       out.shape[2], len(weights))
    col = 0
    for i, w in enumerate(weights):
        args.scale[i] = _CTableScale(w.data_ptr(), w.shape[1], cf,
                                     w.shape[0], col)
        col += w.shape[0]
    _KERNELS.launch(name, feats.device, ctypes.byref(args))
    return out


def sa_scale(xyz: torch.Tensor, new_xyz: torch.Tensor,
             feats: torch.Tensor | None, idx: torch.Tensor,
             layers: Sequence[Layer], out: torch.Tensor,
             offset: int = 0, table: torch.Tensor | None = None,
             table_offset: int = 0) -> torch.Tensor:
    """One fused scale into out[..., offset:offset + C_out]: clouds that
    `cuda_build.takes_kernel` sends to the kernel -> `sa_mlp_cuda`, its
    first layer factored where a `table` is given; any other on the CPU or
    CUDA -> `sa_mlp_plain` (the table only spares the kernel work)."""
    if cuda_build.takes_kernel(xyz, new_xyz, feats):
        return sa_mlp_cuda(xyz, new_xyz, feats, idx, layers, out, offset,
                           table, table_offset)
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused set-abstraction scale for device "
                         f"{xyz.device}")
    got = sa_mlp_plain(xyz, new_xyz, feats, idx, layers)
    out[..., offset:offset + got.shape[-1]] = got
    return out
