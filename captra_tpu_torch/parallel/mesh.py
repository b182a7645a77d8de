"""Data parallelism over `torch.distributed` (counterpart of
`captra_tpu/parallel/mesh.py`).

The JAX package shards the batch axis over a device mesh and replicates
the parameters; under `jit`, GSPMD makes a step over n devices *the*
single-device step on the global batch: BatchNorm's statistics, every
loss's mean or ratio and the gradient all span the global batch, and the
parameters and statistics stay identical on every device.  Plain DDP keeps
only the gradient mean.  The port keeps all of it, with one process a
rank:

  * `DataParallel` is the mesh: the ranks of a group, and the process
    groups its all-reduce runs over (one for a flat group; for a hybrid
    (dcn, ici) group, this rank's ici row and then its dcn column);
  * while a `DataParallel` is `active` (the trainer's steps),
    `models/blocks.BatchNorm` normalises with the global statistics (one
    differentiable all-reduce a layer of each rank's count, mean and
    centred sum of squares, combined exactly: Chan's formula) and
    `models/losses` divide each rank's local sum by the global count, so
    that the ranks' losses add up to the global batch's loss;
  * `Trainer.train_step` adds the ranks' gradients
    (`DataParallel.all_reduce_`) before the optimizer, which then sees
    the global gradient.

`all_reduce` is differentiable and its backward adds the upstream
gradients over the ranks, which is right where each rank's partial sums
feed every rank's loss (BatchNorm's statistics).  A count that only
divides (a loss's denominator) is reduced with
`DataParallel.all_reduce_`, outside autograd.

`launch` starts the ranks of one machine (`torch.multiprocessing` with
the spawn method, a `file://` rendezvous): gloo on the CPU, NCCL on CUDA
with one card a rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from captra_tpu_torch.device import resolve_device

_ACTIVE: list = []


@dataclasses.dataclass
class DataParallel:
    """A data-parallel group as one rank sees it: its rank in the group,
    the group's size, the process groups an all-reduce runs over in turn,
    and the process group that spans all its ranks (for broadcasts,
    gathers and barriers; None: the default group)."""
    rank: int
    world: int
    groups: tuple = (None,)
    group: object = None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the group's ranks, in place (outside autograd)."""
        with torch.no_grad():
            for g in self.groups:
                dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, differentiable: the backward adds
        the upstream gradients over the ranks."""
        return _AllReduceSum.apply(t, self)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dp):
        ctx.dp = dp
        return dp.all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.dp.all_reduce_(grad.clone()), None


def current() -> DataParallel | None:
    """The active `DataParallel`, or None outside `active`."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def active(dp: DataParallel | None):
    """Make `dp` the group that BatchNorm and the losses reduce over (a
    no-op for None)."""
    if dp is None:
        yield None
        return
    _ACTIVE.append(dp)
    try:
        yield dp
    finally:
        _ACTIVE.pop()


def init_data_parallel(rank: int | None = None, world: int | None = None,
                       init_method: str | None = None,
                       backend: str | None = None) -> tuple[int, int]:
    """Join the default process group (the counterpart of
    `jax.distributed.initialize`): rank, world size and rendezvous as
    given, else from torchrun's `RANK`, `WORLD_SIZE` and `MASTER_ADDR` /
    `MASTER_PORT` (the `env://` rendezvous); backend gloo unless given.
    Returns (rank, world)."""
    if rank is None:
        rank = int(os.environ["RANK"])
    if world is None:
        world = int(os.environ["WORLD_SIZE"])
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError("init_data_parallel needs init_method= or "
                             "torchrun's MASTER_ADDR / MASTER_PORT")
        init_method = "env://"
    if not dist.is_initialized():
        dist.init_process_group(backend or "gloo", init_method=init_method,
                                rank=rank, world_size=world)
    return rank, world


def data_parallel_mesh(n: int | None = None) -> DataParallel | None:
    """A flat group over the first `n` ranks of the default group (all of
    them by default), as the JAX function takes the first n devices; None
    on a rank outside it.  Every rank must call this."""
    world = dist.get_world_size()
    n = world if n is None else n
    if not 0 < n <= world:
        raise ValueError(f"a group of {n} ranks in a world of {world}")
    rank = dist.get_rank()
    group = None if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return DataParallel(rank=rank, world=n, groups=(group,), group=group)


def hybrid_data_parallel_mesh(dcn: int | None = None,
                              ici: int | None = None) -> DataParallel:
    """The ranks as a (dcn, ici) grid, row-major, as the JAX function lays
    out its devices: an all-reduce sums over this rank's ici
    row first, then over its dcn column.  dcn defaults to the hosts
    (WORLD_SIZE / LOCAL_WORLD_SIZE under torchrun, else 1), ici to the
    ranks a host.  Raises ValueError where the grid does not cover the
    ranks exactly.  Every rank must call this."""
    world = dist.get_world_size()
    if dcn is None:
        dcn = max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
    if dcn > world or world % dcn:
        raise ValueError(
            f"dcn={dcn} must divide the world size ({world}); "
            "a (dcn, ici) grid cannot silently drop ranks")
    if ici is None:
        ici = world // dcn
    if dcn * ici != world:
        raise ValueError(f"dcn*ici = {dcn}*{ici} != world size {world}")
    rank = dist.get_rank()
    grid = np.arange(world).reshape(dcn, ici)
    # new_group is collective: every rank creates every group, in order
    rows = [dist.new_group(list(map(int, r))) for r in grid]
    cols = [dist.new_group(list(map(int, c))) for c in grid.T]
    d, i = divmod(rank, ici)
    return DataParallel(rank=rank, world=world, groups=(rows[d], cols[i]))


def tree_map(fn, tree):
    """`fn` on every leaf of a tree of dicts, lists, tuples, named tuples
    and dataclasses (a `Pose`, a `TrackAux`), the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    return fn(tree)


def shard_batch(batch, rank: int, world: int, batch_dim: int = 0):
    """This rank's equal slice of every array (tensor or numpy) of a
    global batch along `batch_dim`; leaves with `ndim <= batch_dim` are
    replicated, as the JAX function does.  A batch axis that does not
    split into `world` equal shards raises ValueError."""
    def take(x):
        if not (torch.is_tensor(x) or isinstance(x, np.ndarray)):
            return x
        if x.ndim <= batch_dim:
            return x
        size = x.shape[batch_dim]
        if size % world:
            raise ValueError(f"batch axis of {size} does not split over "
                             f"{world} ranks")
        b = size // world
        index = (slice(None),) * batch_dim + (slice(rank * b,
                                                    (rank + 1) * b),)
        return x[index]
    return tree_map(take, batch)


def gather_batch(tree, dp: DataParallel, batch_dim: int = 0):
    """Every rank's shard of each tensor of `tree`, concatenated along
    `batch_dim` in rank order (the inverse of `shard_batch`), on every
    rank."""
    def gather(x):
        if not torch.is_tensor(x):
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dp.world)]
        dist.all_gather(parts, x, group=dp.group)
        return torch.cat(parts, dim=batch_dim)
    return tree_map(gather, tree)


def _tensors(state) -> list:
    """The tensors of a state to broadcast: a TrainState's flat parameters,
    its module's buffers and its optimizer moments; else every tensor of a
    tree (`tree_map`)."""
    if hasattr(state, "module") and hasattr(state, "params"):
        return ([state.params] + list(state.module.buffers())
                + [v for v in state.opt_state.values() if torch.is_tensor(v)])
    out = []
    tree_map(lambda x: out.append(x) if torch.is_tensor(x) else None, state)
    return out


def replicate(state, dp: DataParallel):
    """Broadcast `state` (a TrainState, or a tree of tensors) from the
    group's rank 0 to every rank, in place; returns it."""
    src = 0 if dp.group is None else dist.get_global_rank(dp.group, 0)
    with torch.no_grad():
        for t in _tensors(state):
            dist.broadcast(t, src=src, group=dp.group)
    return state


# ---------------------------------------------------------------------------
# launching the ranks of one machine
# ---------------------------------------------------------------------------

def _child(rank: int, world: int, device: str, backend: str, cards: tuple,
           out_dir: str):
    torch.set_num_threads(1)
    with open(os.path.join(out_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    if device.startswith("cuda"):
        torch.cuda.set_device(cards[rank])
        device = f"cuda:{cards[rank]}"
    init_data_parallel(rank, world,
                       "file://" + os.path.join(out_dir, "store"), backend)
    try:
        result = fn(rank, world, device, *args)
        with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, device=None, args: Sequence = (),
           backend: str | None = None, cards: Sequence[int] | None = None,
           timeout: float = 1800.0) -> list:
    """Run `fn(rank, world, device, *args)` in `world` new processes (the
    spawn method), each a rank of one default process group with a
    `file://` rendezvous; returns their results in rank order (picklable
    values).  The ranks run on CUDA unless device="cpu" (no card and no
    device: RuntimeError).  The backend is gloo on the CPU and NCCL on
    CUDA, where rank r takes card `cards[r]` (rank r's own card by
    default: more ranks than cards raise ValueError).  `fn` and `args`
    reach the ranks through a file of the run's temporary directory:
    through the spawn pipe, a few MB of arguments delay the ranks' start
    by seconds.  A rank that raises, or a run that outlasts `timeout`
    seconds, kills the others and raises."""
    import torch.multiprocessing as mp
    device = str(resolve_device(device))
    cuda = device.startswith("cuda")
    if cuda:
        have = torch.cuda.device_count()
        if cards is None:
            if world > have:
                raise ValueError(f"{world} ranks need {world} cards and "
                                 f"this machine has {have}")
            cards = tuple(range(world))
        backend = backend or "nccl"
    else:
        backend = backend or "gloo"
    cards = tuple(cards or ())
    tmp = tempfile.mkdtemp(prefix="captra_dp_")
    try:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        ctx = mp.start_processes(
            _child, args=(world, device, backend, cards, tmp),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(
                    5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish in "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
