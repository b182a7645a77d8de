"""One data-parallel training step over n ranks on tiny shapes (the
counterpart of `__graft_entry__.py::dryrun_multichip`).

    python -c "from captra_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(4, device='cpu')"

The JAX function builds a mesh of n virtual CPU devices; here n processes
of this machine (`mesh.launch`: NCCL ranks on n cards by default, more
ranks than cards raising, or gloo ranks on the CPU with device="cpu")
take one global step of a tiny CoordNet on a global batch of n frames,
one a rank, and print `dryrun_multichip(n): ok, loss=...` with the
global loss.
"""
from __future__ import annotations

import math

import torch

from captra_tpu_torch.config.schema import (
    Config, NetworkCfg, ObjCfg, PointNetCfg, SAMsgCfg,
)
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.parallel import mesh

NUM_POINTS = 64


def tiny_config() -> Config:
    """The JAX dry run's config: a one-part object, a two-scale sa1 of 16
    centroids, an sa2 of 8, 32-wide layers, 64 points."""
    pn = PointNetCfg(
        sa1=SAMsgCfg(npoint=16, radius_list=(0.1, 0.2), nsample_list=(4, 8),
                     mlp_list=((8, 16), (8, 16))),
        sa2=SAMsgCfg(npoint=8, radius_list=(0.4,), nsample_list=(4,),
                     mlp_list=((16, 32),)),
        sa3_mlp=(32,), fp3_mlp=(32,), fp2_mlp=(32,), fp1_mlp=(32,))
    obj = ObjCfg(num_parts=1, num_joints=0, tree=(-1,), extra_dims=1)
    return Config(obj=obj,
                  network=NetworkCfg(type="canon_coord", backbone_out_dim=32,
                                     nocs_head_dims=(16,)),
                  pointnet=pn, num_points=NUM_POINTS)


def _step(rank: int, world: int, device: str) -> dict:
    from captra_tpu_torch.data.synthetic import make_frame_batch
    from captra_tpu_torch.training.trainer import Trainer
    dp = mesh.data_parallel_mesh()
    cfg = tiny_config()
    trainer = Trainer(cfg, steps_per_epoch=10, device=device, dp=dp)
    state = mesh.replicate(trainer.init_state(
        generator=torch.Generator().manual_seed(0)), dp)
    batch = mesh.shard_batch(make_frame_batch(
        0, cfg.obj, batch=world, num_points=NUM_POINTS), rank, world)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    state, loss_dict, _ = trainer.train_step(state, batch, generator=gen)
    return {"loss": float(loss_dict["total_loss"]),
            "params": state.params.cpu()}


def dryrun_multichip(n_devices: int, device=None) -> float:
    """Take the step over `n_devices` ranks (on as many cards, unless
    device="cpu"); check that the loss is finite and the parameters equal
    on every rank; print the ok line and return the loss."""
    results = mesh.launch(_step, n_devices, resolve_device(device))
    loss = results[0]["loss"]
    if not (math.isfinite(loss)
            and torch.isfinite(results[0]["params"]).all()):
        raise RuntimeError(f"dryrun_multichip({n_devices}): non-finite "
                           f"loss {loss} or parameters")
    for r in results[1:]:
        if r["loss"] != loss or not torch.equal(r["params"],
                                                 results[0]["params"]):
            raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks' "
                               "losses or parameters differ")
    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.4f}")
    return loss
