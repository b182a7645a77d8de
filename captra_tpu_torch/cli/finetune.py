"""NOCS finetune entry (counterpart of `captra_tpu/cli/finetune.py`): mix
CAMERA-synthetic and Real275 single-frame batches each epoch.

    python -m captra_tpu_torch.cli.finetune --config=config_coordnet.yml \\
        --obj_config=obj_info_nocs.yml --obj_category=<c> --basepath=<root> \\
        [--syn_n N] [--real_only] [--downsample K]

Per epoch: `syn_n` x (real batches) synthetic batches from a persistent
stream over the `train` split (`syn_stream`), then the whole `real_train`
split, then an evaluation on `real_test` (downsampled by --downsample),
each logged as the JAX CLI logs it.  Checkpoints and resume as
`cli/train.py`; the draws of each (epoch, phase) from their own generator
on the device.  `--ckpt_format orbax` and `--num_devices` as in
`cli/train.py`: data-parallel ranks each take their shard of every global
batch, rank 0 logs and saves.
"""
from __future__ import annotations

import argparse

import torch

from captra_tpu_torch.cli.args import add_args, config_overrides
from captra_tpu_torch.cli.train import (
    INIT_SEED, _run, num_ranks, resume, run_epoch, save,
)
from captra_tpu_torch.config import get_config
from captra_tpu_torch.data.loader import single_frame_batches
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.parallel import mesh
from captra_tpu_torch.training.trainer import Trainer


def syn_stream(dataset, batch_size: int, consumed: int):
    """Persistent synthetic stream, one shuffled pass after another (pass
    k seeded k + 1), fast-forwardable: the first `consumed` batches are
    skipped by index, without reads, so a resumed run continues the stream
    where an uninterrupted one would be."""
    if len(dataset) < batch_size:
        raise ValueError(
            f"synthetic split has {len(dataset)} frames < batch_size "
            f"{batch_size}: every epoch would yield zero batches")
    per = len(dataset) // batch_size
    seed = consumed // per
    start = consumed % per
    while True:
        seed += 1
        yield from single_frame_batches(dataset, batch_size, seed=seed,
                                        start_batch=start)
        start = 0


def parse(argv=None):
    """(args, cfg) of a finetune command line."""
    parser = add_args(argparse.ArgumentParser("captra-tpu-torch finetune"))
    parser.add_argument("--syn_n", type=int, default=1,
                        help="synthetic batches per real batch per epoch")
    parser.add_argument("--real_only", action="store_true", default=False)
    parser.add_argument("--downsample", type=int, default=None)
    args = parser.parse_args(argv)
    return args, get_config(args.config, config_overrides(args),
                            args.config_dir)


def main(argv=None, device=None):
    device = resolve_device(device)
    args, cfg = parse(argv)
    n = num_ranks(args.num_devices, cfg.batch_size, device)
    if n > 1:
        mesh.launch(_rank_main, n, device, args=(argv,))
        return None
    return _run(_finetune, cfg, args, device, "finetune")


def _rank_main(rank: int, world: int, device: str, argv) -> None:
    args, cfg = parse(argv)
    _run(_finetune, cfg, args, torch.device(device), "finetune",
         mesh.data_parallel_mesh())


def _finetune(cfg, args, device, logger, dp=None):
    from captra_tpu_torch.data.factory import make_dataset
    if dp is not None:
        logger.info("data parallel: %d ranks", dp.world)
    real_ds = make_dataset(cfg, "real_train")
    syn_ds = make_dataset(cfg, "train")
    real_len = max(1, len(real_ds) // cfg.batch_size)
    syn_per_epoch = real_len * args.syn_n
    test_ds = None
    try:
        test_ds = make_dataset(cfg, "real_test",
                               downsampling=args.downsample)
    except Exception as e:  # noqa: BLE001 - no test split on disk
        logger.info("no real_test split (%s); skipping per-epoch eval", e)

    trainer = Trainer(cfg, steps_per_epoch=real_len + syn_per_epoch,
                      device=device, dp=dp)
    state = trainer.init_state(
        generator=torch.Generator().manual_seed(INIT_SEED))
    state, start_epoch = resume(trainer, state, cfg, args, logger)
    if dp is not None:
        mesh.replicate(state, dp)
    syn_cycle = syn_stream(syn_ds, cfg.batch_size,
                           consumed=start_epoch * syn_per_epoch)

    for epoch in range(start_epoch, cfg.optim.total_epoch):
        trainer.set_epoch(epoch)
        phases = [] if args.real_only else [
            ("Syn_Train", 0, (next(syn_cycle) for _ in range(syn_per_epoch)))]
        phases.append(("Real_Train", 1, single_frame_batches(
            real_ds, cfg.batch_size, seed=epoch)))
        for tag, phase, batches in phases:
            run_epoch(trainer, state, batches, True, tag, epoch, logger,
                      phase=phase)
        if ((epoch + 1) % cfg.save_freq == 0
                or epoch == cfg.optim.total_epoch - 1):
            save(state, cfg, args, epoch, dp)
        if test_ds is not None:
            run_epoch(trainer, state, single_frame_batches(
                test_ds, cfg.batch_size, shuffle=False), False, "Test",
                epoch, logger, phase=2)
    return state


if __name__ == "__main__":
    main()
