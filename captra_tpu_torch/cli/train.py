"""Training entry point (counterpart of `captra_tpu/cli/train.py`).

    python -m captra_tpu_torch.cli.train --config=config_coordnet.yml \\
        [--synthetic_data [--device_aug]] [--experiment_dir=<exp>] [flags]

Trains the CoordNet (`config_coordnet.yml`) or the RotNet
(`config_rotnet.yml`) of the config's object on the card: with
`--synthetic_data` on generated batches (`synthetic_epoch`, 50 steps an
epoch), with `--device_aug` on poses drawn on the device over a host
geometry pool, else on the dataset under the object config's basepath
(`train` split, shuffled per epoch; `real_test` / `test` and `--use_val`
evaluated each epoch).  Saves `<exp>/ckpt/model_%04d` every `freq/save`
epochs and at the last (the JAX package's pickle layout, which both
packages' track CLIs read) and resumes from the newest (or
`--resume_epoch`) checkpoint of the port or of the JAX package.  Logs the
JAX CLI's lines to `<exp>/log/log.txt` and the console.

The draws of an epoch (pose noise, the symmetric NOCS sample, device-side
poses) come from a generator on the card seeded by (epoch, phase), so a
resumed run replays an uninterrupted one.  The JAX CLI's `jax.random`
streams cannot be reproduced; the synthetic batches and the dataset's frame
order and point shuffle are the JAX package's.

`--ckpt_format orbax` writes orbax checkpoint directories through
tensorstore (`training/orbax_io.py`; without tensorstore it raises
`ImportError` naming it); resume reads either format.

`--num_devices N` (default: the cards, or 1 on the CPU; lowered until it
divides the batch, the JAX CLI's rule) trains data-parallel over N ranks
of this machine (`parallel/mesh.py`: gloo on the CPU, NCCL on CUDA with
one card a rank; more ranks than cards raise `ValueError`, where the JAX
CLI's `devs[:n]` shrinks the mesh).  Every rank builds the same global
batch and takes its shard; the step is the single-device step on the
global batch.  Rank 0 logs and writes the checkpoints while the others
wait at a barrier; `main` then returns None.  `main(argv, device="cpu")`
runs on the CPU; without it the card is required.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from os.path import join as pjoin

import torch

from captra_tpu_torch.cli.args import add_args, config_overrides
from captra_tpu_torch.config import get_config
from captra_tpu_torch.data.loader import prefetch, single_frame_batches
from captra_tpu_torch.data.synthetic import make_frame_batch
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.parallel import mesh
from captra_tpu_torch.training import checkpoint as ckpt
from captra_tpu_torch.training.trainer import Trainer

SYNTHETIC_STEPS = 50        # steps of a synthetic epoch
DRAW_SEED = 0               # the draws' base seed (the JAX CLI's PRNGKey(0))
AUG_SEED = 42               # --device_aug's poses (the JAX CLI's PRNGKey(42))
INIT_SEED = 0               # the nets' xavier draw


def setup_logger(experiment_dir: str, name: str,
                 quiet: bool = False) -> logging.Logger:
    """The run's logger: `<exp>/log/log.txt` and the console, or nothing
    with `quiet` (the ranks after 0 of a data-parallel run)."""
    logger = logging.getLogger(f"captra_tpu_torch.{name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    if quiet:
        logger.addHandler(logging.NullHandler())
        return logger
    log_dir = pjoin(experiment_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    fh = logging.FileHandler(pjoin(log_dir, "log.txt"))
    fh.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    logger.addHandler(fh)
    logger.addHandler(logging.StreamHandler())
    return logger


def close_logger(logger: logging.Logger) -> None:
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


def phase_generator(device: torch.device, epoch: int, phase: int,
                    base: int = DRAW_SEED) -> torch.Generator:
    """The draw stream of one (epoch, phase) of a run: a generator on
    `device`, seeded from them alone, so a resumed run replays it."""
    seed = (base * 1_000_003 + epoch) * 8 + phase
    return torch.Generator(device=device).manual_seed(seed)


def synthetic_epoch(cfg, epoch: int, steps: int = SYNTHETIC_STEPS):
    for i in range(steps):
        yield make_frame_batch(epoch * steps + i, cfg.obj,
                               batch=cfg.batch_size,
                               num_points=cfg.num_points)


def make_device_aug_sampler(cfg, pool_size: int, device: torch.device,
                            pool_seed: int = 0):
    """`sample(generator)` -> a training batch of `cfg.batch_size` pooled
    geometries (drawn uniformly) rendered under fresh random poses on the
    device (`data/synthetic.py::device_pose_batch`); the pool of
    `pool_size` geometries from `geometry_pool(pool_seed)` lives on the
    device."""
    from captra_tpu_torch.data.synthetic import (
        device_pose_batch, geometry_pool,
    )
    pool = {k: torch.from_numpy(v).to(device) for k, v in geometry_pool(
        seed=pool_seed, obj=cfg.obj, count=pool_size,
        num_points=cfg.num_points).items()}
    G = pool["npcs"].shape[0]

    def sample(generator: torch.Generator) -> dict:
        idx = torch.randint(0, G, (cfg.batch_size,), generator=generator,
                            device=generator.device)
        return device_pose_batch(pool["npcs"][idx], pool["labels"][idx],
                                 pool["corners"][idx], cfg.obj,
                                 generator=generator)

    return sample


def device_aug_epoch(sampler, epoch: int, steps: int, device: torch.device):
    """An epoch of device-side augmented batches, their draws from the
    epoch's own stream."""
    gen = phase_generator(device, epoch, 0, base=AUG_SEED)
    for _ in range(steps):
        yield sampler(gen)


def num_ranks(requested: int | None, batch_size: int | None,
              device: torch.device) -> int:
    """The data-parallel ranks of a run: `requested` (--num_devices), else
    the cards (1 on the CPU), lowered until it divides `batch_size` (the
    JAX CLI's rule; None: no batch to divide).  On CUDA, more ranks than
    cards raise ValueError."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    n = max(requested or cards, 1)
    while batch_size and batch_size % n:
        n -= 1
    if device.type == "cuda" and n > cards:
        raise ValueError(f"--num_devices asks for {n} ranks and this "
                         f"machine has {cards} cards (one card a rank)")
    return n


def shards(batches, dp: mesh.DataParallel | None):
    """This rank's shard of each global batch (the batches as given
    without `dp`)."""
    for batch in batches:
        yield batch if dp is None else mesh.shard_batch(batch, dp.rank,
                                                        dp.world)


def save(state, cfg, args, epoch: int, dp: mesh.DataParallel | None):
    """Rank 0 writes the epoch's checkpoint in `--ckpt_format`; the other
    ranks wait for it at a barrier."""
    if dp is None or dp.rank == 0:
        ckpt.save_train_state(pjoin(cfg.experiment_dir, "ckpt"), epoch,
                              state, format=args.ckpt_format,
                              grad_clip=cfg.optim.grad_clip)
    if dp is not None:
        dp.barrier()


def resume(trainer: Trainer, state, cfg, args, logger):
    """(state, first epoch): the newest (or --resume_epoch) checkpoint of
    the experiment loaded into `state`, else (state, 0)."""
    last = ckpt.latest_checkpoint(pjoin(cfg.experiment_dir, "ckpt"),
                                  args.resume_epoch
                                  if args.resume_epoch >= 0 else None)
    if not last:
        return state, 0
    payload = ckpt.load_checkpoint(last)
    state = ckpt.restore_state(payload, state)
    start = payload["epoch"] + 1
    logger.info("resumed from %s (epoch %d)", last, start)
    return state, start


def run_epoch(trainer: Trainer, state, batches, train: bool, tag: str,
              epoch: int, logger, phase: int | None = None) -> int:
    """Train (or evaluate) over `batches` (global batches: under the
    trainer's `dp`, each rank steps on its shard); the global losses and
    metrics are summed on the device and logged, once an epoch, as their
    means."""
    gen = phase_generator(trainer.device, epoch,
                          (0 if train else 1) if phase is None else phase)
    sums, count = None, 0
    for batch in prefetch(shards(batches, trainer.dp)):
        if train:
            state, loss_dict, metrics = trainer.train_step(
                state, batch, generator=gen)
        else:
            loss_dict, metrics = trainer.eval_step(state, batch,
                                                   generator=gen)
        cur = {**loss_dict, **metrics}
        sums = cur if sums is None else {k: sums[k] + v
                                         for k, v in cur.items()}
        count += 1
    for k in sorted(sums or ()):
        logger.info("%s epoch %d %s is %.6f", tag, epoch, k,
                    float(sums[k]) / max(count, 1))
    return count


def parse(argv=None):
    """(args, cfg) of a train command line."""
    parser = add_args(argparse.ArgumentParser("captra-tpu-torch train"))
    args = parser.parse_args(argv)
    if args.device_aug and not args.synthetic_data:
        raise SystemExit("--device_aug resamples poses over generated "
                         "geometry and requires --synthetic_data")
    return args, get_config(args.config, config_overrides(args),
                            args.config_dir)


def main(argv=None, device=None):
    device = resolve_device(device)
    args, cfg = parse(argv)
    n = num_ranks(args.num_devices, cfg.batch_size, device)
    if n > 1:
        mesh.launch(_rank_main, n, device, args=(argv,))
        return None
    return _run(_train, cfg, args, device, "train")


def _run(body, cfg, args, device, name, dp=None):
    logger = setup_logger(cfg.experiment_dir, name,
                          quiet=dp is not None and dp.rank > 0)
    try:
        return body(cfg, args, device, logger, dp)
    finally:
        close_logger(logger)


def _rank_main(rank: int, world: int, device: str, argv) -> None:
    args, cfg = parse(argv)
    _run(_train, cfg, args, torch.device(device), "train",
         mesh.data_parallel_mesh())


def _train(cfg, args, device, logger, dp=None):
    from captra_tpu_torch.data.factory import make_dataset
    logger.info("config: %s", cfg)
    if args.use_val and args.synthetic_data:
        logger.info("--use_val is ignored with --synthetic_data "
                    "(no disk splits)")
    logger.info("device: %s", device)
    if dp is not None:
        logger.info("data parallel: %d ranks", dp.world)

    steps_per_epoch = SYNTHETIC_STEPS
    train_ds = None
    if not args.synthetic_data:
        train_ds = make_dataset(cfg, "train")
        steps_per_epoch = max(1, len(train_ds) // cfg.batch_size)
    trainer = Trainer(cfg, steps_per_epoch=steps_per_epoch, device=device,
                      dp=dp)
    state = trainer.init_state(
        generator=torch.Generator().manual_seed(INIT_SEED))
    state, start_epoch = resume(trainer, state, cfg, args, logger)
    if dp is not None:
        mesh.replicate(state, dp)

    test_ds, val_ds = None, None
    if not args.synthetic_data:
        try:
            test_ds = make_dataset(
                cfg, "real_test" if cfg.obj.nocs_data else "test")
        except Exception as e:  # noqa: BLE001 - no test split on disk
            logger.info("no test split (%s); skipping per-epoch eval", e)
        if args.use_val:
            try:
                val_ds = make_dataset(cfg, args.use_val)
            except Exception as e:  # noqa: BLE001 - no such split
                logger.info("no %s split (%s)", args.use_val, e)

    sampler = (make_device_aug_sampler(cfg, args.geom_pool, device)
               if args.device_aug else None)
    for epoch in range(start_epoch, cfg.optim.total_epoch):
        trainer.set_epoch(epoch)
        if sampler is not None:
            batches = device_aug_epoch(sampler, epoch, steps_per_epoch,
                                       device)
        elif args.synthetic_data:
            batches = synthetic_epoch(cfg, epoch, steps_per_epoch)
        else:
            batches = single_frame_batches(train_ds, cfg.batch_size,
                                           seed=epoch)
        t0 = time.time()
        count = run_epoch(trainer, state, batches, True, "Train", epoch,
                          logger)
        logger.info("epoch %d: %d steps in %.1fs", epoch, count,
                    time.time() - t0)
        if ((epoch + 1) % cfg.save_freq == 0
                or epoch == cfg.optim.total_epoch - 1):
            save(state, cfg, args, epoch, dp)
        if test_ds is not None:
            run_epoch(trainer, state, single_frame_batches(
                test_ds, cfg.batch_size, shuffle=False), False, "Test",
                epoch, logger)
        if val_ds is not None:
            run_epoch(trainer, state, single_frame_batches(
                val_ds, cfg.batch_size, shuffle=False), False, args.use_val,
                epoch, logger, phase=2)
    return state


if __name__ == "__main__":
    main()
