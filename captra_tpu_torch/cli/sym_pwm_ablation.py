"""Symmetric-category pwm-term ablation (counterpart of
`scripts/sym_pwm_ablation.py`).

    python -m captra_tpu_torch.cli.sym_pwm_ablation [--steps 3000] \\
        [--pwm 128,384] [--dtype bfloat16] [--norm gn] [--category 1]

The pairwise-distance-matrix (pwm) term of the symmetric NOCS loss
(`pwm_num` sampled points) is the only term that pins per-point azimuthal
consistency for a symmetric category.  For each `--pwm` value this trains
the full-width CoordNet (`config_coordnet.yml` on `obj_info_nocs.yml`,
the flags' category, batch, grad clip, norm and dtype) on synthetic data
and reports the loss decomposition and pose metrics at the same step
budget.  A category that is not symmetric raises.

A leg: `Trainer(cfg, steps_per_epoch=200)`, the net drawn xavier-uniform
from a CPU generator seeded 0 (the script's `PRNGKey(0)`), batch i the
cached `make_frame_batch(i % 157)`, and a step's draws (the pose noise
and the pwm sample over the GT labels, `Trainer.draw`) from a generator on
the device seeded 0, in step order (the script splits `jax.random` keys,
whose streams torch cannot reproduce).  A step reads nothing back to the
host but the losses it prints.

Flags, defaults and printed lines are the JAX script's, plus one line a
leg with its ms a step and the device.  `main(argv, device="cpu")` runs on
the CPU; without it the card is required.  Returns {pwm: the last printed
losses and metrics}, as the script's JSON.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from captra_tpu_torch.config import get_config
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.eval import quality
from captra_tpu_torch.training.trainer import Trainer, to_device

INIT_SEED = 0               # the nets' draw (the script's PRNGKey(0))
DRAW_SEED = 0               # a leg's train-step draws
STEPS_PER_EPOCH = 200       # the schedules' epoch
LOG_EVERY = 200             # steps between printed (host-read) losses
DISTINCT_BATCHES = 157      # the cycled make_frame_batch pool


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("captra-tpu-torch sym_pwm_ablation")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--pwm", default="128,384")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--grad_clip", type=float, default=1.0)
    ap.add_argument("--norm", default="gn", choices=["bn", "gn"])
    ap.add_argument("--category", default="1")  # bottle: sym
    return ap.parse_args(argv)


def pwm_values(args: argparse.Namespace) -> list[int]:
    return [int(x) for x in args.pwm.split(",")]


def overrides(args: argparse.Namespace, pwm: int) -> dict:
    """The `config_coordnet.yml` overrides of the leg at `pwm`."""
    return {"obj_config": "obj_info_nocs.yml",
            "obj_category": args.category,
            "batch_size": args.batch,
            "grad_clip": args.grad_clip,
            "network/pwm_num": pwm,
            "network/norm": args.norm,
            "network/compute_dtype": args.dtype}


def config(args: argparse.Namespace, pwm: int):
    """The CoordNet training config of the leg at `pwm`; raises
    `ValueError` when the category is not symmetric."""
    cfg = get_config("config_coordnet.yml", overrides=overrides(args, pwm))
    if not cfg.obj.sym:
        raise ValueError(f"pwm ablation needs a sym category; category "
                         f"{args.category} ({cfg.obj.name}) is not")
    return cfg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(trainer: Trainer, state, steps: int, batch_of, draws_of,
          pwm: int):
    """`steps` train steps of `state` (in place): batch i is
    `batch_of(i)`, its draws `draws_of(i, batch)`.  Prints the script's
    line at every LOG_EVERY-th and at the last step.  Returns (state, the
    last printed losses and metrics as floats, every step's total loss
    [steps] on the device)."""
    totals = None
    last = {}
    for i in range(steps):
        batch = batch_of(i)
        state, loss, metrics = trainer.train_step(
            state, batch, draws=draws_of(i, batch))
        if totals is None:
            totals = loss["total_loss"].new_zeros(steps)
        totals[i] = loss["total_loss"]
        if i % LOG_EVERY == 0 or i == steps - 1:
            # in the script's order: the losses, then the metrics, each
            # sorted by name (a jitted step returns its dicts sorted)
            last = {k: float(v) for k, v in [*sorted(loss.items()),
                                             *sorted(metrics.items())]}
            print(f"[pwm={pwm}] step {i}: total={last['total_loss']:.4f}"
                  f" pwm={last.get('nocs_pwm_loss', 0):.4f}"
                  f" dist={last.get('nocs_dist_loss', 0):.4f}"
                  f" sdiff={last.get('sdiff', 0):.4f}", flush=True)
    return state, last, totals


def run_leg(args: argparse.Namespace, pwm: int, device: torch.device
            ) -> dict:
    """Train the leg at `pwm`; returns its last printed losses and
    metrics."""
    from captra_tpu_torch.data.synthetic import make_frame_batch
    cfg = config(args, pwm)
    trainer = Trainer(cfg, steps_per_epoch=STEPS_PER_EPOCH, device=device)
    state = trainer.init_state(
        generator=torch.Generator().manual_seed(INIT_SEED))
    gen = torch.Generator(device).manual_seed(DRAW_SEED)
    cache = {}

    def batch_of(i):
        ci = i % DISTINCT_BATCHES
        if ci not in cache:
            cache[ci] = to_device(make_frame_batch(
                ci, cfg.obj, batch=args.batch, num_points=cfg.num_points),
                device)
        return cache[ci]

    _sync(device)
    t0 = time.time()
    _, last, _ = train(trainer, state, args.steps, batch_of,
                       lambda i, batch: trainer.draw(batch, gen), pwm)
    _sync(device)
    dt = time.time() - t0
    print(f"[pwm={pwm}] {args.steps} steps in {dt:.0f}s")
    print(f"[pwm={pwm}] {dt / max(args.steps, 1) * 1e3:.2f} ms a step on "
          f"{quality.device_label(device)}", flush=True)
    return last


def main(argv=None, device=None) -> dict:
    """Run the ablation as the command line says; returns {pwm: the last
    printed losses and metrics}."""
    device = resolve_device(device)
    args = parse(argv)
    results = {}
    for pwm in pwm_values(args):
        results[pwm] = run_leg(args, pwm, device)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
