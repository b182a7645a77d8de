"""Train CoordNet, then RotNet, at full width on synthetic data, then track
with them (counterpart of `scripts/tpu_flagship_demo.py`).

    python -m captra_tpu_torch.cli.flagship_demo [--steps 600] \\
        [--device_aug] [--eval_at 1000,2000,3000] [--out runs/flagship_demo]

Each leg (`config_coordnet.yml`, then `config_rotnet.yml`, the flags'
object, batch, dtype and norm) trains with `training/trainer.Trainer`
(200 steps an epoch for the schedules) on the cycled pool of
`--distinct_batches` `make_frame_batch` batches, or with `--device_aug`
on poses drawn on the card over a `--geom_pool` geometry pool
(`cli/train.make_device_aug_sampler`, pool seed 0 for the CoordNet and 1
for the RotNet), and saves `<out>/<net>/ckpt/model_0000` (the JAX
package's pickle layout).  `--skip_coord` loads that CoordNet checkpoint
instead of training it, when it exists.  Then both nets track
`--track_trajs` synthetic trajectories of TRACK_FRAMES frames (seeds
1000+, GT init) against the frozen-init baseline, once more at each
`--eval_at` budget with that step's snapshot of both nets (copies on the
card), and `<out>/EVIDENCE.json` gets the JAX script's keys, plus the
card's name and power limit under `tracking.device` beside the rate, and
each leg's mean total loss over each 50 steps under
`<net>.total_loss_by_50`.

Flags, defaults and printed lines are the JAX script's.  The draws differ:
the nets are drawn xavier-uniform from a CPU generator seeded 0 (the
script's `PRNGKey(0)`), a leg's train-step draws come from a generator on
the device seeded 0 and the device-side poses from one seeded 42, each
drawn in step order (the script splits and folds `jax.random` keys, whose
streams torch cannot reproduce).  A step reads nothing back to the host
but the losses it prints every 100 steps.  The tracked block runs on the
points plus 1e-9, as the script's timed run does.  `main(argv,
device="cpu")` runs on the CPU; without it the card is required.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from captra_tpu_torch.config import get_config
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.eval import quality
from captra_tpu_torch.tracking.tracker import evaluate_track
from captra_tpu_torch.training import checkpoint as ckpt
from captra_tpu_torch.training.trainer import Trainer, to_device

NETS = (("canon_coord", "config_coordnet.yml"),
        ("rot", "config_rotnet.yml"))
TRACK_FRAMES = 20           # frames of each tracked trajectory
INIT_SEED = 0               # the nets' draw (the script's PRNGKey(0))
DRAW_SEED = 0               # a leg's train-step draws
AUG_SEED = 42               # --device_aug's poses (the script's PRNGKey(42))
STEPS_PER_EPOCH = 200       # the schedules' epoch
LOG_EVERY = 100             # steps between printed (host-read) losses
LOSS_WINDOW = 50            # steps a mean of total_loss_by_50


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("captra-tpu-torch flagship_demo")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--track_trajs", type=int, default=8)
    ap.add_argument("--out", type=str, default="runs/flagship_demo")
    ap.add_argument("--category", type=str, default="1")
    ap.add_argument("--obj_config", type=str, default="obj_info_nocs.yml")
    ap.add_argument("--dtype", type=str, default="float32")
    ap.add_argument("--rot_steps", type=int, default=None)
    ap.add_argument("--grad_clip", type=float, default=None,
                    help="override optim grad_clip (None = config value)")
    ap.add_argument("--norm", default=None, choices=[None, "bn", "gn"],
                    help="override network/norm (gn: no train/eval BN gap)")
    ap.add_argument("--eval_at", type=str, default=None,
                    help="comma-separated step budgets: snapshot both nets "
                         "at each and track with every matched pair "
                         "(accuracy-vs-budget trend in one run)")
    ap.add_argument("--distinct_batches", type=int, default=157,
                    help="size of the cycled synthetic-batch pool "
                         "(training-data diversity knob)")
    ap.add_argument("--rot_perturb_r", type=float, default=None,
                    help="override pose_perturb/r (deg) for RotationNet "
                         "training only")
    ap.add_argument("--coord_perturb_r", type=float, default=None,
                    help="override pose_perturb/r (deg) for CoordNet "
                         "training only")
    ap.add_argument("--skip_coord", action="store_true", default=False,
                    help="load an existing <out>/canon_coord/ckpt "
                         "checkpoint instead of training the CoordNet")
    ap.add_argument("--device_aug", action="store_true", default=False,
                    help="device-side pose resampling: every step draws a "
                         "fresh random pose over a device-resident "
                         "geometry pool")
    ap.add_argument("--geom_pool", type=int, default=512,
                    help="geometry pool size for --device_aug")
    args = ap.parse_args(argv)
    args.eval_budgets = sorted({int(s) for s in args.eval_at.split(",")}) \
        if args.eval_at else []
    return args


def leg_config(args: argparse.Namespace, net_type: str, config: str):
    """The training config of one leg: the flags' object, batch, dtype and
    the overrides each flag names."""
    overrides = {
        "obj_config": args.obj_config, "obj_category": args.category,
        "batch_size": args.batch, "network/compute_dtype": args.dtype}
    if args.grad_clip is not None:
        overrides["grad_clip"] = args.grad_clip
    if args.norm is not None:
        overrides["network/norm"] = args.norm
    if args.rot_perturb_r is not None and net_type == "rot":
        overrides["pose_perturb/r"] = args.rot_perturb_r
    if args.coord_perturb_r is not None and net_type == "canon_coord":
        overrides["pose_perturb/r"] = args.coord_perturb_r
    return get_config(config, overrides=overrides)


def track_config(args: argparse.Namespace):
    overrides = {
        "obj_config": args.obj_config, "obj_category": args.category,
        "init_frame/gt": True, "network/compute_dtype": args.dtype}
    if args.norm is not None:
        overrides["network/norm"] = args.norm
    return get_config("config_track.yml", overrides=overrides)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_leg(args: argparse.Namespace, net_type: str, cfg, device) -> dict:
    """Train one net for its steps (and at least to the last budget):
    {"state", "snapshots" {budget: state_dict copy}, "report" (the
    EVIDENCE.json entry)}."""
    from captra_tpu_torch.data.synthetic import make_frame_batch
    trainer = Trainer(cfg, steps_per_epoch=STEPS_PER_EPOCH, device=device)
    state = trainer.init_state(
        generator=torch.Generator().manual_seed(INIT_SEED))
    coord_ckpt = os.path.join(args.out, "canon_coord", "ckpt", "model_0000")
    if (net_type == "canon_coord" and args.skip_coord
            and os.path.exists(coord_ckpt)):
        ckpt.restore_state(ckpt.load_checkpoint(coord_ckpt), state)
        print("[canon_coord] loaded existing checkpoint "
              f"({coord_ckpt}); skipping coord training", flush=True)
        return {"state": state, "snapshots": {},
                "report": {"final": {}, "sec": 0.0, "loaded": True}}
    steps = args.steps if net_type == "canon_coord" else \
        (args.rot_steps or args.steps)
    steps = max([steps] + args.eval_budgets)
    sample = None
    if args.device_aug:
        from captra_tpu_torch.cli.train import make_device_aug_sampler
        sample = make_device_aug_sampler(
            cfg, args.geom_pool, device,
            pool_seed=0 if net_type == "canon_coord" else 1)
        aug_gen = torch.Generator(device).manual_seed(AUG_SEED)
    gen = torch.Generator(device).manual_seed(DRAW_SEED)
    batch_cache = {}
    snapshots = {}
    totals = torch.zeros(steps, device=device)
    last = {}
    _sync(device)
    t0 = time.time()
    for i in range(steps):
        if sample is not None:
            batch = sample(aug_gen)
        else:
            ci = i % args.distinct_batches
            if ci not in batch_cache:
                batch_cache[ci] = to_device(make_frame_batch(
                    ci, cfg.obj, batch=args.batch,
                    num_points=cfg.num_points), device)
            batch = batch_cache[ci]
        state, loss, metrics = trainer.train_step(state, batch,
                                                  generator=gen)
        totals[i] = loss["total_loss"]
        if (i + 1) in args.eval_budgets:
            snapshots[i + 1] = {k: v.detach().clone() for k, v in
                                state.module.state_dict().items()}
        if i % LOG_EVERY == 0 or i == steps - 1:
            last = {k: float(v) for k, v in {**loss, **metrics}.items()}
            print(f"[{net_type}] step {i}: total="
                  f"{last['total_loss']:.4f} "
                  f"5d5cm={last.get('5deg5cm', 0):.3f} "
                  f"rdiff={last.get('rdiff', 0):.2f}", flush=True)
    _sync(device)
    dt = time.time() - t0
    print(f"[{net_type}] {steps} steps in {dt:.1f}s "
          f"({dt / steps * 1e3:.0f} ms/step)", flush=True)
    ckpt.save_train_state(os.path.join(args.out, net_type, "ckpt"), 0, state)
    by_window = [float(w.mean()) for w in totals.split(LOSS_WINDOW)]
    return {"state": state, "snapshots": snapshots,
            "report": {"final": last, "sec": round(dt, 1),
                       "total_loss_by_50": by_window}}


def run(args: argparse.Namespace, device) -> tuple[dict, dict]:
    """Train both legs and track: (the EVIDENCE.json report, {net type:
    the leg's {"state", "snapshots", "report"}})."""
    device = resolve_device(device)
    os.makedirs(args.out, exist_ok=True)
    report = {"steps": args.steps, "batch": args.batch}
    legs = {}
    for net_type, config in NETS:
        legs[net_type] = train_leg(args, net_type,
                                   leg_config(args, net_type, config), device)
        report[net_type] = legs[net_type]["report"]

    # --- tracking ---------------------------------------------------------
    cfg = track_config(args)
    coord, rotn = quality.nets_of(cfg, legs["canon_coord"]["state"].module
                          .state_dict(), legs["rot"]["state"].module
                          .state_dict(), device)
    T = TRACK_FRAMES
    data = quality.eval_set(cfg.obj, args.track_trajs, T, cfg.num_points)
    gt = data["pose"].to(device)
    init_pose = gt[0]
    points = torch.as_tensor(data["points"]).to(device)
    quality.track(cfg, coord, rotn, init_pose, points, device)  # warm-up
    # the script's timed dispatch differs from its warm-up by 1e-9 (against
    # a remote result cache); the tracked block keeps its inputs
    points_timed = points + torch.tensor(1e-9, dtype=points.dtype)
    _sync(device)
    t0 = time.perf_counter()
    pose = quality.track(cfg, coord, rotn, init_pose, points_timed, device)
    _sync(device)
    dt = time.perf_counter() - t0
    fps = (T - 1) * args.track_trajs / dt

    gt_rest = gt.map(lambda x: x[1:])
    frame1, tracked = quality.means(evaluate_track(pose, gt_rest,
                                                   sym=cfg.obj.sym))
    # first tracked frame separates per-frame fit quality from drift
    report["tracking_frame1"] = frame1
    print("frame-1    ", quality.rounded(frame1))
    frozen_m = quality.frozen_init(gt, cfg.obj.sym)
    report["tracking"] = {"fps_per_chip": round(fps, 1),
                          "device": quality.device_label(device),
                          "tracked": tracked, "frozen_init": frozen_m}
    print(f"\ntracking: {fps:.1f} frames/s/chip")
    print("tracked    ", quality.rounded(tracked))
    print("frozen-init", quality.rounded(frozen_m))

    # --- accuracy-vs-budget trend: track with every snapshot pair ---------
    coord_snaps = legs["canon_coord"]["snapshots"]
    rot_snaps = legs["rot"]["snapshots"]
    trend = {}
    for budget in sorted(set(coord_snaps) & set(rot_snaps)):
        cb, rb = quality.nets_of(cfg, coord_snaps[budget],
                                 rot_snaps[budget], device)
        f1, full = quality.track_means(cfg, cb, rb, init_pose, points, gt,
                                       device)
        trend[budget] = {"frame1": f1, "full": full}
        print(f"budget {budget}: frame1 rdiff="
              f"{f1.get('rdiff', 0):.2f} "
              f"full rdiff={full.get('rdiff', 0):.2f} "
              f"full 5d5cm={full.get('5deg5cm', 0):.3f}", flush=True)
    if trend:
        report["trend"] = trend

    path = os.path.join(args.out, "EVIDENCE.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print("wrote", path)
    return report, legs


def main(argv=None, device=None) -> dict:
    """Run the demo as the command line says; returns the report."""
    return run(parse(argv), device)[0]


if __name__ == "__main__":
    main()
