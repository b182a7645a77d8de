"""On-policy rollout fine-tuning entry point (counterpart of
`scripts/rollout_finetune.py`).

    python -m captra_tpu_torch.cli.rollout_finetune \\
        --coord <coord exp>/ckpt/model_0000 --rot <rot exp>/ckpt/model_0000 \\
        --out <dir> [--rounds 100 --eval_at 25,50,100] [flags]

Loads a trained CoordNet and RotNet (pickle checkpoints of either package),
runs fine-tune rounds (`training/rollout.py`: trajectories rendered on the
card, tracked by the current nets, both nets trained on the harvested
carried-pose states) and tracks the held-out synthetic set (trajectories
of `make_trajectory` seeds 1000+, GT init) at round 0 and at each round of
`--eval_at`, where it also writes `<out>/round_<r>/<net>/ckpt/model_0000`.
Writes `<out>/EVIDENCE.json` with the trend.  Flags, defaults, log lines
and the report's keys are the JAX script's.  Round r's draws come from a
generator on the card seeded by r (the JAX script folds r into its key,
whose streams torch cannot reproduce).  `main(argv, device="cpu")` runs on
the CPU; without it the card is required.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from captra_tpu_torch.config import get_config
from captra_tpu_torch.data.synthetic import (
    batch_trajectories, geometry_pool, make_trajectory,
)
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.tracking.tracker import (
    evaluate_track, init_pose_from_gt, make_track_step, track_trajectory,
)
from captra_tpu_torch.training import checkpoint as ckpt
from captra_tpu_torch.training.rollout import make_finetune_round
from captra_tpu_torch.training.trainer import Trainer

ROUND_SEED = 7              # the rounds' draws (the JAX script's PRNGKey(7))
NETS = (("canon_coord", "config_coordnet.yml"),
        ("rot", "config_rotnet.yml"))


def parse(argv=None) -> argparse.Namespace:
    """The JAX script's flags, with its --eval_at / --rounds
    reconciliation (budgets past --rounds are an error; the final round is
    appended)."""
    ap = argparse.ArgumentParser("captra-tpu-torch rollout_finetune")
    ap.add_argument("--coord", required=True)
    ap.add_argument("--rot", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--obj_config", default="obj_info_nocs.yml")
    ap.add_argument("--category", default="1")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--eval_at", type=str, default=None,
                    help="comma-separated round budgets to evaluate at "
                         "(default: just the final round)")
    ap.add_argument("--traj_batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--minibatch", type=int, default=12)
    ap.add_argument("--plain_steps", type=int, default=0,
                    help="standard noise-perturbation steps per round "
                         "(off-policy retention mixing)")
    ap.add_argument("--freeze_coord", action="store_true",
                    help="fine-tune RotationNet only (CoordNet frozen)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--geom_pool", type=int, default=512)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--norm", default="gn", choices=["bn", "gn"])
    ap.add_argument("--motion_rad", type=float, default=0.03)
    ap.add_argument("--eval_trajs", type=int, default=8)
    ap.add_argument("--eval_frames", type=int, default=20)
    args = ap.parse_args(argv)
    eval_at = sorted({int(s) for s in args.eval_at.split(",")}) \
        if args.eval_at else [args.rounds]
    # budgets past --rounds would never fire, and rounds after the last
    # budget would train without being evaluated or checkpointed
    if eval_at[-1] != args.rounds:
        bad = [b for b in eval_at if b > args.rounds]
        if bad:
            ap.error(f"--eval_at budgets {bad} exceed --rounds={args.rounds}")
        print(f"# note: appending final budget {args.rounds} to eval_at "
              f"(rounds after {eval_at[-1]} would otherwise be discarded)")
        eval_at.append(args.rounds)
    args.eval_budgets = eval_at
    return args


def configs(args: argparse.Namespace):
    """(the tracking config, {net type: its training config}) of a run:
    the flags' object, dtype, norm and learning rate, a learning rate held
    for 10000 epochs, GT init."""
    common = {"obj_config": args.obj_config, "obj_category": args.category,
              "network/compute_dtype": args.dtype, "network/norm": args.norm,
              "learning_rate": args.lr, "lr_step_size": 10_000}
    cfg_track = get_config("config_track.yml", overrides={
        **common, "init_frame/gt": True})
    return cfg_track, {net_type: get_config(config, overrides=common)
                       for net_type, config in NETS}


def setup(args: argparse.Namespace, device) -> dict:
    """The run's configs, trainers, states (loaded from --coord / --rot),
    fine-tune round and held-out evaluation: {"cfg_track", "trainers",
    "states", "round_fn", "eval_fn"}; eval_fn(states) -> {"frame1",
    "full"} of mean errors (floats)."""
    device = resolve_device(device)
    cfg_track, cfgs = configs(args)
    obj = cfg_track.obj

    trainers, states = {}, {}
    for (net_type, _), path in zip(NETS, (args.coord, args.rot)):
        tr = Trainer(cfgs[net_type], steps_per_epoch=10_000, device=device)
        payload = ckpt.load_checkpoint(path)
        states[net_type] = tr.init_state(variables={
            "params": payload["params"],
            "batch_stats": payload["batch_stats"]})
        trainers[net_type] = tr

    pool = geometry_pool(seed=0, obj=obj, count=args.geom_pool,
                         num_points=cfg_track.num_points)
    round_fn = make_finetune_round(
        cfg_track, trainers["canon_coord"], trainers["rot"], pool,
        traj_batch=args.traj_batch, traj_frames=args.frames,
        minibatch=args.minibatch, plain_steps=args.plain_steps,
        motion_rad=args.motion_rad, freeze_coord=args.freeze_coord,
        device=device)

    # the held-out set (generator seeds disjoint from the training pool)
    trajs = [make_trajectory(seed=1000 + s, obj=obj,
                             num_frames=args.eval_frames,
                             num_points=cfg_track.num_points)
             for s in range(args.eval_trajs)]
    data = batch_trajectories(trajs)
    gt = data["pose"].to(device)
    init_pose = init_pose_from_gt(gt[0], cfg_track,
                                  generator=torch.Generator(device)
                                  .manual_seed(0))
    gt_rest = gt.map(lambda x: x[1:])
    points = torch.from_numpy(data["points"]).to(device)

    def eval_fn(states: dict) -> dict:
        nets = [states[n].module for n, _ in NETS]
        for net in nets:
            net.eval()
        step = make_track_step(cfg_track, *nets, device=device)
        with torch.no_grad():
            _, aux = track_trajectory(step, init_pose, {"points": points},
                                      device=device)
        errs = evaluate_track(aux.pose, gt_rest, sym=obj.sym)
        return {"frame1": {k: float(torch.mean(v[0]))
                           for k, v in errs.items()},
                "full": {k: float(torch.mean(v)) for k, v in errs.items()}}

    return {"cfg_track": cfg_track, "trainers": trainers, "states": states,
            "round_fn": round_fn, "eval_fn": eval_fn}


def round_generator(device, r: int) -> torch.Generator:
    """Round r's draw stream: a generator on `device` seeded by r alone."""
    return torch.Generator(device=device).manual_seed(
        ROUND_SEED * 1_000_003 + r)


def main(argv=None, device=None) -> dict:
    device = resolve_device(device)
    args = parse(argv)
    os.makedirs(args.out, exist_ok=True)
    run = setup(args, device)
    states, round_fn = run["states"], run["round_fn"]

    def eval_now(tag):
        out = run["eval_fn"](states)
        print(f"[eval @{tag}] frame1 rdiff={out['frame1']['rdiff']:.3f} "
              f"full rdiff={out['full']['rdiff']:.2f} "
              f"5d5cm={out['full']['5deg5cm']:.3f} "
              f"tdiff={out['full']['tdiff']:.4f} "
              f"sdiff={out['full']['sdiff']:.4f}", flush=True)
        return out

    report = {"args": {k: v for k, v in vars(args).items()
                       if k != "eval_budgets"}, "trend": {}}
    report["trend"]["0"] = eval_now(0)

    t0 = time.time()
    for r in range(1, args.rounds + 1):
        states["canon_coord"], states["rot"], logs = round_fn(
            states["canon_coord"], states["rot"],
            generator=round_generator(device, r))
        if r % 5 == 0 or r == 1:
            logs = {k: float(v) for k, v in logs.items()}
            print(f"round {r}: coord_loss={logs['coord_loss']:.4f} "
                  f"rot_loss={logs['rot_loss']:.4f} "
                  f"rot_rdiff={logs['rot_rdiff']:.3f} "
                  f"rollout_rdiff={logs['rollout_rdiff']:.2f} "
                  f"rollout_5d5cm={logs['rollout_5deg5cm']:.3f} "
                  f"({(time.time() - t0) / r:.2f}s/round)", flush=True)
        if r in args.eval_budgets:
            report["trend"][str(r)] = eval_now(r)
            for net_type, _ in NETS:
                ckpt.save_train_state(
                    os.path.join(args.out, f"round_{r}", net_type, "ckpt"),
                    0, states[net_type])

    path = os.path.join(args.out, "EVIDENCE.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print("wrote", path)
    return report


if __name__ == "__main__":
    main()
