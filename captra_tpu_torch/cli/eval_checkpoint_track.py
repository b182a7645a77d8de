"""Track the synthetic eval set with trained checkpoints under any
tracking flags (counterpart of `scripts/eval_checkpoint_track.py`, the
quality harness behind the preset tables).

    python -m captra_tpu_torch.cli.eval_checkpoint_track \\
        --coord <coord exp>/ckpt/model_0000 --rot <rot exp>/ckpt/model_0000 \\
        [--category 1 --obj_config obj_info_nocs.yml] \\
        [--trajs 8 --frames 20] [--dtype float32 --norm bn] \\
        [--sweep 'delta:1;npcs:1;npcs:3:forward']

Prints, for each variant, its seconds and its frame-1 and full-scan means
(rdiff / tdiff / sdiff / 5deg5cm / 10deg10cm), then the frozen-init
baseline, in the lines `scripts/summarize_q4.py` parses.  Flags, defaults
and lines are the JAX script's; a track flag enters the config only when
it differs from its default, so `--quality_profile best` fills in the
rest.  The defaults are `--dtype bfloat16 --norm gn`: a BatchNorm
checkpoint needs `--norm bn`, and a mismatched one raises naming both
norms.  With `--init_noise` the frame-0 noise comes from a generator
seeded 0 (the JAX script's `PRNGKey(0)` stream cannot be reproduced).
`main(argv, device="cpu")` runs on the CPU; without it the card is
required.  Returns {"variants": {tag: {"frame1", "full"}}, "frozen_init"}.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from captra_tpu_torch.config import get_config
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.eval import quality

# track flags that enter the config only when they differ from their
# default (the script's rule)
TRACK_KEYS = ("conf_weighted_delta", "scale_clamp", "refine_iters",
              "refine_mode", "rot_fit", "rot_fit_alpha", "fit_ransac",
              "fit_ransac_th", "motion_model", "motion_gain", "motion_beta",
              "quality_profile")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("captra-tpu-torch eval_checkpoint_track")
    ap.add_argument("--coord", required=True,
                    help="CoordNet checkpoint path (training.checkpoint)")
    ap.add_argument("--rot", required=True, help="RotationNet checkpoint")
    ap.add_argument("--obj_config", default="obj_info_nocs.yml")
    ap.add_argument("--category", default="1")
    ap.add_argument("--trajs", type=int, default=8)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--norm", default="gn", choices=["bn", "gn"])
    ap.add_argument("--conf_weighted_delta", action="store_true")
    ap.add_argument("--scale_clamp", type=float, default=0.0)
    ap.add_argument("--refine_iters", type=int, default=1)
    ap.add_argument("--refine_mode", default="debias",
                    choices=["forward", "debias"])
    ap.add_argument("--rot_fit", default="delta",
                    choices=["delta", "npcs", "fused"])
    ap.add_argument("--rot_fit_alpha", type=float, default=0.5)
    ap.add_argument("--delta_gain", type=str, default="1.0",
                    help="amplify the regressed delta's rotation angle "
                         "(track_cfg/delta_gain); comma-separated values "
                         "sweep in one process")
    ap.add_argument("--fit_ransac", type=int, default=0,
                    help="RANSAC hypotheses for the tracking-time fits "
                         "(track_cfg/fit_ransac)")
    ap.add_argument("--fit_ransac_th", type=float, default=0.01)
    ap.add_argument("--motion_model", default="none",
                    choices=["none", "const_vel"])
    ap.add_argument("--motion_gain", type=float, default=0.8)
    ap.add_argument("--motion_beta", type=float, default=0.5)
    ap.add_argument("--quality_profile", default="reference",
                    choices=["reference", "best"],
                    help="category-aware preset (track_cfg/quality_profile);"
                         " explicitly-passed track flags still win")
    ap.add_argument("--sweep", default=None,
                    help="semicolon-separated rot_fit:refine_iters"
                         "[:refine_mode] specs evaluated in one process "
                         "(e.g. 'delta:1;npcs:1;npcs:3:forward'); "
                         "overrides --rot_fit/--refine_*")
    ap.add_argument("--eval_seed_base", type=int, default=1000,
                    help="trajectory seed base for the eval set; vary to "
                         "measure stack-ranking noise across eval draws")
    ap.add_argument("--init_noise", action="store_true",
                    help="perturb the frame-0 pose (reference protocol "
                         "init_frame/gt=False) instead of GT init")
    return ap


def config_overrides(args: argparse.Namespace,
                     ap: argparse.ArgumentParser) -> dict:
    """`get_config` overrides of a command line: the object, the GT init,
    dtype and norm, and each track flag that differs from its default."""
    overrides = {
        "obj_config": args.obj_config, "obj_category": args.category,
        "init_frame/gt": not args.init_noise,
        "network/compute_dtype": args.dtype, "network/norm": args.norm,
    }
    for k in TRACK_KEYS:
        if getattr(args, k) != ap.get_default(k):
            overrides[f"track_cfg/{k}"] = getattr(args, k)
    return overrides


def variants(args: argparse.Namespace) -> list[tuple[str, dict]]:
    """(tag, TrackCfg fields) of each tracked variant: one a `--delta_gain`
    value (untagged when there is one), or one a `--sweep` spec."""
    gains = [float(g) for g in args.delta_gain.split(",")]
    out = [(f"gain={g}" if len(gains) > 1 else "", {"delta_gain": g})
           for g in gains]
    if args.sweep:
        out = []
        for spec in args.sweep.split(";"):
            parts = spec.split(":")
            rep = {"rot_fit": parts[0],
                   "refine_iters": int(parts[1]) if len(parts) > 1 else 1}
            if len(parts) > 2:
                rep["refine_mode"] = parts[2]
            out.append((spec, rep))
    return out


def main(argv=None, device=None) -> dict:
    device = resolve_device(device)
    ap = parser()
    args = ap.parse_args(argv)
    cfg = get_config("config_track.yml",
                     overrides=config_overrides(args, ap))
    coord, rotn = quality.load_nets(cfg, args.coord, args.rot, device)

    T, B = args.frames, args.trajs
    data = quality.eval_set(cfg.obj, B, T, cfg.num_points,
                            seed_base=args.eval_seed_base)
    gt = data["pose"].to(device)
    init_pose = quality.gt_init(gt, cfg)
    fr = quality.frozen_init(gt, cfg.obj.sym)

    report = {"variants": {}, "frozen_init": fr}
    for tag0, rep in variants(args):
        cfg_g = dataclasses.replace(
            cfg, track=dataclasses.replace(cfg.track, **rep))
        t0 = time.time()
        f1, full = quality.track_means(cfg_g, coord, rotn, init_pose,
                                       data["points"], gt, device)
        tag = f"[{tag0}] " if tag0 else ""
        print(f"{tag}({time.time() - t0:.0f}s incl. compile)")
        print(quality.row("frame-1", f1, tag0))
        print(quality.row("full-scan", full, tag0))
        report["variants"][tag0] = {"frame1": f1, "full": full}
    print(quality.row("frozen-init", fr))
    return report


if __name__ == "__main__":
    main()
