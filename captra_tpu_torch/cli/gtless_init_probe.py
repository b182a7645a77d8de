"""The GT-less frame-0 init's operating envelope (counterpart of
`scripts/gtless_init_probe.py`).

    python -m captra_tpu_torch.cli.gtless_init_probe --coord ... --rot ... \\
        [--category 1] [--thetas 0,10,20,30,45,60,90] \\
        [--init_search 64 [--init_search_scorer mode|basin]] [--out r.json]

`tracking/tracker.init_pose_from_cloud` (the cloud's mean, the covering
radius's scale, the identity rotation) is the init of captures without
annotations.  This probe re-poses synthetic scans with known GT so that
frame 0's root rotation lies exactly theta degrees from identity
(`eval/quality.repose_to_theta`, one axis a trajectory from
`RandomState(7)`, drawn in the script's order), tracks each from the
cloud-only init (with `--init_search K`, after the frame-0 orientation
search) and prints, per row, the frame-1 and full-scan means: the GT-init
row on the unmodified scan, the cloud-init row on it (its orientation is
whatever the draw made), then one row a theta.  With `--out` the rows go
into a JSON report.  Flags, defaults and lines are the JAX script's; the
basin scorer needs a CoordNet checkpoint written by
`captra_tpu_torch.cli.train_basin_head` (or the JAX script).
`main(argv, device="cpu")` runs on the CPU; without it the card is
required.  Returns the report.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from captra_tpu_torch.config import get_config
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.eval import quality
from captra_tpu_torch.tracking.tracker import (
    init_pose_from_cloud, search_init_orientation,
)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser("captra-tpu-torch gtless_init_probe")
    ap.add_argument("--coord", required=True)
    ap.add_argument("--rot", required=True)
    ap.add_argument("--obj_config", default="obj_info_nocs.yml")
    ap.add_argument("--category", default="1")
    ap.add_argument("--trajs", type=int, default=8)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--norm", default="gn", choices=["bn", "gn"])
    ap.add_argument("--thetas", default="0,10,20,30,45,60,90")
    ap.add_argument("--init_search", type=int, default=0,
                    help="K>0 runs the frame-0 orientation search "
                         "(track_cfg/init_search) on the cloud init rows")
    ap.add_argument("--init_search_steps", type=int, default=2)
    ap.add_argument("--init_search_tau", type=float, default=10.0,
                    help="mode-clustering radius in degrees (<=0 = the "
                         "pure-residual selection)")
    ap.add_argument("--init_search_scorer", default="mode",
                    choices=["mode", "basin"],
                    help="basin = the supervised basin-confidence head "
                         "(--coord must be a checkpoint fine-tuned by "
                         "train_basin_head)")
    ap.add_argument("--quality_profile", default="reference",
                    choices=["reference", "best"])
    ap.add_argument("--out", default=None, help="optional JSON report path")
    return ap.parse_args(argv)


def config(args: argparse.Namespace):
    return get_config("config_track.yml", overrides={
        "obj_config": args.obj_config, "obj_category": args.category,
        "init_frame/gt": True, "network/compute_dtype": args.dtype,
        "network/norm": args.norm,
        "track_cfg/init_search": args.init_search,
        "track_cfg/init_search_steps": args.init_search_steps,
        "track_cfg/init_search_tau": args.init_search_tau,
        "track_cfg/init_search_scorer": args.init_search_scorer,
        "network/basin_head": args.init_search_scorer == "basin",
        "track_cfg/quality_profile": args.quality_profile})


def main(argv=None, device=None) -> dict:
    device = resolve_device(device)
    args = parse(argv)
    cfg = config(args)
    coord, rotn = quality.load_nets(cfg, args.coord, args.rot, device)

    T, B = args.frames, args.trajs
    base = quality.eval_set(cfg.obj, B, T, cfg.num_points)
    rng = np.random.RandomState(quality.REPOSE_SEED)

    report = {"args": vars(args), "rows": []}

    def eval_run(tag, init_pose, data):
        gt = data["pose"].to(device)
        t0 = time.time()
        f1, full = quality.track_means(cfg, coord, rotn, init_pose,
                                       data["points"], gt, device)
        f1, full = quality.rounded(f1), quality.rounded(full)
        print(f"[{tag}] ({time.time() - t0:.0f}s) frame-1 {f1}")
        print(f"[{tag}]        full-scan {full}", flush=True)
        report["rows"].append({"tag": tag, "frame1": f1, "full": full})

    # reference row: GT init on the unmodified scan
    eval_run("gt-init", quality.gt_init(base["pose"].to(device), cfg), base)

    def cloud_init(data):
        points0 = torch.as_tensor(data["points"][0])
        ip = init_pose_from_cloud(points0, cfg.obj.num_parts,
                                  cfg.data_radius, device=device)
        if args.init_search > 0:
            ip = search_init_orientation(coord, points0, ip, cfg,
                                         device=device)
        return ip

    # cloud init on the unmodified scan (theta: whatever the draw made)
    eval_run("cloud-init/raw-draw", cloud_init(base), base)

    for theta in [float(x) for x in args.thetas.split(",")]:
        data = quality.repose_to_theta(base, theta, rng)
        eval_run(f"cloud-init/theta={theta:g}", cloud_init(data), data)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.out)
    return report


if __name__ == "__main__":
    main()
