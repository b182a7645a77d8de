#!/usr/bin/env python3
"""The port's accuracy record on one NVIDIA card: the quality harness's
four CLIs at full width on the NOCS bottle, then the OTF path with the
trained nets.

    python3 quality_record.py [--out runs/quality_record] [--steps 3000] \\
        [--eval_at 1000,2000,3000] [--basin_steps 1500] [--init_search 64] \\
        [--norm bn --dtype float32] [--flagship_only]

1. `cli.flagship_demo --steps S --device_aug --eval_at E` (every other
   flag at the script's default: batch 12, 8 tracked trajectories, a
   512-geometry pool, the configs' grad_clip and perturbations).
2. `cli.eval_checkpoint_track` on those nets, with `--sweep
   'delta:1;npcs:1;npcs:3:forward'` and with `--quality_profile best`.
   `--flagship_only` stops here.
3. `cli.train_basin_head --steps B` on the CoordNet.
4. `cli.gtless_init_probe --init_search K` with the mode scorer (the
   trained CoordNet) and the basin scorer (step 3's).
5. The OTF path (`chip_smoke.phase_otf`, a 480x640 depth video of
   OTF_FRAMES frames; its config's float32 BN nets) at B=1 and B=8 with
   the trained nets: its gates (launches, poses against the plain FPS),
   ms a step, and on every tracked frame's crop the picks before the
   first forced 0 and the crop kernel's ms a frame.

Each CLI's printed lines go to the standard output; `<out>` gets
RECORD.json (every CLI's returned report, the seconds of each step, the
card's name and power limit), EVIDENCE.json, REPORT.json, the probe
reports, and the three nets as checkpoints without optimizer state
(`canon_coord.ckpt`, `rot.ckpt`, `basin.ckpt`).  Every CLI gets the
same `--dtype` and `--norm`.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OTF_FRAMES = 20
OTF_RUNS = (("b1", 1, "exact", False, {}), ("b8", 8, "exact", False, {}))


def stripped(src: str, dst: str) -> None:
    """Copy a checkpoint's parameters and statistics (no optimizer
    state) to `dst`."""
    from captra_tpu_torch.training import checkpoint as ckpt
    payload = ckpt.load_checkpoint(src)
    path = ckpt.save_checkpoint(os.path.dirname(dst) or ".", 0, payload)
    os.replace(path, dst)


def trained_nets(coord_path: str, rot_path: str):
    """chip_smoke's `seeded_nets` with the trained checkpoints: `nets(cfg)`
    -> (CoordNet, RotNet) of cfg holding them."""
    from captra_tpu_torch.training import checkpoint as ckpt
    from captra_tpu_torch.training.convert import (
        coordnet_from_flax, rotnet_from_flax,
    )
    cv, rv = ckpt.load_track_variables(coord_path, rot_path)

    def seeded_nets(config, dev):
        made = {}

        def nets(cfg):
            key = (cfg.network, cfg.pointnet, cfg.obj)
            if key not in made:
                made[key] = (coordnet_from_flax(cfg, cv, device=dev),
                             rotnet_from_flax(cfg, rv, device=dev))
            return made[key]
        return nets
    return seeded_nets


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "runs",
                                                  "quality_record"))
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--eval_at", default="1000,2000,3000")
    ap.add_argument("--basin_steps", type=int, default=1500)
    ap.add_argument("--init_search", type=int, default=64)
    ap.add_argument("--otf_frames", type=int, default=OTF_FRAMES)
    ap.add_argument("--norm", default="bn", choices=["bn", "gn"])
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--flagship_only", action="store_true",
                    help="train and track, then evaluate the checkpoints; "
                         "skip the basin head, the probe and the OTF runs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("quality_record: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from captra_tpu_torch.cli import (
        eval_checkpoint_track, flagship_demo, gtless_init_probe,
        train_basin_head,
    )
    from captra_tpu_torch.eval.quality import device_label

    dev = torch.device("cuda")
    common = ["--dtype", args.dtype, "--norm", args.norm]
    os.makedirs(args.out, exist_ok=True)
    record = {"device": device_label(dev), "torch": torch.__version__,
              "cuda": torch.version.cuda, "args": vars(args), "seconds": {}}
    print(f"card: {record['device']}", flush=True)

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        record["seconds"][name] = time.perf_counter() - t0
        print(f"== {name}: {record['seconds'][name]:.1f} s", flush=True)
        return out

    with tempfile.TemporaryDirectory(prefix="captra_quality_") as work:
        fd_out = os.path.join(work, "flagship")
        record["flagship"] = timed(
            "flagship", flagship_demo.main,
            ["--steps", str(args.steps), "--device_aug", "--eval_at",
             args.eval_at, "--out", fd_out, *common], device=dev)
        shutil.copy(os.path.join(fd_out, "EVIDENCE.json"), args.out)
        coord = os.path.join(fd_out, "canon_coord", "ckpt", "model_0000")
        rot = os.path.join(fd_out, "rot", "ckpt", "model_0000")
        stripped(coord, os.path.join(args.out, "canon_coord.ckpt"))
        stripped(rot, os.path.join(args.out, "rot.ckpt"))
        nets = ["--coord", coord, "--rot", rot, *common]
        record["eval_sweep"] = timed(
            "eval_sweep", eval_checkpoint_track.main,
            [*nets, "--sweep", "delta:1;npcs:1;npcs:3:forward"], device=dev)
        record["eval_best"] = timed(
            "eval_best", eval_checkpoint_track.main,
            [*nets, "--quality_profile", "best"], device=dev)
        if args.flagship_only:
            return _write(record, args.out)

        basin_out = os.path.join(work, "basin")
        record["basin"] = timed(
            "basin", train_basin_head.main,
            ["--coord", coord, "--out", basin_out, "--steps",
             str(args.basin_steps), *common], device=dev)
        shutil.copy(os.path.join(basin_out, "REPORT.json"), args.out)
        basin = record["basin"]["checkpoint"]
        stripped(basin, os.path.join(args.out, "basin.ckpt"))

        for scorer, coord_path in (("mode", coord), ("basin", basin)):
            report = os.path.join(args.out, f"PROBE_{scorer}.json")
            record[f"probe_{scorer}"] = timed(
                f"probe_{scorer}", gtless_init_probe.main,
                ["--coord", coord_path, "--rot", rot, *common,
                 "--init_search", str(args.init_search),
                 "--init_search_scorer", scorer, "--out", report],
                device=dev)

        chip_smoke.seeded_nets = trained_nets(coord, rot)
        kernels = {name: [] for name in chip_smoke.REPLACES}
        otf = timed("otf", chip_smoke.phase_otf, runs=OTF_RUNS,
                    frames=args.otf_frames, kernels=kernels)
        chip_smoke.check_otf_launches(otf, args.otf_frames)
        record["otf"] = otf
        record["otf_kernels"] = {k: v for k, v in kernels.items() if v}

    return _write(record, args.out)


def _write(record: dict, out: str) -> int:
    with open(os.path.join(out, "RECORD.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(f"wrote {os.path.join(out, 'RECORD.json')}; card: "
          f"{record['device']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
