#!/usr/bin/env python3
"""Readings that the limits of a cell's comparison are set from, on the card
at the cell's own size, in one process:

    python3 port_bench/calibrate.py --workload <cell> --seeds 12
        --control-seeds 3 [--faults half,altered --fault-seeds 3]
        [--seconds 3] [--control-seconds 8] [--first-seed N]

Each sound run is the cell's run (a short window, as many answers compared
as a run compares) with its own seed; each control run puts the plain
reference, its products in TF32, in the program's place; each fault run
plants one of `controls`' faults (see there).  Prints a JSON line a run
and, last, each number's lower reading (the largest over the sound runs)
and upper reading (the smallest over the control runs) and each fault's
smallest reading.  The benchmark's runs never call this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = os.path.dirname(HERE)

from port_bench.harness import (  # noqa: E402
    Clock, Context, driver, find_cell, load_spec,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seconds", type=float, default=8.0)
    ap.add_argument("--first-seed", type=int, default=3 * 2 ** 31 + 1)
    args = ap.parse_args(argv)
    import torch

    from port_bench.controls import STEPS, TRAIN_PROGRAMS
    cell = find_cell(load_spec(), args.workload)
    name = cell.traffic["driver"]
    drv = driver(name)
    stand_ins, key = ((TRAIN_PROGRAMS, "make_program") if name == "train"
                      else (STEPS, "make_step"))
    dev = torch.device("cuda", 0)
    faults = [f for f in args.faults.split(",") if f]
    readings = {"sound": [], "control": [], **{f: [] for f in faults}}
    plan = ([("sound", args.first_seed + i, args.seconds)
             for i in range(args.seeds)]
            + [("control", args.first_seed + 1000 + i, args.control_seconds)
               for i in range(args.control_seeds)]
            + [(f, args.first_seed + 2000 + 100 * j + i, args.seconds)
               for j, f in enumerate(faults) for i in range(args.fault_seeds)])
    for kind, seed, seconds in plan:
        ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                      device=dev, clock=Clock(),
                      log=lambda m: print(m, file=sys.stderr, flush=True))
        kw = {} if kind == "sound" else {key: stand_ins[kind]}
        out = drv.run(ctx, **kw)
        readings[kind].append(out.checks)
        print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                          "steps": out.run.steps,
                          "failed": out.failed, "gaps": out.checks,
                          "values": out.values}), flush=True)
        torch.cuda.empty_cache()
    names = list(readings["sound"][0]) if readings["sound"] else []
    summary = {n: {"lower": max(r[n] for r in readings["sound"]),
                   **{k: min(r[n] for r in readings[k])
                      for k in readings if k != "sound" and readings[k]}}
               for n in names}
    print(json.dumps({"cell": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
