#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout.  The cell's weights and traffic are made on the
card from the seed, the cell's shapes are warmed up (set-up), the system is
measured for --seconds, then what the window produced is held to the plain
reference.  The last line of standard output is one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device and, last, the numbers compared
with their limits, which also end standard error.  With no CUDA card, too
few cards, or JAX loaded once the window has closed, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# run as a script: the checkout's root, not this directory, on the path
HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = os.path.dirname(HERE)

from port_bench.harness import (  # noqa: E402
    Clock, Context, driver, find_cell, forbidden_modules, load_spec, result,
)

CLOCK = Clock()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_spec()
    cell = find_cell(spec, args.workload)
    import torch
    log(f"torch imported at {CLOCK.since_start():.3f} s")
    # the step's host work is one Python thread; no CPU op pool competes
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=torch.device("cuda", 0),
                  clock=CLOCK, log=log)
    outcome = driver(cell.traffic["driver"]).run(ctx)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or of the JAX package are loaded: {bad}")
        return 4
    log(f"card: {card_line()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    line, checks = result(cell, outcome, ctx.trace)
    for c in checks:
        log(c)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
