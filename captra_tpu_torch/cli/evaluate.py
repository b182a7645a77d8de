"""Offline evaluation entry point (counterpart of
`captra_tpu/cli/evaluate.py`).

    python -m captra_tpu_torch.cli.evaluate --experiment_dir=<rot exp> \\
        [--no_iou] [flags]

Scores every result pickle under <experiment_dir>/results/data and writes
err.pkl and err.csv beside it (`eval/evaluator.py`).  `main(argv,
device="cpu")` runs on the CPU; without it the card is required.
"""
from __future__ import annotations

import argparse
from os.path import join as pjoin

from captra_tpu_torch.cli.args import add_args, config_overrides
from captra_tpu_torch.config import get_config
from captra_tpu_torch.device import resolve_device
from captra_tpu_torch.eval.evaluator import evaluate_results_dir


def main(argv=None, device=None):
    device = resolve_device(device)
    parser = add_args(argparse.ArgumentParser("captra-tpu-torch eval"))
    parser.add_argument("--no_iou", action="store_true", default=False)
    args = parser.parse_args(argv)
    cfg = get_config(args.config, config_overrides(args), args.config_dir)
    results_dir = pjoin(cfg.experiment_dir, "results")
    return evaluate_results_dir(results_dir, cfg.obj,
                                eval_iou=not args.no_iou, device=device)


if __name__ == "__main__":
    main()
