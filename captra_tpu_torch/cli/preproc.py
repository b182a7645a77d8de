"""Offline NOCS preprocessing entry point (counterpart of
`captra_tpu/cli/preproc.py`): a raw NOCS release in, the `render/` tree
that `data/nocs.py` reads out (pose recovery -> instance lists -> model
corners -> per-instance gathering -> the render/test link).  It runs on
the host and uses no device:

    python -m captra_tpu_torch.cli.preproc --data_path data/nocs_data \
        [--data_type all|test_only|train|val|real_train|real_test] \
        [--categories 1,2,...] [--num_proc 8] [--stages poses,lists,...]
"""
from __future__ import annotations

import argparse

from captra_tpu_torch.data.preproc_pipeline import ALL_TYPES, run_pipeline

_STAGES = ("poses", "lists", "corners", "gather")


def main(argv=None):
    ap = argparse.ArgumentParser("captra-tpu-torch preproc")
    ap.add_argument("--data_path", required=True,
                    help="raw NOCS release root (contains nocs_full/, "
                         "obj_models/)")
    ap.add_argument("--data_type", default="all",
                    help="'all', 'test_only' (real_test), or a comma list "
                         "of train,val,real_train,real_test")
    ap.add_argument("--categories", default="1,2,3,4,5,6")
    ap.add_argument("--num_proc", type=int, default=1)
    ap.add_argument("--img_per_folder", type=int, default=100)
    ap.add_argument("--stages", default=",".join(_STAGES),
                    help="comma subset of poses,lists,corners,gather "
                         "(each stage can be rerun alone)")
    args = ap.parse_args(argv)

    if args.data_type == "all":
        data_types = ALL_TYPES
    elif args.data_type == "test_only":
        data_types = ("real_test",)
    else:
        data_types = tuple(s for s in args.data_type.split(",") if s)
    bad = set(data_types) - set(ALL_TYPES)
    if bad:
        raise SystemExit(f"unknown data types {sorted(bad)}")
    stages = tuple(s for s in args.stages.split(",") if s)
    bad = set(stages) - set(_STAGES)
    if bad:
        raise SystemExit(f"unknown stages {sorted(bad)}")
    categories = [int(c) for c in args.categories.split(",") if c]

    run_pipeline(args.data_path, data_types=data_types,
                 categories=categories, num_proc=args.num_proc,
                 img_per_folder=args.img_per_folder, stages=stages)


if __name__ == "__main__":
    main()
