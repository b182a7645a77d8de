"""Visualisation entry point (counterpart of `captra_tpu/cli/visualize.py`).
Two modes:

  * with --img_path (NOCS real): each tracked instance's posed predicted
    box projected onto the scene's RGB / depth frames
    (`eval.visualize.visualize_scene_images`; no OpenCV);
  * without: 3D box plots of each saved trajectory
    (`eval.visualize.visualize_results_dir`; needs matplotlib).

    python -m captra_tpu_torch.cli.visualize --results_dir runs/exp/results \\
        [--img_path <nocs_full/real_test>] [--scene scene_1] [--depth] \\
        [--draw_gt] [--output_path <dir>] [--max_frames 10]

`--experiment_dir` may be given instead of --results_dir (its `results/`,
where `cli.track --save` writes).  It runs on the host alone.
"""
from __future__ import annotations

import argparse
import os
from os.path import join as pjoin


def discover_scenes(results_dir: str) -> list[str]:
    """Scene ids from saved pickle names (`<instance>_..._<scene>_<track>.pkl`
    with '_'-separated tokens; NOCS real scenes are 'scene_N')."""
    data_dir = pjoin(results_dir, "data")
    scenes = set()
    if not os.path.isdir(data_dir):
        return []
    for name in os.listdir(data_dir):
        if not name.endswith(".pkl"):
            continue
        toks = name[:-4].split("_")
        for i, t in enumerate(toks[:-1]):
            if t == "scene" and toks[i + 1].isdigit():
                scenes.add(f"scene_{toks[i + 1]}")
    return sorted(scenes)


def main(argv=None):
    ap = argparse.ArgumentParser("captra-tpu-torch visualize")
    ap.add_argument("--results_dir", type=str, default=None,
                    help="directory holding data/*.pkl tracking artifacts")
    ap.add_argument("--experiment_dir", type=str, default=None,
                    help="experiment dir; uses <experiment_dir>/results")
    ap.add_argument("--img_path", type=str, default=None,
                    help="NOCS real image root (e.g. nocs_full/real_test); "
                         "enables the RGB/depth overlay mode")
    ap.add_argument("--scene", type=str, default=None,
                    help="scene id (default: every scene found in the "
                         "saved results)")
    ap.add_argument("--output_path", type=str, default=None)
    ap.add_argument("--depth", action="store_true", default=False,
                    help="overlay on depth images instead of color")
    ap.add_argument("--draw_gt", action="store_true", default=False)
    ap.add_argument("--max_frames", type=int, default=10,
                    help="3D-plot mode: frames per trajectory to render")
    args = ap.parse_args(argv)

    results_dir = args.results_dir or (
        pjoin(args.experiment_dir, "results") if args.experiment_dir
        else None)
    if not results_dir or not os.path.isdir(results_dir):
        raise SystemExit(f"no results directory: {results_dir!r} "
                         "(run cli.track with --save first)")

    if args.img_path:
        from captra_tpu_torch.eval.visualize import visualize_scene_images
        scenes = [args.scene] if args.scene else discover_scenes(results_dir)
        if not scenes:
            raise SystemExit("no scenes found in saved results; pass --scene")
        total = []
        for scene in scenes:
            out = (pjoin(args.output_path, scene) if args.output_path
                   else None)
            written = visualize_scene_images(
                results_dir, args.img_path, scene, out_dir=out,
                depth=args.depth, draw_gt=args.draw_gt)
            print(f"{scene}: {len(written)} frames")
            total += written
        print(f"wrote {len(total)} images")
    else:
        from captra_tpu_torch.eval.visualize import visualize_results_dir
        written = visualize_results_dir(results_dir,
                                        out_dir=args.output_path,
                                        max_frames=args.max_frames)
        print(f"wrote {len(written)} images")
    return 0


if __name__ == "__main__":
    main()
