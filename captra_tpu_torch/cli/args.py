"""Shared CLI flags with slash-path config overrides (the port's own copy
of `captra_tpu/cli/args.py`: the same parser and the same overrides).

Any flag whose name contains '/' overrides the matching nested config key
(`captra_tpu_torch.config.loader.overwrite_config`).  Flags of paths the
port has not ported yet (training, multi-device, orbax) are parsed as the
JAX package parses them; the entry points that meet them raise.
"""
from __future__ import annotations

import argparse


def boolean_string(s: str) -> bool:
    if s.lower() not in ("true", "false"):
        raise ValueError(f"{s!r} is not a valid boolean string")
    return s.lower() == "true"


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    a = parser.add_argument
    a("--config", type=str, default="config_track.yml")
    a("--config_dir", type=str, default=None,
      help="directory holding all_config/obj_config/pointnet_config "
           "(defaults to the bundled configs)")
    a("--obj_config", type=str, default=None)
    a("--obj_category", type=str, default=None)
    a("--basepath", type=str, default=None,
      help="dataset root (overrides the object YAML's basepath)")
    a("--experiment_dir", type=str, default=None)
    a("--resume_epoch", type=int, default=-1)

    a("--coord_exp/dir", type=str, default=None)
    a("--coord_exp/resume_epoch", type=int, default=None)

    a("--batch_size", type=int, default=None)
    a("--total_epoch", type=int, default=None)
    a("--optimizer", type=str, default=None)
    a("--weight_decay", type=float, default=None)
    a("--learning_rate", type=float, default=None)
    a("--lr_policy", type=str, default=None)
    a("--lr_gamma", type=float, default=None)
    a("--lr_step_size", type=int, default=None)
    a("--lr_clip", type=float, default=None)

    a("--num_points", type=int, default=None)
    a("--data_radius", type=float, default=None)
    a("--dataset_length", type=int, default=None)
    a("--freq/save", type=int, default=None)
    a("--pointnet_cfg/camera", type=str, default=None)

    a("--network/type", type=str, default=None)
    a("--network/nocs_head_dims", type=int, default=None)
    a("--network/backbone_out_dim", type=int, default=None)
    a("--network/pwm_num", type=int, default=None)

    a("--save", action="store_true", default=False)
    a("--no_eval", action="store_true", default=False)
    a("--mode_name", type=str, default=None,
      help="dataset split for tracking (real_test / test / test_seq / "
           "bmvc_<track>; reference parse_args.py --mode_name)")
    a("--use_val", type=str, default=None,
      help="additional split evaluated each epoch during training "
           "(reference train.py:52-80)")
    a("--init_frame/gt", type=boolean_string, default=None)

    for key in ("rloss", "tloss", "sloss", "corner_loss", "nocs_loss",
                "nocs_dist_loss", "nocs_pwm_loss", "seg_loss"):
        a(f"--loss_weight/{key}", type=float, default=None)
    for key in ("r", "s", "t", "point"):
        a(f"--pose_loss_type/{key}", type=str, default=None)
    a("--pose_perturb/type", type=str, default=None)
    a("--pose_perturb/r", type=float, default=None)
    a("--pose_perturb/s", type=float, default=None)
    a("--pose_perturb/t", type=float, default=None)

    a("--nocs_otf", type=boolean_string, default=None)
    a("--track_cfg/quality_profile", "--quality_profile", type=str,
      default=None, choices=[None, "reference", "best"],
      help="one-flag tracking preset: 'best' resolves the measured best "
           "per-category stack (rot_fit/refine, EVIDENCE.md sweeps) from "
           "the object config; explicit --track_cfg/* flags still win")
    a("--track_cfg/gt_label", type=boolean_string, default=None)
    a("--track_cfg/nocs2d_label", type=boolean_string, default=None)
    a("--track_cfg/nocs2d_path", type=str, default=None)
    a("--track_cfg/otf_fps_mode", type=str, default=None,
      choices=[None, "exact", "grouped"])
    a("--track_cfg/otf_work_factor", type=int, default=None)
    a("--track_cfg/scale_clamp", type=float, default=None)
    a("--track_cfg/conf_weighted_delta", type=boolean_string, default=None)
    a("--track_cfg/refine_iters", type=int, default=None,
      help="extra per-frame refinement passes (>1 is a deviation; "
           "mode set by --track_cfg/refine_mode)")
    a("--track_cfg/refine_mode", type=str, default=None,
      choices=[None, "forward", "debias"])
    a("--track_cfg/rot_fit", type=str, default=None,
      choices=[None, "delta", "npcs", "fused"],
      help="tracked-rotation source: regressed delta (reference behavior), "
           "absolute Procrustes from predicted NPCS, or their geodesic "
           "blend (deviation when not 'delta')")
    a("--track_cfg/rot_fit_alpha", type=float, default=None,
      help="fused-mode blend weight toward the NPCS solve (0..1)")
    a("--track_cfg/delta_gain", type=float, default=None,
      help="scale the regressed delta's rotation angle before composition "
           "(deviation when != 1; counteracts the measured under-correction "
           "equilibrium, see EVIDENCE.md)")
    a("--track_cfg/fit_ransac", type=int, default=None,
      help="RANSAC hypotheses for the tracking-time pose fits (deviation "
           "when > 0; outlier rejection for real sensor data)")
    a("--track_cfg/fit_ransac_th", type=float, default=None,
      help="RANSAC inlier threshold in camera meters")
    a("--track_cfg/init_search", type=int, default=None,
      help="K>0 runs the frame-0 orientation search for GT-less init: K "
           "candidate orientations scored by CoordNet NPCS "
           "self-consistency in one batched forward (deviation; extends "
           "the ~30 deg identity-init envelope, EVIDENCE.md round 5)")
    a("--track_cfg/init_search_steps", type=int, default=None,
      help="descend-and-score passes per init-search candidate")

    a("--ckpt_format", type=str, default="pickle",
      choices=["pickle", "orbax"],
      help="checkpoint backend: single-file pickle (default) or an orbax "
           "directory (multi-host-ready); resume auto-detects either")
    a("--num_devices", type=int, default=None,
      help="restrict the data-parallel mesh to this many devices")
    a("--synthetic_data", action="store_true", default=False,
      help="run on generated synthetic data instead of a dataset on disk")
    a("--device_aug", action="store_true", default=False,
      help="with --synthetic_data: draw a fresh random pose per step over "
           "an HBM-resident geometry pool (device-side augmentation; "
           "unbounded pose diversity at zero host cost)")
    a("--geom_pool", type=int, default=512,
      help="geometry pool size for --device_aug")
    return parser


def config_overrides(args: argparse.Namespace) -> dict:
    """Namespace -> {slash_path: value} (only explicitly set flags)."""
    skip = {"config", "config_dir", "resume_epoch", "save", "no_eval",
            "num_devices", "synthetic_data", "mode_name", "device_aug",
            "geom_pool", "use_val", "ckpt_format"}
    out = {}
    for key, value in vars(args).items():
        # None = not passed.  False is NOT skipped: every boolean flag here
        # is a boolean_string with default=None, so False means the user
        # explicitly passed "false" (e.g. to turn OFF a YAML-enabled
        # track_cfg deviation); the action="store_true" flags (save,
        # no_eval, ...) are all in `skip`.
        if key in skip or value is None:
            continue
        out[key] = value
    return out
