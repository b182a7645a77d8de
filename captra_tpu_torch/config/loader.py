"""3-level YAML config loader with slash-path overrides (the port's own
copy of `captra_tpu/config/loader.py`).

An experiment YAML names an object YAML and pointnet YAML(s); overrides like
`pose_perturb/r=3.0` set nested keys; derived fields (num_parts, tree, sym,
...) are filled from the object entry.  The result is folded into the typed
`Config`.

`yaml` is imported inside `_load_yaml`: PyYAML is optional for the port, and
a `Config` built in code (as `chip_smoke.py` does) needs none.
"""
from __future__ import annotations

import dataclasses
import os
from os.path import join as pjoin
from typing import Any, Mapping

from captra_tpu_torch.config.schema import (
    Config, NetworkCfg, ObjCfg, OptimCfg, PerturbCfg, PointNetCfg, SAMsgCfg,
    TrackCfg, frozen_map, tuplify,
)

DEFAULTS_DIR = pjoin(os.path.dirname(__file__), "defaults")


def _choice(value, allowed: tuple, name: str) -> str:
    """Validate an enum-like config knob at load time — an unknown value
    would otherwise silently select no-op behavior downstream (e.g. PointMLP
    applies NO normalization for an unrecognized norm string)."""
    v = str(value)
    if v not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {v!r}")
    return v


def overwrite_config(cfg: dict, key_path: list[str], value) -> None:
    """Set a nested key addressed by a '/'-split path (reference
    overwrite_config, config.py:8-18)."""
    cur = key_path[0]
    if len(key_path) == 1:
        cfg[cur] = value
    else:
        cfg.setdefault(cur, {})
        overwrite_config(cfg[cur], key_path[1:], value)


def _load_yaml(path: str) -> dict:
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def _resolve(name: str, subdir: str, base_dir: str | None) -> str:
    """Find a config file: absolute, relative to base_dir, or bundled."""
    if os.path.isabs(name) and os.path.exists(name):
        return name
    if base_dir:
        cand = pjoin(base_dir, subdir, name)
        if os.path.exists(cand):
            return cand
        cand = pjoin(base_dir, name)
        if os.path.exists(cand):
            return cand
    return pjoin(DEFAULTS_DIR, subdir, name)


def load_obj_config(obj_yaml: str, category: str,
                    base_dir: str | None = None) -> ObjCfg:
    raw = _load_yaml(_resolve(obj_yaml, "obj_config", base_dir))
    entry = raw[category]
    return ObjCfg(
        category=str(category),
        name=entry.get("name", str(category)),
        num_parts=int(entry["num_parts"]),
        num_joints=int(entry["num_joints"]),
        tree=tuplify(entry["tree"]),
        sym=bool(entry.get("sym", False)),
        joint_type=entry.get("type", "revolute"),
        main_axis=tuplify(entry.get("main_axis", []) or []),
        extra_dims=int(raw.get("extra_dims", 0)),
        num_frames=int(raw.get("num_frames", 100)),
        synthetic=bool(raw.get("synthetic", True)),
        nocs_data=bool(raw.get("nocs_data", False)),
        bad_ins=tuplify(entry.get("bad_ins", []) or []),
        test_list=tuplify(entry.get("test_list", []) or []),
        basepath=raw.get("basepath", ""),
    )


def _pointnet_from_yaml(raw: Mapping) -> PointNetCfg:
    def sa(entry):
        return SAMsgCfg(npoint=int(entry["npoint"]),
                        radius_list=tuplify(entry["radius_list"]),
                        nsample_list=tuplify(entry["nsample_list"]),
                        mlp_list=tuplify(entry["mlp_list"]))

    return PointNetCfg(
        sa1=sa(raw["sa1"]), sa2=sa(raw["sa2"]),
        sa3_mlp=tuplify(raw["sa3"]["mlp"]),
        fp3_mlp=tuplify(raw["fp3"]["mlp"]),
        fp2_mlp=tuplify(raw["fp2"]["mlp"]),
        fp1_mlp=tuplify(raw["fp1"]["mlp"]),
    )


# Multi-part categories where forward refinement measurably CONTRACTS
# drift (see _quality_profile).  Scissors: two large, similar-sized parts
# give well-conditioned per-part fits — refine x3 beat no-refine on all 4
# eval draws (full-scan rdiff 10.40/9.25/8.18/8.88 vs 10.70/10.94/10.23/
# 10.12, runs/q4_scissors_r5/SWEEP_scissors_{base,seed2000,seed3000,
# seed4000}.log) and on the r=15 CoordNet (6.80 vs 7.28,
# runs/q4_scissors_r15).
_REFINE_MULTIPART = ("scissors",)


def _quality_profile(obj: ObjCfg) -> dict:
    """track_cfg preset for `quality_profile: best` — the measured best
    per-category tracking stack (EVIDENCE.md round-3/4/5 sweep tables).
    The discriminator is fit conditioning, approximated by part count with
    a measured per-class carve-out (_REFINE_MULTIPART):

    - rigid (1 part; sym bottle/bowl/can AND non-sym camera/laptop/mug):
      absolute NPCS rotation fit + forward refinement; each pass re-solves
      the single root from a better canonicalization, so refinement
      CONTRACTS (sym full-scan rdiff 12.3 -> 4.4 with the r=15 CoordNet;
      non-sym rigid 16.8 -> 11.6, runs/q4_n3_r5).
    - scissors (2 similar-sized parts): refinement also contracts —
      consistent across 4 independent eval draws (see _REFINE_MULTIPART).
    - other articulated (laptop/glasses/drawers): the absolute fit alone;
      per-part re-canonicalization by a noisy per-part 3D solve compounds
      noise (laptop npcs 11.8 -> npcs+refine3 16.5; glasses 9.56 -> 10.66;
      drawers 8.74 -> 15.71 on the r=15 nets, runs/q4_*_r15).

    Training-side companion (not a tracking knob): train CoordNet with
    pose_perturb/r=15 (--coord_perturb_r) so the NPCS head stays accurate
    under drifted canonicalization.  Measured scope: helps sym rigid
    (12.3->4.4), laptop (11.8->7.3), glasses (10.61->9.56), scissors
    (10.40->6.80); REGRESSES non-sym rigid (runs/q4_n3_r15) and drawers
    (7.01->8.74, runs/q4_drawers_r15) — keep r=5 there.  See README
    "quality profile".
    """
    if obj.num_parts == 1 or obj.category in _REFINE_MULTIPART:
        return {"rot_fit": "npcs", "refine_iters": 3,
                "refine_mode": "forward"}
    return {"rot_fit": "npcs"}


def get_config(config: str = "config_track.yml",
               overrides: Mapping[str, Any] | None = None,
               base_dir: str | None = None) -> Config:
    """Load an experiment config by file name.

    overrides: flat mapping of slash paths to values, e.g.
      {"obj_category": "bottle", "pose_perturb/r": 3.0}.
    """
    raw = _load_yaml(_resolve(config, "all_config", base_dir))
    for key, value in (overrides or {}).items():
        if value is not None:
            overwrite_config(raw, key.split("/"), value)

    obj = load_obj_config(raw.get("obj_config", "obj_info_sapien.yml"),
                          str(raw.get("obj_category", "laptop")), base_dir)
    # experiment-level basepath override (dataset root without editing the
    # object YAML)
    if raw.get("basepath"):
        obj = dataclasses.replace(obj, basepath=str(raw["basepath"]))

    pn_name = raw.get("pointnet_cfg", {}).get("camera", "pointnet2_camera.yml")
    pointnet = _pointnet_from_yaml(
        _load_yaml(_resolve(pn_name, "pointnet_config", base_dir)))

    net_raw = raw.get("network", {})
    network = NetworkCfg(
        type=net_raw.get("type", "rot_coord_track"),
        backbone_out_dim=int(net_raw.get("backbone_out_dim", 128)),
        nocs_head_dims=tuplify(net_raw.get("nocs_head_dims", [128])),
        pwm_num=int(net_raw.get("pwm_num", 128)),
        compute_dtype=str(net_raw.get("compute_dtype", "float32")),
        fps_mode=_choice(net_raw.get("fps_mode", "exact"),
                         ("exact", "grouped"), "network/fps_mode"),
        norm=_choice(net_raw.get("norm", "bn"), ("bn", "gn"),
                     "network/norm"),
        basin_head=bool(net_raw.get("basin_head", False)),
    )

    pp = raw.get("pose_perturb", {})
    perturb = PerturbCfg(kind=pp.get("type", "normal"),
                         s=float(pp.get("s", 0.02)),
                         r=float(pp.get("r", 5.0)),
                         t=float(pp.get("t", 0.03)))

    tc = raw.get("track_cfg", {}) or {}
    profile = _choice(tc.get("quality_profile", "reference"),
                      ("reference", "best"), "track_cfg/quality_profile")
    if profile == "best":
        for k, v in _quality_profile(obj).items():
            tc.setdefault(k, v)  # explicit keys always win over the preset
    track = TrackCfg(
        quality_profile=profile,
        gt_label=bool(tc.get("gt_label", False)),
        nocs2d_label=bool(tc.get("nocs2d_label", False)),
        nocs2d_path=str(tc.get("nocs2d_path") or ""),
        init_frame_gt=bool((raw.get("init_frame", {}) or {}).get("gt", False)),
        nocs_otf=bool(raw.get("nocs_otf", False)),
        otf_work_factor=int(tc.get("otf_work_factor", 5)),
        otf_fps_mode=_choice(tc.get("otf_fps_mode", "exact"),
                             ("exact", "grouped"),
                             "track_cfg/otf_fps_mode"),
        scale_clamp=float(tc.get("scale_clamp", 0.0)),
        conf_weighted_delta=bool(tc.get("conf_weighted_delta", False)),
        refine_iters=int(tc.get("refine_iters", 1)),
        refine_mode=_choice(tc.get("refine_mode", "debias"),
                            ("forward", "debias"),
                            "track_cfg/refine_mode"),
        rot_fit=_choice(tc.get("rot_fit", "delta"),
                        ("delta", "npcs", "fused"), "track_cfg/rot_fit"),
        rot_fit_alpha=float(tc.get("rot_fit_alpha", 0.5)),
        delta_gain=float(tc.get("delta_gain", 1.0)),
        fit_ransac=int(tc.get("fit_ransac", 0)),
        fit_ransac_th=float(tc.get("fit_ransac_th", 0.01)),
        motion_model=_choice(tc.get("motion_model", "none"),
                             ("none", "const_vel"),
                             "track_cfg/motion_model"),
        motion_gain=float(tc.get("motion_gain", 0.8)),
        motion_beta=float(tc.get("motion_beta", 0.5)),
        init_search=int(tc.get("init_search", 0)),
        init_search_steps=int(tc.get("init_search_steps", 2)),
        init_search_tau=float(tc.get("init_search_tau", 10.0)),
        init_search_scorer=_choice(tc.get("init_search_scorer", "mode"),
                                   ("mode", "basin"),
                                   "track_cfg/init_search_scorer"),
    )

    optim = OptimCfg(
        optimizer=str(raw.get("optimizer", "Adam")).lower(),
        learning_rate=float(raw.get("learning_rate", 1e-3)),
        weight_decay=float(raw.get("weight_decay", 1e-4)),
        lr_policy=raw.get("lr_policy", "step"),
        lr_gamma=float(raw.get("lr_gamma", 0.5)),
        lr_step_size=int(raw.get("lr_step_size", 20)),
        lr_clip=float(raw.get("lr_clip", 1e-5)),
        grad_clip=float(raw.get("grad_clip", 0.0)),
        bn_momentum_original=float(raw.get("momentum_original", 0.1)),
        bn_momentum_decay=float(raw.get("momentum_decay", 0.5)),
        bn_momentum_step_size=int(raw.get("momentum_step_size", 20)),
        bn_momentum_min=float(raw.get("momentum_min", 0.01)),
        weight_init=raw.get("weight_init", "xavier"),
        batch_size=int(raw.get("batch_size", 12)),
        total_epoch=int(raw.get("total_epoch", 250)),
    )

    coord_exp = raw.get("coord_exp", {}) or {}
    return Config(
        obj=obj, network=network, pointnet=pointnet, perturb=perturb,
        track=track, optim=optim,
        num_points=int(raw.get("num_points", 4096)),
        data_radius=float(raw.get("data_radius", 0.6)),
        save_freq=int((raw.get("freq") or {}).get("save", 1)),
        experiment_dir=str(raw.get("experiment_dir", "runs/exp_tmp")),
        coord_exp_dir=str(coord_exp.get("dir") or ""),
        coord_resume_epoch=int(coord_exp.get("resume_epoch", -1) or -1),
        dataset_length=raw.get("dataset_length"),
        batch_size=int(raw.get("batch_size", 12)),
        loss_weight=frozen_map({k: float(v) for k, v in
                                raw.get("loss_weight", {}).items()}),
        pose_loss_type=frozen_map(dict(raw.get("pose_loss_type", {
            "r": "frob", "s": "l1", "t": "l1", "point": "l1"}))),
    )
