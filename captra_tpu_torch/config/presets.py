"""Configurations built in code, for hosts without PyYAML.

`nocs_bottle()` is the tracking configuration of the main path: what
`get_config("config_track.yml", overrides=nocs_bottle_overrides())` loads
(NOCS-REAL275 bottle, 4096 points, full-width `pointnet2_camera` backbone,
ground-truth first frame), field for field; `compute_dtype` and
`quality_profile` ("best": the loader's tracking preset for the object,
`loader._quality_profile`) are the same overrides in code.

`nocs_bottle_otf()` is the same object tracked on the fly from raw depth
(`nocs_otf`): what `get_config` loads with `nocs_bottle_otf_overrides()`,
the overrides of the OTF speed protocol (`scripts/bench_otf.py:89-99`),
whose `network/compute_dtype` is bfloat16; both default to float32 here.
"""
from __future__ import annotations

import dataclasses

from captra_tpu_torch.config.loader import _quality_profile
from captra_tpu_torch.config.schema import (
    Config, NetworkCfg, ObjCfg, TrackCfg,
)

NOCS_BOTTLE_OVERRIDES = {
    "obj_config": "obj_info_nocs.yml",
    "obj_category": "1",
    "init_frame/gt": True,
}


def _bottle() -> ObjCfg:
    return ObjCfg(category="1", name="bottle", num_parts=1, num_joints=0,
                  tree=(-1,), sym=True, joint_type="revolute", main_axis=(),
                  extra_dims=1, num_frames=100, synthetic=True,
                  nocs_data=True, basepath="data/nocs_data")


def nocs_bottle_overrides(compute_dtype: str = "float32",
                          quality_profile: str = "reference") -> dict:
    """`get_config` overrides of `nocs_bottle(compute_dtype,
    quality_profile)`."""
    return {**NOCS_BOTTLE_OVERRIDES, "network/compute_dtype": compute_dtype,
            "track_cfg/quality_profile": quality_profile}


def nocs_bottle(compute_dtype: str = "float32",
                quality_profile: str = "reference") -> Config:
    """The NOCS bottle tracking Config (category "1": one part, symmetric
    about y, one background seg channel)."""
    obj = _bottle()
    track = TrackCfg(init_frame_gt=True, quality_profile=quality_profile)
    if quality_profile == "best":
        track = dataclasses.replace(track, **_quality_profile(obj))
    elif quality_profile != "reference":
        raise ValueError(f"track_cfg/quality_profile={quality_profile!r} "
                         "is not one of ['best', 'reference']")
    return Config(obj=obj, network=NetworkCfg(compute_dtype=compute_dtype),
                  track=track)


def nocs_bottle_otf_overrides(fps_mode: str = "exact", work_factor: int = 5,
                              nocs2d: bool = False,
                              compute_dtype: str = "float32") -> dict:
    """`get_config` overrides of the OTF protocol: `fps_mode` applies to the
    crop and to the backbone's set-abstraction layers."""
    return {**NOCS_BOTTLE_OVERRIDES,
            "nocs_otf": True,
            "track_cfg/otf_fps_mode": fps_mode,
            "track_cfg/otf_work_factor": work_factor,
            "track_cfg/nocs2d_label": nocs2d,
            "track_cfg/nocs2d_path": "bench" if nocs2d else "",
            "network/fps_mode": fps_mode,
            "network/compute_dtype": compute_dtype}


def nocs_bottle_otf(fps_mode: str = "exact", work_factor: int = 5,
                    nocs2d: bool = False,
                    compute_dtype: str = "float32") -> Config:
    """The NOCS bottle Config of the OTF protocol, built in code."""
    return Config(
        obj=_bottle(), network=NetworkCfg(fps_mode=fps_mode,
                                          compute_dtype=compute_dtype),
        track=TrackCfg(init_frame_gt=True, nocs_otf=True,
                       otf_fps_mode=fps_mode, otf_work_factor=work_factor,
                       nocs2d_label=nocs2d,
                       nocs2d_path="bench" if nocs2d else ""))
