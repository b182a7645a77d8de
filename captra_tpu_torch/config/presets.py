"""Configurations built in code, for hosts without PyYAML.

`nocs_bottle()` is the tracking configuration of the main path: what
`get_config("config_track.yml", overrides=NOCS_BOTTLE_OVERRIDES)` loads
(NOCS-REAL275 bottle, 4096 points, full-width `pointnet2_camera` backbone,
ground-truth first frame), field for field.

`nocs_bottle_otf()` is the same object tracked on the fly from raw depth
(`nocs_otf`): what `get_config` loads with `nocs_bottle_otf_overrides()`,
the overrides of the OTF speed protocol (`scripts/bench_otf.py:89-99`) with
`network/compute_dtype` float32, the port's only compute type so far.
"""
from __future__ import annotations

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


def nocs_bottle() -> Config:
    """The NOCS bottle tracking Config (category "1": one part, symmetric
    about y, one background seg channel)."""
    return Config(obj=_bottle(), track=TrackCfg(init_frame_gt=True))


def nocs_bottle_otf_overrides(fps_mode: str = "exact", work_factor: int = 5,
                              nocs2d: bool = False) -> dict:
    """`get_config` overrides of the OTF protocol: `fps_mode` applies to the
    crop and to the backbone's set-abstraction layers."""
    return {**NOCS_BOTTLE_OVERRIDES,
            "nocs_otf": True,
            "track_cfg/otf_fps_mode": fps_mode,
            "track_cfg/otf_work_factor": work_factor,
            "track_cfg/nocs2d_label": nocs2d,
            "track_cfg/nocs2d_path": "bench" if nocs2d else "",
            "network/fps_mode": fps_mode,
            "network/compute_dtype": "float32"}


def nocs_bottle_otf(fps_mode: str = "exact", work_factor: int = 5,
                    nocs2d: bool = False) -> Config:
    """The NOCS bottle Config of the OTF protocol, built in code."""
    return Config(
        obj=_bottle(), network=NetworkCfg(fps_mode=fps_mode),
        track=TrackCfg(init_frame_gt=True, nocs_otf=True,
                       otf_fps_mode=fps_mode, otf_work_factor=work_factor,
                       nocs2d_label=nocs2d,
                       nocs2d_path="bench" if nocs2d else ""))
