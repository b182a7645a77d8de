"""Configurations built in code, for hosts without PyYAML.

`nocs_bottle()` is the tracking configuration of the main path: what
`get_config("config_track.yml", overrides=NOCS_BOTTLE_OVERRIDES)` loads
(NOCS-REAL275 bottle, 4096 points, full-width `pointnet2_camera` backbone,
ground-truth first frame), field for field.
"""
from __future__ import annotations

from captra_tpu_torch.config.schema import Config, ObjCfg, TrackCfg

NOCS_BOTTLE_OVERRIDES = {
    "obj_config": "obj_info_nocs.yml",
    "obj_category": "1",
    "init_frame/gt": True,
}


def nocs_bottle() -> Config:
    """The NOCS bottle tracking Config (category "1": one part, symmetric
    about y, one background seg channel)."""
    obj = ObjCfg(category="1", name="bottle", num_parts=1, num_joints=0,
                 tree=(-1,), sym=True, joint_type="revolute", main_axis=(),
                 extra_dims=1, num_frames=100, synthetic=True, nocs_data=True,
                 basepath="data/nocs_data")
    return Config(obj=obj, track=TrackCfg(init_frame_gt=True))
