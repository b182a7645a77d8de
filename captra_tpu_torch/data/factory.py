"""Dataset backend selection by object-config flags + mode (counterpart of
`captra_tpu/data/factory.py`; the reference's PointData backend choice,
network/data/dataset.py:43-63):

  * ``obj.nocs_data``          -> NOCSDataset (any mode)
  * ``'bmvc' in mode``         -> BMVCDataset (mode ``bmvc_<track>``)
  * ``mode == 'real_test'`` and not nocs -> SAPIENRealDataset (captured
    real trajectories, GT poses optional)
  * otherwise                  -> SAPIENDataset (synthetic renders;
    ``test_seq``/``train_seq`` select the temporal render_seq split)

Every backend returns {"data": {points[, labels, nocs]}, "meta": {...}}
items and exposes ``track_index()`` so the same collation / tracking loop
drives all of them.
"""
from __future__ import annotations

from captra_tpu_torch.config.schema import Config


def make_dataset(cfg: Config, mode: str, downsampling: int | None = None):
    obj = cfg.obj
    if obj.nocs_data:
        from captra_tpu_torch.data.nocs import NOCSDataset
        return NOCSDataset(
            obj.basepath, obj.category, obj,
            num_expr=cfg.num_expr,
            num_points=cfg.num_points, mode=mode,
            radius=cfg.data_radius, perturb=cfg.perturb,
            truncate_length=cfg.dataset_length,
            downsampling=downsampling,
            nocs2d_path=(cfg.track.nocs2d_path
                         if cfg.track.nocs2d_label else None))
    if "bmvc" in mode:
        if downsampling:
            # a BMVC "dataset" is one contiguous trajectory; skipping
            # frames would silently change the tracked video
            raise ValueError("downsampling is not supported for BMVC "
                             "trajectories")
        from captra_tpu_torch.data.real_arti import BMVCDataset
        tok = mode.split("_")[-1]
        return BMVCDataset(obj.basepath, obj.category,
                           track=int(tok) if tok.isdigit() else 0,
                           truncate_length=cfg.dataset_length)
    if mode == "real_test":
        from captra_tpu_torch.data.real_arti import SAPIENRealDataset
        return SAPIENRealDataset(obj.basepath, obj.category,
                                 num_points=cfg.num_points,
                                 truncate_length=cfg.dataset_length,
                                 downsampling=downsampling)
    from captra_tpu_torch.data.sapien import SAPIENDataset
    return SAPIENDataset(obj.basepath, obj.category, obj,
                         num_expr=cfg.num_expr,
                         num_points=cfg.num_points, mode=mode,
                         truncate_length=cfg.dataset_length,
                         downsampling=downsampling)


def default_track_mode(cfg: Config) -> str:
    """The split a plain `track` invocation should read when --mode_name is
    not given: NOCS tracks the real_test scenes
    (scripts/track/nocs/1_bottle.sh --mode_name=real_test), SAPIEN tracks
    the temporal synthetic split (scripts/track/sapien/laptop.sh
    --mode_name=test_seq when render_seq exists, plain test otherwise)."""
    if cfg.obj.nocs_data:
        return "real_test"
    import os
    from os.path import join as pjoin
    if os.path.isdir(pjoin(cfg.obj.basepath, "render_seq")):
        return "test_seq"
    return "test"
