from captra_tpu_torch.tracking.tracker import (  # noqa: F401
    TrackAux,
    make_track_step,
    track_trajectory,
)
