from captra_tpu_torch.tracking.tracker import (  # noqa: F401
    TrackAux,
    evaluate_track,
    extrapolate_pose,
    init_pose_from_cloud,
    init_pose_from_gt,
    make_track_step,
    search_init_orientation,
    track_trajectory,
)
