from captra_tpu_torch.ops.pointops import (  # noqa: F401
    ball_group,
    ball_query,
    farthest_point_sample,
    farthest_point_sample_grouped_t,
    gather_points,
    gather_xyz,
    group_ball,
    group_points,
    square_distance,
    three_interp_rows,
    three_interpolate,
    three_nn,
)
