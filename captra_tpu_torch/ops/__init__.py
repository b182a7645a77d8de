# the kernel modules, imported with the package so that
# `cuda_build.launch_counts` holds all their kernels
from captra_tpu_torch.ops import fps, neighbors, pointops, sa_mlp  # noqa: F401
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


def kernel_switches() -> tuple:
    """The settings, read at call time, that choose a hand-written kernel
    (a captured CUDA graph holds for one setting): the blocked FPS
    opt-in."""
    return (fps.use_blocked(),)


def fps_wrapped() -> bool:
    """Whether the point ops' FPS entry is not `fps`'s own (a recorder, or
    the plain FPS swapped in)."""
    return pointops.farthest_point_sample_indices \
        is not fps.farthest_point_sample_indices
