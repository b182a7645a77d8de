"""The yardstick's counts against hand counts."""
from __future__ import annotations

import pytest

from port_bench import counts
from port_bench.harness import find_cell, load_spec


def test_one_sa_layer_by_hand():
    """sa1 of pointnet2_camera with xyz features, one cloud of 4096 points:
    512 centres; scale 0 groups 32 neighbours through 6->32->32->64."""
    macs = 6 * 32 + 32 * 32 + 32 * 64
    assert counts.mlp_flops(6, (32, 32, 64)) == 2 * macs
    pn = {"sa1": {"npoint": 512, "nsample_list": [32],
                  "mlp_list": [[32, 32, 64]]},
          "sa2": {"npoint": 1, "nsample_list": [], "mlp_list": []},
          "sa3_mlp": [0], "fp3_mlp": [0], "fp2_mlp": [0], "fp1_mlp": [0]}
    got = counts.backbone_flops(pn, 4096, 0, True)
    sa1 = 512 * 32 * 2 * macs + 2 * 512 * 4096 * 3
    rest = 2 * 512 * 1 * 3 + 2 * 4096 * 512 * 3     # the 3-NN distances
    assert got == sa1 + rest


def test_step_of_the_bottle_by_hand():
    cfg = find_cell(load_spec(), "bottle_points_b16").config
    sa1 = 2 * 512 * (32 * (6 * 32 + 32 * 32 + 32 * 64)
                     + 64 * (6 * 64 + 64 * 64 + 64 * 128)
                     + 128 * (6 * 64 + 64 * 96 + 96 * 128))
    assert sa1 == pytest.approx(3.4e9, rel=0.01)
    coord = counts.coordnet_flops(cfg)
    assert 9.5e9 < coord < 10.0e9
    # RotNet's backbone has no xyz features: 3 input channels fewer in sa1
    # and fp1; its head is 128->512->512->256->3 (symmetric)
    coord_heads = 2 * 4096 * (128 * 2 + 128 * 128 + 128 * 3)
    no_xyz = 2 * 512 * 3 * (32 * 32 + 64 * 64 + 128 * 64) + 2 * 4096 * 3 * 128
    rot_head = 2 * 4096 * (128 * 512 + 512 * 512 + 512 * 256 + 256 * 3)
    rot = counts.rotnet_flops(cfg)
    assert rot == coord - coord_heads - no_xyz + rot_head
    assert counts.track_step_flops(cfg, 16) == 16 * (coord + rot)


def test_fps_bound_by_hand():
    # [8, 20480] -> 4096 with every point distinct: operations bound
    ops = 20480 * 8 * 4096 * 10 / 67e12
    assert counts.fps_bound_s(8, 20480, 4096, 8 * 4096) == pytest.approx(ops)
    # one pick on a tiny cloud: the bytes bound
    by = (1 * 64 * 12 + 1 * 16 * 4) / 3.35e12
    assert counts.fps_bound_s(1, 64, 16, 1) == pytest.approx(
        max(by, 64 * 10 / 67e12))
