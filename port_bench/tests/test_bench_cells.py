"""Each cell's traffic and driver, end to end at a test's size on the CPU
with the plain FPS, and the comparison failing the control and the faults
a tracking cell can have."""
from __future__ import annotations

import math

import pytest

from port_bench.controls import STEPS
from port_bench.drivers import track
from port_bench.harness import result
from port_bench.tests.conftest import CELLS, cpu_context, tiny_cell


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearses_on_cpu(name, trace):
    cell = tiny_cell(name)
    out = track.run(cpu_context(cell, trace=trace))
    line, lines = result(cell, out, trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 2 * out.run.steps and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert lines[-1] == "check failed_frames: 0 limit 0"
    if trace:
        # no device trace on the CPU: only the host-clock metrics read
        assert set(line["metrics"]) == {"host_enqueue_ms.track",
                                        "mfu.track"}
    else:
        assert set(line["metrics"]) == {"frames_per_s", "step_ms_p95",
                                        "setup_s"}
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0


@pytest.mark.parametrize("stand_in", sorted(STEPS))
@pytest.mark.parametrize("name", CELLS)
def test_comparison_fails_control_and_faults(name, stand_in):
    """The TF32 reference in the program's place, a step that returns its
    state unchanged, half of the batch left out, an answer altered: each
    comes out not correct."""
    cell = tiny_cell(name)
    out = track.run(cpu_context(cell), make_step=STEPS[stand_in])
    line, _ = result(cell, out, False)
    assert not line["correct"], line["checks"]


def test_same_seed_same_traffic_and_weights():
    import torch
    from port_bench import traffic, weights
    from port_bench.reference import captra
    cell = tiny_cell("drawers_points_b8")
    cfg = cell.config
    dev = torch.device("cpu")
    a = traffic.make(cell.traffic, cfg, 2 ** 33 + 5, dev)
    b = traffic.make(cell.traffic, cfg, 2 ** 33 + 5, dev)
    assert torch.equal(a[0]["points"], b[0]["points"])
    spec = captra.weight_spec(cfg)
    wa = weights.make(spec, cfg, 2 ** 33 + 5, dev)
    wb = weights.make(spec, cfg, 2 ** 33 + 5, dev)
    wc = weights.make(spec, cfg, 2 ** 33 + 6, dev)
    k = "backbone.sa1.scale_0.dense_0.weight"
    assert torch.equal(wa["coord"][k], wb["coord"][k])
    assert not torch.equal(wa["coord"][k], wc["coord"][k])


def tiny_train_cell():
    """The training cell at a test's size: 256 points, narrow set
    abstractions, a batch of 4 from a pool of 16."""
    from port_bench.harness import find_cell, load_spec
    import copy
    cell = find_cell(load_spec(), "bottle_coordnet_train_b12")
    cfg = copy.deepcopy(cell.config)
    cfg["num_points"] = 256
    cfg["pointnet"]["sa1"].update(npoint=32, nsample_list=[8, 16, 16])
    cfg["pointnet"]["sa2"].update(npoint=16, nsample_list=[8, 16])
    cfg["network"]["pwm_num"] = 32
    cfg["train"]["batch_size"] = 4
    cell.config = cfg
    cell.traffic = dict(cell.traffic, pool=16)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_train_cell_rehearses_on_cpu(trace):
    """The training cell end to end, correct at a test's size."""
    from port_bench.drivers import train
    cell = tiny_train_cell()
    out = train.run(cpu_context(cell, seconds=0.5, trace=trace))
    line, lines = result(cell, out, trace)
    assert out.failed == 0 and out.run.steps > 0
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert line["correct"], line["checks"]
    want = {"mfu.train"} if trace else {"train_samples_per_s", "setup_s"}
    assert set(line["metrics"]) == want


@pytest.mark.parametrize("stand_in", ["control", "unchanged", "half",
                                      "altered"])
def test_train_comparison_fails_control_and_faults(stand_in):
    from port_bench.controls import TRAIN_PROGRAMS
    from port_bench.drivers import train
    cell = tiny_train_cell()
    out = train.run(cpu_context(cell, seconds=0.3),
                    make_program=TRAIN_PROGRAMS[stand_in])
    line, _ = result(cell, out, False)
    assert not line["correct"], line["checks"]
