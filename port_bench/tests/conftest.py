"""Shared helpers of the benchmark's CPU tests: cells cut to a size a test
run holds (the configurations' widths cut, two streams, a few frames, a
small depth image), and the card fixture of the card-only tests."""
from __future__ import annotations

import copy

import pytest
import torch

from port_bench.harness import Clock, Context, find_cell, load_spec

CELLS = ("bottle_points_b16", "bottle_otf_b16", "drawers_points_b8")


def tiny_cell(name: str, streams: int = 2, frames: int = 6, root=None,
              spec=None):
    """The cell `name` (of `spec`, default BENCHMARK.json, in the checkout at
    `root`) at a test's size: 256 points, narrow set abstractions,
    `streams` streams of `frames` frames."""
    spec = spec or load_spec()
    cell = find_cell(spec, name) if root is None else find_cell(
        spec, name, root)
    cfg = copy.deepcopy(cell.config)
    cfg["num_points"] = 256
    pn = cfg["pointnet"]
    pn["sa1"].update(npoint=32, nsample_list=[8, 16, 16])
    pn["sa2"].update(npoint=16, nsample_list=[8, 16])
    cell.config = cfg
    cell.traffic = dict(cell.traffic, streams=streams, frames=frames)
    if cell.traffic["input"] == "depth":
        cell.traffic.update(height=96, width=128, origin_rows=[10, 20],
                            origin_cols=[10, 20], object_px=40)
        cell.traffic["track"] = dict(cell.traffic["track"],
                                     otf_work_factor=2)
    return cell


def cpu_context(cell, seed: int = 2 ** 31 + 17, seconds: float = 1.0,
                trace: bool = False) -> Context:
    return Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                   device=torch.device("cpu"), clock=Clock(),
                   log=lambda msg: None)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, not
    at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def few_threads():
    """One torch thread a test: the suite runs in several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
