"""Share of the set-abstraction scales that a tracking step runs with their
first layer factored per point (`captra_tpu_torch/ops/sa_mlp.py`: the
stage's table of the feature channels' products, then the offset channels
a neighbour row): the program's `sa_factored` counter over its `sa_scales`
counter, each summed over the traced window's `track.step` roots and every
span below them (CoordNet's and RotNet's).  None where nothing counted a
scale or a factored one (a program without that route), without a traced
window, or without device times (the CPU)."""
from port_bench.spans import roots


def _total(span: dict, name: str) -> int:
    return span["counters"].get(name, 0) + sum(
        _total(child, name) for child in span["children"])


def read(run):
    got = roots(run, "track.step")
    if got is None:
        return None
    scales = sum(_total(r, "sa_scales") for r in got)
    factored = sum(_total(r, "sa_factored") for r in got)
    if not scales or not factored:
        return None
    return factored / scales
