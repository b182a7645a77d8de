"""Share of the set-abstraction scales that a tracking step runs through the
fused route (`captra_tpu_torch/ops/sa_mlp.py`, one kernel a scale on the
card): the program's `sa_fused` counter over its `sa_scales` counter, each
summed over the traced window's `track.step` roots and every span below
them (CoordNet's and RotNet's).  None where nothing counted a scale (a
program without these counters), without a traced window, or without
device times (the CPU)."""
from port_bench.spans import roots


def _total(span: dict, name: str) -> int:
    return span["counters"].get(name, 0) + sum(
        _total(child, name) for child in span["children"])


def read(run):
    got = roots(run, "track.step")
    if got is None:
        return None
    scales = sum(_total(r, "sa_scales") for r in got)
    if not scales:
        return None
    return sum(_total(r, "sa_fused") for r in got) / scales
