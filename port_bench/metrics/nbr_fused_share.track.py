"""Share of the backbone stages' neighbour searches that a tracking step
runs through the fused route (`captra_tpu_torch/ops/neighbors.py`: one
selection kernel a stage on the card): the program's `nbr_fused` counter
over its `nbr_stages` counter, each summed over the traced window's
`track.step` roots and every span below them.  None where nothing counted
a stage (a program without these counters), without a traced window, or
without device times (the CPU)."""
from port_bench.spans import roots


def _total(span: dict, name: str) -> int:
    return span["counters"].get(name, 0) + sum(
        _total(child, name) for child in span["children"])


def read(run):
    got = roots(run, "track.step")
    if got is None:
        return None
    stages = sum(_total(r, "nbr_stages") for r in got)
    if not stages:
        return None
    return sum(_total(r, "nbr_fused") for r in got) / stages
