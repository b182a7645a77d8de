"""The FPS kernels' share of their roofline in the traced window: the sum
of each FPS call's least time (`counts.fps_bound_s`, its picks counted
from its inputs' distinct points) over the device time of the kernels
named `fps_`, in %."""


def read(run):
    t = getattr(run, "trace", None)
    bound = getattr(run, "fps_bound_s", None)
    if t is None or not bound:
        return None
    spent = sum(s for name, s in t.kernels_s.items() if "fps_" in name)
    return 100.0 * bound / spent if spent > 0 else None
