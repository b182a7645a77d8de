"""Device milliseconds a step of the kernels a step launches after its
RotNet range closes: the rotation's composition and the scale and
translation fits (profiler trace)."""


def read(run):
    t = getattr(run, "trace", None)
    if t is None or "after_rotnet" not in t.ranges_s:
        return None
    return 1e3 * t.ranges_s["after_rotnet"] / t.steps
