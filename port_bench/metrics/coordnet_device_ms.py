"""Device milliseconds a step of the kernels launched inside the
benchmark's range around the CoordNet callable (profiler trace)."""


def read(run):
    t = getattr(run, "trace", None)
    if t is None or "bench.coordnet" not in t.ranges_s:
        return None
    return 1e3 * t.ranges_s["bench.coordnet"] / t.steps
