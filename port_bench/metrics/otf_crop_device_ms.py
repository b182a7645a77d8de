"""Device milliseconds a step of the kernels a step launches before its
CoordNet range opens: on raw depth the backprojection, the ball crop and
its FPS (and the root canonicalization); profiler trace."""


def read(run):
    t = getattr(run, "trace", None)
    if t is None or "before_coordnet" not in t.ranges_s:
        return None
    return 1e3 * t.ranges_s["before_coordnet"] / t.steps
