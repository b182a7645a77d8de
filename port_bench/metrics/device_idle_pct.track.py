"""The share of the traced window in which no kernel, copy or memset ran
on the card, in % (profiler trace)."""


def read(run):
    t = getattr(run, "trace", None)
    if t is None or t.window_s <= 0 or t.kernels == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
