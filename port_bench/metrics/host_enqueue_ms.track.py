"""Host milliseconds from a tracking step's call to its return, before its
poses are read back, the mean over the measured window (host clock)."""


def read(run):
    e = getattr(run, "enqueue_s", None)
    return 1e3 * sum(e) / len(e) if e else None
