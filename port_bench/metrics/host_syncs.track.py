"""Host synchronisations a tracking step makes: the `host_syncs` counter of
the program's `track.step` span (CUDA's sync debug mode), the mean over
the traced window."""
from port_bench.spans import counter


def read(run):
    return counter(run, "track.step", "host_syncs")
