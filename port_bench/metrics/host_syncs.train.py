"""Host synchronisations a training step makes: the `host_syncs` counter of
the program's `train.step` span (CUDA's sync debug mode), the mean over
the traced window."""
from port_bench.spans import counter


def read(run):
    return counter(run, "train.step", "host_syncs")
