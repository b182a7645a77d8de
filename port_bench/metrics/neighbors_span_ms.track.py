"""Device milliseconds a tracking step of the program's `backbone.neighbors`
spans: each backbone stage's neighbour search (a set-abstraction stage's
distance product and every radius's ball query; a propagation stage's
product and 3-NN), inside CoordNet's and RotNet's spans, summed over the
step and averaged over the traced steps.  None where the program has no
such span (the traced window's steps hold none), without a traced window,
or without device times (the CPU)."""
from port_bench.spans import span_ms


def read(run):
    return span_ms(run, "track.step", "backbone.neighbors")
