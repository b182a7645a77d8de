"""Device milliseconds a step of the program's `track.rotnet` spans (one a
pass): RotNet's kernels and the card's idle between them (the spans' own
events; traced window)."""
from port_bench.spans import span_ms


def read(run):
    return span_ms(run, "track.step", "track.rotnet")
