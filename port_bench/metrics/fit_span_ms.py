"""Device milliseconds a step of the program's `track.fit` spans (one a
pass): rotation decode, composition, the scale and translation fit and
validity, every pass counted (the spans' own events; traced window)."""
from port_bench.spans import span_ms


def read(run):
    return span_ms(run, "track.step", "track.fit")
