"""Device milliseconds a step of the program's `track.coordnet` spans (one a
pass): CoordNet's kernels and the card's idle between them; less
`coordnet_device_ms`, the card's wait for the host inside CoordNet (the
spans' own events; traced window)."""
from port_bench.spans import span_ms


def read(run):
    return span_ms(run, "track.step", "track.coordnet")
