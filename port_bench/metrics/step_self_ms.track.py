"""Device milliseconds a step of the program's `track.step` span less its
children's: the canonicalizations, means and label picks between the
layers, and the card's idle there (the spans' own events; traced
window)."""
from port_bench.spans import self_ms


def read(run):
    return self_ms(run, "track.step")
