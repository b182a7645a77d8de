"""Device milliseconds a step of the program's `track.crop` span: the OTF
backprojection, detection pick, ball crop and its FPS, with the card's idle
between them (the span's own events; traced window)."""
from port_bench.spans import span_ms


def read(run):
    return span_ms(run, "track.step", "track.crop")
