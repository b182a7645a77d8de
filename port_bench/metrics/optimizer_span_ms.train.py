"""Device milliseconds a training step of the program's `train.optimizer`
span: clipping, weight decay and Adam over the flat buffers, with the
card's idle between their kernels (the span's own events; traced
window)."""
from port_bench.spans import span_ms


def read(run):
    return span_ms(run, "train.step", "train.optimizer")
