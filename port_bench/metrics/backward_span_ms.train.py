"""Device milliseconds a training step of the program's `train.backward`
span: the backward, with the card's idle between its kernels (the span's
own events; traced window)."""
from port_bench.spans import span_ms


def read(run):
    return span_ms(run, "train.step", "train.backward")
