"""Device milliseconds a training step of the program's `train.forward` span:
the forward in train mode and the losses, with the card's idle between
their kernels (the span's own events; traced window)."""
from port_bench.spans import span_ms


def read(run):
    return span_ms(run, "train.step", "train.forward")
