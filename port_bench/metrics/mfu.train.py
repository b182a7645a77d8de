"""The CoordNet training step's share of the card's float32 peak over the
measured window: the operations of a step (3 x the forward's, counted by
`counts.coordnet_flops` from the configuration's shapes, x the batch) x
steps / window seconds / 67 TFLOP/s, in %."""


def read(run):
    from port_bench.counts import FP32_FLOPS
    if not getattr(run, "steps", 0) or not getattr(run, "flops_per_step",
                                                    0):
        return None
    return 100.0 * run.flops_per_step * run.steps / run.seconds / FP32_FLOPS
