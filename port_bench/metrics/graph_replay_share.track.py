"""Share of the tracking steps that replayed a CUDA graph: the program's
`graph_counts` (`captra_tpu_torch/tracking/tracker.py`), replayed ÷
(replayed + run eagerly), over every step the run made (warm-up, window,
traced window).  A call that captured the graph counts on neither side.
None where the program keeps no such counter or counted no step, and where
the traced window ran no device work (the CPU, where no step replays)."""
import sys


def read(run):
    t = getattr(run, "trace", None)
    if t is None or t.kernels == 0:
        return None
    tracker = sys.modules.get("captra_tpu_torch.tracking.tracker")
    counts = getattr(tracker, "graph_counts", None)
    if not counts:
        return None
    replayed, eager = counts.get("replayed", 0), counts.get("eager", 0)
    if replayed + eager == 0:
        return None
    return replayed / (replayed + eager)
