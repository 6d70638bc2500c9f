"""The whole step's share of the card's peak in the traced window, in %:
the model FLOPs of the profiled calls (`portbench/flops.py`, from their
plans) over the profiled calls' span (the first's start to the last's end,
on the profiler's clock) times the H100's dense bf16 peak: what bounds the
kernels' roofline shares from above."""
from portbench.flops import PEAK_BF16_FLOPS, of_calls


def read(run):
    work = of_calls(run)
    if work is None:
        return None
    done = sum(f["total"] for f in work)
    return 100.0 * done / (run.trace.window_ns / 1e9 * PEAK_BF16_FLOPS)
