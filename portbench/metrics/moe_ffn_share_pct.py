"""Share, in %, of the device time of the profiled calls that the MoE FFN
takes: the device operations launched while the host was inside
`moe_apply` (the benchmark's `portbench.moe` span: routing, dispatch,
the expert GEMMs, combine) over every device operation of the calls."""
from portbench.entries.prefill import MOE


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    moe = sum(e - s for _, s, e, _ in tr.launched_in(MOE))
    if not moe:
        return None
    return 100.0 * moe / sum(e - s for _, s, e, _ in tr.device_ops)
