"""The MoE FFN's share of its roofline, in %: the least time of its work
in the profiled calls (`flops.roofline_pct`: its model FLOPs, the router
and every routed expert's three GEMMs a token and a choice, at the bf16
peak, or its bytes, the weights read once, at the HBM rate, whichever is
longer; at full width the FLOPs, 13.4 against 3.9 ms a call) over the
device time of the operations launched inside `moe_apply`
(`portbench.moe`). Off the card the reader takes the spans' host time
instead."""
from portbench.entries.prefill import MOE
from portbench.flops import of_calls, roofline_pct


def read(run):
    work = of_calls(run)
    if work is None:
        return None
    tr = run.trace
    if tr.on_device:
        took_ns = sum(e - s for _, s, e, _ in tr.launched_in(MOE))
    else:
        took_ns = sum(e - s for s, e in tr.spans(MOE))
    if not took_ns:
        return None
    done = sum(f["moe"] for f in work)
    moved = sum(f["moe_bytes"] for f in work)
    return roofline_pct(done, moved, took_ns / 1e9)
