"""The tensor-core flash kernel's share of its roofline, in %: the least
time of the profiled calls' attention (`flops.roofline_pct`: the causal
attention FLOPs, QK^T and PV over the pairs the mask lets through, at the
bf16 peak, or the bytes of q, k, v and o, once, at the HBM rate,
whichever is longer: the FLOPs at these lengths) over the device time of
the `flash_wgmma_kernel` launches. Nothing where no such kernel ran
(another attention route); off the card the reader takes the host time
of the `portbench.attention` spans instead."""
from portbench.entries.prefill import ATTENTION
from portbench.flops import of_calls, roofline_pct


def read(run):
    work = of_calls(run)
    if work is None:
        return None
    tr = run.trace
    if tr.on_device:
        took_ns = sum(e - s for n, s, e, _ in tr.device_ops
                      if "flash_wgmma_kernel" in n)
    else:
        took_ns = sum(e - s for s, e in tr.spans(ATTENTION))
    if not took_ns:
        return None
    done = sum(f["attention"] for f in work)
    moved = sum(f["attention_bytes"] for f in work)
    return roofline_pct(done, moved, took_ns / 1e9)
