"""Milliseconds of an entry call outside its cycle steps: the runner's
plan, cold start, the final state's transfer to the host (with the wait
for the device) and the per-row stats, averaged over the profiled
calls."""
from portbench.entries._sim import STEP


def read(run):
    tr = run.trace
    if tr is None:
        return None
    steps = tr.spans(STEP)
    if not steps:
        return None
    out = []
    for cs, ce in tr.calls:
        inside = sum(e - s for s, e in steps if cs <= s < ce)
        out.append((ce - cs - inside) / 1e6)
    return sum(out) / len(out)
