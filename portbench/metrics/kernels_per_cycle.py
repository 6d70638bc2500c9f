"""Device operations (kernels, copies, fills) launched inside the cycle
step, per step call, in the profiled calls: the step runs once a cycle
for each pass of a call. The runner's operations (cold start, the
state's transfer) are not the step's."""
from portbench.entries._sim import STEP


def read(run):
    tr = run.trace
    if tr is None or not tr.counts.get(STEP):
        return None
    ops = tr.launched_in(STEP)
    return len(ops) / tr.counts[STEP] if ops else None
