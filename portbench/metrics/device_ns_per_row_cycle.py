"""Nanoseconds of the device operations launched inside the cycle step,
in the profiled calls, per simulated row-cycle (a row's one cycle). The
runner's operations (cold start, the state's transfer) are not the
step's."""
from portbench.entries._sim import STEP


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ops = tr.launched_in(STEP)
    return sum(e - s for _, s, e, _ in ops) / tr.work if ops else None
