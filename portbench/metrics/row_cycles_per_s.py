"""Simulated row-cycles completed per second of the window: every row of
every call (rows x cycles, the entry's work), over the host time from the
window's start to the end of its last call, tracing off."""


def read(run):
    if not run.calls:
        return None
    done = sum(c.work for c in run.calls)
    return done / (run.calls[-1].end - run.calls[0].start)
