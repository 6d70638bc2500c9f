"""Share of the profiled window, in %, in which no device operation
ran."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_ns() / tr.window_ns)
