"""Milliseconds a call spends bringing final states to the host: the
summed duration of the program's `sim.to_host` spans in the profiled
calls, per call. It holds the wait for the device's last cycles."""
from portbench.program_spans import records


def read(run):
    spans = records(run, "sim.to_host")
    if spans is None:
        return None
    return sum(e - s for _, s, e, _, _ in spans) / len(run.trace.calls) / 1e6
