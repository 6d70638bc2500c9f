"""Megabytes (1e6 B) a call copies from the device to the host for its
final states: the summed `bytes` of the program's `sim.to_host` spans in
the profiled calls, per call. An exact count, from the state's shapes."""
from portbench.program_spans import records


def read(run):
    spans = records(run, "sim.to_host")
    if spans is None:
        return None
    return sum(a["bytes"] for *_, a in spans) / len(run.trace.calls) / 1e6
