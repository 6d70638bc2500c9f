"""Milliseconds of host time a pass-cycle spends issuing the cycle step:
the mean duration of the program's `sim.step` spans in the profiled
calls (the step runs once a cycle for each pass of a call)."""
from portbench.program_spans import records


def read(run):
    steps = records(run, "sim.step")
    if steps is None:
        return None
    return sum(e - s for _, s, e, _, _ in steps) / len(steps) / 1e6
