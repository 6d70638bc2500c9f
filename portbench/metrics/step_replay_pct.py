"""Share, in %, of the cycle steps in the profiled calls that replayed
their captured CUDA graphs: the program's `sim.step` spans whose
attribute `replay` is 1. Nothing where no step span carries the
attribute (a program that issues every step op by op)."""
from portbench.program_spans import records


def read(run):
    steps = records(run, "sim.step")
    if steps is None or not any("replay" in a for *_, a in steps):
        return None
    return 100.0 * sum(a.get("replay") == 1 for *_, a in steps) / len(steps)
