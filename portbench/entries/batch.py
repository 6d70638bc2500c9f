"""`run_batch`: every row under one design, in one pass, with the
design's knobs as host scalars."""
from __future__ import annotations

from portbench.entries import Entry
from portbench.entries import _sim

# the control and the CPU tests' shrinks and faults are the simulator's
control, TESTS = _sim.control, _sim.TESTS


def make(config: dict, traffic: dict, device, shrink=None) -> Entry:
    from repro_torch.sim import runner
    _sim.check_sizes(config)
    (design,) = traffic["designs"]

    def run(mixes, cycles):
        return {design: runner.run_batch(design, mixes, cycles=cycles,
                                         device=device)}

    return _sim.sim_entry(config, traffic, device, [design], run, shrink)
