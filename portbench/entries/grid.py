"""`run_grid`: the designs x rows cross product, grouped by static
signature into as few passes as `max_rows` allows."""
from __future__ import annotations

from portbench.entries import Entry
from portbench.entries import _sim

# the control and the CPU tests' shrinks and faults are the simulator's
control, TESTS = _sim.control, _sim.TESTS


def make(config: dict, traffic: dict, device, shrink=None) -> Entry:
    from repro_torch.sim import runner
    _sim.check_sizes(config)
    designs = list(traffic["designs"])

    def run(mixes, cycles):
        out = runner.run_grid(designs, mixes, cycles=cycles,
                              max_rows=traffic["max_rows"], device=device)
        return dict(zip(designs, out))

    return _sim.sim_entry(config, traffic, device, designs, run, shrink)
