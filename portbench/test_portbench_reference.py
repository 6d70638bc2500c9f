"""The benchmark's plain reference against the program on the CPU: both
configurations, a few rows with idle partners, a `pwc` row among them,
43 cycles. Integer counters equal and floats float-hex equal: every
stats value the same float64 bits."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import reference
from portbench.entries._sim import same

HERE = Path(__file__).resolve().parent
CYCLES = 43          # a cycle count no other test file runs the port at


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("config,rows", [
    ("table1-2app", [("3DS", "BLK"), ("MUM", None), ("HISTO", "BFS2")]),
    ("table1-3app", [("3DS", "BLK", "GUP"), ("SCAN", None, None),
                     ("FFT", "HS", "RED")]),
])
def test_reference_equals_the_program(config, rows):
    from repro_torch.sim import runner
    sizes = json.loads((HERE / "configs" / f"{config}.json").read_text())
    designs = ["ideal", "pwc", "mask", "static"]
    prog = runner.run_grid(designs, rows, cycles=CYCLES, device="cpu")
    for d, got in zip(designs, prog):
        want = reference.run_rows(d, rows, CYCLES, "cpu", sizes)
        for r, (a, b) in enumerate(zip(got, want)):
            assert same(a, b), (config, d, rows[r])
            assert a["walks"].dtype == np.float64


def test_reference_keeps_the_configuration_sizes():
    """A size from the configuration file reaches the simulated GPU: a
    smaller L2 data cache changes the answers."""
    rows = [("3DS", "BLK")]
    base = reference.run_rows("gpu-mmu", rows, 31, "cpu", {"l2_sets": 1024})
    small = reference.run_rows("gpu-mmu", rows, 31, "cpu", {"l2_sets": 16})
    assert not same(base[0], small[0])


@pytest.mark.parametrize("design", ["mask", "mask-tlb", "mask-cache",
                                    "mask-dram"])
def test_reference_follows_epoch_maintenance(design, monkeypatch):
    """The cells' calls end before the first epoch boundary (8,000
    cycles); with the epoch cut to 7 cycles on both sides, the token
    hill-climb, DRAM pressure and bypass latch run four times in 29
    cycles, and the reference still equals the program."""
    import dataclasses

    from portbench.reference import design as ref_design
    from repro_torch.core.design import get_design
    from repro_torch.sim import runner
    rows = [("3DS", "BLK"), ("MUM", None), ("HISTO", "BFS2")]
    sizes = json.loads((HERE / "configs" / "table1-2app.json").read_text())
    cut = dataclasses.replace(get_design(design), epoch_cycles=7)
    got = runner.run_batch(cut, rows, cycles=29, device="cpu")
    plain = reference.run_rows(design, rows, 29, "cpu", sizes)
    monkeypatch.setattr(reference, "get_design", lambda n: dataclasses
                        .replace(ref_design.get_design(n), epoch_cycles=7))
    want = reference.run_rows(design, rows, 29, "cpu", sizes)
    assert all(same(a, b) for a, b in zip(got, want))
    assert not all(same(a, b) for a, b in zip(plain, want))
