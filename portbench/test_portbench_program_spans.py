"""The readers of the program's own spans, on the CPU: nothing without a
trace or without the program's spans (a program that has none, as
before they were added, reports no value and does not raise); on a
shrunk cell, the transfer's bytes are the rows' state bytes exactly, and
the stage spans hold every operation the step launched."""
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, stages
from portbench import trace as trace_mod

HERE = Path(__file__).resolve().parent
READERS = ("step_host_ms_per_cycle", "to_host_ms_per_call",
           "to_host_mb_per_call")
# the cells the transfer's readers report in
(CELLS,) = [m["workloads"] for m in harness.load_bench()["per_layer"]
            if m["name"] == "to_host_mb_per_call"]
# cycle counts no other test file runs the port at
SHRINK = {"rows": 3, "cycles": 9, "warm_cycles": 8}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reader(name):
    return harness._load_file(HERE / "metrics" / f"{name}.py",
                              f"portbench_test_metric_{name}")


def _traced(cell):
    """One shrunk traced run of `cell`: (result line, its `Trace`)."""
    return stages.traced_run(cell, 2**31 + 23, 0.0, device="cpu",
                             shrink=SHRINK, log=lambda msg: None)


@pytest.mark.parametrize("name", READERS)
def test_no_trace_reads_nothing(name, monkeypatch):
    assert reader(name).read(harness.Run(setup_s=1.0, calls=[])) is None
    # a trace whose calls hold none of the program's spans
    tr = trace_mod.Trace(calls=[(0, 1)], work=1, counts={}, device_ops=[],
                         host_spans=[], on_device=False)
    assert reader(name).read(harness.Run(1.0, [], tr)) is None
    # spans inside the calls are read; a program without
    # `repro_torch.spans` gives nothing
    import repro_torch
    from repro_torch import spans
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("sim.step"), spans.span("sim.to_host", bytes=7):
            pass
    tr.calls = [(spans.log()[-2][1], 2**63)]
    assert reader(name).read(harness.Run(1.0, [], tr)) > 0
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert reader(name).read(harness.Run(1.0, [], tr)) is None


@pytest.mark.parametrize("cell", CELLS)
def test_to_host_bytes_are_the_rows_state(cell):
    from repro_torch.core.design import design_params
    from repro_torch.sim import memsys
    from repro_torch.sim.config import SimConfig
    result, tr = _traced(cell)
    config = harness.resolve(harness.load_bench(), cell).config
    st = memsys.init_state(SimConfig(n_apps=config["n_apps"], device="cpu"),
                           design_params("mask"), rows=1)
    leaves = []
    memsys.map_state(leaves.append, st)
    row_bytes = sum(x.numel() * x.element_size() for x in leaves)
    rows = result["attempted"] // len(tr.calls)
    got = result["metrics"]["to_host_mb_per_call"]["value"]
    assert got == rows * row_bytes / 1e6
    assert result["metrics"]["step_host_ms_per_cycle"]["value"] > 0
    assert result["metrics"]["to_host_ms_per_call"]["value"] > 0


def test_stage_spans_hold_every_operation_of_the_step():
    from repro_torch import spans
    result, tr = _traced("grid2-allpairs")
    out = stages.join(tr, spans.log())
    # two passes (ideal; the other seven stacked) of SHRINK's cycles
    assert out["pass_cycles"] == out["wrapped_steps"] == 2 * SHRINK["cycles"]
    assert out["wrapped_ops"] > 0
    assert out["wrapped_ops_in_sim_step"] == out["wrapped_ops"]
    assert out["stage_ops"] == out["wrapped_ops"]
    per_cycle = result["metrics"]["kernels_per_cycle"]["value"]
    assert sum(s["ops"] for s in out["stages"].values()) == per_cycle
