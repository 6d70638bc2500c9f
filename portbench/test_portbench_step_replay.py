"""`step_replay_pct` on the CPU: nothing without a trace, or where the
step spans carry no `replay` attribute (a program whose step has none);
the share of the profiled step spans that replayed; 0 on a shrunk cell,
where the CPU steps op by op."""
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, stages
from portbench import trace as trace_mod

HERE = Path(__file__).resolve().parent
# cycle counts no other test file runs the port at
SHRINK = {"rows": 2, "cycles": 7, "warm_cycles": 5}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reader():
    return harness._load_file(HERE / "metrics" / "step_replay_pct.py",
                              "portbench_test_metric_step_replay_pct")


def _spans(*attrs):
    """A trace whose one call holds a `sim.step` span per attrs dict."""
    from repro_torch import spans
    with profile(activities=[ProfilerActivity.CPU]):
        for a in attrs:
            with spans.span("sim.step", **a):
                pass
    recs = spans.log()[-len(attrs):]
    return trace_mod.Trace(calls=[(recs[0][1], 2**63)], work=1, counts={},
                           device_ops=[], host_spans=[], on_device=False)


def test_reads_the_share_of_replayed_steps(monkeypatch):
    read = _reader().read
    assert read(harness.Run(setup_s=1.0, calls=[])) is None
    empty = trace_mod.Trace(calls=[(0, 1)], work=1, counts={},
                            device_ops=[], host_spans=[], on_device=False)
    assert read(harness.Run(1.0, [], empty)) is None
    assert read(harness.Run(1.0, [], _spans({}, {}))) is None
    tr = _spans({"replay": 1}, {"replay": 1}, {"replay": 0},
                {"replay": 1})
    assert read(harness.Run(1.0, [], tr)) == 75.0
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read(harness.Run(1.0, [], tr)) is None


def test_a_shrunk_cell_on_the_cpu_reads_zero():
    result, _ = stages.traced_run("batch3-mask-all", 2**31 + 41, 0.0,
                                  device="cpu", shrink=SHRINK,
                                  log=lambda msg: None)
    assert result["correct"]
    assert result["metrics"]["step_replay_pct"]["value"] == 0.0
