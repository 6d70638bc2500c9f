"""The program's spans (`repro_torch.spans`) on the CPU: nothing kept with
no profiler recording; under `torch.profiler.profile` one record per
span, nested as the calls nest, on the profiler's host clock; the stats
the same bit for bit either way."""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.core.design import design_params
from repro_torch.sim import memsys, runner
from repro_torch.sim.config import SimConfig

MIXES = [("3DS", "BLK"), ("HISTO", None)]
STAGES = ["sim.step." + s for s in ("sched", "probe", "front", "memory",
                                     "commit", "retire", "stats", "epoch")]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _recorded(fn):
    """The records `fn` adds to the log under the profiler, indexed as a
    list of their own (parents remapped; -1 for one outside it)."""
    first = len(spans.log())
    with cpu_profile():
        out = fn()
    recs = spans.log()[first:]
    return out, [(n, s, e, p - first if p >= first else -1, a)
                 for n, s, e, p, a in recs]


def test_nothing_is_kept_without_a_profiler():
    assert spans.span("a") is spans.span("b", rows=3)
    before = spans.log()
    with spans.span("a") as attrs:
        assert attrs is None
    runner.run_batch("mask", MIXES, cycles=3, device="cpu")
    assert spans.log() == before


def test_a_pass_records_its_runner_and_step_spans():
    _, recs = _recorded(
        lambda: runner.run_batch("mask", MIXES, cycles=3, device="cpu"))
    names = [r[0] for r in recs]
    assert names.count("sim.pass") == 1 and names.count("sim.step") == 3
    assert names.count("sim.init_state") == 1
    assert names.count("sim.stats") == len(MIXES)
    (i_pass,) = [i for i, n in enumerate(names) if n == "sim.pass"]
    assert recs[i_pass][3] == -1
    assert recs[i_pass][4] == {"rows": len(MIXES), "cycles": 3}
    steps = [i for i, n in enumerate(names) if n == "sim.step"]
    for i in steps:
        assert recs[i][3] == i_pass
        kids = [j for j, r in enumerate(recs) if r[3] == i]
        assert [names[j] for j in kids] == STAGES
        for j in kids:
            assert recs[i][1] <= recs[j][1] <= recs[j][2] <= recs[i][2]
        # mask runs one fused round a cycle, inside the memory stage
        (rnd,) = [j for j, r in enumerate(recs) if r[0] == "fused_tlb.round"
                  and recs[r[3]][3] == i]
        assert names[recs[rnd][3]] == "sim.step.memory"
    (i_host,) = [i for i, n in enumerate(names) if n == "sim.to_host"]
    assert recs[i_host][3] == i_pass
    cfg = SimConfig(n_apps=2, sim_cycles=3, design="mask", device="cpu")
    st = memsys.init_state(cfg, design_params(cfg.design), rows=len(MIXES))
    leaves = []
    memsys.map_state(leaves.append, st)
    assert len(leaves) == 51
    assert recs[i_host][4] == {
        "bytes": sum(x.numpy().nbytes for x in leaves), "copies": 51}
    assert all(r[3] == -1 for r in recs if r[0] == "sim.stats")


def test_a_pwc_round_is_inside_the_probe_stage():
    _, recs = _recorded(
        lambda: runner.run_batch("pwc", MIXES[:1], cycles=2, device="cpu"))
    parents = sorted(recs[r[3]][0] for r in recs
                     if r[0] == "fused_tlb.round")
    assert parents == ["sim.step.memory"] * 2 + ["sim.step.probe"] * 2


def test_spans_are_on_the_profilers_clock():
    with cpu_profile() as prof:
        with spans.span("outer"):
            with record_function("inner_event"):
                torch.ones(3).sum()
    (rec,) = [r for r in spans.log() if r[0] == "outer"][-1:]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "inner_event"]
    assert rec[1] <= ev.start_ns() <= ev.end_ns() <= rec[2]


def test_summary_self_time_leaves_out_children():
    def nest():
        with spans.span("top", n=2):
            with spans.span("kid"):
                pass
            with spans.span("kid") as attrs:
                attrs["n"] = 5
    _, recs = _recorded(nest)
    top, k1, k2 = recs
    dur = lambda r: r[2] - r[1]  # noqa: E731
    out = spans.summary(recs)
    assert out["top"] == {"count": 1, "total_ns": dur(top),
                          "self_ns": dur(top) - dur(k1) - dur(k2), "n": 2}
    assert out["kid"] == {"count": 2, "total_ns": dur(k1) + dur(k2),
                          "self_ns": dur(k1) + dur(k2), "n": 5}


def test_the_log_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(spans, "_log", collections.deque(maxlen=3))
    monkeypatch.setattr(spans, "_made", 0)
    with cpu_profile():
        with spans.span("a"):
            for name in ("b", "c", "d"):
                with spans.span(name):
                    pass
    # "a" is dropped; its children's parent reads -1
    assert [(n, p) for n, _, _, p, _ in spans.log()] == [
        ("b", -1), ("c", -1), ("d", -1)]
    with cpu_profile():
        with spans.span("e"):
            with spans.span("f"):
                pass
    assert [(n, p) for n, _, _, p, _ in spans.log()] == [
        ("d", -1), ("e", -1), ("f", 1)]


def test_a_grids_stats_are_the_same_under_the_profiler():
    designs, mixes = ["ideal", "mask", "pwc"], MIXES
    plain = runner.run_grid(designs, mixes, cycles=6, device="cpu")
    traced, recs = _recorded(
        lambda: runner.run_grid(designs, mixes, cycles=6, device="cpu"))
    assert sum(r[0] == "sim.step" for r in recs) == 2 * 6
    for a_row, b_row in zip(plain, traced):
        for a, b in zip(a_row, b_row):
            assert set(a) == set(b)
            for k in a:
                x = np.asarray(a[k], np.float64)
                y = np.asarray(b[k], np.float64)
                assert x.shape == y.shape and x.tobytes() == y.tobytes()
