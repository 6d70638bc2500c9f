"""The harness end to end on the CPU, each cell cut to the size its entry
type gives the dry run (`TESTS.dry_run`: the simulator's at a handful of
rows and a few cycles): each cell's traffic resolves, the result line has
the contract's keys, a traced run reports every per-layer metric named
for the cell; and a configuration, a traffic mix, an entry type and a
metric can be added as new files with no edit to a file that is there,
the new kind of cell going through the control and the per-cell tests."""
import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness, mixes, test_portbench_faults

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def quiet(msg):
    pass


def check_dry_run(cell, traced, bench=BENCH, root=ROOT):
    """One CPU run of `cell` of `bench` (files under `root`) at its entry
    type's dry-run size: the contract's keys, correct, every metric."""
    shrink = test_portbench_faults.entry_tests(cell, bench, root).dry_run
    result, checks = harness.run_cell(cell, 2**31 + 11, 0.0, traced,
                                      device="cpu", bench=bench, root=root,
                                      shrink=shrink, log=quiet)
    assert list(result)[:5] == ["correct", "attempted", "failed",
                                "metrics", "device"]
    assert list(result)[-1] == "checks" and result["checks"] == checks
    assert result["correct"] is True and result["failed"] == 0
    kind = "per_layer" if traced else "end_to_end"
    want = {m["name"] for m in harness.metrics_of(bench, cell, kind)}
    assert set(result["metrics"]) == want and want
    for m in result["metrics"].values():
        assert m["value"] is not None and m["unit"]
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        assert 0 < len(result["breakdown"]["device_ops"]) <= 10
        assert 0 < len(result["breakdown"]["idle_gaps"]) <= 10
    json.dumps(result)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(cell, traced):
    check_dry_run(cell, traced)


def test_every_seed_gives_the_same_rows():
    rows = mixes.rows(3, {"bundles": "all", "solo_rows": True})
    assert len(rows) == 2300 + 25 and len(set(rows)) == len(rows)
    for seed in (0, 2**31 + 7, -5):
        a, b = mixes.order(rows, seed, 0), mixes.order(rows, seed, 1)
        assert sorted(a, key=str) == sorted(rows, key=str) and a != b
        assert a == mixes.order(rows, seed, 0)


def test_pairs_cover_the_pair_space():
    rows = mixes.rows(2, {"bundles": "all", "solo_rows": True})
    assert len(rows) == 300 + 25
    paper = json.loads((HERE / "traffic" / "sweep2-paper35.json")
                       .read_text())
    drawn = mixes.rows(2, paper)
    assert len(set(drawn)) == len(drawn) == 35 + 25
    assert {frozenset(m) for m in drawn[:35]} <= {frozenset(m)
                                                  for m in rows}
    assert set(drawn[35:]) <= set(rows)
    # the paper's own pairs, as the program's sweep draws them
    from repro_torch.sim.workloads import pair_workloads
    assert drawn[:35] == pair_workloads(7, 35)


def test_a_bundle_that_is_no_mix_is_refused():
    for bad in ([["BFS2", "BFS2"]], [["BFS2", "NOPE"]], [["BFS2"]]):
        with pytest.raises(ValueError):
            mixes.rows(2, {"bundles": bad})


def _digest(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_as_new_files(tmp_path):
    """A new configuration, traffic mix, entry type and per-layer metric,
    each a new file plus new entries in a copy of BENCHMARK.json, run
    through the harness as it is."""
    before = _digest(HERE)
    for sub in ("configs", "traffic", "entries", "metrics"):
        shutil.copytree(HERE / sub, tmp_path / "portbench" / sub)
    new = tmp_path / "portbench"
    cfg = json.loads((HERE / "configs" / "table1-2app.json").read_text())
    (new / "configs" / "tiny-2app.json").write_text(json.dumps(
        dict(cfg, name="tiny-2app", sim_cycles=7)))
    (new / "traffic" / "few-pairs.json").write_text(json.dumps({
        "entry": "each", "designs": ["gpu-mmu", "mask"],
        "bundles": [["BFS2", "CONS"], ["MM", "NW"], ["RAY", "BLK"]],
        "solo_rows": False}))
    (new / "entries" / "each.py").write_text(
        "from portbench.entries import _sim\n\n\n"
        "def make(config, traffic, device, shrink=None):\n"
        "    from repro_torch.sim import runner\n"
        "    designs = list(traffic['designs'])\n\n"
        "    def run(mixes, cycles):\n"
        "        return {d: runner.run_batch(d, mixes, cycles,"
        " device=device) for d in designs}\n\n"
        "    return _sim.sim_entry(config, traffic, device, designs, run,"
        " shrink)\n")
    (new / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return len(run.trace.calls) if run.trace"
        " else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tiny-2app", "source": "a test",
                             "file": "portbench/configs/tiny-2app.json",
                             "reduced": ["sim_cycles"], "why": "a test"})
    bench["workloads"].append({"name": "tiny.few", "config": "tiny-2app",
                               "traffic": "few-pairs", "chips": 1,
                               "why": "a test"})
    (rate,) = [m for m in bench["end_to_end"]
               if m["name"] == "row_cycles_per_s"]
    rate["workloads"].append("tiny.few")
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "program_span",
                               "layer": "runner", "moves":
                               "row_cycles_per_s", "workloads":
                               ["tiny.few"]})
    for traced in (False, True):
        result, _ = harness.run_cell("tiny.few", 5, 0.0, traced,
                                     device="cpu", bench=bench,
                                     root=tmp_path, log=quiet)
        assert result["correct"] is True
        assert result["attempted"] == 2 * 3
        if traced:
            assert result["metrics"]["calls_in_window"]["value"] == 1
            assert "kernels_per_cycle" not in result["metrics"]
        else:
            assert set(result["metrics"]) == {"row_cycles_per_s",
                                              "setup_s"}
    assert _digest(HERE) == before


SOLVE_ENTRY = '''"""A cell of another kind than the simulator's: batched
linear solves in float64, judged against NumPy's."""
import numpy as np
import torch

from portbench.entries import Entry, Fault, Tests


def make(config, traffic, device, shrink=None, dtype=torch.float64):
    n, batch = config["n"], (shrink or traffic)["batch"]

    def plan(seed, k):
        rng = np.random.default_rng([seed & (2**64 - 1), k])
        a = rng.standard_normal((batch, n, n)) + n * np.eye(n)
        return a, rng.standard_normal((batch, n, 1))

    def call(p):
        a, b = (torch.tensor(x, device=device, dtype=dtype) for x in p)
        return torch.linalg.solve(a, b).double().cpu().numpy()

    def check(calls):
        done = [c for c in calls if c.results is not None]
        errs = np.array([float(np.abs(x - y).max()) for c in done
                         for x, y in zip(c.results,
                                         np.linalg.solve(*c.plan))])
        missing = batch * (len(calls) - len(done))
        return {"solves_mismatched": {"value": int((errs > 1e-9).sum()),
                                      "limit": 0},
                "solves_missing": {"value": missing, "limit": 0},
                "max_abs_err": {"value": float(errs.max(initial=0.0)),
                                "limit": 1e-9}}, missing

    return Entry(answers=batch, work=batch, plan=plan, call=call,
                 warm=lambda: call(plan(0, 0)), check=check)


def control(config, traffic, device, shrink=None):
    """The solves in float32, the precision below float64."""
    return make(config, traffic, device, shrink, dtype=torch.float32)


def _answer_altered(monkeypatch, shrink):
    real = torch.linalg.solve
    monkeypatch.setattr(torch.linalg, "solve",
                        lambda a, b: real(a, b) + 1e-6)


TESTS = Tests(dry_run={"batch": 4}, faults_shrink={"batch": 3},
              faults=(Fault(_answer_altered, ("solves_mismatched",)),),
              control_checks=("solves_mismatched",))
'''


def test_a_cell_of_another_kind_is_added_as_new_files(tmp_path):
    """A kind of work that is no simulator (its own inputs, set-up,
    reference and comparison, in its entry type), a configuration, a
    traffic mix and an end-to-end and a per-layer metric of its own, each
    a new file plus new entries in a copy of BENCHMARK.json, run through
    the harness as it is, and through the control and the per-cell tests
    (`check_dry_run`, `test_portbench_faults`'s checks) in the copy."""
    before = _digest(HERE)
    for sub in ("configs", "traffic", "entries", "metrics"):
        shutil.copytree(HERE / sub, tmp_path / "portbench" / sub)
    new = tmp_path / "portbench"
    (new / "configs" / "solve-8.json").write_text(json.dumps({"n": 8}))
    (new / "traffic" / "solve-batch.json").write_text(json.dumps({
        "entry": "solve", "batch": 16}))
    (new / "entries" / "solve.py").write_text(SOLVE_ENTRY)
    (new / "metrics" / "solves_per_s.py").write_text(
        "def read(run):\n    w = sum(c.work for c in run.calls)\n"
        "    return w / (run.calls[-1].end - run.calls[0].start)\n")
    (new / "metrics" / "calls_traced.py").write_text(
        "def read(run):\n    return len(run.trace.calls) if run.trace"
        " else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "solve-8", "source": "a test",
                             "file": "portbench/configs/solve-8.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "solve.batch", "config": "solve-8",
                               "traffic": "solve-batch", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "solves_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["solve.batch"]})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "higher", "source": "program_span",
                               "layer": "solver", "moves": "solves_per_s",
                               "workloads": ["solve.batch"]})
    for traced in (False, True):
        result, checks = harness.run_cell("solve.batch", 2**31 + 9, 0.0,
                                          traced, device="cpu",
                                          bench=bench, root=tmp_path,
                                          log=quiet)
        assert result["correct"] is True and result["failed"] == 0
        assert result["attempted"] == 16
        assert checks["max_abs_err"]["value"] < 1e-9
        if traced:
            assert set(result["metrics"]) == {"calls_traced"}
            assert result["device"]["busy_s"] > 0
        else:
            assert set(result["metrics"]) == {"setup_s", "solves_per_s"}
    faults = test_portbench_faults
    for traced in (False, True):
        check_dry_run("solve.batch", traced, bench, tmp_path)
    faults.check_sound("solve.batch", bench, tmp_path)
    faults.check_control("solve.batch", bench, tmp_path)
    (fault,) = faults.entry_tests("solve.batch", bench, tmp_path).faults
    with pytest.MonkeyPatch.context() as mp:
        faults.check_fault("solve.batch", fault, mp, bench, tmp_path)
    assert _digest(HERE) == before
