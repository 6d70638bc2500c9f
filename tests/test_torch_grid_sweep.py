"""The port's sweep layer against the reference's laws (CPU).

No JAX simulator runs here (each costs minutes of compile); the port is
held to its own per-design loop, to the reference's pure-Python layers
on the same raw stats, and to the reference's laws:

* grid == loop, float-hex, over the 8 designs x n_apps in {1, 2};
* `sweep` == the per-design `Experiment` loop, and the port's
  `MixResult` / `ExperimentResult` / `AppStats` give the reference's
  numbers on the same raw stats;
* `TRACE_COUNT` (plans): an 8-design x 2-mix sweep sets up 2, a
  re-sweep 0; a `predict_mixes` loop with `pad_rows` 1;
* `predict_mixes` == the reference's on one canned grid (both runners'
  `run_grid` replaced by it): slot and row padding, `solo_cache`,
  `FailureRecord` propagation;
* the fail-soft laws of `tests/test_failsoft.py` on the poisoned design;
* `run_grid` chunks a signature group as the reference does: a design's
  mixes are never split (67 mixes, past the 64-row cap: one pass of 67
  rows per design, counted at `runner._grid_pass`), and a failing pass's
  `FailureRecord` fills all of its cells.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.mask import ALL_DESIGNS  # noqa: E402
from repro.sim import runner as ref_runner  # noqa: E402
from repro_torch.core.design import get_design  # noqa: E402
from repro_torch.sim import runner  # noqa: E402
from repro_torch.sim.runner import (Experiment, ExperimentResult,  # noqa: E402
                                    FailureRecord, ZeroCycleError,
                                    run_grid, run_mix, sweep)

CYC = 150
MIXES = [("3DS", "BLK"), ("MUM", "RED")]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hexed(s):
    return {k: [x.hex() for x in np.asarray(v, np.float64).ravel().tolist()]
            for k, v in s.items()}


@pytest.mark.parametrize("mixes", [[("3DS",), ("BLK",)],
                                   [("3DS", "BLK"), ("MUM", None)]])
def test_grid_matches_loop_float_hex(mixes):
    """run_grid over all 8 designs, two rows a pass == per-design run_mix,
    float-hex."""
    grid = run_grid(list(ALL_DESIGNS), mixes, cycles=CYC, device="cpu")
    for i, name in enumerate(ALL_DESIGNS):
        for m, mix in enumerate(mixes):
            loop = _hexed(run_mix(name, list(mix), cycles=CYC, device="cpu"))
            assert _hexed(grid[i][m]) == loop, f"{name} {mix} drifted"


def _count_passes(monkeypatch):
    """Record every pass `run_grid` makes: (its designs, its rows)."""
    passes = []
    grid_pass = runner._grid_pass

    def counted(ccfg, designs, mixes):
        passes.append((tuple(d.name for d in designs),
                       len(designs) * len(mixes)))
        return grid_pass(ccfg, designs, mixes)

    monkeypatch.setattr(runner, "_grid_pass", counted)
    return passes


def test_run_grid_chunks_equal_width(monkeypatch):
    """A design's mixes are never split, as in the reference: 5 mixes with
    max_rows=2 run as one pass of 5 rows, reuse the 5-row plan, and give
    the grid's cells without the cap."""
    mixes = [("3DS", "BLK"), ("MUM", "RED"), ("BLK", None), ("3DS", None),
             ("RED", "MUM")]
    whole = run_grid(["mask"], mixes, cycles=40, device="cpu")[0]
    before = runner.TRACE_COUNT
    passes = _count_passes(monkeypatch)
    capped = run_grid(["mask"], mixes, cycles=40, max_rows=2,
                      device="cpu")[0]
    for a, b in zip(whole, capped):
        assert _hexed(a) == _hexed(b)
    assert passes == [(("mask",), 5)]
    assert runner.TRACE_COUNT == before


def test_run_grid_one_pass_per_design(monkeypatch):
    """67 mixes (prime, past the 64-row cap): one pass of 67 rows per
    design (`max_rows // M` rounds up to one design a pass), where
    chunking rows by divisors would make 67 passes of one row; a poisoned
    design's `FailureRecord` fills all 67 of its cells."""
    from repro_torch.sim.workloads import pair_workloads
    mixes = pair_workloads(n_pairs=67)
    passes = _count_passes(monkeypatch)
    out = run_grid(["mask", "pwc", _poison()], mixes, cycles=3,
                   fail_soft=True, device="cpu")
    assert passes == [(("mask",), 67), (("pwc",), 67), (("poison",), 67)]
    assert all(len(row) == 67 for row in out)
    for row in out[:2]:
        assert all(np.isfinite(c["ipc"]).all() and c["cycles"] == 3.0
                   for c in row)
    rec = out[2][0]
    assert isinstance(rec, FailureRecord) and rec.designs == ("poison",)
    assert all(c is rec for c in out[2])


def test_sweep_grid_matches_experiment_loop():
    """Grid-path sweep == per-design Experiment loop: same raw stats
    (float-hex), same derived metrics, same solo-baseline bookkeeping."""
    designs = ["ideal", "gpu-mmu", "mask"]
    g = sweep(designs, MIXES, cycles=CYC, device="cpu")
    assert set(g) == set(designs)
    for name in designs:
        ell = Experiment(name, MIXES, cycles=CYC, device="cpu").run()
        gres = g[name]
        assert gres.solo_ipc == ell.solo_ipc
        assert len(gres) == len(ell)
        for rg, rl in zip(gres, ell):
            assert rg.benches == rl.benches
            assert _hexed(rg.raw) == _hexed(rl.raw)
            assert rg.weighted_speedup() == rl.weighted_speedup()
            assert rg.unfairness() == rl.unfairness()


def _fake_stats(mix, salt=0):
    """A deterministic raw stats dict for a mix: the reference's keys."""
    n = len(mix)
    h = np.array([sum(map(ord, b or "-")) + 7 * i + salt
                  for i, b in enumerate(mix)], np.float64)
    keys = ("l1_hit_rate", "l1_miss_rate", "l2_hit_rate", "l2_miss_rate",
            "byp_hit_rate", "walk_lat", "walks", "stalls_per_miss",
            "dram_tlb_lat", "dram_data_lat", "dram_tlb_n", "dram_data_n")
    out = {k: (h * (j + 3)) % 101 / 97.0 for j, k in enumerate(keys)}
    out["ipc"] = np.where([b is None for b in mix], 0.001, h % 53 + 1.5)
    out["tokens"] = np.full(n, 30 + salt, np.int32)
    out["l2c_tlb_hit_rate"] = np.asarray(h.sum() % 89 / 89.0)
    out["l2c_data_hit_rate"] = np.asarray(h.sum() % 83 / 83.0)
    out["cycles"] = 100.0
    return out


def test_result_types_match_reference_on_same_stats():
    """The port's typed layer (_mix_plan, _assemble_result, MixResult,
    ExperimentResult, AppStats) gives the reference's numbers."""
    mixes = runner._normalize_mixes(["3DS", ("3DS", "BLK"), ("MUM", None),
                                     ("BLK", "RED", "MUM"), ("RED",)])
    assert mixes == ref_runner._normalize_mixes(
        ["3DS", ("3DS", "BLK"), ("MUM", None), ("BLK", "RED", "MUM"),
         ("RED",)])
    plans = runner._mix_plan(mixes, True)
    rplans = ref_runner._mix_plan(mixes, True)
    assert {n: tuple(p) for n, p in plans.items()} == \
        {n: tuple(p) for n, p in rplans.items()}
    stats = {n: [_fake_stats(m, salt=n) for m in p.rows]
             for n, p in plans.items()}
    d = get_design("mask")
    got = runner._assemble_result(d, 100, len(mixes), plans, stats)
    want = ref_runner._assemble_result(d, 100, len(mixes), rplans, stats)
    assert got.solo_ipc == want.solo_ipc and len(got) == len(want)
    assert got.mean_weighted_speedup() == want.mean_weighted_speedup()
    assert got.mean_unfairness() == want.mean_unfairness()
    for a, b in zip(got, want):
        assert a.benches == b.benches and a.cycles == b.cycles
        assert [dataclasses.asdict(x) for x in a.apps] == \
            [dataclasses.asdict(x) for x in b.apps]
        assert a.weighted_speedup() == b.weighted_speedup()
        assert a.unfairness() == a.max_slowdown() == b.unfairness()
        assert a.l2c_tlb_hit_rate == b.l2c_tlb_hit_rate
        assert a.l2c_data_hit_rate == b.l2c_data_hit_rate
        assert [x.bench for x in a.real_apps] == \
            [x.bench for x in b.real_apps]
        first = a.benches[0]
        assert a.app(first).speedup == b.app(first).speedup
        assert a.app(first).slowdown == b.app(first).slowdown
        assert a["ipc"] is a.raw["ipc"]
    with pytest.raises(KeyError):
        got[0].app("NW")
    bare = runner._assemble_result(
        d, 100, len(mixes), runner._mix_plan(mixes, False),
        {n: [_fake_stats(m) for m in p.rows]
         for n, p in runner._mix_plan(mixes, False).items()})
    with pytest.raises(ValueError, match="solo baselines"):
        bare[1].apps[0].speedup
    with pytest.raises(TypeError, match="bare string"):
        runner._normalize_mixes("3DS")
    with pytest.raises(ValueError):
        runner._normalize_mixes([])


def test_full_sweep_sets_up_one_plan_per_signature_group():
    """The 8-design x 2-mix sweep (solo baselines included, 6 rows a pass)
    sets up len(signature groups) == 2 plans; re-running it none."""
    cycles = 23           # unique -> cannot reuse another test's plans
    before = runner.TRACE_COUNT
    res = sweep(list(ALL_DESIGNS), MIXES, cycles=cycles, device="cpu")
    assert runner.TRACE_COUNT - before == 2
    assert set(res) == set(ALL_DESIGNS)
    again = sweep(list(ALL_DESIGNS), MIXES, cycles=cycles, device="cpu")
    assert runner.TRACE_COUNT - before == 2, "a re-sweep set up a plan"
    for name in ALL_DESIGNS:
        for a, b in zip(res[name], again[name]):
            assert _hexed(a.raw) == _hexed(b.raw)


def test_predict_mixes_pad_rows_one_plan():
    cycles = 19
    cands = [("3DS",), ("BLK",), ("3DS", "BLK")]
    before = runner.TRACE_COUNT
    first = runner.predict_mixes("mask", cands, cycles=cycles, pad_rows=8,
                                 device="cpu")
    assert runner.TRACE_COUNT - before == 1
    cache = {}
    second = runner.predict_mixes("mask", cands, cycles=cycles, pad_rows=8,
                                  solo_cache=cache, device="cpu")
    third = runner.predict_mixes("mask", [("BLK", "3DS")], cycles=cycles,
                                 pad_rows=8, solo_cache=cache, device="cpu")
    assert runner.TRACE_COUNT - before == 1
    assert first == second and set(cache) == {"3DS", "BLK"}
    assert third[0].solo_ipc == (cache["BLK"], cache["3DS"])


def _canned_grid(calls, record):
    """A stand-in for run_grid: deterministic stats per row; a row holding
    "NW" fails (a `record` when fail_soft, else raises)."""
    def grid(designs, rows, cycles=60_000, max_rows=64, devices=None,
             fail_soft=False, **_):
        calls.append((len(designs), tuple(rows), cycles))
        out = []
        for r in rows:
            if "NW" in r:
                if not fail_soft:
                    raise RuntimeError("poisoned row")
                out.append(record(("d",), len(r), cycles, "RuntimeError",
                                  "poisoned row", "grid-chunk"))
            else:
                out.append(_fake_stats(r))
        return [out]
    return grid


@pytest.mark.parametrize("kw", [
    dict(), dict(slots=3), dict(pad_rows=4), dict(pad_rows=8, slots=4),
    dict(fail_soft=True, nw=True), dict(fail_soft=True, nw=True, pad_rows=5),
])
def test_predict_mixes_matches_reference_on_canned_grid(monkeypatch, kw):
    kw = dict(kw)
    mixes = [("3DS",), ("BLK", "3DS"), ("MUM", None, "RED"), ("BLK",)]
    if kw.pop("nw", False):
        mixes += [("NW", "3DS"), ("RED",)]
    calls, ref_calls = [], []
    monkeypatch.setattr(runner, "run_grid",
                        _canned_grid(calls, FailureRecord))
    monkeypatch.setattr(ref_runner, "run_grid",
                        _canned_grid(ref_calls, ref_runner.FailureRecord))
    for seed_cache in ({}, {"3DS": 2.25}):
        cache, ref_cache = dict(seed_cache), dict(seed_cache)
        got = runner.predict_mixes("mask", mixes, cycles=77,
                                   solo_cache=cache, device="cpu", **kw)
        want = ref_runner.predict_mixes("mask", mixes, cycles=77,
                                        solo_cache=ref_cache, **kw)
        assert calls == ref_calls and cache == ref_cache
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert type(a).__name__ == type(b).__name__
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert runner.predict_mixes("mask", [], device="cpu") == []
    with pytest.raises(ValueError, match="slots"):
        runner.predict_mixes("mask", mixes, slots=1, device="cpu")
    with pytest.raises(ValueError, match="at least one bench"):
        runner.predict_mixes("mask", [(None,)], device="cpu")


# ------------------------------------------------------------- fail-soft

def _poison():
    mask = get_design("mask")
    return dataclasses.replace(
        mask, name="poison",
        translation=dataclasses.replace(mask.translation, l2_ways=0))


def test_grid_sweep_completes_around_poisoned_design():
    out = sweep(["gpu-mmu", "mask", _poison()], MIXES, cycles=30,
                fail_soft=True, device="cpu")
    assert isinstance(out["gpu-mmu"], ExperimentResult)
    assert isinstance(out["mask"], ExperimentResult)
    rec = out["poison"]
    assert isinstance(rec, FailureRecord)
    assert rec.error_type == "ZeroDivisionError"
    assert rec.designs == ("poison",) and rec.n_apps == 2
    assert not rec and out["mask"]
    with pytest.raises(RuntimeError, match="poison"):
        rec.reraise()
    assert out["mask"].mean_weighted_speedup() > 0


def test_fail_soft_default_still_raises():
    with pytest.raises(ZeroDivisionError):
        sweep(["gpu-mmu", _poison()], MIXES, cycles=30, device="cpu")
    with pytest.raises(ZeroDivisionError):
        run_grid([_poison()], MIXES, cycles=30, device="cpu")


def test_run_grid_fail_soft_cells():
    out = run_grid(["mask", _poison()], MIXES, cycles=30, fail_soft=True,
                   device="cpu")
    assert all(isinstance(c, dict) for c in out[0])
    assert all(isinstance(c, FailureRecord) for c in out[1])
    assert out[1][0].stage == "grid-chunk"
    assert np.isfinite(out[0][0]["ipc"]).all()


def test_experiment_fail_soft():
    exp = Experiment(_poison(), MIXES, cycles=30, device="cpu")
    with pytest.raises(ZeroDivisionError):
        exp.run()
    rec = exp.run(fail_soft=True)
    assert isinstance(rec, FailureRecord)
    assert rec.stage == "experiment-batch"
    out = sweep(["mask", _poison()], MIXES, cycles=30, grid=False,
                fail_soft=True, device="cpu")
    assert isinstance(out["mask"], ExperimentResult)
    assert isinstance(out["poison"], FailureRecord)


def test_zero_cycle_guards():
    with pytest.raises(ZeroCycleError, match="IPC"):
        run_mix("gpu-mmu", ["3DS", "BLK"], cycles=0, device="cpu")
    rec = sweep(["gpu-mmu"], MIXES, cycles=0, fail_soft=True,
                device="cpu")["gpu-mmu"]
    assert isinstance(rec, FailureRecord)
    assert rec.error_type == "ZeroCycleError"
    with pytest.raises(ValueError, match="duplicate"):
        sweep(["mask", "mask"], MIXES, cycles=1, device="cpu")
    with pytest.raises(ValueError, match="same size"):
        run_grid(["mask"], [("3DS",), ("3DS", "BLK")], cycles=1,
                 device="cpu")
