"""`correct` refuses what it must, on the CPU at a size a test run holds:
the control (the reference in bfloat16 in the program's place), and each
fault the cells can have, planted under a run that skips the look for a
card and drives the rest: a step that returns its state unchanged, half
of the rows left out with the other half's answers in their place, and
one answer altered where it is produced. (One chip: no exchange between
chips to leave out.) A sound run of the same size is correct."""
import numpy as np
import pytest
import torch

from portbench import control, harness

# cycle counts no other test file runs the port at
SHRINK = {"rows": 5, "cycles": 19, "warm_cycles": 17}
CELLS = [w["name"] for w in harness.load_bench()["workloads"]]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run(cell, seed=2**31 + 3):
    return harness.run_cell(cell, seed, 0.0, False, device="cpu",
                            shrink=SHRINK, log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, checks = run(cell)
    assert result["correct"] is True
    assert checks["rows_mismatched"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(cell):
    result, checks = control.run(cell, 2**31 + 5, "cpu", shrink=SHRINK)
    assert result["correct"] is False
    assert checks["rows_mismatched"]["value"] > 0


def timed(cfg) -> bool:
    """Whether a config is the timed calls' (set-up's warm call is not)."""
    return cfg.sim_cycles == SHRINK["cycles"]


def _unchanged_step(monkeypatch):
    from repro_torch.sim import runner
    real = runner.step
    monkeypatch.setattr(runner, "step", lambda cfg, dp, pm, st, c: st
                        if timed(cfg) else real(cfg, dp, pm, st, c))


def _half_the_rows(monkeypatch):
    from repro_torch.sim import runner
    real = runner._run_rows

    def half(cfg, dp, mixes):
        if not timed(cfg):
            return real(cfg, dp, mixes)
        keep = (len(mixes) + 1) // 2
        if not isinstance(dp.use_pwc, torch.Tensor):
            final = real(cfg, dp, mixes[:keep])
        else:   # per-row knobs: cut them with the rows
            dp = type(dp)(*(k[:keep] if isinstance(k, torch.Tensor) else k
                            for k in dp))
            final = real(cfg, dp, mixes[:keep])
        idx = np.arange(len(mixes)) % keep
        return type(final)(*_take(final, idx))
    monkeypatch.setattr(runner, "_run_rows", half)


def _take(tree, idx):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [type(x)(*_take(x, idx)) if isinstance(x, tuple) else
                x[idx] for x in tree]
    return tree[idx]


def _altered_answer(monkeypatch):
    from repro_torch.sim import runner
    real = runner._stats
    seen = []

    def stats(cfg, st, audit=None):
        out = real(cfg, st, audit)
        seen.append(timed(cfg))
        if sum(seen) == 2 and seen[-1]:   # one row's answer, one ulp off
            out["ipc"] = np.nextafter(out["ipc"], np.inf)
        return out
    monkeypatch.setattr(runner, "_stats", stats)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_the_rows,
                                   _altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_refused(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, checks = run(cell)
    assert result["correct"] is False
    assert (checks["rows_mismatched"]["value"]
            + checks["rows_missing"]["value"]) > 0
