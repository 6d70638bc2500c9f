"""The port's `run_mix` against the reference's float-hex goldens (CPU).

The 9 `GOLDEN` pins of `tests/test_memsys_stages.py` (8 designs at 1200
cycles, plus `mask@9000`, which crosses an epoch) must reproduce bit for
bit through `repro_torch.sim.runner.run_mix(..., device="cpu")`. The
pins are loaded from that file by path, so there is one copy of them.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sim import runner as ref_runner  # noqa: E402
from repro_torch.core.design import design_params, get_design  # noqa: E402
from repro_torch.sim import runner  # noqa: E402
from repro_torch.sim.config import SimConfig  # noqa: E402
from repro_torch.sim.convert import state_to_numpy  # noqa: E402
from repro_torch.sim.workloads import IDLE_ROW, make_app  # noqa: E402

CYCLES = 300


def _load_golden():
    path = Path(__file__).with_name("test_memsys_stages.py")
    spec = importlib.util.spec_from_file_location("_memsys_stage_pins", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GOLDEN


GOLDEN = _load_golden()


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("entry", sorted(GOLDEN))
def test_goldens_float_hex(entry):
    name, _, cyc = entry.partition("@")
    s = runner.run_mix(name, ["3DS", "BLK"], cycles=int(cyc) if cyc else 1200,
                       device="cpu")
    for key, want in GOLDEN[entry].items():
        got = [x.hex() for x in
               np.asarray(s[key], np.float64).ravel().tolist()]
        assert got == want, f"{entry}:{key} drifted: {got} != {want}"


def _direct_run(name, rows, cycles):
    """Explicit config + explicit matrix + the bare cycle loop: bypasses
    run_mix's plumbing so the wrapper tests are not tautologies."""
    cfg = SimConfig(n_apps=len(rows), sim_cycles=cycles,
                    design=get_design(name), device="cpu")
    pm = torch.tensor(np.stack(rows))
    return runner._stats(cfg, state_to_numpy(
        runner.simulate(cfg, design_params(cfg.design), pm)))


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_run_mix_matches_run_pair_bitforbit():
    p = runner.run_pair("mask", "3DS", "BLK", cycles=CYCLES, device="cpu")
    m = runner.run_mix("mask", ["3DS", "BLK"], cycles=CYCLES, device="cpu")
    _assert_same(p, m)
    _assert_same(m, _direct_run("mask", [make_app("3DS").as_array(),
                                         make_app("BLK").as_array()], CYCLES))


def test_run_mix_idle_partner_matches_run_solo():
    s = runner.run_solo("gpu-mmu", "3DS", cycles=CYCLES, device="cpu")
    m = runner.run_mix("gpu-mmu", ["3DS", None], cycles=CYCLES, device="cpu")
    _assert_same(s, m)
    _assert_same(m, _direct_run("gpu-mmu", [make_app("3DS").as_array(),
                                            IDLE_ROW], CYCLES))


def test_run_mix_three_apps_finite():
    s = runner.run_mix("mask", ["3DS", "HISTO", "BLK"], cycles=CYCLES,
                       device="cpu")
    assert s["ipc"].shape == s["l1_hit_rate"].shape == s["tokens"].shape \
        == (3,)
    assert np.all(s["ipc"] > 0)
    for k, v in s.items():
        assert np.all(np.isfinite(np.asarray(v, np.float64))), k


def test_zero_cycles_raise():
    with pytest.raises(runner.ZeroCycleError):
        runner.run_mix("gpu-mmu", ["3DS", "BLK"], cycles=0, device="cpu")


def test_speedup_and_slowdown_match_reference():
    mix = {"ipc": np.asarray([12.5, 3.25])}
    solos = ({"ipc": np.asarray([20.0, 9.0])}, {"ipc": np.asarray([4.0, 1.0])})
    assert runner.weighted_speedup(mix, *solos) == \
        ref_runner.weighted_speedup(mix, *solos)
    assert runner.max_slowdown(mix, *solos) == \
        ref_runner.max_slowdown(mix, *solos)
