"""Grid rows over several devices (`run_grid` / `sweep` with `devices=N`)
against the reference's sharded grid, on the CPU.

The CPU shows one device to shard over; these tests patch
`runner._visible_devices` where the reference's test forces host devices
with XLA_FLAGS (`tests/test_sharded_grid.py`), so the N shards of a pass
run one after another on the CPU.

* `tests/test_sharded_grid.py`'s law: mask and gpu-mmu x (3DS, BLK),
  (MUM, RED), (3DS, MUM) at 120 cycles with solo baselines, sharded over
  4 == one device, every stat float-hex; the group's 14 rows (7 a
  design, one signature group) are padded to 16 (shards of 4 rows) and
  sliced back; `devices=64` raises ValueError naming it.
* The chunk plan at `devices=4` (the cap is `max_rows * 4`): which
  designs share a pass, the padded rows' knobs and workloads (the shards
  joined in order) and the `FailureRecord`s == the reference's, with the
  reference stubbed at `_compiled_grid_run` (and `_row_sharding`, which
  needs 4 JAX devices) and the port at `_run_rows`: nothing is simulated.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.sim import runner as ref_runner  # noqa: E402
# `repro_torch.core.design` the module: the package binds the name to
# the `design` function, as `repro.core` does
pt_design = importlib.import_module("repro_torch.core.design")
from repro_torch.sim import runner  # noqa: E402
from repro_torch.sim import workloads as pt_wl  # noqa: E402
from tests.test_torch_grid_designs import _plane  # noqa: E402

ref_design = importlib.import_module("repro.core.design")

DESIGNS = ["mask", "gpu-mmu"]
MIXES = [("3DS", "BLK"), ("MUM", "RED"), ("3DS", "MUM")]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def four_devices(monkeypatch):
    monkeypatch.setattr(runner, "_visible_devices", lambda dev: 4)


def _hex(x):
    return [float(v).hex() for v in np.atleast_1d(x).ravel()]


def test_sharded_sweep_matches_single_device(four_devices, monkeypatch):
    kw = dict(cycles=120, solo_baselines=True, grid=True, device="cpu")
    single = runner.sweep(DESIGNS, MIXES, **kw)
    shards = []
    run_rows = runner._run_rows

    def counted(cfg, dp, mixes):
        shards.append(len(mixes))
        return run_rows(cfg, dp, mixes)

    monkeypatch.setattr(runner, "_run_rows", counted)
    sharded = runner.sweep(DESIGNS, MIXES, devices=4, **kw)
    # mask and gpu-mmu share a signature group: 2 x (3 mixes + 4 solo
    # rows) = 14 rows, padded to 16, 4 shards of 4
    assert shards == [4] * 4
    for name in single:
        ra, rb = single[name], sharded[name]
        assert len(ra) == len(rb) == 3
        for xa, xb in zip(ra, rb):
            for k in xa.raw:
                assert _hex(xa.raw[k]) == _hex(xb.raw[k]), (name, k)
        assert ra.solo_ipc == rb.solo_ipc, name
    with pytest.raises(ValueError, match="devices=64"):
        runner.run_grid(DESIGNS, MIXES, cycles=120, devices=64, device="cpu")


def test_pad_rows_repeats_the_first_rows():
    assert runner._pad_rows(list("abcdefg"), 4) == list("abcdefga")
    assert runner._pad_rows(list("ab"), 4) == list("abab")
    assert runner._pad_rows(list("abcd"), 4) == list("abcd")


def test_shard_devices():
    assert runner._shard_devices("cpu", 1) == [torch.device("cpu")]
    with pytest.raises(ValueError, match="devices=3"):
        runner._shard_devices("cpu", 3)


class _Stop(RuntimeError):
    pass


def _ref_stub(calls):
    def compiled(ccfg):
        def run(dp_stack, pm_stack):
            calls.append((jax.device_get(dp_stack), np.asarray(pm_stack)))
            raise _Stop("stubbed pass")
        return run
    return compiled


def _port_stub(calls, n):
    """Records each shard; the last shard of a pass raises, as the
    reference's stubbed pass does."""
    shards = []

    def run_rows(cfg, dp, mixes):
        shards.append((_plane(dp, len(mixes)),
                       np.stack([pt_wl.app_matrix(list(m)) for m in mixes])))
        if len(shards) < n:
            return None
        planes, pms = zip(*shards)
        shards.clear()
        calls.append((pt_design.DesignParams(*(
            np.concatenate(leaves) for leaves in zip(*planes))),
            np.concatenate(pms)))
        raise _Stop("stubbed pass")
    return run_rows


@pytest.mark.parametrize("names, M, max_rows", [
    (["mask", "gpu-mmu", "static", "mask-tlb", "mask-cache", "mask-dram"],
     5, 4),
    (list(ref_design.list_designs()), 3, 2),
    (list(ref_design.list_designs()), 10, 64),
    (["mask", "mask-tlb", "mask-cache", "mask-dram"], 5, 10),
])
def test_chunk_plans_at_four_devices_match_reference(four_devices,
                                                     monkeypatch, names, M,
                                                     max_rows):
    pt_ds = [pt_design.get_design(n) for n in names]
    ref_ds = [ref_design.get_design(n) for n in names]
    mixes = pt_wl.pair_workloads(n_pairs=M)
    got_calls, want_calls = [], []
    monkeypatch.setattr(runner, "_run_rows", _port_stub(got_calls, 4))
    monkeypatch.setattr(ref_runner, "_compiled_grid_run",
                        _ref_stub(want_calls))
    monkeypatch.setattr(ref_runner, "_row_sharding",
                        lambda n: jax.sharding.SingleDeviceSharding(
                            jax.devices()[0]))
    got = runner.run_grid(pt_ds, mixes, cycles=5, max_rows=max_rows,
                          devices=4, fail_soft=True, device="cpu")
    want = ref_runner.run_grid(ref_ds, mixes, cycles=5, max_rows=max_rows,
                               devices=4, fail_soft=True)
    assert len(got_calls) == len(want_calls) > 0
    for (dp, pm), (ref_dp, ref_pm) in zip(got_calls, want_calls):
        assert len(pm) % 4 == 0
        for f in ref_design.DesignParams._fields:
            a, b = getattr(dp, f), np.asarray(getattr(ref_dp, f))
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(pm, ref_pm)
    for a_row, b_row in zip(got, want):
        for a, b in zip(a_row, b_row):
            assert isinstance(a, runner.FailureRecord)
            assert (a.designs, a.n_apps, a.cycles, a.error_type, a.message,
                    a.stage) == (b.designs, b.n_apps, b.cycles,
                                 b.error_type, b.message, b.stage)
