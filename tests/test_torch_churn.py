"""The port's churn layer against the reference (CPU): `churn_schedule`,
`memsys.apply_membership_change` and the segmented `runner.run_trace`.

* `churn_schedule` gives the reference's schedules, tuple for tuple.
* `_flush_slots` and `apply_membership_change` are the identity, bit for
  bit, on an all-False mask, and equal the reference's functions on the
  same state (a short port run carried across with `convert`), integer
  planes exactly and float planes bit for bit, also on a state whose
  ASIDs are a generation on; with a row axis each row equals the state
  without it.
* Constant membership: K segments equal the port's own `run_mix` of K x
  seg cycles float-hex, for every builtin design; 4 x 300 cycles give
  the reference's 1200-cycle `GOLDEN` pins (`tests/test_memsys_stages.py`)
  for `mask` and `pwc`; with a 40-cycle epoch, segments that straddle
  epochs equal the monolithic run (each segment starts at its own cycle).
* A departure leaves no translation of the dead generation anywhere; an
  arrival into an idle slot runs cold on a fresh generation.
* A schedule's shape sets up one segment plan (`runner.TRACE_COUNT`).

No test here calls the reference's `run_trace`, `run_mix` or `run_grid`,
so none warms a compile the reference's own tests count; plan counts use
a segment length no other port test uses.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.design import design_params as ref_design_params  # noqa: E402
from repro.core.design import get_design as ref_get_design  # noqa: E402
from repro.sim import memsys as ref_ms  # noqa: E402
from repro.sim import workloads as ref_wl  # noqa: E402
from repro.sim.config import SimConfig as RefConfig  # noqa: E402
from repro_torch.core.design import (BUILTIN_DESIGNS, design_params,  # noqa: E402
                                     get_design)
from repro_torch.sim import convert, memsys, runner  # noqa: E402
from repro_torch.sim.config import SimConfig  # noqa: E402
from repro_torch.sim.workloads import (BENCHES, CATEGORY, app_matrix,  # noqa: E402
                                       churn_schedule)

MIX2 = ("3DS", "BLK")
MIX3 = ("3DS", "BLK", "MUM")


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


def _hex(stats) -> dict:
    return {k: np.asarray(v).tobytes() for k, v in sorted(stats.items())}


def _leaves(tree, path="state"):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}.{f}")
    else:
        yield path, np.asarray(tree)


def _assert_trees_equal(got, want, msg):
    """Every leaf: same path, dtype, shape and bytes (floats bit for bit)."""
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (msg, path)
        assert a.tobytes() == b.tobytes(), f"{msg}: {path}"


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("n_slots", [1, 2, 3, 4])
def test_churn_schedule_matches_reference(n_slots):
    for seed in range(12):
        for kw in ({}, {"arrival_rate": 0.9, "departure_rate": 0.6},
                   {"benches": ["3DS", "BLK", "MUM"]}):
            assert churn_schedule(seed=seed, n_segments=9, n_slots=n_slots,
                                  **kw) == ref_wl.churn_schedule(
                seed=seed, n_segments=9, n_slots=n_slots, **kw)


def test_churn_schedule_generator():
    a = churn_schedule(seed=9, n_segments=6, n_slots=3)
    assert a == churn_schedule(seed=9, n_segments=6, n_slots=3)
    assert len(a) == 6 and all(len(s) == 3 for s in a)
    assert any(x is not None for x in a[0]), "segment 0 never fully idle"
    pool = {x for x in BENCHES if CATEGORY[x] != ("low", "low")}
    assert {x for s in a for x in s if x is not None} <= pool
    assert a != churn_schedule(seed=10, n_segments=6, n_slots=3)
    with pytest.raises(ValueError, match="n_segments >= 1"):
        churn_schedule(n_segments=0)


@settings(max_examples=20, deadline=None, derandomize=True, database=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 10), st.integers(1, 4))
def test_property_churn_schedule_wellformed(seed, n_segments, n_slots):
    sched = churn_schedule(seed=seed, n_segments=n_segments,
                           n_slots=n_slots)
    assert len(sched) == n_segments
    assert all(len(s) == n_slots for s in sched)
    assert any(b is not None for b in sched[0])
    assert sched == ref_wl.churn_schedule(seed=seed, n_segments=n_segments,
                                          n_slots=n_slots)


# ------------------------------------------------ teardown, state level

WARM = 150


def _warm_state(name="mask", mix=MIX3, cycles=WARM):
    """A state from a short port run (no row axis) and its configs."""
    cfg = SimConfig(n_apps=len(mix), sim_cycles=cycles,
                    design=get_design(name), device="cpu")
    dp = design_params(cfg.design)
    pm = convert.params_mat_from_numpy(app_matrix(list(mix)), "cpu")
    ref_cfg = RefConfig(n_apps=len(mix), design=ref_get_design(name))
    return (cfg, dp, pm, runner.simulate(cfg, dp, pm), ref_cfg,
            ref_design_params(ref_cfg.design))


def _to_ref(ref_cfg, ref_dp, state):
    """The port's state -> the reference's SimState (jnp leaves)."""
    treedef = jax.tree_util.tree_structure(ref_ms.init_state(ref_cfg,
                                                             ref_dp))
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for _, x in
                  _leaves(convert.state_to_numpy(state))])


def test_teardown_is_identity_on_all_false_mask():
    cfg, dp, _, state, _, _ = _warm_state()
    before = convert.state_to_numpy(state)
    none = torch.zeros(cfg.n_apps, dtype=torch.bool)
    _assert_trees_equal(convert.state_to_numpy(
        memsys.apply_membership_change(cfg, dp, state, none)), before,
        "apply_membership_change(all False)")
    l2 = state.trans.l2tlb
    flushed = memsys._flush_slots(
        memsys.map_state(lambda x: x[None], l2), none[None], cfg.n_apps)
    _assert_trees_equal(convert.tlb_to_numpy(
        memsys.map_state(lambda x: x[0], flushed)),
        convert.tlb_to_numpy(l2), "_flush_slots(all False)")


@pytest.mark.parametrize("name", ["mask", "pwc"])
def test_membership_change_matches_reference(name):
    """Two boundaries in a row on a carried state: the second tears down
    entries whose ASIDs are already a generation on (slot + n_apps)."""
    cfg, dp, pm, state, ref_cfg, ref_dp = _warm_state(name)
    for change, more in (([False, True, False], 40),
                         ([True, True, False], 0)):
        ref_state = _to_ref(ref_cfg, ref_dp, state)
        want = ref_ms.apply_membership_change(ref_cfg, ref_dp, ref_state,
                                              np.asarray(change))
        state = memsys.apply_membership_change(cfg, dp, state,
                                               torch.tensor(change))
        _assert_trees_equal(convert.state_to_numpy(state),
                            jax.device_get(want), f"{name} {change}")
        start = int(state.t)
        state = runner.simulate(
            SimConfig(n_apps=3, sim_cycles=more, design=cfg.design,
                      device="cpu"), dp, pm, state, start)
    asids = state.asid_of_app.tolist()
    assert asids == [3, 7, 2]
    # the dead generations are gone from every ASID-tagged cache
    for tlb in (state.trans.l1, state.trans.l2tlb, state.trans.bypass_tlb):
        dead = torch.isin(tlb.asids, torch.tensor([0, 1, 4]))
        assert not (dead & (tlb.tags >= 0)).any()


def test_membership_change_rows_match_single_rows():
    """With a row axis, each row's change equals the change applied to
    that row alone (the shape a row-axis trace would take)."""
    cfg, dp, _, state, _, _ = _warm_state()
    other = runner.simulate(
        cfg, dp, convert.params_mat_from_numpy(
            app_matrix(["MUM", None, "RED"]), "cpu"))
    rows = convert.state_from_numpy(
        [convert.state_to_numpy(state), convert.state_to_numpy(other)],
        "cpu")
    change = torch.tensor([[True, False, True], [False, True, False]])
    out = memsys.apply_membership_change(cfg, dp, rows, change)
    for r, single in enumerate((state, other)):
        _assert_trees_equal(
            convert.state_to_numpy(out, row=r),
            convert.state_to_numpy(memsys.apply_membership_change(
                cfg, dp, single, change[r])), f"row {r}")


# ------------------------------------------- constant membership, traces

@pytest.mark.parametrize("mix", [MIX2, MIX3], ids=["2app", "3app"])
@pytest.mark.parametrize("design", [d.name for d in BUILTIN_DESIGNS])
def test_constant_membership_segments_bitwise(design, mix):
    K, seg = 3, 30
    mono = runner.run_mix(design, list(mix), cycles=K * seg, device="cpu")
    tr = runner.run_trace(design, [mix] * K, seg_cycles=seg, device="cpu")
    assert _hex(mono) == _hex(tr.stats)


@pytest.mark.parametrize("name", ["mask", "pwc"])
def test_constant_membership_trace_reproduces_golden(name):
    """4 segments of 300 cycles give the reference's 1200-cycle pins."""
    tr = runner.run_trace(name, [MIX2] * 4, seg_cycles=300, device="cpu",
                          collect_segments=False)
    for key, want in GOLDEN[name].items():
        got = [x.hex() for x in
               np.asarray(tr.stats[key], np.float64).ravel().tolist()]
        assert got == want, f"{name}:{key} drifted: {got} != {want}"


@pytest.mark.parametrize("name", ["mask", "mask-dram"])
def test_segments_straddling_epochs_equal_monolithic(name):
    """Epochs every 40 cycles, segments of 50: each segment must run on
    the host's clock from k * 50 (the epoch fires at 40, 80, 120, ...),
    not from 0."""
    d = get_design(name).with_(epoch_cycles=40)
    mono = runner.run_mix(d, list(MIX2), cycles=150, device="cpu")
    tr = runner.run_trace(d, [MIX2] * 3, seg_cycles=50, device="cpu")
    assert _hex(mono) == _hex(tr.stats)
    assert [s["cycles"] for s in tr.segments] == [50.0, 100.0, 150.0]


def test_segment_split_invariance():
    total = 120
    mono = runner.run_mix("mask", list(MIX2), cycles=total, device="cpu")
    for k in (2, 4):
        tr = runner.run_trace("mask", [MIX2] * k, seg_cycles=total // k,
                              device="cpu")
        assert _hex(mono) == _hex(tr.stats), f"K={k}"


def test_per_segment_snapshots():
    tr = runner.run_trace("mask", [MIX2] * 3, seg_cycles=40, device="cpu")
    assert len(tr.segments) == 3
    assert [s["cycles"] for s in tr.segments] == [40.0, 80.0, 120.0]
    assert _hex(tr.segments[-1]) == _hex(tr.stats)
    assert tr["ipc"] is tr.stats["ipc"]
    lean = runner.run_trace("mask", [MIX2] * 3, seg_cycles=40,
                            collect_segments=False, device="cpu")
    assert lean.segments == () and _hex(lean.stats) == _hex(tr.stats)
    assert lean.final_state is None


def test_departure_triggers_asid_shootdown():
    tr = runner.run_trace("mask",
                          [("3DS", "BLK"), ("3DS", None), ("3DS", "MUM")],
                          seg_cycles=60, return_state=True, device="cpu")
    st = convert.state_to_numpy(tr.final_state)
    # slot 1: BLK (asid 1) -> idle (asid 3) -> MUM (asid 5); slot 0 stays
    assert st.asid_of_app.tolist() == [0, 5]
    dead = (1, 3)
    for name in ("l1", "l2tlb", "bypass_tlb"):
        tlb = getattr(st.trans, name)
        assert not (np.isin(tlb.asids, dead) & (tlb.tags >= 0)).any(), name
    assert not np.isin(st.trans.walk[:, memsys.WASID], dead).any()
    assert tr.stats["ipc"][0] > 0 and np.isfinite(tr.stats["ipc"]).all()


def test_arrival_into_idle_slot_runs_cold():
    tr = runner.run_trace("gpu-mmu", [("3DS", None), ("3DS", "BLK")],
                          seg_cycles=60, return_state=True, device="cpu")
    assert tr.final_state.asid_of_app.tolist() == [0, 3]
    assert tr.stats["ipc"][1] > 0


def test_schedules_share_one_segment_plan():
    seg = 31          # no other port test uses it: this test owns its plan
    t0 = runner.TRACE_COUNT
    runner.run_trace("mask", [MIX2, MIX2, ("3DS", None)], seg_cycles=seg,
                     device="cpu")
    first = runner.TRACE_COUNT - t0
    runner.run_trace("mask", [("MUM", "RED")] * 2, seg_cycles=seg,
                     device="cpu")
    runner.run_trace("mask-tlb", [MIX2, ("BLK", "3DS")], seg_cycles=seg,
                     device="cpu")
    assert first == 1
    assert runner.TRACE_COUNT - t0 == 1, \
        "a schedule or design of the same signature group set up a plan"


def test_schedule_validation():
    with pytest.raises(ValueError, match="at least one segment"):
        runner.run_trace("mask", [], device="cpu")
    with pytest.raises(ValueError, match="same slot count"):
        runner.run_trace("mask", [("3DS", "BLK"), ("3DS",)], device="cpu")
    with pytest.raises(ValueError, match="seg_cycles"):
        runner.run_trace("mask", [MIX2], seg_cycles=0, device="cpu")


def test_trace_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_trace("mask", [MIX2], seg_cycles=5)
