"""The port's fault injection (`sim/faults.py`) and state auditor
(`sim/audit.py`) against the reference (CPU).

* `random_plan` and `plan_operands` give the reference's plans and
  operand arrays, array for array (the reference's aliased integer
  operand arrays included, see `test_plan_operands_match_reference`).
* `apply_state_faults` equals the reference's on the same carried state,
  fault kind by fault kind, bit for bit, and is the identity on empty
  operands; `tlb_corrupt` drops a same-(vpn, asid) entry before it writes.
* A churned trace under a plan that holds every fault kind equals the
  reference's `run_trace` float-hex in every snapshot, and its final state
  leaf for leaf (asid_of_app included); replay is bitwise; seeded chaos
  runs finish finite and audit-clean; a fault plan sets up no plan.
* The auditor gives the reference auditor's violations, message for
  message, on the same injected corruptions; `REPRO_AUDIT` gates
  `_stats` (set only through `monkeypatch`).

The one test that calls the reference's `run_trace` uses a segment length
(110) that no other file under tests/ uses, so it warms no compile that a
reference test counts.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.design import design_params as ref_design_params  # noqa: E402
from repro.core.design import get_design as ref_get_design  # noqa: E402
from repro.sim import audit as ref_audit  # noqa: E402
from repro.sim import faults as ref_faults  # noqa: E402
from repro.sim import memsys as ref_ms  # noqa: E402
from repro.sim import runner as ref_runner  # noqa: E402
from repro.sim.config import SimConfig as RefConfig  # noqa: E402
from repro_torch.core.design import design_params, get_design  # noqa: E402
from repro_torch.sim import convert, faults, memsys, runner  # noqa: E402
from repro_torch.sim.audit import (AuditError, check_monotone,  # noqa: E402
                                   check_state)
from repro_torch.sim.config import SimConfig  # noqa: E402
from repro_torch.sim.faults import (FAULT_KINDS, Fault, FaultOps,  # noqa: E402
                                    FaultPlan, plan_operands, random_plan)
from repro_torch.sim.workloads import app_matrix, churn_schedule  # noqa: E402

MIX = ("3DS", "BLK")
SCHED = [MIX, ("3DS", None), ("SC", "MUM"), ("SC", "MUM")]
SEG = 60

ALL_KINDS_PLAN = FaultPlan(seed=11, faults=(
    Fault("kill", 1, app=0),
    Fault("tlb_flush", 2, level=1),
    Fault("tlb_corrupt", 2, app=1),
    Fault("drop_dram", 3),
    Fault("walk_clobber", 3, app=0),
))

# the reference comparison: 3 slots of seeded churn, every fault kind and
# every flush level; a segment length no other test file uses
REF_SEG = 110
REF_SCHED = churn_schedule(seed=5, n_segments=5, n_slots=3)
REF_PLAN = FaultPlan(seed=11, faults=(
    Fault("kill", 1, app=0),
    Fault("tlb_flush", 2, level=1),
    Fault("tlb_corrupt", 2, app=1),
    Fault("drop_dram", 3),
    Fault("walk_clobber", 3, app=2),
    Fault("tlb_flush", 4, level=0),
    Fault("tlb_flush", 4, level=2),
    Fault("tlb_corrupt", 4, app=2),
))


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_plan(plan: FaultPlan) -> ref_faults.FaultPlan:
    return ref_faults.FaultPlan(seed=plan.seed, faults=tuple(
        ref_faults.Fault(f.kind, f.segment, f.app, f.level)
        for f in plan.faults))


def _hex(stats) -> dict:
    return {k: np.asarray(v).tobytes() for k, v in sorted(stats.items())}


def _leaves(tree, path="state"):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}.{f}")
    else:
        yield path, np.asarray(tree)


def _assert_trees_equal(got, want, msg):
    got, want = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (msg, path)
        assert a.tobytes() == b.tobytes(), f"{msg}: {path}"


# ------------------------------------------------------------ the plans

def test_random_plan_matches_reference():
    for seed in range(20):
        for n_segments, n_apps, rate in ((4, 2, 0.5), (9, 3, 0.8)):
            got = random_plan(seed, n_segments, n_apps, rate)
            want = ref_faults.random_plan(seed, n_segments, n_apps, rate)
            assert [dataclasses.astuple(f) for f in got.faults] == \
                [dataclasses.astuple(f) for f in want.faults]
            assert got.seed == want.seed


@pytest.mark.parametrize("n_apps", [2, 3])
def test_plan_operands_match_reference(n_apps):
    """Array for array, for a plan of every kind and for seeded plans.
    The reference's `empty_operands` hands ONE int32 array to all nine
    integer fields, so each later write lands in all of them (the last
    write of a boundary wins); the copy keeps that, and so do its
    results."""
    cfg = SimConfig(n_apps=n_apps, device="cpu")
    ref_cfg = RefConfig(n_apps=n_apps)
    plans = [ALL_KINDS_PLAN] + [random_plan(s, 6, n_apps, 0.9)
                                for s in range(6)]
    for plan in plans:
        got = plan_operands(plan, cfg, 6)
        want = ref_faults.plan_operands(_ref_plan(plan), ref_cfg, 6)
        assert got._fields == want._fields
        for f, a, b in zip(got._fields, got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    ops = plan_operands(ALL_KINDS_PLAN, cfg, 4)
    assert ops.corrupt_set is ops.clobber_delta     # the reference's alias
    assert ops.kill[1, 0] and ops.flush[2, 1] and ops.corrupt[2]
    assert ops.drop_dram[3] and ops.clobber[3]
    empty = faults.empty_operands(cfg, 4)
    assert not any(x.any() for x in empty)


def test_fault_plan_validation():
    with pytest.raises(ValueError, match="kind"):
        Fault("meteor-strike", 0)
    with pytest.raises(ValueError, match="segment"):
        Fault("kill", -1)
    with pytest.raises(ValueError, match="level"):
        Fault("tlb_flush", 0, level=3)
    plan = FaultPlan(seed=0, faults=(Fault("kill", 9, app=0),))
    with pytest.raises(ValueError, match="only 2 segments"):
        runner.run_trace("mask", [MIX, MIX], seg_cycles=SEG,
                         fault_plan=plan, device="cpu")
    with pytest.raises(ValueError, match="kills app slot"):
        plan_operands(FaultPlan(0, (Fault("kill", 0, app=7),)),
                      SimConfig(n_apps=2, device="cpu"), 2)


def test_fault_plan_on_simconfig_is_hashable_and_canonical_strips_it():
    cfg = SimConfig(n_apps=2, fault_plan=ALL_KINDS_PLAN, device="cpu")
    hash(cfg)
    assert runner._canonical(cfg).fault_plan is None
    assert runner._canonical(cfg) == runner._canonical(
        dataclasses.replace(cfg, fault_plan=None))


# ---------------------------------------------------- state-level faults

def _warm():
    """A carried mid-run state (port run, 3 apps, no row axis)."""
    mix = ["3DS", "BLK", "MUM"]
    cfg = SimConfig(n_apps=3, sim_cycles=150, design=get_design("mask"),
                    device="cpu")
    dp = design_params(cfg.design)
    pm = convert.params_mat_from_numpy(app_matrix(mix), "cpu")
    state = runner.simulate(cfg, dp, pm)
    # a generation on for slot 1, so a live ASID is not its slot, and
    # cycles to fill the caches under it
    state = memsys.apply_membership_change(cfg, dp, state,
                                           torch.tensor([False, True, False]))
    state = runner.simulate(dataclasses.replace(cfg, sim_cycles=60), dp, pm,
                            state, 150)
    ref_cfg = RefConfig(n_apps=3, design=ref_get_design("mask"))
    return cfg, state, ref_cfg, ref_design_params(ref_cfg.design)


def _to_ref(ref_cfg, ref_dp, state):
    treedef = jax.tree_util.tree_structure(ref_ms.init_state(ref_cfg,
                                                             ref_dp))
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for _, x in
                  _leaves(convert.state_to_numpy(state))])


def _ops(**kw):
    """One boundary's operands (no segment axis), all off but `kw`."""
    base = {f: np.zeros((), np.int32) for f in FaultOps._fields}
    base.update(kill=np.zeros(3, bool), flush=np.zeros(3, bool),
                corrupt=np.zeros((), bool), drop_dram=np.zeros((), bool),
                clobber=np.zeros((), bool))
    base.update({k: np.asarray(v, base[k].dtype) for k, v in kw.items()})
    return base


def _resident(state):
    """(set, way, vpn, slot) of a valid shared-L2-TLB entry of slot 1."""
    l2 = state.trans.l2tlb
    live = int(state.asid_of_app[1])
    s, w = np.argwhere((l2.asids == live).numpy())[0]
    return int(s), int(w), int(l2.tags[s, w]), 1


def _cases(state):
    s, w, vpn, slot = _resident(state)
    ways = state.trans.l2tlb.tags.shape[1]
    return {
        "none": _ops(),
        "flush-l1": _ops(flush=[True, False, False]),
        "flush-l2": _ops(flush=[False, True, False]),
        "flush-bypass": _ops(flush=[False, False, True]),
        # a vpn already resident for the slot's live ASID in another way:
        # the old entry goes, the new one lands in the target way
        "corrupt-dup": _ops(corrupt=True, corrupt_set=s,
                            corrupt_way=(w + 3) % ways, corrupt_vpn=vpn,
                            corrupt_app=slot),
        "corrupt-same-way": _ops(corrupt=True, corrupt_set=s, corrupt_way=w,
                                 corrupt_vpn=vpn, corrupt_app=slot),
        "corrupt-fresh": _ops(corrupt=True, corrupt_set=7 + 64,
                              corrupt_way=5 + 16, corrupt_vpn=123457,
                              corrupt_app=2 + 3),
        "drop-dram": _ops(drop_dram=True),
        "clobber": _ops(clobber=True, clobber_row=5, clobber_vpn=4242,
                        clobber_app=1, clobber_delta=777),
        "all": _ops(flush=[True, False, True], corrupt=True, corrupt_set=s,
                    corrupt_way=(w + 1) % ways, corrupt_vpn=vpn,
                    corrupt_app=slot, drop_dram=True, clobber=True,
                    clobber_row=2, clobber_vpn=99, clobber_app=2,
                    clobber_delta=1500),
    }


def test_state_faults_match_reference():
    cfg, state, ref_cfg, ref_dp = _warm()
    ref_state = _to_ref(ref_cfg, ref_dp, state)
    before = convert.state_to_numpy(state)
    for name, kw in _cases(state).items():
        got = faults.apply_state_faults(cfg, state, FaultOps(**kw))
        want = ref_faults.apply_state_faults(ref_cfg, ref_state,
                                             ref_faults.FaultOps(**kw))
        _assert_trees_equal(convert.state_to_numpy(got),
                            jax.device_get(want), name)
        if name == "none":
            _assert_trees_equal(convert.state_to_numpy(got), before, name)
        else:
            check_state(cfg, convert.state_to_numpy(got))
    got = faults.apply_state_faults(cfg, state,
                                    FaultOps(**_cases(state)["corrupt-dup"]))
    s, w, vpn, _ = _resident(state)
    tags = got.trans.l2tlb.tags[s]
    assert int((tags == vpn).sum()) == 1 and int(tags[w]) == -1


def test_state_faults_with_rows_match_single_rows():
    cfg, state, _, _ = _warm()
    cases = _cases(state)
    rows = convert.state_from_numpy([convert.state_to_numpy(state)] * 2,
                                    "cpu")
    pair = FaultOps(*(np.stack([a, b]) for a, b in
                      zip(FaultOps(**cases["all"]),
                          FaultOps(**cases["clobber"]))))
    out = faults.apply_state_faults(cfg, rows, pair)
    for r, name in enumerate(("all", "clobber")):
        _assert_trees_equal(
            convert.state_to_numpy(out, row=r),
            convert.state_to_numpy(faults.apply_state_faults(
                cfg, state, FaultOps(**cases[name]))), name)


# ------------------------------------------------------- faulted traces

def test_churned_faulted_trace_matches_reference():
    got = runner.run_trace("mask", REF_SCHED, seg_cycles=REF_SEG,
                           fault_plan=REF_PLAN, audit=True,
                           return_state=True, device="cpu")
    want = ref_runner.run_trace("mask", REF_SCHED, seg_cycles=REF_SEG,
                                fault_plan=_ref_plan(REF_PLAN), audit=True,
                                return_state=True)
    assert len(got.segments) == len(want.segments) == len(REF_SCHED)
    for k, (a, b) in enumerate(zip(got.segments, want.segments)):
        assert _hex(a) == _hex(b), f"snapshot {k}"
    _assert_trees_equal(convert.state_to_numpy(got.final_state),
                        jax.device_get(want.final_state), "final state")
    assert got.final_state.asid_of_app.tolist() == \
        np.asarray(want.final_state.asid_of_app).tolist()


def test_fault_plan_replay_is_bitwise():
    a = runner.run_trace("mask", SCHED, seg_cycles=SEG,
                         fault_plan=ALL_KINDS_PLAN, device="cpu")
    b = runner.run_trace("mask", SCHED, seg_cycles=SEG,
                         fault_plan=ALL_KINDS_PLAN, device="cpu")
    for x, y in zip(a.segments, b.segments):
        assert _hex(x) == _hex(y)


def test_every_fault_kind_is_exercised_and_audit_clean():
    assert {f.kind for f in ALL_KINDS_PLAN.faults} == set(FAULT_KINDS)
    tr = runner.run_trace("mask", SCHED, seg_cycles=SEG,
                          fault_plan=ALL_KINDS_PLAN, audit=True,
                          device="cpu")
    assert np.isfinite(tr.stats["ipc"]).all()
    # the kill at boundary 1 is a membership change of slot 0
    tr = runner.run_trace("mask", [MIX, MIX], seg_cycles=SEG,
                          fault_plan=FaultPlan(0, (Fault("kill", 1),)),
                          return_state=True, device="cpu")
    assert tr.final_state.asid_of_app.tolist() == [2, 1]


@settings(max_examples=3, deadline=None, derandomize=True, database=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_property_chaos_runs_always_finish_finite(seed):
    sched = churn_schedule(seed=seed, n_segments=4, n_slots=2)
    plan = random_plan(seed, 4, 2, rate=0.8)
    tr = runner.run_trace("mask", sched, seg_cycles=25, fault_plan=plan,
                          audit=True, device="cpu")
    for snap in tr.segments:
        assert np.isfinite(snap["ipc"]).all() and snap["cycles"] > 0


def test_fault_plan_adds_no_plan():
    seg = 37          # no other port test uses it: this test owns its plan
    t0 = runner.TRACE_COUNT
    runner.run_trace("mask", [MIX, MIX], seg_cycles=seg, device="cpu")
    assert runner.TRACE_COUNT - t0 == 1
    runner.run_trace("mask", [MIX, MIX], seg_cycles=seg, device="cpu",
                     fault_plan=FaultPlan(seed=5, faults=(
                         Fault("tlb_flush", 1), Fault("kill", 1, app=1))))
    assert runner.TRACE_COUNT - t0 == 1, \
        "a fault plan must ride the no-fault plan (operands are data)"


def test_poisoned_design_raises():
    mask = get_design("mask")
    poison = dataclasses.replace(mask, name="poison", translation=(
        dataclasses.replace(mask.translation, l2_ways=0)))
    with pytest.raises(ZeroDivisionError):
        runner.run_trace(poison, [MIX], seg_cycles=5, device="cpu")


# ------------------------------------------------------------ the audit

def _final():
    tr = runner.run_trace("mask", SCHED, seg_cycles=SEG, return_state=True,
                          collect_segments=False, device="cpu")
    cfg = SimConfig(n_apps=2, sim_cycles=SEG, design=tr.design,
                    device="cpu")
    return cfg, RefConfig(n_apps=2, design=ref_get_design("mask")), \
        convert.state_to_numpy(tr.final_state)


def _stale(s):
    s.trans.l2tlb.tags[0, 0] = 777
    s.trans.l2tlb.asids[0, 0] = 9


def _dup(s):
    for w in (0, 1):
        s.trans.l2tlb.tags[3, w] = 555
        s.trans.l2tlb.asids[3, w] = int(s.asid_of_app[0])


def _disagree(s):
    s.trans.l1.tags[2, 0, 0] = 42
    s.trans.l1.asids[2, 0, 0] = -1


def _tokens_counters(s):
    s.tokens.tokens[0] = 0
    s.stats.ints[1, 2] = -5


def _lru_walk(s):
    s.trans.l2tlb.lru[1, 1] = int(s.t) + 999
    s.trans.walk[0] = (123, 9, int(s.t) + 50, 1)


def _asid_map(s):
    s.asid_of_app[1] = 4


@pytest.mark.parametrize("corrupt,match,n", [
    (_stale, "stale translation", 1), (_dup, "duplicate", 1),
    (_disagree, "validity disagree", 1),
    (_tokens_counters, "tokens outside", 2),
    (_lru_walk, "LRU stamp", 2), (_asid_map, "slot recovery", None)])
def test_audit_flags_what_the_reference_flags(corrupt, match, n):
    cfg, ref_cfg, st = _final()
    check_state(cfg, st)                 # healthy: must not raise
    corrupt(st)
    with pytest.raises(AuditError, match=match) as got:
        check_state(cfg, st)
    with pytest.raises(ref_audit.AuditError) as want:
        ref_audit.check_state(ref_cfg, st)
    assert got.value.violations == want.value.violations
    if n is not None:
        assert len(got.value.violations) == n


def test_audit_monotone():
    one = runner.run_trace("mask", [MIX], seg_cycles=SEG, return_state=True,
                           device="cpu")
    two = runner.run_trace("mask", [MIX, MIX], seg_cycles=SEG,
                           return_state=True, device="cpu")
    s1 = convert.state_to_numpy(one.final_state)
    s2 = convert.state_to_numpy(two.final_state)
    check_monotone(s1, s2)
    with pytest.raises(AuditError, match="decreased|backwards"):
        check_monotone(s2, s1)
    s2.stats.ints[1, :] = 0
    check_monotone(s1, s2, changed=np.array([False, True]))
    with pytest.raises(AuditError, match="decreased"):
        check_monotone(s1, s2, changed=np.array([False, False]))
    with pytest.raises(ref_audit.AuditError, match="decreased"):
        ref_audit.check_monotone(s1, s2, changed=np.array([False, False]))


def test_stats_env_gating(monkeypatch):
    cfg, _, st = _final()
    _stale(st)
    monkeypatch.setenv("REPRO_AUDIT", "1")
    with pytest.raises(AuditError):
        runner._stats(cfg, st)
    monkeypatch.setenv("REPRO_AUDIT", "0")
    runner._stats(cfg, st)
    monkeypatch.setenv("REPRO_AUDIT", "1")
    runner._stats(cfg, st, audit=False)
    monkeypatch.delenv("REPRO_AUDIT")
    with pytest.raises(AuditError):
        runner._stats(cfg, st, audit=True)
