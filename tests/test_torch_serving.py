"""Parity of the port's serving stack (`repro_torch.serving`,
`repro_torch.sim.profiles`, the serving half of `repro_torch.sim.faults`)
with the reference on the CPU, without the simulator.

* Profiles; the four trace presets (and `make_trace`'s step scaling,
  `only`, `schedule_to_specs`): equal specs, and `arrivals` gives equal
  prompts (array for array), rids, tenants and lengths.
* `random_serving_plan` equals the reference's plan draw for draw; the
  serving faults validate alike.
* Every `serving.metrics` function gives equal results on the same
  finished lists and engines.
* Each policy decides alike on scripted `EngineView`s; `OraclePlacement`
  runs in both packages against one scripted oracle (the same prediction
  tables, each package's `PlacementPrediction`) down every rung of
  `RUNGS`, safe mode and its recovery included.
* The engine with stub forwards under `none`/`static`/`greedy` on every
  preset, and under the oracle policy (scripted oracle) with every
  serving fault kind, preemption and backoff: equal fingerprints (the
  externally visible history: finished requests, decisions, preemptions,
  faults, mode changes) and equal pool planes at the end, bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.memmgr import kv_cache as jkvc  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import metrics as jmet  # noqa: E402
from repro.serving import oracle as jorc  # noqa: E402
from repro.serving import placement as jpl  # noqa: E402
from repro.serving import stream as jstrm  # noqa: E402
from repro.sim import faults as jfaults  # noqa: E402
from repro.sim import profiles as jprof  # noqa: E402
from repro.sim.workloads import churn_schedule  # noqa: E402
from repro_torch.memmgr import kv_cache as pkvc  # noqa: E402
from repro_torch.serving import engine as peng  # noqa: E402
from repro_torch.serving import metrics as pmet  # noqa: E402
from repro_torch.serving import oracle as porc  # noqa: E402
from repro_torch.serving import placement as ppl  # noqa: E402
from repro_torch.serving import stream as pstrm  # noqa: E402
from repro_torch.sim import faults as pfaults  # noqa: E402
from repro_torch.sim import profiles as pprof  # noqa: E402

REF = dict(eng=jeng, met=jmet, orc=jorc, pl=jpl, strm=jstrm, kvc=jkvc,
           faults=jfaults, dev={})
PORT = dict(eng=peng, met=pmet, orc=porc, pl=ppl, strm=pstrm, kvc=pkvc,
            faults=pfaults, dev={"device": "cpu"})
PRESETS = ["flood_vs_trickle", "churn", "heavy_tail", "many_tenants"]
POOL = dict(n_pages=64, page_size=8, n_kv=1, head_dim=4, n_layers=1,
            max_seqs=16, pages_per_seq=8)
SMALL_POOL = dict(n_pages=32, page_size=8, n_kv=1, head_dim=4, n_layers=1,
                  max_seqs=16, pages_per_seq=4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------- helpers
def fingerprint(eng):
    """The visible history of a run (`benchmarks/serving_bench.py`
    `_fingerprint`)."""
    return (
        tuple((r.rid, r.tenant, r.submit_step, r.first_token_step,
               r.finish_step, r.retries, r.wasted_tokens, len(r.out))
              for r in sorted(eng.finished, key=lambda r: r.rid)),
        tuple((d.step, d.rung, d.allowed, tuple(sorted(d.caps.items())),
               tuple(sorted(d.decode_quota.items())),
               tuple(sorted(d.preempt.items())))
              for d in eng.decisions),
        tuple(eng.preempt_log),
        tuple(eng.fault_log),
        tuple(getattr(eng.placement, "mode_log", [])),
    )


def _pred(p):
    return (p.tenants, p.benches, p.weighted_speedup.hex(),
            p.max_slowdown.hex(),
            tuple((t, float(s).hex()) for t, s in sorted(p.slowdown.items())))


def decision(d):
    """Every field of a PlacementDecision, predictions by float hex."""
    return (d.step, d.policy, d.allowed, tuple(sorted(d.caps.items())),
            tuple(_pred(p) for p in d.predictions),
            None if d.chosen is None else _pred(d.chosen), d.note,
            d.default_cap, tuple(sorted(d.decode_quota.items())),
            tuple(sorted(d.preempt.items())), d.rung)


def _ref_pool(pool):
    host = jax.device_get(pool)
    out = {}
    for f in jkvc.KVPool._fields:
        val = getattr(host, f)
        if hasattr(val, "_fields"):
            out[f] = {g: np.asarray(getattr(val, g)) for g in val._fields}
        else:
            out[f] = np.asarray(val)
    return out


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float32"):
        return a.astype(np.float32).view(np.uint32)
    return a


def same_pool(jpool, ppool):
    want, got = _ref_pool(jpool), pkvc.pool_to_numpy(ppool)
    assert list(got) == list(want)
    for f in want:
        w, g = want[f], got[f]
        if isinstance(w, dict):
            assert list(g) == list(w), f
            for k in w:
                assert np.array_equal(_bits(g[k]), _bits(w[k])), f"{f}.{k}"
        else:
            assert np.array_equal(_bits(g), _bits(w)), f


class ScriptedOracle:
    """One scripted oracle for both packages: `table` maps a tenant set to
    its max slowdown (the last tenant of the sorted set is the victim),
    returned as the given package's `PlacementPrediction`; a missing set
    predicts None (a failed simulation)."""

    def __init__(self, orc_mod, table, slots=4):
        self.orc = orc_mod
        self.table = table
        self.slots = slots
        self.evicted = []

    def predict(self, candidates, profiles, pool_pressure=0.0):
        out = []
        for c in candidates:
            c = tuple(sorted(c))
            ms = self.table.get(frozenset(c))
            if ms is None:
                out.append(None)
                continue
            out.append(self.orc.PlacementPrediction(
                tenants=c, benches=tuple("B" for _ in c),
                weighted_speedup=float(len(c)) / ms, max_slowdown=ms,
                slowdown={t: (ms if i == len(c) - 1 else 1.0)
                          for i, t in enumerate(c)}))
        return out

    def evict_tenant(self, tenant):
        self.evicted.append(tenant)


FAIR = {frozenset({0}): 1.0, frozenset({1}): 1.0, frozenset({0, 1}): 1.05}
UNFAIR = {frozenset({0}): 1.0, frozenset({1}): 1.0, frozenset({0, 1}): 2.0}
SATURATED = {frozenset({0}): 2.5, frozenset({1}): 2.5,
             frozenset({0, 1}): 2.0}


# ------------------------------------------------------------- profiles
def test_profiles_match_reference():
    assert pprof.PROFILES == jprof.PROFILES
    assert pprof.DEFAULT_PROFILE == jprof.DEFAULT_PROFILE
    from repro.sim.workloads import BENCHES
    for name in list(jprof.PROFILES) + list(BENCHES):
        assert pprof.bench_for_profile(name) == jprof.bench_for_profile(name)
        assert pprof.profile_category(name) == jprof.profile_category(name)
    for mod in (pprof, jprof):
        with pytest.raises(KeyError, match="unknown app profile"):
            mod.bench_for_profile("no-such-profile")


# ------------------------------------------------------------- streams
def _same_trace(pt, jt):
    assert pt.name == jt.name and pt.steps == jt.steps
    assert pt.seed == jt.seed
    assert [dataclasses.asdict(s) for s in pt.specs] == \
        [dataclasses.asdict(s) for s in jt.specs]
    assert pt.profiles() == jt.profiles()


@pytest.mark.parametrize("name,seed,steps", [
    (n, 0, None) for n in PRESETS] + [
    ("flood_vs_trickle", 3, 240), ("churn", 5, 60), ("heavy_tail", 1, 40),
    ("many_tenants", 2, 30)])
def test_arrivals_match_reference(name, seed, steps):
    jt = jstrm.make_trace(name, seed=seed, steps=steps)
    pt = pstrm.make_trace(name, seed=seed, steps=steps)
    _same_trace(pt, jt)
    tenant = jt.specs[-1].tenant
    _same_trace(pt.only(tenant), jt.only(tenant))
    for ptr, jtr in ((pt, jt), (pt.only(tenant), jt.only(tenant))):
        pa = pstrm.arrivals(ptr, 64, rid_base=7)
        ja = jstrm.arrivals(jtr, 64, rid_base=7)
        assert len(pa) == len(ja) == ptr.steps
        for ps, js in zip(pa, ja):
            assert [(r.rid, r.tenant, r.max_new) for r in ps] == \
                [(r.rid, r.tenant, r.max_new) for r in js]
            for pr, jr in zip(ps, js):
                assert pr.prompt.dtype == jr.prompt.dtype
                assert np.array_equal(pr.prompt, jr.prompt)
    assert sum(len(s) for s in pstrm.arrivals(pt, 64)) > 0


def test_schedule_to_specs_match_reference():
    sched = churn_schedule(seed=4, n_segments=7, n_slots=5)
    for seg_steps in (1, 9):
        got = pstrm.schedule_to_specs(sched, seg_steps, rate=0.2,
                                      prompt_lens=(8, 16), max_new=3)
        want = jstrm.schedule_to_specs(sched, seg_steps, rate=0.2,
                                       prompt_lens=(8, 16), max_new=3)
        assert [dataclasses.asdict(s) for s in got] == \
            [dataclasses.asdict(s) for s in want]
    for mod in (pstrm, jstrm):
        with pytest.raises(ValueError, match="seg_steps"):
            mod.schedule_to_specs(sched, 0)
        with pytest.raises(KeyError, match="unknown trace preset"):
            mod.make_trace("no-such-trace")


# -------------------------------------------------------------- faults
@pytest.mark.parametrize("seed,n_steps,tenants,rate", [
    (0, 64, (0, 1), 0.05), (3, 64, (0, 1, 2), 0.1), (7, 240, (0, 1), 0.2),
    (11, 9, (4,), 0.9)])
def test_random_serving_plan_matches_reference(seed, n_steps, tenants, rate):
    got = pfaults.random_serving_plan(seed, n_steps, tenants, rate)
    want = jfaults.random_serving_plan(seed, n_steps, tenants, rate)
    assert got.seed == want.seed
    assert [dataclasses.asdict(f) for f in got.faults] == \
        [dataclasses.asdict(f) for f in want.faults]
    for step in range(n_steps):
        assert [dataclasses.asdict(f) for f in got.at_step(step)] == \
            [dataclasses.asdict(f) for f in want.at_step(step)]
    got.validate(tenants)
    if rate >= 0.2:
        assert got.faults


def test_serving_faults_validate_alike():
    assert pfaults.SERVING_FAULT_KINDS == jfaults.SERVING_FAULT_KINDS
    bad = [dict(kind="nope", step=0), dict(kind="pool_spike", step=-1),
           dict(kind="pool_spike", step=0, duration=0),
           dict(kind="pool_spike", step=0, pages=-1)]
    for kw in bad:
        for mod in (pfaults, jfaults):
            with pytest.raises(ValueError):
                mod.ServingFault(**kw)
    for mod in (pfaults, jfaults):
        plan = mod.ServingFaultPlan(seed=1, faults=[
            mod.ServingFault("profile_poison", step=3, tenant=5)])
        assert isinstance(plan.faults, tuple)
        with pytest.raises(ValueError, match="poisons tenant 5"):
            plan.validate((0, 1))


# ------------------------------------------------------------ policies
def _view(pl, step=8, queued=None, running=None, pressure=0.1,
          pages_by_tenant=None, max_batch=8, max_running=0, profiles=None,
          waiting=None):
    queued = queued or {}
    return pl.EngineView(
        step=step, max_batch=max_batch, queued=queued,
        running=running or {},
        waiting_since=waiting or {t: 0 for t in queued},
        pool_used_frac=pressure, pool_free_seqs=8,
        profiles=profiles or {0: "heavy", 1: "interactive"},
        pages_by_tenant=pages_by_tenant or {}, max_running=max_running)


# (view kwargs, achieved slowdowns observed before the decision or None,
#  stall window, scripted table)
SCRIPT = [
    (dict(queued={0: 3, 1: 1}, pressure=0.2), None, 0, FAIR),      # normal
    (dict(queued={0: 3, 1: 1}, pressure=0.8), None, 0, FAIR),      # quota
    (dict(queued={0: 3, 1: 1}, running={0: 4, 1: 1}, pressure=0.93,
          pages_by_tenant={0: 40, 1: 4}), None, 0, FAIR),          # preempt
    (dict(queued={0: 3, 1: 1}, running={0: 4}, pressure=0.99,
          pages_by_tenant={0: 60}), None, 0, FAIR),                # freeze
    (dict(queued={0: 3, 1: 1}, pressure=0.2), None, 12, FAIR),     # stalled
    (dict(queued={0: 5, 1: 2}, running={0: 6, 1: 2}, max_running=8),
     None, 0, SATURATED),                     # fairness preemption, fallback
    (dict(queued={0: 2, 1: 2}, pressure=0.95, max_batch=4), None, 0, UNFAIR),
    (dict(queued={0: 1, 1: 1}), None, 0, {}),  # every prediction failed
    (dict(queued={}), None, 0, FAIR),                                # idle
    (dict(queued={0: 3, 1: 1}), {0: 9.0, 1: 9.0}, 0, FAIR),
    (dict(queued={0: 3, 1: 1}), {0: 9.0, 1: 9.0}, 0, FAIR),
    (dict(queued={0: 3, 1: 1}), {0: 9.0, 1: 9.0}, 0, FAIR),   # safe_static
    (dict(queued={0: 3, 1: 1}), {0: 9.0, 1: 9.0}, 0, FAIR),
    (dict(queued={0: 3, 1: 1}), {0: 9.0, 1: 9.0}, 0, FAIR),
    (dict(queued={0: 3, 1: 1}), {0: 9.0, 1: 9.0}, 0, FAIR),   # safe_open
    (dict(queued={0: 3, 1: 1}), {0: float("nan"), 1: 0.0}, 0, FAIR),
] + [(dict(queued={0: 3, 1: 1}), {0: 1.0, 1: 1.05}, 0, FAIR)] * 12 + [
    (dict(queued={0: 3, 1: 1, 2: 1}, profiles={0: "heavy", 1: "rag",
                                                2: "light"},
          waiting={0: 5, 1: 0, 2: 3}), None, 0, FAIR),   # over-wide
]


def _walk(pkg):
    """The scripted ladder walk on one package: every decision, the
    admission answers, the safe-mode log and the corrections."""
    pl, orc = pkg["pl"], pkg["orc"]
    oracle = ScriptedOracle(orc, FAIR, slots=2)
    pol = pl.OraclePlacement(oracle, epoch_steps=4,
                             recalibrator=orc.Recalibrator(alpha=0.5))
    out = []
    for i, (kw, achieved, stall, table) in enumerate(SCRIPT):
        oracle.table = table
        step = 8 + 4 * i
        pol.stall_until = step + stall if stall else 0
        if achieved is not None:
            pol.observe(achieved)
        d = pol.refresh(_view(pl, step=step, **kw))
        admits = tuple(pol.may_admit(t, n) for t in (0, 1, 2)
                       for n in (0, 1, 4))
        out.append((decision(d), admits, pol.due(step + 1),
                    pol.stale((0, 1, 2)), pol.safe_level,
                    pol.rolling_error()))
    pol.retire(1)
    out.append((pol.stale((0,)), tuple(oracle.evicted),
                pol.recalibrator.correction(1)))
    pol.invalidate()
    rec = pol.recalibrator
    return out, list(pol.mode_log), rec.corrections(), rec.updates, \
        rec.rejected, rec.last_delta, pol.stale((0,))


def test_oracle_policy_walks_every_rung_like_reference():
    got, want = _walk(PORT), _walk(REF)
    assert got == want
    rungs = {step[0][-1] for step in want[0][:-1]}
    assert rungs == set(jpl.RUNGS) == set(ppl.RUNGS)
    assert ppl.RUNGS == jpl.RUNGS and ppl.POLICIES == jpl.POLICIES
    levels = [lvl for _, lvl, _ in want[1]]
    assert levels == [1, 2, 1, 0]       # degraded twice, re-engaged twice
    assert want[4] >= 1                 # the NaN measurement was rejected


def _policy_walk(pkg, name):
    pl = pkg["pl"]
    pol = pl.make_policy(name, profiles={0: "heavy", 1: "interactive",
                                         2: "rag"}, epoch_steps=3)
    views = [dict(queued={0: 3, 1: 1}, pressure=0.2),
             dict(queued={0: 3}, running={1: 2}, pressure=0.92),
             dict(queued={0: 1, 2: 4}, pressure=0.98),
             dict(queued={}, pressure=0.0),
             dict(queued={2: 1}, running={0: 8}, max_batch=3)]
    out = []
    for i, kw in enumerate(views):
        step = 3 * i + 1
        out.append((pol.due(step), pol.stale((0, 1, 2))))
        d = pol.refresh(_view(pl, step=step, **kw))
        out.append((decision(d), tuple(pol.may_admit(t, n)
                                       for t in (0, 1, 2, 3)
                                       for n in (0, 2, 5))))
    pol.retire(0)
    out.append(pol.stale((1,)))
    return out


@pytest.mark.parametrize("name", ["none", "static", "greedy"])
def test_policies_decide_like_reference(name):
    assert _policy_walk(PORT, name) == _policy_walk(REF, name)


def test_make_policy_refuses_alike():
    for pl in (ppl, jpl):
        with pytest.raises(ValueError, match="declared profiles"):
            pl.make_policy("static")
        with pytest.raises(KeyError, match="unknown placement policy"):
            pl.make_policy("nope")
        with pytest.raises(ValueError, match="epoch_steps"):
            pl.PlacementPolicy(epoch_steps=0)
    for orc in (porc, jorc):
        with pytest.raises(ValueError, match="alpha"):
            orc.Recalibrator(alpha=0.0)
        with pytest.raises(ValueError, match="bounds"):
            orc.Recalibrator(bounds=(1.5, 4.0))
        with pytest.raises(ValueError, match="max_step"):
            orc.Recalibrator(max_step=1.0)


def test_kv_inflation_and_recalibrator_match_reference():
    p = porc.ContentionOracle(kv_watermark=0.5, kv_gain=0.8, device="cpu")
    j = jorc.ContentionOracle(kv_watermark=0.5, kv_gain=0.8)
    for n in (1, 2, 3, 4):
        for f in (0.0, 0.4, 0.5, 0.77, 1.0):
            assert p.kv_inflation(n, f).hex() == j.kv_inflation(n, f).hex()
    pr, jr = porc.Recalibrator(), jorc.Recalibrator()
    for ach, pred in [({0: 2.0, 1: 0.5}, {0: 1.1, 1: 1.3}),
                      ({0: float("inf")}, {0: 1.0}), ({3: 1.2}, {}),
                      ({0: 30.0, 1: 0.01}, {0: 1.0, 1: 1.0})] * 3:
        pr.observe(ach, pred)
        jr.observe(ach, pred)
    assert pr.corrections() == jr.corrections()
    assert (pr.updates, pr.rejected, pr.last_delta) == \
        (jr.updates, jr.rejected, jr.last_delta)
    pr.evict(0)
    jr.evict(0)
    assert pr.corrections() == jr.corrections()


# -------------------------------------------------------------- engine
def _engine(pkg, pool, placement, profiles, ecfg_kw, solo_hint=None):
    e = pkg["eng"]
    return e.ServingEngine(
        e.stub_model_config(), None, None, pkg["kvc"].PoolConfig(**pool),
        e.EngineConfig(**ecfg_kw), placement=placement, profiles=profiles,
        forwards=e.stub_forwards(), solo_hint=solo_hint, **pkg["dev"])


def _drive_preset(pkg, name, policy, steps):
    tr = pkg["strm"].make_trace(name, seed=1, steps=steps)
    pol = pkg["pl"].make_policy(policy, profiles=tr.profiles(),
                                epoch_steps=6)
    eng = _engine(pkg, POOL, pol, tr.profiles(),
                  dict(max_batch=4, max_running=6))
    pkg["strm"].drive(eng, tr, drain_steps=300)
    return eng


@pytest.mark.parametrize("policy", ["none", "static", "greedy"])
@pytest.mark.parametrize("name", PRESETS)
def test_stub_engine_matches_reference(name, policy):
    steps = 40 if name == "many_tenants" else 48
    jeng_, peng_ = (_drive_preset(REF, name, policy, steps),
                    _drive_preset(PORT, name, policy, steps))
    assert fingerprint(peng_) == fingerprint(jeng_)
    assert len(jeng_.finished) > 0
    assert peng_.profiles == jeng_.profiles      # retired tenants left
    assert peng_.placement._last_active == jeng_.placement._last_active
    same_pool(jeng_.pool, peng_.pool)
    assert pmet.conservation_report(peng_) == \
        jmet.conservation_report(jeng_)
    assert pmet.conservation_report(peng_)["ok"]
    assert pmet.overload_summary(peng_) == jmet.overload_summary(jeng_)


def _fault_run(pkg):
    """The oracle policy (scripted, saturated-then-fair) under a plan of
    every serving fault kind on a tight pool: preemptions, backoff,
    freeze and stall rungs, phantom pages, a poisoned profile."""
    plan = pkg["faults"].ServingFaultPlan(seed=2, faults=(
        pkg["faults"].ServingFault("pool_spike", step=5, duration=9,
                                   pages=27),
        pkg["faults"].ServingFault("oracle_stall", step=12, duration=4),
        pkg["faults"].ServingFault("profile_poison", step=14, duration=10,
                                   tenant=1, profile="batch"),
        pkg["faults"].ServingFault("pool_spike", step=30, duration=6)))
    oracle = ScriptedOracle(pkg["orc"], SATURATED, slots=2)
    pol = pkg["pl"].OraclePlacement(oracle, epoch_steps=4,
                                    preempt_slowdown=1.5, degrade_error=50.0)
    tr = pkg["strm"].make_trace("flood_vs_trickle", seed=0, steps=60)
    eng = _engine(pkg, SMALL_POOL, pol, tr.profiles(),
                  dict(max_batch=3, max_running=6, backoff_base=3,
                       backoff_seed=5, max_retries=2, fault_plan=plan),
                  solo_hint={0: 18.0})
    for i, step_reqs in enumerate(pkg["strm"].arrivals(tr, 64)):
        if i == 20:
            oracle.table = FAIR
        for r in step_reqs:
            eng.submit(r)
        eng.step()
    eng.run_until_drained(max_steps=400)
    return eng, oracle


def test_fault_run_matches_reference():
    (jeng_, jor), (peng_, por) = _fault_run(REF), _fault_run(PORT)
    assert fingerprint(peng_) == fingerprint(jeng_)
    assert por.evicted == jor.evicted and jor.evicted
    same_pool(jeng_.pool, peng_.pool)
    over = jmet.overload_summary(jeng_)
    assert pmet.overload_summary(peng_) == over
    assert over["preemptions"] > 0
    assert set(over["faults_injected"]) == set(jfaults.SERVING_FAULT_KINDS)
    assert any(r.retries for r in jeng_.finished)
    rungs = jmet.rung_counts(jeng_.decisions)
    assert {"preempt", "stalled"} <= set(rungs)
    assert pmet.rung_counts(peng_.decisions) == rungs
    assert pmet.conservation_report(peng_) == \
        jmet.conservation_report(jeng_)
    assert pmet.conservation_report(peng_)["ok"]


@pytest.mark.parametrize("seed,rid,retries,base", [
    (0, 0, 1, 2), (5, 17, 3, 3), (9, 1234, 4, 1), (2, 7, 0, 0)])
def test_backoff_matches_reference(seed, rid, retries, base):
    assert peng.backoff_steps(seed, rid, retries, base) == \
        jeng.backoff_steps(seed, rid, retries, base)


def test_stub_forwards_run_on_the_tokens_device():
    prefill, decode = peng.stub_forwards()
    toks = torch.zeros((1, 5), dtype=torch.int32)
    logits, caches = prefill(None, None, None, {"tokens": toks})
    assert logits.shape == (1, 5, 8) and caches == {}
    assert logits.device == toks.device
    logits, _ = decode(None, None, None, {"tokens": toks[:, :1]}, caches)
    assert logits.shape == (1, 1, 8)


# ------------------------------------------------------------- metrics
def test_metrics_match_reference():
    jeng_ = _drive_preset(REF, "heavy_tail", "greedy", 48)
    peng_ = _drive_preset(PORT, "heavy_tail", "greedy", 48)
    fin = jeng_.finished
    steps = jeng_.step_count
    solo = {0: 5.5, 1: 4.0, 2: 7.25}
    shared = {0: 0.5, 1: 0.25, 2: 0.125}
    alone = {0: 1.0, 1: 0.5, 2: 0.2}
    for fn, args in [
            ("tenant_throughput", (fin, steps)),
            ("weighted_speedup", (shared, alone)),
            ("max_slowdown", (shared, alone)),
            ("mean_latency", (fin,)), ("mean_latency", ([],)),
            ("tenant_mean_latency", (fin,)), ("tenant_ttft", (fin,)),
            ("latency_percentiles", (fin,)),
            ("latency_percentiles", ([], (10, 90))),
            ("tenant_latency_percentiles", (fin, (25, 75))),
            ("slo_attainment", (fin, 9.0)),
            ("tenant_slowdown", (shared, {0: 0.25, 2: 0.0})),
            ("unfairness", (shared,)), ("unfairness", ({},)),
            ("prediction_error", (1.2, 1.0)),
            ("prediction_error", (None, 1.0)),
            ("fairness_report", (fin, solo, jeng_.decisions)),
            ("decision_summary", (jeng_.decisions,)),
            ("rung_counts", (jeng_.decisions,))]:
        assert getattr(pmet, fn)(*args) == getattr(jmet, fn)(*args), fn
    # the same functions on each package's own engine and decisions
    for fn in ("decision_summary", "rung_counts"):
        assert getattr(pmet, fn)(peng_.decisions) == \
            getattr(jmet, fn)(jeng_.decisions)
    assert pmet.fairness_report(peng_.finished, solo, peng_.decisions) == \
        jmet.fairness_report(jeng_.finished, solo, jeng_.decisions)
    for fn in ("conservation_report", "overload_summary"):
        assert getattr(pmet, fn)(peng_) == getattr(jmet, fn)(jeng_)
