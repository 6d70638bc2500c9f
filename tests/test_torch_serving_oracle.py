"""Parity of the port's contention oracle with the reference's, on the CPU,
with the simulator in the loop: one real oracle in each package.

* `ContentionOracle(cycles=90, slots=2, pad_rows=8)` in both packages:
  predictions (raw `MixPrediction`s and tenant-level, KV-inflated
  `PlacementPrediction`s) are float-hex equal, and so are the cached solo
  IPCs.
* The flood_vs_trickle overload drive of `benchmarks/serving_bench.py`
  (`overload_run`'s plan, pool, engine and policy settings, stub
  forwards) at 64 steps with that oracle: equal fingerprints, equal
  chosen predictions of every decision, equal `mode_log` and
  recalibration, equal pool planes.
* The port's `runner.TRACE_COUNT` rises by one plan over the oracle's
  lifetime: every grid call pads to one (8 rows x 2 slots) shape.

90 cycles is a count no other test under `tests/` uses: the cycle count
keys the reference's compile cache (`runner._canonical`), so the
reference's own cold-cache tests (200/300 cycles in
`test_serving_oracle.py`, 150 in `test_serving_overload.py`) never meet
an entry this file warmed, and no other port test shares the plan.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.serving import metrics as jmet  # noqa: E402
from repro.sim import faults as jfaults  # noqa: E402
from repro_torch.serving import metrics as pmet  # noqa: E402
from repro_torch.serving import oracle as porc  # noqa: E402
from repro_torch.sim import runner as prunner  # noqa: E402
from tests.test_torch_serving import _pred as placement  # noqa: E402
from tests.test_torch_serving import (PORT, REF, decision,  # noqa: E402
                                      fingerprint, same_pool)

CYC = 90
ORACLE = dict(cycles=CYC, slots=2, pad_rows=8)
PROF = {0: "heavy", 1: "interactive", 2: "rag"}
# benchmarks/serving_bench.py `overload_run` / `overload_plan(0)`
OVERLOAD_POOL = dict(n_pages=64, page_size=8, n_kv=1, head_dim=4,
                     n_layers=1, max_seqs=16, pages_per_seq=8)
STEPS = 64


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _overload_drive(pkg, oracle):
    """`overload_run(seed=0)` at STEPS steps: solo hints from the `none`
    policy, then the oracle policy under `overload_plan(0)`."""
    e, strm, pl, f = pkg["eng"], pkg["strm"], pkg["pl"], pkg["faults"]
    trace = strm.make_trace("flood_vs_trickle", seed=0, steps=STEPS)
    plan = f.ServingFaultPlan(seed=0, faults=(
        f.ServingFault("oracle_stall", step=16, duration=8),
        f.ServingFault("profile_poison", step=36, duration=36, tenant=0,
                       profile="interactive"),
        f.ServingFault("pool_spike", step=40, duration=32,
                       pages=OVERLOAD_POOL["n_pages"])))

    def run(tr, policy, solo_hint=None, fault_plan=None, drain=1200):
        eng = e.ServingEngine(
            e.stub_model_config(), None, None,
            pkg["kvc"].PoolConfig(**OVERLOAD_POOL),
            e.EngineConfig(max_batch=8, max_running=12,
                           fault_plan=fault_plan),
            placement=policy, profiles=tr.profiles(),
            forwards=e.stub_forwards(), solo_hint=solo_hint, **pkg["dev"])
        strm.drive(eng, tr, drain_steps=drain)
        return eng

    solo = {}
    for spec in trace.specs:
        solo.update(pkg["met"].tenant_mean_latency(
            run(trace.only(spec.tenant), pl.make_policy("none")).finished))
    policy = pl.make_policy(
        "oracle", profiles=trace.profiles(), oracle=oracle, epoch_steps=8,
        degrade_error=0.4, reengage_error=0.28, error_window=2,
        recalibrator=pkg["orc"].Recalibrator(alpha=0.5))
    eng = run(trace, policy, solo, plan, drain=2000)
    return eng, solo


def _mix(p):
    return (p.benches, p.weighted_speedup.hex(), p.max_slowdown.hex(),
            tuple(x.hex() for x in p.slowdown), tuple(x.hex() for x in p.ipc),
            tuple(x.hex() for x in p.solo_ipc))


@pytest.fixture(scope="module")
def runs():
    """Both packages' oracles through predictions, then the overload drive
    on fresh oracles; the port's plan count around all of it."""
    plans = prunner.TRACE_COUNT
    out = {}
    for tag, pkg in (("ref", REF), ("port", PORT)):
        oracle = pkg["orc"].ContentionOracle(**ORACLE, **pkg["dev"])
        preds = oracle.predict([(0,), (1,), (0, 1), (1, 2)], PROF,
                               pool_pressure=0.8)
        again = oracle.predict([(1, 0), (2,)], PROF)
        raw = oracle.predict_benches([("MUM", "GUP"), ("GUP",),
                                      ("3DS", "NN")])
        lifetime = (oracle.grid_calls, oracle.memo_size, oracle.solo_ipc(),
                    oracle.tenant_benches())
        drive_oracle = pkg["orc"].ContentionOracle(**ORACLE, **pkg["dev"])
        eng, solo = _overload_drive(pkg, drive_oracle)
        out[tag] = dict(preds=preds, again=again, raw=raw,
                        lifetime=lifetime, eng=eng, solo=solo,
                        oracle=drive_oracle)
    out["plans"] = prunner.TRACE_COUNT - plans
    return out


def test_predictions_float_hex_equal(runs):
    ref, port = runs["ref"], runs["port"]
    for key in ("preds", "again"):
        got = [placement(p) for p in port[key]]
        want = [placement(p) for p in ref[key]]
        assert got == want
    assert [_mix(p) for p in port["raw"]] == [_mix(p) for p in ref["raw"]]
    grid_calls, memo, solo, benches = port["lifetime"]
    assert port["lifetime"][:2] == ref["lifetime"][:2] == (3, 7)
    assert {b: v.hex() for b, v in solo.items()} == \
        {b: v.hex() for b, v in ref["lifetime"][2].items()}
    assert benches == ref["lifetime"][3]
    # KV inflation reached the pair only (pressure 0.8 over the 0.6 mark)
    pair = port["preds"][2]
    assert pair.max_slowdown > max(port["again"][0].slowdown.values())


def test_overload_drive_matches_reference(runs):
    ref, port = runs["ref"], runs["port"]
    assert {t: v.hex() for t, v in port["solo"].items()} == \
        {t: v.hex() for t, v in ref["solo"].items()}
    peng_, jeng_ = port["eng"], ref["eng"]
    assert fingerprint(peng_) == fingerprint(jeng_)
    # every decision's predictions and chosen placement, float hex
    assert [decision(d) for d in peng_.decisions] == \
        [decision(d) for d in jeng_.decisions]
    assert any(d.chosen is not None for d in jeng_.decisions)
    assert peng_.placement.mode_log == jeng_.placement.mode_log
    over = jmet.overload_summary(jeng_)
    assert pmet.overload_summary(peng_) == over
    assert set(over["faults_injected"]) == set(jfaults.SERVING_FAULT_KINDS)
    assert pmet.conservation_report(peng_) == \
        jmet.conservation_report(jeng_)
    assert pmet.conservation_report(peng_)["ok"]
    same_pool(jeng_.pool, peng_.pool)
    assert port["oracle"].grid_calls == ref["oracle"].grid_calls >= 2
    assert port["oracle"].failures == ref["oracle"].failures == []


def test_one_plan_for_the_oracles_lifetime(runs):
    """Every grid call of both port oracles pads to 8 rows of 2 slots:
    one plan set up, then reused by each later call."""
    assert runs["port"]["lifetime"][0] + runs["port"]["oracle"].grid_calls \
        >= 4
    assert runs["plans"] == 1


def test_candidate_wider_than_slots_raises():
    oracle = porc.ContentionOracle(**ORACLE, device="cpu")
    with pytest.raises(ValueError, match="exceeds oracle slots"):
        oracle.predict([(0, 1, 2)], PROF)
    assert oracle.grid_calls == 0
