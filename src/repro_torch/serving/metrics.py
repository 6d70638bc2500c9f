"""Per-tenant serving metrics: throughput, latency distributions, TTFT,
SLO attainment, and the paper's fairness metrics (weighted speedup, max
slowdown) applied to the serving engine — plus the oracle's
predicted-vs-achieved fairness error.

Latency accounting is in ENGINE STEPS (submit -> finish), the serving
analogue of the simulator's cycles: a tenant's *slowdown* is its shared
mean latency over its solo mean latency (same seeded arrivals, engine
to itself — `stream.TraceSpec.only`), and *unfairness* is the max
slowdown over tenants, mirroring §6's IPC_alone construction.

A copy of `repro.serving.metrics` (host Python and numpy).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Mapping, Optional

import numpy as np


def _decoded(r) -> int:
    """Decode-produced tokens of a finished request (the prefill-emitted
    token in `out` is not a decode token)."""
    d = getattr(r, "decoded", None)
    return d if d is not None else max(len(r.out) - 1, 0)


def tenant_throughput(finished, total_steps: int) -> Dict[int, float]:
    """Decoded tokens per engine step, per tenant."""
    toks = defaultdict(int)
    for r in finished:
        toks[r.tenant] += _decoded(r)
    return {t: n / max(total_steps, 1) for t, n in toks.items()}


def weighted_speedup(shared: Dict[int, float],
                     alone: Dict[int, float]) -> float:
    return sum(shared[t] / max(alone.get(t, 1e-9), 1e-9) for t in shared)


def max_slowdown(shared: Dict[int, float], alone: Dict[int, float]) -> float:
    return max(max(alone.get(t, 0.0), 1e-9) / max(v, 1e-9)
               for t, v in shared.items())


def mean_latency(finished) -> float:
    if not finished:
        return 0.0
    return sum(r.finish_step - r.submit_step for r in finished) / len(finished)


def tenant_mean_latency(finished) -> Dict[int, float]:
    lat = defaultdict(list)
    for r in finished:
        lat[r.tenant].append(r.finish_step - r.submit_step)
    return {t: float(np.mean(v)) for t, v in lat.items()}


def tenant_ttft(finished) -> Dict[int, float]:
    """Mean time-to-first-token (submit -> prefill emission), per
    tenant; requests that never prefilled are excluded."""
    lat = defaultdict(list)
    for r in finished:
        if r.first_token_step >= 0:
            lat[r.tenant].append(r.first_token_step - r.submit_step)
    return {t: float(np.mean(v)) for t, v in lat.items()}


def latency_percentiles(finished, ps: Iterable[int] = (50, 95, 99)
                        ) -> Dict[str, float]:
    """Overall completion-latency percentiles, `{"p50": ..., ...}`."""
    if not finished:
        return {f"p{p}": 0.0 for p in ps}
    lat = np.asarray([r.finish_step - r.submit_step for r in finished])
    return {f"p{p}": float(np.percentile(lat, p)) for p in ps}


def tenant_latency_percentiles(finished, ps: Iterable[int] = (50, 95, 99)
                               ) -> Dict[int, Dict[str, float]]:
    by = defaultdict(list)
    for r in finished:
        by[r.tenant].append(r)
    return {t: latency_percentiles(v, ps) for t, v in by.items()}


def slo_attainment(finished, slo_steps: float) -> Dict[int, float]:
    """Fraction of each tenant's finished requests completing within
    `slo_steps` engine steps of submission."""
    tot, ok = defaultdict(int), defaultdict(int)
    for r in finished:
        tot[r.tenant] += 1
        if r.finish_step - r.submit_step <= slo_steps:
            ok[r.tenant] += 1
    return {t: ok[t] / tot[t] for t in tot}


def tenant_slowdown(shared_lat: Mapping[int, float],
                    solo_lat: Mapping[int, float]) -> Dict[int, float]:
    """Per-tenant achieved slowdown: shared mean latency / solo mean
    latency (>= ~1 when sharing hurts). Tenants missing a side are
    skipped; a tenant starved in the shared run (no finished requests)
    simply has no entry — report starvation separately."""
    out = {}
    for t, shared in shared_lat.items():
        solo = solo_lat.get(t)
        if solo is not None:
            out[t] = shared / max(solo, 1e-9)
    return out


def unfairness(slowdowns: Mapping[int, float]) -> float:
    """Max per-tenant slowdown (the paper's unfairness metric)."""
    if not slowdowns:
        return 0.0
    return float(max(slowdowns.values()))


def prediction_error(predicted: Optional[float],
                     achieved: Optional[float]) -> Optional[float]:
    """Relative predicted-vs-achieved fairness error
    |pred - achieved| / achieved. None when either side is missing
    (e.g. the `none` policy makes no predictions)."""
    if predicted is None or achieved is None or achieved <= 0:
        return None
    return abs(predicted - achieved) / achieved


def decision_summary(decisions) -> Dict[str, object]:
    """Fold an engine's placement `decisions` log into benchmark-ready
    scalars: epochs, mean/last predicted max-slowdown of the CHOSEN
    placements, and per-policy bookkeeping."""
    chosen = [d.chosen for d in decisions if d.chosen is not None]
    pred = [c.max_slowdown for c in chosen]
    allowed_sizes = [len(d.allowed) for d in decisions]
    return {
        "epochs": len(decisions),
        "predicted_max_slowdown_mean": (float(np.mean(pred))
                                        if pred else None),
        "predicted_max_slowdown_last": (float(pred[-1]) if pred else None),
        "predicted_weighted_speedup_mean": (
            float(np.mean([c.weighted_speedup for c in chosen]))
            if chosen else None),
        "mean_allowed_tenants": (float(np.mean(allowed_sizes))
                                 if allowed_sizes else 0.0),
        "rungs": rung_counts(decisions),
        "notes": sorted({d.note for d in decisions if d.note}),
    }


def rung_counts(decisions) -> Dict[str, int]:
    """Degradation-ladder attribution: how many decision epochs landed
    on each rung (`placement.RUNGS`) — the benchmark's WHY record."""
    counts: Dict[str, int] = {}
    for d in decisions:
        rung = getattr(d, "rung", "normal")
        counts[rung] = counts.get(rung, 0) + 1
    return counts


def conservation_report(eng) -> Dict[str, object]:
    """Request-conservation audit across admit/evict/re-queue cycles:
    every submitted rid must be in exactly one of {queued, running,
    parked, finished}, exactly once. `lost`/`duplicated` are the
    violation counts (both must be 0 — the preemption invariant)."""
    seen: Dict[int, int] = {}
    for q in eng.queues.values():
        for r in q:
            seen[r.rid] = seen.get(r.rid, 0) + 1
    for pool in (eng.running, eng.parked, eng.finished):
        for r in pool:
            seen[r.rid] = seen.get(r.rid, 0) + 1
    duplicated = sum(n - 1 for n in seen.values() if n > 1)
    lost = eng.submitted - len(seen)
    return {
        "submitted": eng.submitted,
        "finished": len(eng.finished),
        "pending": eng.pending(),
        "lost": lost,
        "duplicated": duplicated,
        "ok": lost == 0 and duplicated == 0,
    }


def overload_summary(eng) -> Dict[str, object]:
    """Overload/robustness attribution for one engine run: preemption
    counts, wasted (re-accounted) tokens, injected faults by kind,
    safe-mode transitions, and the recalibrator's movement — next to
    `rung_counts` this answers WHY a protective policy won or lost."""
    pol = eng.placement
    recal = getattr(pol, "recalibrator", None)
    faults: Dict[str, int] = {}
    for _, kind, _ in eng.fault_log:
        faults[kind] = faults.get(kind, 0) + 1
    return {
        "preemptions": eng.preemptions,
        "preempted_tenants": sorted({t for _, t, _ in eng.preempt_log}),
        "wasted_tokens": int(sum(r.wasted_tokens
                                 for r in (eng.finished + eng.running
                                           + eng.parked))),
        "faults_injected": faults,
        "safe_mode_log": [tuple(e) for e in getattr(pol, "mode_log", [])],
        "safe_level_final": getattr(pol, "safe_level", 0),
        "recalibration": None if recal is None else {
            "updates": recal.updates,
            "rejected": recal.rejected,
            "last_delta": recal.last_delta,
            "corrections": {int(t): float(c)
                            for t, c in sorted(recal.corrections().items())},
        },
    }


def fairness_report(shared_finished, solo_lat: Mapping[int, float],
                    decisions=()) -> Dict[str, object]:
    """One-call fairness rollup for a shared run: achieved per-tenant
    slowdown + unfairness, and (when placement decisions carry oracle
    predictions) the predicted-vs-achieved error."""
    shared_lat = tenant_mean_latency(shared_finished)
    slow = tenant_slowdown(shared_lat, solo_lat)
    ach = unfairness(slow)
    summ = decision_summary(decisions)
    pred = summ["predicted_max_slowdown_mean"]
    return {
        "tenant_slowdown": {int(t): v for t, v in sorted(slow.items())},
        "unfairness": ach,
        "predicted_max_slowdown": pred,
        "fairness_error": prediction_error(pred, ach),
        "starved_tenants": sorted(set(solo_lat) - set(shared_lat)),
    }
