"""Seeded trace-driven multi-tenant request streams for the engine (port
of `repro.serving.stream`; the trace, its arrivals and its draws are the
reference's, host numpy).

Models the host side of an MLPerf-style offline/server inference
harness: a trace is a per-step list of request arrivals that the
driver submits into the engine's host-side queues ahead of each
continuous-batching step. Arrival processes are per-tenant Poisson,
optionally modulated:

* bursty    — on/off duty cycling (same mean rate, concentrated into
              bursts of `burst_period * burst_duty` steps)
* heavy-tail — Pareto-ish decode lengths (a few requests decode for
              much longer than the median, the classic serving tail)
* churn     — tenants are only live inside their [start, stop) window

Every tenant draws from its OWN RandomState seeded by (trace seed,
tenant id), so a trace replays bit-identically for every policy under
test, and restricting a trace to one tenant (`TraceSpec.only`, the
solo-latency baseline) leaves that tenant's arrivals/lengths untouched
— the A/B discipline a serving benchmark depends on. Prompt lengths come from a
small bucket set so the engine's prefill compiles stay bounded.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.sim.workloads import churn_schedule


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's traffic model inside a trace."""

    tenant: int
    profile: str = "batch"            # -> sim bench via sim.profiles
    rate: float = 0.2                 # mean arrivals per engine step
    prompt_lens: Tuple[int, ...] = (8, 16)   # bucketed (compile-friendly)
    max_new: int = 6                  # decode steps per request
    heavy_tail: bool = False          # Pareto decode lengths (mean ~max_new)
    burst_period: int = 0             # >0: on/off modulated Poisson
    burst_duty: float = 0.5           # fraction of the period that is "on"
    start: int = 0                    # live window [start, stop)
    stop: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """A named, seeded multi-tenant traffic trace."""

    name: str
    steps: int
    specs: Tuple[TenantSpec, ...]
    seed: int = 0

    def profiles(self) -> Dict[int, str]:
        return {s.tenant: s.profile for s in self.specs}

    def only(self, tenant: int) -> "TraceSpec":
        """The same trace restricted to one tenant (solo baseline).

        Tenants draw from independent per-tenant RandomStates, so the
        kept tenant sees the SAME arrivals/lengths as in the shared
        trace — the solo run isolates scheduling contention, not a
        different workload.
        """
        specs = tuple(s for s in self.specs if s.tenant == tenant)
        return dataclasses.replace(self, name=f"{self.name}:solo{tenant}",
                                   specs=specs)


def _rate_at(spec: TenantSpec, step: int) -> float:
    if step < spec.start or (spec.stop is not None and step >= spec.stop):
        return 0.0
    if spec.burst_period > 0:
        on = (step % spec.burst_period) < spec.burst_duty * spec.burst_period
        return spec.rate / max(spec.burst_duty, 1e-9) if on else 0.0
    return spec.rate


def arrivals(trace: TraceSpec, vocab_size: int,
             rid_base: int = 0) -> List[List[Request]]:
    """Materialize the trace: `out[step]` is the list of requests to
    submit before engine step `step`. Deterministic in `trace.seed`;
    each tenant owns an independent (seed, tenant)-derived stream, so
    one tenant's params never shift another tenant's draws (and
    `TraceSpec.only` baselines replay the kept tenant exactly)."""
    rngs = {s.tenant: np.random.RandomState(
        (trace.seed * 1_000_003 + s.tenant) % (2 ** 31))
        for s in trace.specs}
    out: List[List[Request]] = []
    rid = rid_base
    for step in range(trace.steps):
        batch: List[Request] = []
        for spec in trace.specs:
            rng = rngs[spec.tenant]
            n = int(rng.poisson(_rate_at(spec, step)))
            for _ in range(n):
                plen = int(spec.prompt_lens[
                    rng.randint(len(spec.prompt_lens))])
                if spec.heavy_tail:
                    max_new = int(min(
                        1 + rng.pareto(1.5) * spec.max_new,
                        8 * spec.max_new))
                else:
                    max_new = spec.max_new
                batch.append(Request(
                    rid=rid, tenant=spec.tenant,
                    prompt=rng.randint(0, vocab_size, plen),
                    max_new=max_new))
                rid += 1
        out.append(batch)
    return out


# ------------------------------------------------- shared churn timeline

def schedule_to_specs(schedule: Sequence[Tuple[Optional[str], ...]],
                      seg_steps: int, rate: float = 0.35,
                      prompt_lens: Tuple[int, ...] = (8,),
                      max_new: int = 6) -> Tuple[TenantSpec, ...]:
    """Map a `sim.workloads.churn_schedule` (per-segment bench tuples,
    None = empty slot) onto serving `TenantSpec`s: each contiguous
    occupancy interval of a slot becomes a FRESH tenant (new id) live on
    [seg_start * seg_steps, seg_end * seg_steps) with the slot's bench
    as its declared profile. The simulator's segmented runner and the
    serving trace driver thereby share ONE seeded timeline generator —
    the same birth-death draw drives both. (A same-bench hand-off at a
    boundary is indistinguishable in the tuple encoding and coalesces
    into one tenant.)"""
    if seg_steps < 1:
        raise ValueError(f"seg_steps must be >= 1, got {seg_steps}")
    specs: List[TenantSpec] = []
    n_slots = len(schedule[0])
    tenant = 0
    for slot in range(n_slots):
        seg = 0
        while seg < len(schedule):
            bench = schedule[seg][slot]
            if bench is None:
                seg += 1
                continue
            end = seg
            while end < len(schedule) and schedule[end][slot] == bench:
                end += 1
            specs.append(TenantSpec(
                tenant, profile=bench, rate=rate, prompt_lens=prompt_lens,
                max_new=max_new, start=seg * seg_steps,
                stop=end * seg_steps))
            tenant += 1
            seg = end
    return tuple(specs)


def _tenant_pending(eng: ServingEngine, tenant: int) -> int:
    return (len(eng.queues.get(tenant, ())) +
            sum(1 for r in eng.running if r.tenant == tenant) +
            sum(1 for r in eng.parked if r.tenant == tenant))


def drive(eng: ServingEngine, trace: TraceSpec,
          drain_steps: int = 400) -> List[Request]:
    """The canonical serving loop: submit the trace's arrivals ahead of
    each engine step, RETIRE each departed tenant once its live window
    closed and its last request drained (placement caches evicted — the
    churn-staleness contract), then drain. Used by the launcher, the
    examples, and the serving benchmark so they all exercise one
    lifecycle path."""
    stops = {s.tenant: s.stop for s in trace.specs if s.stop is not None}
    retired: set = set()

    def _retire_done(step: int):
        for t, stop in stops.items():
            if t not in retired and step >= stop \
                    and _tenant_pending(eng, t) == 0:
                eng.retire_tenant(t)
                retired.add(t)

    for step_reqs in arrivals(trace, eng.cfg.vocab_size):
        for r in step_reqs:
            eng.submit(r)
        eng.step()
        _retire_done(eng.step_count)
    for _ in range(drain_steps):
        if eng.pending() == 0:
            break
        eng.step()
        _retire_done(eng.step_count)
    _retire_done(eng.step_count)
    return eng.finished


# ---------------------------------------------------------------- presets

def flood_vs_trickle(seed: int = 0, steps: int = 96) -> TraceSpec:
    """A heavy tenant floods the engine in waves while a light
    interactive tenant trickles — the paper's flooding-aggressor-vs-
    victim shape (Fig. 1) at the serving layer. Long aggressor decodes
    (16 steps) make batch-slot turnover slow, so a victim request
    landing mid-burst waits several times its own solo latency for
    admission unless the placement layer holds a slot open for it; the
    bursts give the aggressor slack between waves, so that reservation
    costs it little. The fairness question: how much does the trickle
    tenant's latency inflate vs running alone?"""
    return TraceSpec("flood_vs_trickle", steps, (
        TenantSpec(0, "heavy", rate=0.45, prompt_lens=(8,), max_new=16,
                   burst_period=24, burst_duty=0.4),
        TenantSpec(1, "interactive", rate=0.1, prompt_lens=(8,),
                   max_new=4),
    ), seed=seed)


def churn(seed: int = 0, steps: int = 120) -> TraceSpec:
    """Tenants arrive and depart mid-trace: placement must adapt as the
    active set changes. The live windows come from the SAME seeded
    birth-death generator the simulator's segmented runner churns with
    (`sim.workloads.churn_schedule` via `schedule_to_specs`) — serving
    traces and sim churn share one timeline."""
    n_segments = 6
    sched = churn_schedule(seed=seed, n_segments=n_segments, n_slots=3,
                           arrival_rate=0.5, departure_rate=0.3)
    specs = schedule_to_specs(sched, max(steps // n_segments, 1),
                              rate=0.35, prompt_lens=(8,), max_new=6)
    return TraceSpec("churn", steps, specs, seed=seed)


def many_tenants(seed: int = 0, steps: int = 120) -> TraceSpec:
    """Tens of tenants churning through a wide slot array (the scale
    stressor): each occupancy interval of a 12-slot churn schedule is a
    fresh tenant, so the trace carries dozens of distinct tenant ids —
    placement, oracle memoization, and the retirement path must all
    stay cheap and correct at this width."""
    n_segments = 6
    sched = churn_schedule(seed=seed, n_segments=n_segments, n_slots=12,
                           arrival_rate=0.6, departure_rate=0.35)
    specs = schedule_to_specs(sched, max(steps // n_segments, 1),
                              rate=0.12, prompt_lens=(8,), max_new=4)
    return TraceSpec("many_tenants", steps, specs, seed=seed)


def heavy_tail(seed: int = 0, steps: int = 96) -> TraceSpec:
    """Bursty arrivals + Pareto decode lengths: a few very long
    requests occupy slots for many epochs (the p99 stressor)."""
    return TraceSpec("heavy_tail", steps, (
        TenantSpec(0, "batch", rate=0.6, prompt_lens=(8,), max_new=6,
                   heavy_tail=True, burst_period=24, burst_duty=0.4),
        TenantSpec(1, "interactive", rate=0.12, prompt_lens=(8,),
                   max_new=6),
        TenantSpec(2, "rag", rate=0.25, prompt_lens=(8, 16), max_new=6,
                   heavy_tail=True),
    ), seed=seed)


PRESETS = {
    "flood_vs_trickle": flood_vs_trickle,
    "churn": churn,
    "heavy_tail": heavy_tail,
    "many_tenants": many_tenants,
}


def make_trace(name: str, seed: int = 0,
               steps: Optional[int] = None) -> TraceSpec:
    if name not in PRESETS:
        raise KeyError(f"unknown trace preset {name!r}: {sorted(PRESETS)}")
    tr = PRESETS[name](seed=seed)
    if steps is not None:
        scale = [dataclasses.replace(
            s,
            stop=None if s.stop is None else max(s.stop * steps
                                                 // tr.steps, 1),
            start=s.start * steps // tr.steps) for s in tr.specs]
        tr = dataclasses.replace(tr, steps=steps, specs=tuple(scale))
    return tr
