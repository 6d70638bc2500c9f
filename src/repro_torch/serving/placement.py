"""Admission/placement policies gating the serving engine's `_admit`
(port of `repro.serving.placement`, which imports no JAX: a copy).

Once per *decision epoch* (every `epoch_steps` engine steps) the active
policy looks at a host-side `EngineView` snapshot — queue depths,
running counts, KV-pool pressure
(`repro_torch.memmgr.kv_cache.pool_pressure`) — and produces a
`PlacementDecision`: which tenants may co-run this epoch (`allowed`) and
each tenant's admission cap (`caps`, max running requests). The engine
consults the current decision on every admission; running requests
always finish out (admission gating only, so decisions are
work-conserving for work already placed).

Policies, least to most informed:

  none    — admit everything (the engine's legacy behavior).
  static  — fixed equal partition of the batch over the DECLARED tenant
            universe, never adapted (the paper's Static baseline
            transplanted: isolating but wasteful when tenants idle).
  greedy  — equal share over the tenants with work right now, backing
            off when the KV pool nears exhaustion. Adaptive but
            contention-blind.
  oracle  — consults the `ContentionOracle`: enumerates candidate
            co-run sets, gets predicted weighted-speedup/unfairness
            from the simulator, picks the best candidate whose
            predicted max slowdown clears the unfairness cap, and
            reserves admission slots for predicted victims so an
            aggressor tenant cannot crowd them out of the batch.

Overload tolerance — decisions are no longer admit/deny only.
A decision may carry per-tenant *decode quotas* (the MASK-token
analogue at the serving layer: a cap on decode slots per step, enforced
work-conservingly) and a *preemption directive* (evict N of a tenant's
running requests; the engine releases their KV pages and re-queues them
with seeded exponential backoff). Under KV-pool pressure the oracle
policy walks a degradation ladder instead of falling off a cliff:

    normal -> quota (tighten decode quotas, pressure > quota_watermark)
           -> preempt (evict from the page-heaviest aggressor)
           -> freeze (no admissions until pressure recedes)

and a *self-correcting* loop guards the oracle itself: achieved
per-tenant slowdowns feed a bounded `Recalibrator`
(`repro_torch.serving.oracle`), and when the rolling prediction error exceeds
`degrade_error` the policy degrades to safe mode (static caps, then
admit-all) and re-engages once the SHADOW prediction error recovers —
a mispredicting oracle is never worse than no oracle.

Every decision (with its predictions, for the oracle) is recorded on
the engine's `decisions` log — the serving benchmark reports
predicted-vs-achieved fairness AND per-rung attribution from exactly
these records.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.serving.oracle import (ContentionOracle,
                                        PlacementPrediction, Recalibrator)

# degradation-ladder rung names, least to most degraded (decision.rung)
RUNGS = ("normal", "quota", "preempt", "freeze",
         "stalled", "safe_static", "safe_open")


@dataclasses.dataclass(frozen=True)
class EngineView:
    """Host-side engine snapshot a policy decides from."""

    step: int
    max_batch: int
    queued: Mapping[int, int]          # tenant -> queued request count
    running: Mapping[int, int]         # tenant -> running request count
    waiting_since: Mapping[int, int]   # tenant -> oldest queued submit step
    pool_used_frac: float              # KV pool page pressure [0, 1]
    pool_free_seqs: int
    profiles: Mapping[int, str]        # declared tenant profiles
    pool_free_pages: int = 0
    pages_by_tenant: Mapping[int, int] = dataclasses.field(
        default_factory=dict)          # KV pages held per tenant
    max_running: int = 0               # admission bound (0: == max_batch)

    @property
    def tenants(self) -> Tuple[int, ...]:
        """Tenants with any work (queued or running), sorted."""
        live = {t for t, n in self.queued.items() if n > 0}
        live |= {t for t, n in self.running.items() if n > 0}
        return tuple(sorted(live))


@dataclasses.dataclass(frozen=True)
class PlacementDecision:
    """One epoch's admission plan (+ the evidence, for the oracle)."""

    step: int
    policy: str
    allowed: Tuple[int, ...]           # tenants that may admit this epoch
    caps: Mapping[int, int]            # tenant -> max running requests
    predictions: Tuple[PlacementPrediction, ...] = ()
    chosen: Optional[PlacementPrediction] = None
    note: str = ""
    default_cap: int = 0               # cap for tenants NOT in `allowed`
    decode_quota: Mapping[int, int] = dataclasses.field(
        default_factory=dict)          # tenant -> decode slots per step
    preempt: Mapping[int, int] = dataclasses.field(
        default_factory=dict)          # tenant -> running requests to evict
    rung: str = "normal"               # degradation-ladder rung (RUNGS)

    def cap(self, tenant: int) -> int:
        """Admission cap. Tenants outside `allowed` get `default_cap`:
        0 freezes them out for the epoch (static partitions), 1 lets a
        tenant that was idle at the decision boundary trickle in
        instead of stalling a full epoch (greedy/oracle)."""
        if tenant not in self.allowed:
            return self.default_cap
        return self.caps.get(tenant, 0)


class PlacementPolicy:
    """Base: admit-all ("none"). Subclasses override `_decide`."""

    name = "none"

    def __init__(self, epoch_steps: int = 16):
        if epoch_steps < 1:
            raise ValueError(f"epoch_steps must be >= 1, got {epoch_steps}")
        self.epoch_steps = epoch_steps
        self.decision: Optional[PlacementDecision] = None
        self._last_step: Optional[int] = None
        self._last_active: Tuple[int, ...] = ()
        self._retired_pending = False
        self.stall_until = 0    # oracle-latency fault window (engine-set)

    def due(self, step: int) -> bool:
        if (self._last_step is not None and self.decision is not None
                and self.decision.rung == "freeze"):
            return True     # frozen epochs re-decide every step: the
            #                 freeze must lift the moment pressure does
        return (self._last_step is None
                or step - self._last_step >= self.epoch_steps)

    def stale(self, active: Sequence[int]) -> bool:
        """Decision invalidation on churn: a tenant that was NOT active
        when the epoch's decision was made has work now, so the
        placement no longer covers the live tenant set — re-decide
        early rather than stall the newcomer a whole epoch. (Tenants
        the decision deliberately excluded were seen at decision time
        and do NOT retrigger; oracle memoization keeps early
        re-decides cheap.)"""
        if self.name == "none" or self.decision is None:
            return False
        if self._retired_pending:
            return True     # current decision still places a dead tenant
        return bool(set(active) - set(self._last_active))

    def refresh(self, view: EngineView) -> PlacementDecision:
        self.decision = self._decide(view)
        self._last_step = view.step
        self._last_active = view.tenants
        self._retired_pending = False
        return self.decision

    def observe(self, achieved: Mapping[int, float]) -> None:
        """Achieved per-tenant slowdowns for the closing epoch (engine
        feedback seam). Base policies don't learn; the oracle policy
        recalibrates and drives its safe-mode state machine from this."""

    def retire(self, tenant: int) -> None:
        """A tenant departed for good: no decision epoch may place it
        again. If the CURRENT decision still allows it, the decision is
        marked stale so the next engine step re-decides immediately."""
        self._last_active = tuple(t for t in self._last_active
                                  if t != tenant)
        if self.decision is not None and tenant in self.decision.allowed:
            self._retired_pending = True

    def invalidate(self) -> None:
        """Mark the current decision stale (the world changed under it:
        a poisoned profile, an oracle stall) — the next engine step
        re-decides immediately instead of waiting out the epoch."""
        if self.decision is not None:
            self._retired_pending = True

    def may_admit(self, tenant: int, running_count: int) -> bool:
        """Admission gate consulted per admitted request. The base
        policy is truly admit-all — never gated on the (stale) epoch
        snapshot, so "none" is the engine's legacy behavior exactly."""
        if self.name == "none" or self.decision is None:
            return True
        return running_count < self.decision.cap(tenant)

    def _decide(self, view: EngineView) -> PlacementDecision:
        ts = view.tenants
        return PlacementDecision(
            step=view.step, policy=self.name, allowed=ts,
            caps={t: view.max_batch for t in ts},
            default_cap=view.max_batch)


class StaticPartition(PlacementPolicy):
    """Fixed 1/N admission slice per DECLARED tenant — isolating but
    non-adaptive: an idle tenant's slice is never reused."""

    name = "static"

    def __init__(self, tenants: Sequence[int], epoch_steps: int = 16):
        super().__init__(epoch_steps)
        self._universe = tuple(sorted(set(tenants)))
        if not self._universe:
            raise ValueError("static partition needs >= 1 declared tenant")

    def stale(self, active: Sequence[int]) -> bool:
        return False        # the partition is fixed; churn changes nothing

    def _decide(self, view: EngineView) -> PlacementDecision:
        share = max(view.max_batch // len(self._universe), 1)
        return PlacementDecision(
            step=view.step, policy=self.name, allowed=self._universe,
            caps={t: share for t in self._universe})


class GreedyShare(PlacementPolicy):
    """Equal share over currently-active tenants + pool backpressure.
    Adaptive (idle tenants' slots are redistributed) but blind to WHICH
    tenants contend on the memory system."""

    name = "greedy"

    def __init__(self, epoch_steps: int = 16,
                 pool_high_water: float = 0.9,
                 freeze_watermark: float = 0.97):
        super().__init__(epoch_steps)
        self.pool_high_water = pool_high_water
        self.freeze_watermark = freeze_watermark

    def _decide(self, view: EngineView) -> PlacementDecision:
        ts = view.tenants
        if not ts:
            return PlacementDecision(step=view.step, policy=self.name,
                                     allowed=(), caps={}, default_cap=1)
        if view.pool_used_frac >= self.freeze_watermark:
            return PlacementDecision(
                step=view.step, policy=self.name, allowed=(), caps={},
                default_cap=0, rung="freeze",
                note=f"pool pressure {view.pool_used_frac:.2f}: "
                     "admission frozen")
        budget = view.max_batch
        note, rung = "", "normal"
        if view.pool_used_frac > self.pool_high_water:
            budget = max(budget // 2, len(ts))
            note = f"pool pressure {view.pool_used_frac:.2f}: halved budget"
            rung = "quota"
        share = max(-(-budget // len(ts)), 1)       # ceil
        return PlacementDecision(
            step=view.step, policy=self.name, allowed=ts,
            caps={t: share for t in ts}, note=note, default_cap=1,
            rung=rung)


class OraclePlacement(PlacementPolicy):
    """Simulator-driven placement (see module docstring).

    Per epoch: enumerate co-run candidates over the (up to `slots`)
    longest-waiting active tenants, predict each through the oracle
    (KV-pressure-inflated, recalibration-corrected), keep candidates
    whose corrected max slowdown clears `unfairness_cap`, and pick the
    one serving the most tenants at the highest predicted weighted
    speedup. Admission caps then reserve batch slots for predicted
    victims; decode quotas shape per-step decode shares toward the
    predicted victims; and under KV pressure or heavy predicted
    unfairness the decision walks the degradation ladder
    (quota -> preempt -> freeze). The safe-mode state machine guards
    the whole thing: persistent prediction error degrades to static
    caps, then admit-all, and re-engages when the SHADOW error
    recovers.
    """

    name = "oracle"

    def __init__(self, oracle: ContentionOracle, epoch_steps: int = 16,
                 unfairness_cap: float = 1.15,
                 pool_high_water: float = 0.9,
                 quota_watermark: float = 0.75,
                 preempt_watermark: float = 0.9,
                 freeze_watermark: float = 0.97,
                 preempt_slowdown: float = 1.6,
                 max_preempt: int = 1,
                 degrade_error: float = 0.6,
                 reengage_error: float = 0.25,
                 error_window: int = 3,
                 recalibrator: Optional[Recalibrator] = None):
        super().__init__(epoch_steps)
        if not (0.0 < quota_watermark <= preempt_watermark
                <= freeze_watermark <= 1.0):
            raise ValueError(
                "watermarks must satisfy 0 < quota <= preempt <= freeze "
                f"<= 1, got {(quota_watermark, preempt_watermark, freeze_watermark)}")
        if reengage_error >= degrade_error:
            raise ValueError("need reengage_error < degrade_error "
                             "(hysteresis), got "
                             f"{(reengage_error, degrade_error)}")
        self.oracle = oracle
        self.unfairness_cap = unfairness_cap
        self.pool_high_water = pool_high_water
        self.quota_watermark = quota_watermark
        self.preempt_watermark = preempt_watermark
        self.freeze_watermark = freeze_watermark
        self.preempt_slowdown = preempt_slowdown
        self.max_preempt = max_preempt
        self.degrade_error = degrade_error
        self.reengage_error = reengage_error
        self.recalibrator = recalibrator if recalibrator is not None \
            else Recalibrator()
        # safe-mode state machine: 0 = oracle, 1 = static caps,
        # 2 = admit-all; driven by the rolling prediction error
        self.safe_level = 0
        self._errors: deque = deque(maxlen=max(error_window, 1))
        self._epochs_observed = 0
        self.mode_log: List[Tuple[int, int, float]] = []  # (obs#, level, err)
        # raw predicted slowdowns of the last chosen/shadow placement —
        # the recalibrator compares achieved feedback against these
        self._last_pred: Dict[int, float] = {}
        self._last_corrected_max: Optional[float] = None

    # -------------------------------------------------------- feedback
    def rolling_error(self) -> Optional[float]:
        if not self._errors:
            return None
        return sum(self._errors) / len(self._errors)

    def observe(self, achieved: Mapping[int, float]) -> None:
        """One closing epoch's achieved per-tenant slowdowns: update
        the recalibrator, the rolling prediction error, and the
        safe-mode level (full-window hysteresis both ways)."""
        self._epochs_observed += 1
        self.recalibrator.observe(achieved, self._last_pred)
        pred, vals = self._last_corrected_max, list(achieved.values())
        if pred is not None and vals:
            ach = max(vals)
            if ach > 0 and all(v > 0 and v == v for v in vals):
                self._errors.append(abs(pred - ach) / ach)
        roll = self.rolling_error()
        if roll is None or len(self._errors) < self._errors.maxlen:
            return
        level = self.safe_level
        if roll > self.degrade_error and level < 2:
            level += 1
        elif roll < self.reengage_error and level > 0:
            level -= 1
        if level != self.safe_level:
            self.safe_level = level
            self.mode_log.append((self._epochs_observed, level, roll))
            self._errors.clear()     # re-fill the window before moving again

    def retire(self, tenant: int) -> None:
        super().retire(tenant)
        self.oracle.evict_tenant(tenant)
        self.recalibrator.evict(tenant)
        self._last_pred.pop(tenant, None)

    # ---------------------------------------------------------- decide
    def _candidates(self, tenants: Tuple[int, ...]
                    ) -> List[Tuple[int, ...]]:
        """All non-empty subsets, smallest-last so ties in scoring
        resolve toward serving more tenants; deterministic order."""
        out: List[Tuple[int, ...]] = []
        n = len(tenants)
        for bits in range(1, 2 ** n):
            out.append(tuple(t for i, t in enumerate(tenants)
                             if bits >> i & 1))
        return sorted(out, key=lambda c: (len(c), c))

    def _corrected(self, p: PlacementPrediction) -> PlacementPrediction:
        """Apply the recalibrator's per-tenant corrections on top of
        the oracle's (already KV-inflated) prediction."""
        slow = {t: s * self.recalibrator.correction(t)
                for t, s in p.slowdown.items()}
        return dataclasses.replace(p, slowdown=slow,
                                   max_slowdown=max(slow.values()))

    def _equal_share(self, view: EngineView, note: str,
                     rung: str) -> PlacementDecision:
        limit = view.max_running or view.max_batch
        active = view.tenants
        share = max(-(-limit // max(len(active), 1)), 1)
        return PlacementDecision(
            step=view.step, policy=self.name, allowed=active,
            caps={t: share for t in active}, default_cap=1,
            note=note, rung=rung)

    def _decode_quota(self, view: EngineView,
                      chosen: PlacementPrediction,
                      tighten: bool) -> Dict[int, int]:
        """Per-step decode shares proportional to corrected predicted
        slowdown (predicted victims get more of the decode batch; the
        aggressor is throttled). Enforcement is work-conserving — the
        engine backfills idle decode slots with throttled requests —
        so shaping only redistributes under contention. `tighten`
        (pool pressure past the quota watermark) halves every share,
        slowing the pool's page-append rate."""
        if len(chosen.tenants) < 2:
            return {}
        tot = sum(chosen.slowdown.values())
        quota: Dict[int, int] = {}
        for t in chosen.tenants:
            q = max(int(round(view.max_batch * chosen.slowdown[t] / tot)), 1)
            quota[t] = max(q // 2, 1) if tighten else q
        return quota

    def _preempt_plan(self, view: EngineView,
                      chosen: Optional[PlacementPrediction],
                      pressure_rung: bool) -> Dict[int, int]:
        """Who to evict. Pool-pressure preemption targets the tenant
        holding the most KV pages; fairness preemption targets the
        predicted aggressor when the predicted victim has queued work
        and the running set is full (admission caps can't evict — this
        is the mechanism that pays off on saturating floods)."""
        if pressure_rung and view.pages_by_tenant:
            heavy = max(sorted(view.pages_by_tenant),
                        key=lambda t: view.pages_by_tenant[t])
            if view.running.get(heavy, 0) > 0:
                return {heavy: self.max_preempt}
        if chosen is not None and len(chosen.tenants) >= 2 \
                and chosen.max_slowdown > self.preempt_slowdown:
            victim, aggr = chosen.victim(), chosen.aggressor()
            limit = view.max_running or view.max_batch
            full = sum(view.running.values()) >= limit
            if (victim != aggr and view.queued.get(victim, 0) > 0
                    and full and view.running.get(aggr, 0) >= 2):
                return {aggr: self.max_preempt}
        return {}

    def _decide(self, view: EngineView) -> PlacementDecision:
        active = view.tenants
        if not active:
            return PlacementDecision(step=view.step, policy=self.name,
                                     allowed=(), caps={}, default_cap=1)
        if view.step < self.stall_until:
            # oracle-latency fault: predictions missed their budget this
            # epoch — fail soft to contention-blind equal share
            return self._equal_share(
                view, "oracle stalled: equal share", "stalled")
        # consider the longest-waiting tenants first when over-wide
        consider = sorted(
            active,
            key=lambda t: (view.waiting_since.get(t, view.step), t)
        )[: self.oracle.slots]
        consider = tuple(sorted(consider))
        cands = self._candidates(consider)
        preds = [self._corrected(p) for p in self.oracle.predict(
            cands, view.profiles, pool_pressure=view.pool_used_frac)
            if p is not None]
        if not preds:
            # every candidate's simulation failed: fail soft to greedy
            return self._equal_share(
                view, "oracle predictions unavailable; equal share",
                "normal")
        note = ""
        feasible = [p for p in preds
                    if p.max_slowdown <= self.unfairness_cap]
        if feasible:
            # serve the most tenants at the best predicted speedup;
            # deterministic tie-break on the tenant tuple
            chosen = max(feasible, key=lambda p: (
                len(p.tenants), p.weighted_speedup, p.tenants))
        else:
            chosen = min(preds, key=lambda p: (
                p.max_slowdown, -len(p.tenants), p.tenants))
            note = (f"no candidate under unfairness cap "
                    f"{self.unfairness_cap}: min-slowdown fallback")
        # feedback anchors: achieved slowdowns are compared against the
        # RAW (pre-correction) predictions for the placement we applied
        # (or would have applied — the safe-mode shadow)
        corr = self.recalibrator
        self._last_pred = {
            t: chosen.slowdown[t] / max(corr.correction(t), 1e-9)
            for t in chosen.tenants}
        self._last_corrected_max = chosen.max_slowdown

        # ---- safe mode: the oracle's own output is not trusted -------
        if self.safe_level >= 2:
            limit = view.max_running or view.max_batch
            return PlacementDecision(
                step=view.step, policy=self.name, allowed=active,
                caps={t: limit for t in active}, default_cap=limit,
                note="safe mode: admit-all (oracle disengaged)",
                rung="safe_open")
        if self.safe_level == 1:
            d = self._equal_share(
                view, "safe mode: static equal caps", "safe_static")
            return d

        # ---- engaged: build the placement, then walk the ladder ------
        pressure = view.pool_used_frac
        if pressure >= self.freeze_watermark:
            return PlacementDecision(
                step=view.step, policy=self.name, allowed=(), caps={},
                default_cap=0, predictions=tuple(preds), chosen=chosen,
                preempt=self._preempt_plan(view, chosen, True),
                note=f"pool pressure {pressure:.2f}: admission frozen",
                rung="freeze")
        allowed = chosen.tenants
        limit = view.max_running or view.max_batch
        # Latent-tenant headroom: declared tenants (profiles) that are
        # idle right now WILL come back; holding a slot for them means
        # their first request admits instantly instead of waiting out a
        # full batch of long decodes (admission caps can't evict).
        latent = min(len([t for t in view.profiles if t not in allowed]), 2)
        caps: Dict[int, int] = {}
        if len(allowed) == 1:
            caps[allowed[0]] = max(limit - latent, 1)
        else:
            # one reserved admission slot per co-tenant: enough for the
            # predicted victim's first request to admit instantly, and
            # cheap enough (1/limit capacity) that a backlogged
            # aggressor is not pushed into queue divergence
            for t in allowed:
                others = len(allowed) - 1
                caps[t] = max(limit - others - latent, 1)
        rung = "normal"
        tighten = pressure >= self.quota_watermark
        if tighten:
            rung = "quota"
            note = (note + "; " if note else "") + (
                f"pool pressure {pressure:.2f}: decode quotas tightened")
        if pressure > self.pool_high_water:
            caps = {t: max(c // 2, 1) for t, c in caps.items()}
            note = (note + "; " if note else "") + (
                f"pool pressure {pressure:.2f}: halved caps")
        quota = self._decode_quota(view, chosen, tighten)
        preempt = self._preempt_plan(
            view, chosen, pressure >= self.preempt_watermark)
        if preempt:
            rung = "preempt"
            note = (note + "; " if note else "") + (
                "preempting " + ", ".join(
                    f"{k}x tenant {t}" for t, k in sorted(preempt.items())))
        return PlacementDecision(
            step=view.step, policy=self.name, allowed=allowed, caps=caps,
            predictions=tuple(preds), chosen=chosen, note=note,
            default_cap=1, decode_quota=quota, preempt=preempt,
            rung=rung)


POLICIES = ("none", "static", "greedy", "oracle")


def make_policy(name: str,
                profiles: Optional[Mapping[int, str]] = None,
                oracle: Optional[ContentionOracle] = None,
                epoch_steps: int = 16,
                **kw) -> PlacementPolicy:
    """Factory used by the benchmark/CLI: policy name -> instance.

    `profiles` (tenant -> declared app profile) is required for
    "static" (it declares the tenant universe); "oracle" builds a
    default `ContentionOracle` when none is passed (kw: design, cycles,
    slots, unfairness_cap, ...).
    """
    if name == "none":
        return PlacementPolicy(epoch_steps=epoch_steps)
    if name == "static":
        if not profiles:
            raise ValueError("static placement needs declared profiles "
                             "(the tenant universe)")
        return StaticPartition(tuple(profiles), epoch_steps=epoch_steps)
    if name == "greedy":
        return GreedyShare(epoch_steps=epoch_steps, **kw)
    if name == "oracle":
        pol_kw = {k: kw.pop(k) for k in (
            "unfairness_cap", "pool_high_water", "quota_watermark",
            "preempt_watermark", "freeze_watermark", "preempt_slowdown",
            "max_preempt", "degrade_error", "reengage_error",
            "error_window", "recalibrator") if k in kw}
        if oracle is None:
            oracle = ContentionOracle(**kw)
        return OraclePlacement(oracle, epoch_steps=epoch_steps, **pol_kw)
    raise KeyError(f"unknown placement policy {name!r}: {POLICIES}")
