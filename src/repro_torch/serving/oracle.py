"""Contention oracle: the memory-system simulator as an admission/
placement advisor for the serving engine (port of `repro.serving.oracle`).

Tenants declare an app *profile* ("interactive", "heavy", a Table 2
bench name, ...); the oracle maps profiles to calibrated simulator
benches (`repro_torch.sim.profiles`) and asks the simulator how candidate
co-placements would contend: for every candidate set of tenants it
returns the predicted weighted speedup, max slowdown (unfairness), and
per-tenant slowdown of co-running their benches on the shared memory
system under the oracle's design point.

Cost discipline — the oracle must be cheap enough to consult every
decision epoch of a serving loop:

* ONE `run_grid` call per epoch: all uncached candidate mixes plus the
  solo-baseline rows their benches need batch through
  `runner.predict_mixes` as a single vmapped grid execution.
* ONE plan per signature group for the oracle's LIFETIME: mixes are
  padded to a fixed `slots` count and the row count to a fixed
  `pad_rows` multiple, so repeated epochs set up no new plan (counted by
  `runner.TRACE_COUNT`).
* Memoized by frozen mix key: a candidate's benches, sorted, key its
  prediction — an epoch whose candidates were all seen before costs no
  simulation at all. Solo IPCs are cached per bench the same way.
* Fail-soft: with `fail_soft=True` (default) a failing simulation
  chunk poisons only its own candidates (their prediction is None and
  the `FailureRecord` is kept on `self.failures`); the serving loop
  keeps running on the surviving predictions.

Predictions are deterministic: the simulator is seeded and
deterministic, and candidate keys/memo insertion order are canonical.
The grid runs on the oracle's `device` (None means the card, and raises
without one); on the card every simulated cycle of a pass is one launch
of the `fused_tlb` kernel for all of the pass's rows.

Overload awareness:

* KV pressure: `predict(..., pool_pressure=f)` inflates predicted
  slowdowns of multi-tenant candidates as the paged KV pool nears
  exhaustion, so admission/quota decisions anticipate page exhaustion
  BEFORE it happens (inflation is applied post-memo — the raw
  simulator prediction stays cached pressure-free).
* Self-correction: `Recalibrator` folds achieved per-tenant slowdowns
  back into the profile->bench calibration as a bounded, clamped EWMA
  correction factor — a corrupt measurement (poisoned profile, NaN)
  cannot destabilize placement.
* Tenant eviction: `evict_tenant` drops a departed tenant from the
  tenant-keyed profile-resolution cache immediately, so an id reused
  after churn can never be predicted under the dead tenant's profile.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.design import Design, as_design
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim import runner as sim_runner
from repro_torch.sim.profiles import DEFAULT_PROFILE, bench_for_profile


@dataclasses.dataclass(frozen=True)
class PlacementPrediction:
    """A candidate tenant co-placement with its predicted contention."""

    tenants: Tuple[int, ...]          # sorted tenant ids
    benches: Tuple[str, ...]          # aligned with `tenants`
    weighted_speedup: float
    max_slowdown: float
    slowdown: Mapping[int, float]     # per tenant

    def victim(self) -> int:
        """The tenant predicted to suffer most from this placement."""
        return max(self.tenants, key=lambda t: (self.slowdown[t], t))

    def aggressor(self) -> int:
        """The tenant predicted to suffer least — the one whose presence
        costs the others (preemption's default target)."""
        return min(self.tenants, key=lambda t: (self.slowdown[t], -t))


class Recalibrator:
    """Online profile->bench calibration correction from achieved
    slowdowns (the serving analogue of re-fitting Table 2).

    Per tenant a multiplicative correction factor `c_t` scales the
    oracle's predicted slowdowns; each decision epoch the factor moves
    toward the achieved/predicted ratio by a bounded EWMA step. Three
    guards keep a corrupt measurement (poisoned profile, NaN latency,
    a starved epoch) from destabilizing placement:

    * non-finite / non-positive measurements are ignored outright;
    * one update can move `c_t` by at most `max_step` multiplicatively;
    * `c_t` itself is clamped into `bounds` forever.
    """

    def __init__(self, alpha: float = 0.35,
                 bounds: Tuple[float, float] = (0.5, 4.0),
                 max_step: float = 1.5):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if bounds[0] <= 0 or bounds[0] > 1.0 or bounds[1] < 1.0:
            raise ValueError(f"bounds must bracket 1.0, got {bounds}")
        if max_step <= 1.0:
            raise ValueError(f"max_step must be > 1, got {max_step}")
        self.alpha = alpha
        self.bounds = bounds
        self.max_step = max_step
        self._corr: Dict[int, float] = {}
        self.updates = 0
        self.rejected = 0                 # corrupt measurements ignored
        self.last_delta = 0.0             # |log step| of the last update

    def correction(self, tenant: int) -> float:
        return self._corr.get(tenant, 1.0)

    def corrections(self) -> Dict[int, float]:
        return dict(self._corr)

    def observe(self, achieved: Mapping[int, float],
                predicted: Mapping[int, float]) -> None:
        """Fold one epoch's achieved per-tenant slowdowns into the
        correction factors (see class docstring for the guards)."""
        lo, hi = self.bounds
        for t in sorted(achieved):
            ach, pred = achieved[t], predicted.get(t)
            if pred is None:
                continue
            if not (math.isfinite(ach) and math.isfinite(pred)
                    and ach > 0 and pred > 0):
                self.rejected += 1
                continue
            cur = self.correction(t)
            # ratio of achieved to the CORRECTED prediction: 1.0 means
            # the current correction is already right
            ratio = ach / (pred * cur)
            ratio = min(max(ratio, 1.0 / self.max_step), self.max_step)
            step = ratio ** self.alpha
            self._corr[t] = min(max(cur * step, lo), hi)
            self.last_delta = abs(math.log(step))
            self.updates += 1

    def evict(self, tenant: int) -> None:
        """Drop a departed tenant's correction (an id reused after
        churn starts calibration-fresh)."""
        self._corr.pop(tenant, None)


class ContentionOracle:
    """Maps tenant profiles to benches and batch-predicts candidate
    placements through the simulator (see module docstring)."""

    def __init__(self, design: object = "mask", cycles: int = 1_500,
                 slots: int = 4, pad_rows: int = 16,
                 fail_soft: bool = True,
                 kv_watermark: float = 0.6, kv_gain: float = 0.6,
                 device: DeviceLike = None):
        self.design: Design = as_design(design)
        self.device = resolve_device(device)
        self.cycles = int(cycles)
        self.slots = int(slots)
        self.pad_rows = int(pad_rows)
        self.fail_soft = fail_soft
        if not 0.0 < kv_watermark < 1.0:
            raise ValueError(f"kv_watermark must be in (0,1): {kv_watermark}")
        self.kv_watermark = kv_watermark
        self.kv_gain = kv_gain
        # frozen mix key (sorted bench tuple) -> prediction (None = failed)
        self._memo: Dict[Tuple[str, ...],
                         Optional[sim_runner.MixPrediction]] = {}
        self._solo: Dict[str, float] = {}       # bench -> IPC_alone
        # tenant id -> resolved bench, evicted on tenant departure so a
        # reused id can never predict under the dead tenant's profile
        self._tenant_bench: Dict[int, str] = {}
        self.failures: List[sim_runner.FailureRecord] = []
        self.grid_calls = 0                     # run_grid invocations

    # ------------------------------------------------------------ core
    def predict_benches(self, bench_mixes: Sequence[Sequence[str]]
                        ) -> List[Optional[sim_runner.MixPrediction]]:
        """Predict raw bench mixes; memoized, one grid call for all
        fresh keys. Returns None for mixes whose simulation failed
        (fail-soft; the FailureRecord lands on `self.failures`)."""
        keys = [tuple(sorted(m)) for m in bench_mixes]
        fresh: List[Tuple[str, ...]] = []
        for k in keys:
            if k not in self._memo and k not in fresh:
                fresh.append(k)
        if fresh:
            preds = sim_runner.predict_mixes(
                self.design, fresh, cycles=self.cycles, slots=self.slots,
                pad_rows=self.pad_rows, fail_soft=self.fail_soft,
                solo_cache=self._solo, device=self.device)
            self.grid_calls += 1
            for k, p in zip(fresh, preds):
                if isinstance(p, sim_runner.FailureRecord):
                    self.failures.append(p)
                    self._memo[k] = None
                else:
                    self._memo[k] = p
        return [self._memo[k] for k in keys]

    def _bench_of(self, tenant: int, profiles: Mapping[int, str]) -> str:
        """Tenant -> bench through the tenant-keyed resolution cache
        (evicted by `evict_tenant` on departure — the churn-staleness
        regression surface)."""
        b = self._tenant_bench.get(tenant)
        if b is None:
            b = bench_for_profile(profiles.get(tenant, DEFAULT_PROFILE))
            self._tenant_bench[tenant] = b
        return b

    def kv_inflation(self, n_tenants: int, pool_pressure: float) -> float:
        """Multiplicative slowdown inflation anticipating KV-page
        exhaustion: grows past `kv_watermark` occupancy and with the
        candidate's width (each extra co-tenant appends pages faster),
        so wide placements become infeasible BEFORE the pool runs dry."""
        excess = max(0.0, pool_pressure - self.kv_watermark)
        if excess <= 0.0 or n_tenants <= 1:
            return 1.0
        return 1.0 + self.kv_gain * (n_tenants - 1) * excess \
            / (1.0 - self.kv_watermark)

    def predict(self, candidates: Sequence[Sequence[int]],
                profiles: Mapping[int, str],
                pool_pressure: float = 0.0
                ) -> List[Optional[PlacementPrediction]]:
        """Predict candidate tenant sets. `profiles` maps tenant id to
        a declared app profile (missing tenants get DEFAULT_PROFILE);
        `pool_pressure` (the KV pool's used_frac) inflates multi-tenant
        candidates' slowdowns post-memo (see `kv_inflation`)."""
        cands = [tuple(sorted(c)) for c in candidates]
        if any(len(c) > self.slots for c in cands):
            raise ValueError(
                f"candidate exceeds oracle slots={self.slots}: "
                f"{max(cands, key=len)}")
        benches = [tuple(self._bench_of(t, profiles) for t in c)
                   for c in cands]
        base = self.predict_benches(benches)
        out: List[Optional[PlacementPrediction]] = []
        for tenants, bs, p in zip(cands, benches, base):
            if p is None:
                out.append(None)
                continue
            # p.benches is the sorted key; align tenants the same way
            # (equal benches are interchangeable slots)
            order = sorted(zip(bs, tenants))
            infl = self.kv_inflation(len(tenants), pool_pressure)
            slowdown = {t: p.slowdown[i] * infl
                        for i, (_, t) in enumerate(order)}
            out.append(PlacementPrediction(
                tenants=tenants, benches=bs,
                weighted_speedup=p.weighted_speedup,
                max_slowdown=max(slowdown.values()), slowdown=slowdown))
        return out

    def evict_tenant(self, tenant: int) -> None:
        """Forget a departed tenant immediately: its profile resolution
        leaves the tenant-keyed cache (bench-keyed sim predictions stay
        — they are profile-content-addressed and shareable)."""
        self._tenant_bench.pop(tenant, None)

    # ------------------------------------------------------ inspection
    @property
    def memo_size(self) -> int:
        return len(self._memo)

    def tenant_benches(self) -> Dict[int, str]:
        """The live tenant->bench resolution cache (a copy)."""
        return dict(self._tenant_bench)

    def solo_ipc(self) -> Dict[str, float]:
        """Cached per-bench IPC_alone baselines (a copy)."""
        return dict(self._solo)
