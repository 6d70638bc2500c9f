"""Multi-tenant continuous-batching serving engine (port of
`repro.serving.engine`).

Requests from multiple tenants (ASIDs) share one model + one paged KV pool.
Scheduling is the paper's three-class discipline (core.dram_sched
semantics transplanted to request admission, §5.4):

  Golden — translation/metadata work (page allocation, table updates,
           admission) always runs before token work each step.
  Silver — one tenant at a time gets guaranteed decode slots, quota
           proportional to Concurrent_i * Stalled_i (Eq. 1 analogue:
           in-flight sequences x queue depth).
  Normal — remaining decode slots round-robin over other tenants.

Admission is additionally gated by a pluggable placement policy
(serving.placement): once per decision epoch the policy — possibly
consulting the simulator-backed contention oracle (serving.oracle) —
decides which tenants may co-run and each tenant's admission cap;
decisions are recorded on `self.decisions` for the predicted-vs-achieved
fairness accounting.

Overload tolerance:

* Admission capacity and decode capacity are decoupled: up to
  `EngineConfig.max_running` requests may hold KV sequence slots while
  only `max_batch` decode per step (`max_running=None` keeps the
  coupling). Decisions' per-tenant *decode quotas* then shape who gets
  the decode batch, enforced work-conservingly: a quota-throttled
  request still runs when slots would otherwise idle.
* Decisions may carry a *preemption directive*: the engine evicts a
  running victim — KV pages released through the pool entry points
  exactly once, generated tokens discarded (and counted on
  `Request.wasted_tokens`: the re-prefill is honest re-accounting, not
  free work), and the request re-queued with seeded exponential backoff
  under a bounded retry budget. A request that exhausts its budget
  becomes immune to further preemption; nothing is ever dropped.
* Achieved per-tenant slowdowns for each closing decision epoch feed
  `placement.observe(...)` — the oracle policy's recalibration +
  safe-mode loop runs on exactly this signal.
* `EngineConfig.fault_plan` (`sim.faults.ServingFaultPlan`) injects
  seeded overload faults at step boundaries: pool-exhaustion spikes
  (phantom KV sequences), oracle-latency stalls, poisoned tenant
  profiles. Deterministic and replayable bit-for-bit.

The engine, its pool, its forwards and (through the policy) the oracle's
simulator all run on the engine's `device`: None means the card, and
raises without one. The scheduling is host Python, as in the reference;
the pool's tables and the model's tensors live on the device. Token
selection is an argmax on the device read back with `int(...)`, and each
admission reads its `ok` back with `bool(...)`, as the reference does.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.memmgr import kv_cache as kvc
from repro_torch.models import model as M
from repro_torch.serving.placement import (EngineView, PlacementDecision,
                                           PlacementPolicy)
from repro_torch.sim.faults import ServingFaultPlan


@dataclasses.dataclass
class Request:
    rid: int
    tenant: int
    prompt: np.ndarray
    max_new: int                 # decode steps (prefill token not counted)
    out: List[int] = dataclasses.field(default_factory=list)
    seq_slot: int = -1
    submit_step: int = 0
    first_token_step: int = -1   # FIRST prefill emission step (TTFT anchor;
    #                              preserved across preemptions)
    finish_step: int = -1
    retries: int = 0             # times preempted so far
    backoff_until: int = 0       # parked until this engine step
    wasted_tokens: int = 0       # tokens discarded by preemptions

    @property
    def decoded(self) -> int:
        """Tokens produced by DECODE steps. `out` also holds the token
        the prefill emitted, so completion/throughput accounting uses
        this, not len(out) — a request runs exactly
        min(max_new, decode_len_cap) decode steps."""
        return max(len(self.out) - 1, 0)


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8           # decode slots per step
    thres_max: int = 16          # silver quota scale
    decode_len_cap: int = 256
    # -- overload tolerance --------------------------------------------
    max_running: Optional[int] = None   # admission bound (None: max_batch,
    #                                     the coupled behavior)
    max_retries: int = 4         # preemptions allowed per request before
    #                              it becomes preemption-immune
    backoff_base: int = 2        # steps; backoff = base * 2^(retries-1) + jitter
    backoff_seed: int = 0        # seeds the deterministic backoff jitter
    fault_plan: Optional[ServingFaultPlan] = None


def stub_forwards():
    """Canonical token-compute stubs for the `forwards` seam: constant
    logits (argmax -> token 0) on the device of the tokens, no KV
    tensors. Scheduling behavior — admission, silver rotation, placement,
    completion — is identical to a real model's; only the token values
    differ."""
    def prefill(cfg, run, params, batch, max_len=None):
        tokens = batch["tokens"]
        return torch.zeros((1, tokens.shape[1], 8), device=tokens.device), {}

    def decode(cfg, run, params, batch, caches):
        return torch.zeros((1, 1, 8), device=batch["tokens"].device), caches
    return prefill, decode


def stub_model_config(vocab_size: int = 64):
    """Minimal cfg satisfying the engine's host-side checks (no real
    model fields needed when `forwards` is stubbed)."""
    import types
    return types.SimpleNamespace(n_patches=0, is_enc_dec=False,
                                 vocab_size=vocab_size)


def backoff_steps(seed: int, rid: int, retries: int, base: int) -> int:
    """Deterministic exponential backoff with seeded per-(request, retry)
    jitter: `base * 2^(retries-1) + jitter`, jitter in [0, base). Same
    (seed, rid, retries) -> same delay, bit for bit."""
    rng = np.random.RandomState(
        (seed * 1_000_003 + rid * 7_919 + retries) % (2 ** 31))
    return base * 2 ** max(retries - 1, 0) + int(rng.randint(0, max(base, 1)))


class ServingEngine:
    """Reference-scale engine: per-request dense caches, one forward per
    request per step; the same scheduling laws as the reference's."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, params,
                 pool_cfg: kvc.PoolConfig, ecfg: EngineConfig = EngineConfig(),
                 placement: Optional[PlacementPolicy] = None,
                 profiles: Optional[Mapping[int, str]] = None,
                 forwards: Optional[Tuple] = None,
                 solo_hint: Optional[Mapping[int, float]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.run = run
        self.params = params
        self.pool_cfg = pool_cfg
        self.ecfg = ecfg
        self.pool = kvc.init(pool_cfg, device=self.device)
        self.queues: Dict[int, deque] = {}
        self.running: List[Request] = []
        self.parked: List[Request] = []     # preempted, in backoff
        self.finished: List[Request] = []
        self.step_count = 0
        self.silver_tenant = 0
        self.silver_left = 1
        self.placement = placement if placement is not None \
            else PlacementPolicy()
        self.profiles: Dict[int, str] = dict(profiles or {})
        self.decisions: List[PlacementDecision] = []
        # mean solo latency per tenant (steps): the achieved-slowdown
        # anchor fed back to the policy; without it an intrinsic proxy
        # (decode length) is used
        self.solo_hint: Dict[int, float] = dict(solo_hint or {})
        self._free_slots = list(range(pool_cfg.max_seqs))
        self._prefill_cache: Dict[int, dict] = {}
        self._silver_quota_used = 0
        # overload accounting / fault state
        self.submitted = 0
        self.preemptions = 0
        self.preempt_log: List[Tuple[int, int, int]] = []  # (step, tenant, rid)
        self.fault_log: List[Tuple[int, str, int]] = []    # (step, kind, tenant)
        self._phantoms: List[Tuple[int, int]] = []         # (slot, release_step)
        self._poisons: List[Tuple[int, int, str]] = []     # (restore, t, orig)
        self._epoch_finished: List[Request] = []
        # (prefill_fn, decode_fn) seam: benchmarks/tests that measure
        # SCHEDULING (steps, not wall-clock) stub the token compute
        self._fwd_prefill, self._fwd_decode = (
            forwards if forwards is not None
            else (M.forward_prefill, M.forward_decode))

    @property
    def max_running(self) -> int:
        """Admission bound: sequences that may hold KV slots at once
        (decode capacity stays `max_batch` per step)."""
        return self.ecfg.max_running or self.ecfg.max_batch

    # ------------------------------------------------------------- API
    def submit(self, req: Request):
        req.submit_step = self.step_count
        self.submitted += 1
        self.queues.setdefault(req.tenant, deque()).append(req)

    def retire_tenant(self, tenant: int):
        """The tenant departed for good (stream churn): the placement
        layer must never place it again, and its profile resolution
        leaves the oracle's memoized key-space immediately."""
        self.profiles.pop(tenant, None)
        self.solo_hint.pop(tenant, None)
        if not self.queues.get(tenant):
            self.queues.pop(tenant, None)
        self.placement.retire(tenant)

    def pending(self) -> int:
        """Requests not yet finished: queued + running + parked.
        (The conservation invariant: submitted == pending + finished.)"""
        return (len(self.running) + len(self.parked)
                + sum(len(q) for q in self.queues.values()))

    def _running_count(self, tenant: int) -> int:
        return sum(1 for r in self.running if r.tenant == tenant)

    def view(self) -> EngineView:
        """Host-side snapshot the placement policy decides from.
        Parked (preempted, backing off) requests count as queued — they
        are waiting work the policy must plan for. Phantom fault
        sequences inflate pool pressure (that is the fault) but are not
        attributed to any tenant."""
        pressure = kvc.pool_pressure(self.pool_cfg, self.pool)
        queued = {t: len(q) for t, q in self.queues.items()}
        waiting = {t: q[0].submit_step
                   for t, q in self.queues.items() if q}
        for r in self.parked:
            queued[r.tenant] = queued.get(r.tenant, 0) + 1
            waiting[r.tenant] = min(waiting.get(r.tenant, r.submit_step),
                                    r.submit_step)
        return EngineView(
            step=self.step_count,
            max_batch=self.ecfg.max_batch,
            queued=queued,
            running={t: self._running_count(t)
                     for t in {r.tenant for r in self.running}},
            waiting_since=waiting,
            pool_used_frac=pressure.used_frac,
            pool_free_seqs=pressure.free_seqs,
            profiles=self.profiles,
            pool_free_pages=pressure.free_pages,
            pages_by_tenant={t: n for t, n in pressure.pages_by_tenant.items()
                             if t != kvc.PHANTOM_ASID},
            max_running=self.max_running)

    def _quota(self) -> Dict[int, int]:
        """Eq. (1) analogue over tenants with queued work."""
        w = {t: max(len(q), 1) * (1 + sum(1 for r in self.running
                                          if r.tenant == t))
             for t, q in self.queues.items() if q}
        tot = sum(w.values()) or 1
        return {t: max(self.ecfg.thres_max * v // tot, 1)
                for t, v in w.items()}

    # ------------------------------------------------------- scheduling
    def _unpark(self):
        """Parked requests whose backoff expired rejoin the FRONT of
        their tenant queue (they were already admitted once)."""
        due = [r for r in self.parked if r.backoff_until <= self.step_count]
        for r in reversed(due):
            self.queues.setdefault(r.tenant, deque()).appendleft(r)
        for r in due:
            self.parked.remove(r)

    def _admit(self):
        """Golden phase: admissions + page allocation first. The
        placement decision gates every admission: a tenant outside the
        epoch's allowed set, or at its admission cap, keeps queueing
        (its running requests still decode — caps are admission-only)."""
        self._unpark()
        tenants = sorted(self.queues)
        # silver tenant first
        order = ([self.silver_tenant] +
                 [t for t in tenants if t != self.silver_tenant])
        for t in order:
            q = self.queues.get(t)
            while (q and len(self.running) < self.max_running
                   and self._free_slots
                   and self.placement.may_admit(t, self._running_count(t))):
                req = q.popleft()
                slot = self._free_slots.pop()
                self.pool, ok = kvc.admit_seq(self.pool_cfg, self.pool, slot,
                                              t, len(req.prompt))
                if not bool(ok):
                    self._free_slots.append(slot)
                    q.appendleft(req)
                    break
                req.seq_slot = slot
                self._prefill(req)
                self.running.append(req)

    def _tokens(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32),
                               device=self.device)

    def _prefill(self, req: Request):
        batch = {"tokens": self._tokens(req.prompt)[None]}
        if self.cfg.n_patches:
            batch["patch_embeds"] = torch.zeros(
                (1, self.cfg.n_patches, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        if self.cfg.is_enc_dec:
            batch["frames"] = torch.zeros(
                (1, self.cfg.enc_len, self.cfg.d_model),
                dtype=torch.bfloat16, device=self.device)
        logits, caches = self._fwd_prefill(
            self.cfg, self.run, self.params, batch,
            max_len=self.pool_cfg.pages_per_seq * self.pool_cfg.page_size)
        tok = int(torch.argmax(logits[0, -1]))
        req.out.append(tok)
        if req.first_token_step < 0:    # TTFT anchors to the FIRST prefill
            req.first_token_step = self.step_count
        self._prefill_cache[req.rid] = caches

    # ------------------------------------------------------- preemption
    def _preempt_one(self, tenant: int) -> bool:
        """Evict one of `tenant`'s running requests: KV pages released
        exactly once through the pool entry point, generated tokens
        discarded (counted as wasted — the later re-prefill is honest
        re-accounting), request parked under seeded exponential backoff.
        Requests that exhausted the retry budget are immune; returns
        False when no victim is eligible."""
        cands = [r for r in self.running
                 if r.tenant == tenant and r.retries < self.ecfg.max_retries]
        if not cands:
            return False
        # least progress lost: evict the request with the fewest decoded
        # tokens (deterministic tie-break on submit order, then rid)
        req = min(cands, key=lambda r: (r.decoded, -r.submit_step, r.rid))
        self.running.remove(req)
        self.pool = kvc.release_seq(self.pool_cfg, self.pool, req.seq_slot)
        self._free_slots.append(req.seq_slot)
        self._prefill_cache.pop(req.rid, None)
        req.wasted_tokens += len(req.out)
        req.out.clear()
        req.seq_slot = -1
        req.retries += 1
        req.backoff_until = self.step_count + backoff_steps(
            self.ecfg.backoff_seed, req.rid, req.retries,
            self.ecfg.backoff_base)
        self.parked.append(req)
        self.preemptions += 1
        self.preempt_log.append((self.step_count, tenant, req.rid))
        return True

    def _execute_preemptions(self, decision: PlacementDecision):
        for t, k in sorted(decision.preempt.items()):
            for _ in range(k):
                if not self._preempt_one(t):
                    break

    # ------------------------------------------------- epoch feedback
    def _observe_epoch(self):
        """Achieved per-tenant slowdowns over the closing epoch's
        finished requests, fed to the placement policy (recalibration +
        safe-mode input). Slowdown anchor: `solo_hint` mean solo latency
        when known, else the request's intrinsic decode length (its
        un-contended latency is ~1 token/step)."""
        fin, self._epoch_finished = self._epoch_finished, []
        if not fin:
            return
        lat: Dict[int, List[Request]] = {}
        for r in fin:
            lat.setdefault(r.tenant, []).append(r)
        achieved: Dict[int, float] = {}
        for t, rs in lat.items():
            mean = sum(r.finish_step - r.submit_step + 1
                       for r in rs) / len(rs)
            solo = self.solo_hint.get(t)
            if not solo or solo <= 0:
                solo = max(sum(min(r.max_new, self.ecfg.decode_len_cap)
                               for r in rs) / len(rs), 1.0)
            achieved[t] = mean / solo
        self.placement.observe(achieved)

    # --------------------------------------------------- fault injection
    def _apply_faults(self):
        """Expire standing serving faults, then fire this step's
        (seeded plan on `EngineConfig.fault_plan`)."""
        for slot, rel in list(self._phantoms):
            if rel <= self.step_count:
                self.pool = kvc.release_seq(self.pool_cfg, self.pool, slot)
                self._free_slots.append(slot)
                self._phantoms.remove((slot, rel))
        for rel, t, orig in list(self._poisons):
            if rel <= self.step_count:
                self.profiles[t] = orig
                self._evict_profile(t)
                self._poisons.remove((rel, t, orig))
        plan = self.ecfg.fault_plan
        if plan is None:
            return
        for f in plan.at_step(self.step_count):
            self.fault_log.append((self.step_count, f.kind, f.tenant))
            if f.kind == "oracle_stall":
                self.placement.stall_until = self.step_count + f.duration
                self.placement.invalidate()   # re-decide into the stall now
            elif f.kind == "profile_poison":
                orig = self.profiles.get(f.tenant, "batch")
                self._poisons.append(
                    (self.step_count + f.duration, f.tenant, orig))
                self.profiles[f.tenant] = f.profile
                self._evict_profile(f.tenant)
            elif f.kind == "pool_spike":
                pages = f.pages or self.pool_cfg.n_pages // 2
                self.pool, slots = kvc.occupy_pages(
                    self.pool_cfg, self.pool, self._free_slots, pages)
                rel = self.step_count + f.duration
                self._phantoms.extend((s, rel) for s in slots)

    def _evict_profile(self, tenant: int):
        """Bust the oracle's tenant->bench resolution for `tenant` (its
        declared profile changed) and force an early re-decision."""
        oracle = getattr(self.placement, "oracle", None)
        if oracle is not None:
            oracle.evict_tenant(tenant)
        self.placement.invalidate()

    # ----------------------------------------------------------- decode
    def _select_decode_batch(self) -> List[Request]:
        """Silver quota first, then normal-class round over the rest.
        Silver requests beyond the quota backfill as NORMAL class: they
        run only when slots would otherwise go unused and do not burn
        silver quota (`_silver_quota_used` counts only the quota-class
        head of the batch).

        Placement decode quotas shape the batch work-conservingly in two
        passes: pass 1 respects each tenant's quota, pass 2 backfills
        idle decode slots with throttled requests — shaping only ever
        redistributes a CONTENDED batch, never idles a slot."""
        silver = [r for r in self.running if r.tenant == self.silver_tenant]
        others = [r for r in self.running if r.tenant != self.silver_tenant]
        quota_n = min(len(silver), max(self.silver_left, 0))
        ordered = silver[:quota_n] + others + silver[quota_n:]
        d = self.placement.decision
        dq = dict(d.decode_quota) if d is not None and d.decode_quota else {}
        if not dq:
            batch = ordered[: self.ecfg.max_batch]
        else:
            batch, used = [], {}
            for r in ordered:                      # pass 1: quota-respecting
                if len(batch) >= self.ecfg.max_batch:
                    break
                cap = dq.get(r.tenant)
                if cap is None or used.get(r.tenant, 0) < cap:
                    batch.append(r)
                    used[r.tenant] = used.get(r.tenant, 0) + 1
            if len(batch) < self.ecfg.max_batch:   # pass 2: backfill
                taken = {id(r) for r in batch}
                for r in ordered:
                    if len(batch) >= self.ecfg.max_batch:
                        break
                    if id(r) not in taken:
                        batch.append(r)
        head_ids = {id(r) for r in silver[:quota_n]}
        self._silver_quota_used = sum(1 for r in batch if id(r) in head_ids)
        return batch

    def step(self):
        """One engine iteration: faults -> placement epoch (feedback,
        re-decision, preemptions) -> golden (admit/alloc) -> silver/
        normal decode under quotas."""
        self.step_count += 1
        self._apply_faults()
        active = tuple(sorted({t for t, q in self.queues.items() if q}
                              | {r.tenant for r in self.running}
                              | {r.tenant for r in self.parked}))
        if self.placement.due(self.step_count) or self.placement.stale(active):
            self._observe_epoch()
            decision = self.placement.refresh(self.view())
            self.decisions.append(decision)
            if decision.preempt:
                self._execute_preemptions(decision)
        self._admit()
        batch = self._select_decode_batch()
        if not batch:
            return
        done = []
        for req in batch:  # the reference decodes per request
            caches = self._prefill_cache[req.rid]
            tok = self._tokens([[req.out[-1]]])
            logits, caches = self._fwd_decode(
                self.cfg, self.run, self.params, {"tokens": tok}, caches)
            self._prefill_cache[req.rid] = caches
            nxt = int(torch.argmax(logits[0, -1]))
            req.out.append(nxt)
            self.pool, ok = kvc.append_token_alloc(self.pool_cfg, self.pool,
                                                   req.seq_slot)
            if req.decoded >= min(req.max_new, self.ecfg.decode_len_cap):
                done.append(req)
        # silver rotation: only quota-class decodes burn quota (backfilled
        # silver requests ran as normal class)
        self.silver_left -= self._silver_quota_used
        if self.silver_left <= 0 and self.queues:
            tenants = sorted(set(list(self.queues) +
                                 [r.tenant for r in self.running]))
            if tenants:
                ix = (tenants.index(self.silver_tenant) + 1) % len(tenants) \
                    if self.silver_tenant in tenants else 0
                self.silver_tenant = tenants[ix]
                self.silver_left = self._quota().get(self.silver_tenant, 1)
        for req in done:
            req.finish_step = self.step_count
            self.running.remove(req)
            self.pool = kvc.release_seq(self.pool_cfg, self.pool,
                                        req.seq_slot)
            self._free_slots.append(req.seq_slot)
            self._prefill_cache.pop(req.rid, None)
            self.finished.append(req)
            self._epoch_finished.append(req)

    def run_until_drained(self, max_steps: int = 1000):
        for _ in range(max_steps):
            if self.pending() == 0:
                break
            self.step()
        return self.finished
