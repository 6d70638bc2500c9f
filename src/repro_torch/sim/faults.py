"""Deterministic fault injection for chaos-testing the simulator; port of
`repro.sim.faults`.

A `FaultPlan` is a declarative, hashable list of `Fault`s, each pinned to
a segment boundary of a `runner.run_trace` schedule. Before a segment
runs, the runner applies every fault scheduled at that boundary:

  kill          -- kill + restart the target app slot: a full membership
                   change (fresh ASID generation, TLB shootdown, cold
                   warps/stats: `memsys.apply_membership_change`).
  tlb_flush     -- spurious full flush of one translation cache level
                   (0 = per-core L1 bank, 1 = shared L2 TLB, 2 = bypass
                   cache): models an over-broad shootdown.
  tlb_corrupt   -- overwrite one seeded (set, way) of the shared L2 TLB
                   with a seeded translation for a LIVE ASID; any existing
                   same-(vpn, asid) entry of the set is dropped first, so
                   the audit's invariants still hold.
  drop_dram     -- drop the standing DRAM backlog and close all open rows.
  walk_clobber  -- occupy one seeded walk-table row with a bogus in-flight
                   walk for a live ASID until its seeded completion time.

Every operand derives from `FaultPlan.seed`, so a plan replays bit for
bit. The plan rides on `SimConfig.fault_plan` but the runner's plan key
strips it: `plan_operands` lowers it to per-segment arrays of one shape
for every plan, which the segment runner takes as data. The lowering is
host numpy, as the reference's; `apply_state_faults` writes the state on
its device, every write a `torch.where` on its mask, so all-False
operands return the state bit for bit.

The serving-layer vocabulary (`ServingFault`, `ServingFaultPlan`,
`random_serving_plan`) is host data that `serving.engine.ServingEngine`
applies at step boundaries; it is a copy of the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.sim import memsys
from repro_torch.sim.config import SimConfig

FAULT_KINDS = ("kill", "tlb_flush", "tlb_corrupt", "drop_dram",
               "walk_clobber")
FLUSH_LEVELS = ("l1", "l2tlb", "bypass")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One declarative fault: `kind` applied before segment `segment` runs.

    `app` targets a slot for "kill" (and seeds the live-ASID choice for
    "tlb_corrupt" / "walk_clobber"); `level` picks the cache for
    "tlb_flush" (index into FLUSH_LEVELS).
    """
    kind: str
    segment: int
    app: int = 0
    level: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}")
        if self.segment < 0:
            raise ValueError(f"fault segment must be >= 0, got {self.segment}")
        if not 0 <= self.level < len(FLUSH_LEVELS):
            raise ValueError(
                f"fault level must index {FLUSH_LEVELS}, got {self.level}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, replayable chaos schedule (hashable; the runner's
    plan key strips it, see `runner._canonical`)."""
    seed: int = 0
    faults: Tuple[Fault, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    def validate(self, n_apps: int, n_segments: int) -> None:
        for f in self.faults:
            if f.segment >= n_segments:
                raise ValueError(
                    f"fault {f} targets segment {f.segment} but the "
                    f"schedule has only {n_segments} segments")
            if f.kind == "kill" and not 0 <= f.app < n_apps:
                raise ValueError(
                    f"fault {f} kills app slot {f.app}, outside "
                    f"[0, {n_apps})")


def random_plan(seed: int, n_segments: int, n_apps: int,
                rate: float = 0.5) -> FaultPlan:
    """Seeded random chaos plan: each boundary draws a fault with
    probability `rate` (boundary 0 is spared: a fault before any cycle
    ran is a no-op for most kinds)."""
    rng = np.random.default_rng(seed)
    faults = []
    for s in range(1, n_segments):
        if rng.random() >= rate:
            continue
        kind = FAULT_KINDS[int(rng.integers(len(FAULT_KINDS)))]
        faults.append(Fault(kind=kind, segment=s,
                            app=int(rng.integers(n_apps)),
                            level=int(rng.integers(len(FLUSH_LEVELS)))))
    return FaultPlan(seed=seed, faults=tuple(faults))


# --------------------------------------------------------------------------
# Serving-layer fault vocabulary: overload faults injected into the
# SERVING ENGINE's host-side loop rather than the simulator state.
# Same discipline as the sim faults — declarative, seeded, replayable
# bit-for-bit — but applied by `ServingEngine.step` at step boundaries:
#
#   pool_spike      -- phantom sequences admitted under a reserved ASID
#                      occupy KV pages for `duration` steps: a pool-
#                      exhaustion spike the degradation ladder must ride
#                      out (quota -> preempt -> freeze) without losing
#                      requests.
#   oracle_stall    -- the contention oracle misses its latency budget for
#                      `duration` steps: the policy must fail soft to a
#                      contention-blind equal share (rung "stalled").
#   profile_poison  -- tenant `tenant` declares profile `profile` for
#                      `duration` steps (a wrong-but-plausible claim): the
#                      recalibrator must absorb the resulting misprediction
#                      without destabilizing placement.

SERVING_FAULT_KINDS = ("pool_spike", "oracle_stall", "profile_poison")


@dataclasses.dataclass(frozen=True)
class ServingFault:
    """One serving-layer fault firing at engine step `step` and lasting
    `duration` steps. `pages` sizes a pool_spike (0 = half the pool);
    `tenant`/`profile` target a profile_poison."""
    kind: str
    step: int
    duration: int = 16
    tenant: int = 0
    pages: int = 0
    profile: str = "heavy"

    def __post_init__(self):
        if self.kind not in SERVING_FAULT_KINDS:
            raise ValueError(f"serving fault kind must be one of "
                             f"{SERVING_FAULT_KINDS}, got {self.kind!r}")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.duration < 1:
            raise ValueError(f"fault duration must be >= 1, "
                             f"got {self.duration}")
        if self.pages < 0:
            raise ValueError(f"fault pages must be >= 0, got {self.pages}")


@dataclasses.dataclass(frozen=True)
class ServingFaultPlan:
    """A deterministic, replayable overload schedule for the serving
    engine (carried on `EngineConfig.fault_plan`)."""
    seed: int = 0
    faults: Tuple[ServingFault, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    def at_step(self, step: int) -> Tuple[ServingFault, ...]:
        return tuple(f for f in self.faults if f.step == step)

    def validate(self, tenants: Tuple[int, ...]) -> None:
        for f in self.faults:
            if f.kind == "profile_poison" and f.tenant not in tenants:
                raise ValueError(
                    f"fault {f} poisons tenant {f.tenant}, not in the "
                    f"declared universe {tenants}")


def random_serving_plan(seed: int, n_steps: int,
                        tenants: Tuple[int, ...],
                        rate: float = 0.05) -> ServingFaultPlan:
    """Seeded random overload plan: each step past warmup draws a fault
    with probability `rate`; operands (kind, tenant, duration) come from
    one generator in step order — same seed, same plan, bit for bit."""
    rng = np.random.default_rng(seed)
    faults = []
    warmup = max(n_steps // 8, 4)
    for s in range(warmup, n_steps):
        if rng.random() >= rate:
            continue
        kind = SERVING_FAULT_KINDS[int(rng.integers(
            len(SERVING_FAULT_KINDS)))]
        faults.append(ServingFault(
            kind=kind, step=s,
            duration=int(rng.integers(8, 24)),
            tenant=int(tenants[int(rng.integers(len(tenants)))]),
            profile="heavy"))
    return ServingFaultPlan(seed=seed, faults=tuple(faults))


class FaultOps(NamedTuple):
    """Per-segment fault operands, all with leading axis (n_segments,):
    numpy from `plan_operands`, tensors once the runner moves them to the
    state's device. One shape for every plan."""
    kill: np.ndarray          # (S, n_apps) bool
    flush: np.ndarray         # (S, 3) bool, FLUSH_LEVELS order
    corrupt: np.ndarray       # (S,) bool
    corrupt_set: np.ndarray   # (S,) int32
    corrupt_way: np.ndarray   # (S,) int32
    corrupt_vpn: np.ndarray   # (S,) int32
    corrupt_app: np.ndarray   # (S,) int32 slot whose LIVE asid is written
    drop_dram: np.ndarray     # (S,) bool
    clobber: np.ndarray       # (S,) bool
    clobber_row: np.ndarray   # (S,) int32
    clobber_vpn: np.ndarray   # (S,) int32
    clobber_app: np.ndarray   # (S,) int32
    clobber_delta: np.ndarray # (S,) int32 cycles until the bogus walk ends


def empty_operands(cfg: SimConfig, n_segments: int) -> FaultOps:
    """The no-fault operand set: all masks False (bitwise identity)."""
    S = n_segments
    z = np.zeros(S, np.int32)
    return FaultOps(
        kill=np.zeros((S, cfg.n_apps), bool),
        flush=np.zeros((S, len(FLUSH_LEVELS)), bool),
        corrupt=np.zeros(S, bool), corrupt_set=z, corrupt_way=z,
        corrupt_vpn=z, corrupt_app=z,
        drop_dram=np.zeros(S, bool),
        clobber=np.zeros(S, bool), clobber_row=z, clobber_vpn=z,
        clobber_app=z, clobber_delta=z)


def plan_operands(plan: FaultPlan, cfg: SimConfig,
                  n_segments: int) -> FaultOps:
    """Lower a declarative plan to per-segment operand arrays.

    Operand draws come from one generator seeded by `plan.seed`, consumed
    in fault-list order: same plan, same operands, bit for bit.
    """
    plan.validate(cfg.n_apps, n_segments)
    ops = empty_operands(cfg, n_segments)
    rng = np.random.default_rng(plan.seed)
    tr = cfg.design.translation
    l2_sets = max(tr.l2_entries // max(tr.l2_ways, 1), 1)
    for f in plan.faults:
        s = f.segment
        if f.kind == "kill":
            ops.kill[s, f.app] = True
        elif f.kind == "tlb_flush":
            ops.flush[s, f.level] = True
        elif f.kind == "tlb_corrupt":
            ops.corrupt[s] = True
            ops.corrupt_set[s] = rng.integers(l2_sets)
            ops.corrupt_way[s] = rng.integers(max(tr.l2_ways, 1))
            ops.corrupt_vpn[s] = rng.integers(1 << 20)
            ops.corrupt_app[s] = f.app % cfg.n_apps
        elif f.kind == "drop_dram":
            ops.drop_dram[s] = True
        elif f.kind == "walk_clobber":
            ops.clobber[s] = True
            ops.clobber_row[s] = rng.integers(
                tr.max_concurrent_walks)
            ops.clobber_vpn[s] = rng.integers(1 << 20)
            ops.clobber_app[s] = f.app % cfg.n_apps
            ops.clobber_delta[s] = int(rng.integers(100, 2000))
    return ops


def _full_flush(st, on):
    """Flush every entry of a TLBState (planes (R, ..., sets, ways)) in
    the rows where `on` ((R,) bool) holds."""
    on = on.reshape(on.shape + (1,) * (st.tags.dim() - 1))
    return st._replace(tags=torch.where(on, -1, st.tags),
                       asids=torch.where(on, -1, st.asids))


def _live_asid(asid_of_app, app, n_apps: int):
    """(R,) live ASID of slot `app` ((R,) int) in each row."""
    return asid_of_app.gather(1, (app % n_apps).long()[:, None])[:, 0]


def apply_state_faults(cfg: SimConfig, state: memsys.SimState,
                       ops: FaultOps) -> memsys.SimState:
    """Apply one boundary's non-kill faults to the carried state.

    `ops` holds one segment's operands (the leading segment axis removed),
    as tensors on the state's device. A state with a row axis takes them
    with a leading row axis ((R,), (R, 3), ...); a state without one (the
    reference's shape) takes the reference's shapes. Kill faults are NOT
    handled here: the runner merges `ops.kill` into the membership-change
    mask, so kills share `memsys.apply_membership_change`'s teardown.

    Every write is a `torch.where` on its mask (the reference's
    out-of-bounds drop scatters become a select on the target row and
    way), so all-False operands return `state` bit for bit, and nothing
    here reads a value back to the host.
    """
    ops = FaultOps(*(torch.as_tensor(x, device=state.t.device) for x in ops))
    if state.t.dim() == 0:                   # one run without a row axis
        out = apply_state_faults(
            cfg, memsys.map_state(lambda x: x[None], state),
            FaultOps(*(x[None] for x in ops)))
        return memsys.map_state(lambda x: x[0], out)
    na = cfg.n_apps
    trans = state.trans
    trans = trans._replace(
        l1=_full_flush(trans.l1, ops.flush[:, 0]),
        l2tlb=_full_flush(trans.l2tlb, ops.flush[:, 1]),
        bypass_tlb=_full_flush(trans.bypass_tlb, ops.flush[:, 2]))

    # tlb_corrupt: drop any same-(vpn, asid) entry of the target set, then
    # write the corrupt entry into its (set, way); inactive rows write
    # nothing
    l2 = trans.l2tlb
    n_sets, n_ways = l2.tags.shape[-2:]
    dev = l2.tags.device
    c_on = ops.corrupt[:, None, None]
    c_vpn = ops.corrupt_vpn[:, None, None]
    c_asid = _live_asid(state.asid_of_app, ops.corrupt_app, na)[:, None, None]
    in_set = (torch.arange(n_sets, device=dev)
              == (ops.corrupt_set % n_sets)[:, None])[:, :, None]
    at_way = (torch.arange(n_ways, device=dev)
              == (ops.corrupt_way % n_ways)[:, None])[:, None, :]
    dup = c_on & in_set & (l2.tags == c_vpn) & (l2.asids == c_asid)
    cell = c_on & in_set & at_way
    trans = trans._replace(l2tlb=l2._replace(
        tags=torch.where(cell, c_vpn, torch.where(dup, -1, l2.tags)),
        asids=torch.where(cell, c_asid, torch.where(dup, -1, l2.asids)),
        lru=torch.where(cell, state.t[:, None, None], l2.lru)))

    # walk_clobber: occupy one walk-table row with a bogus live-ASID walk
    wt = trans.walk.shape[1]
    k_row = (torch.arange(wt, device=dev)
             == (ops.clobber_row % wt)[:, None]) & ops.clobber[:, None]
    bogus = torch.stack([
        ops.clobber_vpn, _live_asid(state.asid_of_app, ops.clobber_app, na),
        state.t + ops.clobber_delta, torch.ones_like(state.t)], -1)
    trans = trans._replace(walk=torch.where(
        k_row[..., None], bogus[:, None, :].to(trans.walk.dtype),
        trans.walk))

    dram = state.data.dram
    drop = ops.drop_dram[:, None, None]
    dram = dram._replace(
        open_row=torch.where(drop, -1, dram.open_row),
        queue_len=torch.where(drop, 0, dram.queue_len))

    return state._replace(trans=trans,
                          data=state.data._replace(dram=dram))
