"""State auditor: structural invariants of `SimState` / `StatState`; a
copy of `repro.sim.audit`.

`check_state` verifies everything the simulator's updates are supposed
to preserve, on host-side numpy trees (`sim.convert.state_to_numpy` of
the port's state, one row), so auditing never touches the device's
state. It
collects EVERY violated invariant and raises one `AuditError` listing
them all, with enough coordinates to localize the corruption.

Wired in at `runner._stats`: setting env `REPRO_AUDIT=1` (or passing
`audit=True` to `run_trace` / `_stats`) audits every state that stats
are derived from — the full tier-1 suite runs clean under it, and an
injected corruption fails loudly.

Invariants:

  * TLB caches (L1 bank / shared L2 TLB / bypass cache — ASID-tagged):
    tag/ASID validity agree ((tag<0) iff (asid<0)), no duplicate
    (tag, asid) entry within a set, every live ASID belongs to a current
    generation (`SimState.asid_of_app` — a stale translation surviving a
    shootdown is exactly this violation), LRU stamps within [0, t].
  * Tag-only caches (PWC, L2 data): ASID plane untouched (-1); LRU
    within [0, t]. (Duplicate tags are NOT checked here: the fused
    one-cycle round documents transient cross-core duplicates,
    `core/tlb.py::access_fused`.)
  * Walk table: in-flight rows (done > t) carry a valid vpn and a
    live-generation ASID; merged counts non-negative.
  * Tokens: within [1, warps_per_app], direction in {-1, +1}, epoch
    counters non-negative, miss rate finite in [0, 1].
  * DRAM: queues/pressure non-negative, silver owner a real slot with
    quota >= 1, open rows >= -1.
  * Warps/stats: t >= 0, stream positions and stall deadlines
    non-negative, retired-instruction and counter planes finite and
    non-negative (int32 wraparound shows up here as a negative count).
  * ASID map: slot recovery holds (asid % n_apps == slot, asid >= slot).

`check_monotone(prev, cur, changed)` covers the cross-snapshot law:
cumulative counters never decrease for slots whose membership did not
change between two boundary snapshots.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.sim.config import SimConfig
from repro_torch.sim.memsys import WASID, WDONE, WMERGED, WVPN


class AuditError(AssertionError):
    """One or more state invariants are violated; message lists all."""

    def __init__(self, violations: List[str]):
        self.violations = list(violations)
        lines = "\n".join(f"  [{i + 1}] {v}"
                          for i, v in enumerate(self.violations))
        super().__init__(
            f"state audit failed: {len(self.violations)} invariant(s) "
            f"violated\n{lines}")


def _where(mask: np.ndarray, limit: int = 4) -> str:
    """Compact coordinate list of the first offending entries."""
    idx = np.argwhere(mask)
    shown = ", ".join(str(tuple(int(c) for c in row))
                      for row in idx[:limit])
    more = f" (+{len(idx) - limit} more)" if len(idx) > limit else ""
    return f"at {shown}{more}"


def _check_tlb(v: List[str], name: str, tlb, live_asids: np.ndarray,
               t: int, tracked: bool) -> None:
    tags = np.asarray(tlb.tags)
    asids = np.asarray(tlb.asids)
    lru = np.asarray(tlb.lru)
    valid = tags >= 0
    if tracked:
        bad = valid != (asids >= 0)
        if bad.any():
            v.append(f"{name}: tag/asid validity disagree {_where(bad)}")
        stale = valid & (asids >= 0) & \
            ~np.isin(asids, live_asids)
        if stale.any():
            v.append(f"{name}: stale translation for dead ASID "
                     f"{sorted(set(asids[stale].tolist()))} "
                     f"(live: {live_asids.tolist()}) {_where(stale)}")
        # no duplicate (tag, asid) within a set: encode pairs, sort the
        # way axis, compare neighbors (works for banked leading axes)
        key = np.where(valid, tags.astype(np.int64) * (1 << 32)
                       + asids.astype(np.int64), -1 - np.arange(
                           tags.shape[-1], dtype=np.int64))
        ks = np.sort(key, axis=-1)
        dup = (ks[..., 1:] == ks[..., :-1]) & (ks[..., 1:] >= 0)
        if dup.any():
            v.append(f"{name}: duplicate (tag, asid) entries within a "
                     f"set {_where(dup)}")
    else:
        if (asids != -1).any():
            v.append(f"{name}: tag-only cache grew ASID entries "
                     f"{_where(asids != -1)}")
    bad_lru = (lru < 0) | (lru > t)
    if bad_lru.any():
        v.append(f"{name}: LRU stamp outside [0, t={t}] {_where(bad_lru)}")
    for c in ("hits", "misses"):   # scalar, or (n_banks,) on the L1 bank
        n = np.asarray(getattr(tlb, c))
        if (n < 0).any():
            v.append(f"{name}: {c} counter negative ({n}) — int32 wrap")


def check_state(cfg: SimConfig, st, audit_stats: bool = True) -> None:
    """Audit one (host-side) SimState; raises AuditError on violation."""
    v: List[str] = []
    t = int(np.asarray(st.t))
    na = cfg.n_apps
    if t < 0:
        v.append(f"t negative: {t}")

    asid_of_app = np.asarray(st.asid_of_app)
    slots = np.arange(na)
    if asid_of_app.shape != (na,):
        v.append(f"asid_of_app shape {asid_of_app.shape} != ({na},)")
    else:
        bad = (asid_of_app % na != slots) | (asid_of_app < slots)
        if bad.any():
            v.append(f"asid_of_app violates slot recovery "
                     f"(asid % n_apps == slot, asid >= slot): "
                     f"{asid_of_app.tolist()}")

    _check_tlb(v, "l1_tlb_bank", st.trans.l1, asid_of_app, t, tracked=True)
    _check_tlb(v, "l2_tlb", st.trans.l2tlb, asid_of_app, t, tracked=True)
    _check_tlb(v, "bypass_tlb", st.trans.bypass_tlb, asid_of_app, t,
               tracked=True)
    _check_tlb(v, "pwc", st.trans.pwc, asid_of_app, t, tracked=False)
    _check_tlb(v, "l2_data", st.data.l2c, asid_of_app, t, tracked=False)

    walk = np.asarray(st.trans.walk)
    live = walk[:, WDONE] > t
    wasid = walk[:, WASID]
    bad = live & ~np.isin(wasid, asid_of_app)
    if bad.any():
        v.append(f"walk table: in-flight walk for dead ASID "
                 f"{sorted(set(wasid[bad].tolist()))} {_where(bad[:, None])}")
    if (live & (walk[:, WVPN] < 0)).any():
        v.append("walk table: in-flight walk with invalid vpn")
    if (walk[:, WMERGED] < 0).any():
        v.append("walk table: negative merge count")

    tok = st.tokens
    wpa = np.asarray(cfg.warps_per_app)
    tokens = np.asarray(tok.tokens)
    if ((tokens < 1) | (tokens > wpa)).any():
        v.append(f"tokens outside [1, warps_per_app={wpa.tolist()}]: "
                 f"{tokens.tolist()}")
    if (~np.isin(np.asarray(tok.direction), (-1, 1))).any():
        v.append(f"token direction not in {{-1,+1}}: "
                 f"{np.asarray(tok.direction).tolist()}")
    for c in ("epoch_hits", "epoch_misses"):
        if (np.asarray(getattr(tok, c)) < 0).any():
            v.append(f"tokens.{c} negative: "
                     f"{np.asarray(getattr(tok, c)).tolist()}")
    pmr = np.asarray(tok.prev_miss_rate)
    if (~np.isfinite(pmr)).any() or ((pmr < 0) | (pmr > 1)).any():
        v.append(f"tokens.prev_miss_rate outside [0, 1]: {pmr.tolist()}")

    dram = st.data.dram
    if (np.asarray(dram.queue_len) < 0).any():
        v.append(f"dram.queue_len negative {_where(np.asarray(dram.queue_len) < 0)}")
    # open_row is NOT range-checked: row ids are `lines // (channels *
    # banks * 32)` over hash-derived int32 line addresses, which can be
    # negative — any int32 is a legal row tag (-1 init just means
    # "closed", and a real -1 row id colliding with it is harmless).
    for c in ("conc_walks", "warps_stalled"):
        if (np.asarray(getattr(dram, c)) < 0).any():
            v.append(f"dram.{c} negative: "
                     f"{np.asarray(getattr(dram, c)).tolist()}")
    sa = int(np.asarray(dram.silver_app))
    if not 0 <= sa < na:
        v.append(f"dram.silver_app {sa} outside [0, {na})")
    if int(np.asarray(dram.silver_left)) < 1:
        v.append(f"dram.silver_left {int(np.asarray(dram.silver_left))} < 1")

    instr = np.asarray(st.instr)
    if (~np.isfinite(instr)).any() or (instr < 0).any():
        v.append("retired-instruction counters non-finite or negative "
                 f"{_where(~np.isfinite(instr) | (instr < 0))}")
    if (np.asarray(st.pos) < 0).any():
        v.append("warp stream positions negative")
    if (np.asarray(st.stall_until) < 0).any():
        v.append("warp stall deadlines negative")

    if audit_stats:
        s = st.stats
        if (np.asarray(s.ints) < 0).any():
            v.append(f"stats int counters negative "
                     f"{_where(np.asarray(s.ints) < 0)} — int32 wrap")
        fl = np.asarray(s.floats)
        if (~np.isfinite(fl)).any() or (fl < 0).any():
            v.append(f"stats float accumulators non-finite or negative "
                     f"{_where(~np.isfinite(fl) | (fl < 0))}")
        if (np.asarray(s.scalars) < 0).any():
            v.append("stats scalar counters negative — int32 wrap")

    if v:
        raise AuditError(v)


def check_monotone(prev, cur, changed: Optional[np.ndarray] = None) -> None:
    """Cross-snapshot law: cumulative per-app counters never decrease
    between two boundary states, except for slots whose membership
    changed (their counters reset to a cold start by design).

    `prev` / `cur` are host-side SimStates; `changed` is the (n_apps,)
    bool membership-change mask applied between them (None = no change).
    Raises AuditError."""
    v: List[str] = []
    t0, t1 = int(np.asarray(prev.t)), int(np.asarray(cur.t))
    if t1 < t0:
        v.append(f"time ran backwards: {t0} -> {t1}")
    keep = (~np.asarray(changed, bool) if changed is not None
            else np.ones(np.asarray(cur.stats.ints).shape[0], bool))
    for plane in ("ints", "floats"):
        p = np.asarray(getattr(prev.stats, plane))[keep]
        c = np.asarray(getattr(cur.stats, plane))[keep]
        if (c < p).any():
            v.append(f"stats.{plane} decreased for an unchanged slot "
                     f"{_where(c < p)}")
    p, c = np.asarray(prev.stats.scalars), np.asarray(cur.stats.scalars)
    if (c < p).any():
        v.append(f"stats.scalars decreased {_where(c < p)}")
    if v:
        raise AuditError(v)
