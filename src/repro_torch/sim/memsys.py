"""Vectorized memory-hierarchy simulator: a lane-fused one-cycle pipeline.

Port of `repro.sim.memsys`. `step` composes the same stages as the
reference:

  warp_sched           -- per-core oldest-ready pick of one warp;
  translation_probe    -- L1 TLB bank -> shared L2 TLB (+ bypass cache)
                          probes/fills, MSHR merging, PWC round, page-walk
                          PTE lanes;
  datapath_front       -- L1D hit draw + the DATA_WIDTH divergent lines;
  shared_memory_access -- ONE fused L2$ round (`tlb.access_fused`, the
                          `fused_tlb` kernel on the card) + DRAM for all of
                          a cycle's walk and data lanes;
  translation_commit   -- walk latencies, walk-table install;
  accumulate_stats     -- the packed per-app counter planes;
plus warp retire and epoch maintenance. `eager_step` issues them op by
op. On a CUDA device `step` replays the CUDA graphs of the stretches
between the fused rounds instead (`sim/replay.py`), launching each round
from Python with the cycle's host time; a cycle where the epoch runs,
and every cycle on the CPU, runs `eager_step`. Under the torch profiler
`step` is a span of `repro_torch.spans` (`sim.step`, attr `replay`: 1
where the cycle replayed its graphs), and so is each stage of an eager
or captured cycle (`sim.step.sched` ... `sim.step.epoch`); with no
profiler they cost a flag read.

State is NamedTuples of tensors with the reference's fields, in the
reference's order (`sim/convert.py` carries states across). The stages
read the cycle from the state's device scalar `t` (a host int is taken
too); the caller keeps a host copy for the epoch branch and the fused
rounds' `time`. The design's policy knobs (`DesignParams`) come
as host values where every row agrees: each branch of the reference's
`lax.cond`/`jnp.where` on such a knob is a Python branch here. A knob
whose rows differ (`core/design.py` `stack_params`) comes as an (R,)
tensor and runs as the reference's masked form: probes and fills with
the other rows' lanes masked off (a state no-op there), a per-row
`torch.where` between both values, the epoch as a per-row select. Which
of the two a knob is, is known on the host, so a cycle runs without a
host sync, and a pass whose rows agree issues a one-design pass's
launches.

Rows. Every state tensor has a leading row axis R: R independent
simulations of one signature group's designs (the rows of
`runner.run_grid`, which the reference vmaps), each with its own
workload matrix and knobs, stepped together.
The stages are written over that axis, with no Python loop over rows:
a cycle issues the same launches whatever R is, and the fused rounds run
all rows in one launch. Per-lane scatters and gathers run along each
row's own flattened table, so rows never collide. The rows share the
cycle counter, as the reference's rows share a scan length, and the
lane-to-app map (the oracle core split). A state made with
`init_state(cfg, dp)` has no row axis: `step` runs it as one row.

The fused rounds update the shared caches' planes (the L2$ and the PWC)
in place; `step` consumes its input state.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bypass as bp_mod
from repro_torch.core import dram_sched
from repro_torch.core import page_table as pt_mod
from repro_torch.core import tlb as tlb_mod
from repro_torch.core import tokens as tok_mod
from repro_torch.core.design import DesignParams
from repro_torch.core.mask import static_partition_index
from repro_torch.core.page_table import _mix, u32, wrap_i32
from repro_torch.sim import replay
from repro_torch.sim.config import SimConfig
from repro_torch.sim.workloads import FIELD, gen_vpn
from repro_torch.spans import span

DATA_WIDTH = 4           # divergent cache lines per memory instruction
BIG = 1 << 30

# packed walk-table columns: TransState.walk is (R, max_concurrent_walks, 4)
WVPN, WASID, WDONE, WMERGED = range(4)

# packed per-app int32 counter plane: StatState.ints is (R, n_apps, N_INT)
(I_L1_HIT, I_L1_MISS, I_L2_HIT, I_L2_MISS, I_BYP_HIT, I_BYP_PROBE,
 I_WALKS, I_DRAM_TLB_N, I_DRAM_DATA_N) = range(9)
N_INT = 9
# packed per-app float32 plane: StatState.floats is (R, n_apps, N_FLOAT)
F_WALK_LAT, F_STALL_PER_MISS, F_DRAM_TLB_LAT, F_DRAM_DATA_LAT = range(4)
N_FLOAT = 4
# shared (not per-app) counters: StatState.scalars is (R, N_SCALAR)
S_L2C_TLB_HIT, S_L2C_TLB_PROBE, S_L2C_DATA_HIT, S_L2C_DATA_PROBE = range(4)
N_SCALAR = 4

I32 = torch.int32


# ---------------------------------------------------------------------------
# layered state; shapes without the leading row axis R
# ---------------------------------------------------------------------------

class TransState(NamedTuple):
    """Translation layer: TLB hierarchy + in-flight page-walk table."""
    l1: tlb_mod.TLBState         # per-core bank, leading axis (n_cores,)
    l2tlb: tlb_mod.TLBState
    bypass_tlb: tlb_mod.TLBState
    pwc: tlb_mod.TLBState        # page-walk cache (PTE lines)
    walk: torch.Tensor           # (max_concurrent_walks, 4) int32 packed


class DataState(NamedTuple):
    """Shared data path: L2 data cache, DRAM, bypass accounting."""
    l2c: tlb_mod.TLBState        # line-addressed, reuses TLB machinery
    dram: dram_sched.DramState
    bypass: bp_mod.BypassState


class StatState(NamedTuple):
    """Cumulative counters, packed into three planes (see the reference);
    the `s_*` names are read-only views used by `runner._stats`. They work
    on tensor and numpy leaves alike."""
    ints: torch.Tensor           # (n_apps, N_INT) int32
    floats: torch.Tensor         # (n_apps, N_FLOAT) float32
    scalars: torch.Tensor        # (N_SCALAR,) int32

    s_l1_hit = property(lambda s: s.ints[..., I_L1_HIT])
    s_l1_miss = property(lambda s: s.ints[..., I_L1_MISS])
    s_l2_hit = property(lambda s: s.ints[..., I_L2_HIT])
    s_l2_miss = property(lambda s: s.ints[..., I_L2_MISS])
    s_byp_hit = property(lambda s: s.ints[..., I_BYP_HIT])
    s_byp_probe = property(lambda s: s.ints[..., I_BYP_PROBE])
    s_walks = property(lambda s: s.ints[..., I_WALKS])
    s_dram_tlb_n = property(lambda s: s.ints[..., I_DRAM_TLB_N])
    s_dram_data_n = property(lambda s: s.ints[..., I_DRAM_DATA_N])
    s_walk_lat = property(lambda s: s.floats[..., F_WALK_LAT])
    s_stall_per_miss = property(lambda s: s.floats[..., F_STALL_PER_MISS])
    s_dram_tlb_lat = property(lambda s: s.floats[..., F_DRAM_TLB_LAT])
    s_dram_data_lat = property(lambda s: s.floats[..., F_DRAM_DATA_LAT])
    s_l2c_tlb_hit = property(lambda s: s.scalars[..., S_L2C_TLB_HIT])
    s_l2c_tlb_probe = property(lambda s: s.scalars[..., S_L2C_TLB_PROBE])
    s_l2c_data_hit = property(lambda s: s.scalars[..., S_L2C_DATA_HIT])
    s_l2c_data_probe = property(lambda s: s.scalars[..., S_L2C_DATA_PROBE])


class SimState(NamedTuple):
    t: torch.Tensor              # () int32, the same in every row; the
                                 # caller keeps a host copy
    stall_until: torch.Tensor    # (W,) int32
    instr: torch.Tensor          # (W,) float32 retired instructions
    pos: torch.Tensor            # (W,) int32 stream position
    trans: TransState
    data: DataState
    tokens: tok_mod.TokenState
    stats: StatState
    asid_of_app: torch.Tensor    # (n_apps,) int32 live ASID per app slot


class _Consts(NamedTuple):
    """Per-config constant tensors, made once so a cycle copies nothing
    from the host."""
    app: torch.Tensor            # (C,) int32 oracle core split
    core: torch.Tensor           # (C,) int32 0..C-1
    cores_per_app: torch.Tensor  # (n_apps,) int32
    warps_per_app: torch.Tensor  # (n_apps,) int32
    walk_tags: torch.Tensor      # (L*C,) int32 depth tags, wave-major
    zeros_walk: torch.Tensor     # (L*C,) int32 (the tag-only PWC's asids)
    ones_walk: torch.Tensor      # (L*C,) bool
    line_salt: torch.Tensor      # (DATA_WIDTH, 1) int64 data-line salts
    zeros_core: torch.Tensor     # (C,) int32
    false_core: torch.Tensor     # (C,) bool
    empty_walk: torch.Tensor     # (4,) int32 a free walk-table row
    warp_app: torch.Tensor       # (W,) int64 app slot of each warp


def _consts(cfg: SimConfig) -> _Consts:
    return replay.held(_make_consts(cfg))


@functools.lru_cache(maxsize=32)
def _make_consts(cfg: SimConfig) -> _Consts:
    dev, C = cfg.device, cfg.n_cores
    tr = cfg.design.translation
    L = 0 if tr.kind == "ideal" else tr.walk_levels
    i32 = dict(dtype=I32, device=dev)
    tags = [pt_mod.walk_depth_tag(lv) for lv in range(L)]
    salts = [(0x85EBCA6B + 0x9E3779B9 * k) & 0xFFFFFFFF
             for k in range(DATA_WIDTH)]
    return _Consts(
        app=torch.tensor(cfg.app_of_core, **i32),
        core=torch.arange(C, **i32),
        cores_per_app=torch.tensor(cfg.cores_per_app, **i32),
        warps_per_app=torch.tensor(cfg.warps_per_app, **i32),
        walk_tags=torch.tensor(tags, **i32).repeat_interleave(C),
        zeros_walk=torch.zeros(L * C, **i32),
        ones_walk=torch.ones(L * C, dtype=torch.bool, device=dev),
        line_salt=torch.tensor(salts, dtype=torch.int64, device=dev)[:, None],
        zeros_core=torch.zeros(C, **i32),
        false_core=torch.zeros(C, dtype=torch.bool, device=dev),
        empty_walk=torch.tensor([-1, -1, 0, 0], **i32),
        warp_app=torch.tensor(cfg.app_of_core, dtype=torch.int64,
                              device=dev).repeat_interleave(
                                  cfg.warps_per_core),
    )


def _lanes(n: int, nw: int, device: str, rows: int):
    """(is_tlb (n,), zeros (rows, n) int32, ones (rows, n) bool) for a
    round of n lanes whose first nw are walk lanes."""
    return replay.held(_make_lanes(n, nw, device, rows))


@functools.lru_cache(maxsize=64)
def _make_lanes(n: int, nw: int, device: str, rows: int):
    return (torch.arange(n, device=device) < nw,
            torch.zeros((rows, n), dtype=I32, device=device),
            torch.ones((rows, n), dtype=torch.bool, device=device))


def init_trans(cfg: SimConfig) -> TransState:
    tr = cfg.design.translation
    tok = cfg.design.tokens
    dev = cfg.device
    return TransState(
        l1=tlb_mod.init_bank(cfg.n_cores, tr.l1_entries, tr.l1_entries, dev),
        l2tlb=tlb_mod.init(tr.l2_entries, tr.l2_ways, dev),
        bypass_tlb=tlb_mod.init(tok.bypass_cache_entries,
                                tok.bypass_cache_entries, dev),
        pwc=tlb_mod.init(cfg.pwc_entries, cfg.pwc_ways, dev),
        walk=_consts(cfg).empty_walk.repeat(tr.max_concurrent_walks, 1),
    )


def init_data(cfg: SimConfig) -> DataState:
    return DataState(
        l2c=tlb_mod.init(cfg.l2_sets * cfg.l2_ways, cfg.l2_ways, cfg.device),
        dram=dram_sched.init(cfg.n_channels, cfg.n_banks, cfg.n_apps,
                             cfg.device),
        bypass=bp_mod.init(cfg.device),
    )


def init_stats(n_apps: int, device) -> StatState:
    return StatState(
        ints=torch.zeros((n_apps, N_INT), dtype=I32, device=device),
        floats=torch.zeros((n_apps, N_FLOAT), dtype=torch.float32,
                           device=device),
        scalars=torch.zeros(N_SCALAR, dtype=I32, device=device),
    )


def map_state(fn, tree):
    """Apply `fn` to every tensor of a (nested) state NamedTuple."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_state(fn, x) for x in tree))
    return fn(tree)


def init_state(cfg: SimConfig, dp: DesignParams,
               rows: Optional[int] = None) -> SimState:
    """The cold-start state. `rows=None` gives the reference's single
    state (no row axis); `rows=R` gives R rows, each tensor (R, ...) and
    contiguous, identical but for each row's InitialTokens where `dp`
    gives `initial_frac` per row (an (R,) tensor)."""
    with span("sim.init_state"):
        W, dev = cfg.total_warps, cfg.device
        frac = dp.initial_frac
        per_row = isinstance(frac, torch.Tensor)
        if per_row and rows is None:
            raise ValueError("per-row design knobs need a state with rows")
        st = SimState(
            t=torch.zeros((), dtype=I32, device=dev),
            stall_until=torch.zeros(W, dtype=I32, device=dev),
            instr=torch.zeros(W, dtype=torch.float32, device=dev),
            pos=torch.zeros(W, dtype=I32, device=dev),
            trans=init_trans(cfg),
            data=init_data(cfg),
            # per-row InitialTokens are set once the rows exist, below
            tokens=tok_mod.init(cfg.n_apps, _consts(cfg).warps_per_app,
                                np.float32(0) if per_row else frac),
            stats=init_stats(cfg.n_apps, dev),
            asid_of_app=torch.arange(cfg.n_apps, dtype=I32, device=dev),
        )
        if rows is None:
            return st
        if rows < 1:
            raise ValueError(f"rows must be >= 1, got {rows}")
        st = map_state(lambda x: x.repeat(rows, *(1,) * x.dim()), st)
        if per_row:
            tok = tok_mod.init(cfg.n_apps, _consts(cfg).warps_per_app, frac)
            st = st._replace(tokens=st.tokens._replace(tokens=tok.tokens))
        return st


def _some(knob) -> bool:
    """Whether a knob is on in any row, read from its host summary: a
    knob given as an (R,) tensor differs between rows, so it is on in
    some."""
    return isinstance(knob, torch.Tensor) or bool(knob)


def _both(a, b):
    """Logical and of two knobs (host bools or (R,) tensors)."""
    if not isinstance(a, torch.Tensor):
        return b if a else False
    if not isinstance(b, torch.Tensor):
        return a if b else False
    return a & b


def _masked(lanes: torch.Tensor, knob) -> torch.Tensor:
    """(R, N) lanes with those of the rows whose knob is off masked off;
    a host knob (on, where this is reached) leaves them as they are."""
    return lanes & knob[:, None] if isinstance(knob, torch.Tensor) else lanes


def _pick(on: torch.Tensor, a, b):
    """Per row, `a` where the (R,) bool `on` holds and `b` elsewhere: (R,
    ...) tensors, or flat NamedTuples of them field by field."""
    if isinstance(a, tuple):
        return type(a)(*(_pick(on, x, y) for x, y in zip(a, b)))
    return torch.where(on.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def _round_time(t, t_host):
    """A fused round's `time`, a host int: `t_host`, else the stage's
    cycle `t` (read back where it is a tensor)."""
    return int(t) if t_host is None else t_host


def _last_writer(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(R, N) bool: lane i is the highest lane of its row writing idx[r, i]
    (idx in 0..n).

    XLA's serial scatter lets the last of several lanes writing one slot
    win; scatter_ gives duplicate indices no order, so the port resolves
    them explicitly, row by row."""
    R, N = idx.shape
    order = torch.arange(N, device=idx.device)
    owner = torch.full((R, n + 1), -1, dtype=torch.long, device=idx.device)
    owner.scatter_reduce_(1, idx, order.expand(R, N), reduce="amax")
    return owner.gather(1, idx) == order


# ---------------------------------------------------------------------------
# stage 1: warp scheduling
# ---------------------------------------------------------------------------

class SchedOut(NamedTuple):
    """One candidate memory instruction per core: (R, n_cores), but `app`
    (n_cores,), the oracle split, the same in every row."""
    picked_warp: torch.Tensor    # global warp id
    slot: torch.Tensor           # warp slot within its core
    active: torch.Tensor         # bool: core found a ready warp
    app: torch.Tensor
    asid: torch.Tensor
    vpn: torch.Tensor
    pos: torch.Tensor            # stream position of the picked warp


def warp_sched(cfg: SimConfig, params_mat, stall_until, pos, t,
               asid_of_app=None) -> SchedOut:
    """GTO-like pick: per core, the ready warp that has waited longest.
    params_mat: (R, n_apps, N_FIELDS); stall_until/pos: (R, W); t: the
    cycle, a host int or a 0-dim int32 tensor (as every stage takes it)."""
    C, wpc = cfg.n_cores, cfg.warps_per_core
    R = stall_until.shape[0]
    k = _consts(cfg)
    waiting = torch.where(stall_until <= t, t - stall_until, -1)
    wait_grid = waiting.reshape(R, C, wpc)
    pick = wait_grid.argmax(-1)
    active = wait_grid.gather(-1, pick[..., None])[..., 0] >= 0
    picked = k.core * wpc + pick                          # (R, C) int64
    picked_warp = picked.to(I32)
    app = k.app                                          # oracle split (§6)
    p = pos.gather(1, picked)
    vpn = gen_vpn(params_mat[:, app], app, picked_warp, p, t)
    asid = app.expand(R, C) if asid_of_app is None else asid_of_app[:, app]
    return SchedOut(picked_warp=picked_warp, slot=pick.to(I32),
                    active=active, app=app, asid=asid, vpn=vpn, pos=p)


# ---------------------------------------------------------------------------
# stage 2a: translation probes (L1 TLB bank -> L2 TLB/bypass -> walk setup)
# ---------------------------------------------------------------------------

class TransProbe(NamedTuple):
    """Front half of translation: everything before the shared L2$/DRAM.
    Per core (R, C); walk lanes are wave-major ((R, walk_levels * C), level
    slowest); they are empty under the ideal design."""
    l1_hit: torch.Tensor
    l1_miss: torch.Tensor
    l2_hit: torch.Tensor
    byp_hit: torch.Tensor
    l2_hit_eff: torch.Tensor     # L2 or bypass-cache hit
    need_walk: torch.Tensor
    merged: torch.Tensor         # joined an in-flight walk
    merge_done: torch.Tensor     # completion time of the joined walk
    first_match: torch.Tensor    # walk-table slot of the joined walk
    new_walk: torch.Tensor       # started a fresh walk
    queue_pen: torch.Tensor      # finite-walker-thread queue penalty
    pwc_lat: torch.Tensor        # (R, C) summed 5-cycle PWC-hit latencies
    walk_lines: torch.Tensor     # (R, L*C) PTE line ids, wave-major
    walk_go: torch.Tensor        # (R, L*C) bool: lanes that access the L2$
    walk_tags: torch.Tensor      # (L*C,) page-walk depth tags (§5.3)


def translation_probe(cfg: SimConfig, dp: DesignParams, trans: TransState,
                      tokens: tok_mod.TokenState, sched: SchedOut, t,
                      t_host: Optional[int] = None
                      ) -> Tuple[TransState, TransProbe]:
    """TLB hierarchy probes/fills + page-walk lane generation. The PWC
    round takes the host cycle `t_host` (default: `t`).

    A cache no row uses is skipped: the reference probes and fills it
    with an all-False mask, which leaves its state unchanged. Where only
    some rows use it, the others' lanes are masked off, as there."""
    tr = cfg.design.translation
    k = _consts(cfg)
    vpn, asid, active = sched.vpn, sched.asid, sched.active
    R, C = vpn.shape

    # ---------------- L1 TLB bank --------------------------------------
    l1, l1_hit = tlb_mod.probe_bank(trans.l1, vpn, asid, active, t)
    zb, zi = k.false_core.expand(R, C), k.zeros_core.expand(R, C)
    if tr.kind == "ideal":
        # every access hits: the walk machinery is not modelled at all
        return (trans._replace(l1=l1),
                TransProbe(l1_hit=active, l1_miss=zb, l2_hit=zb, byp_hit=zb,
                           l2_hit_eff=zb, need_walk=zb, merged=zb,
                           merge_done=zi, first_match=zi, new_walk=zb,
                           queue_pen=zi, pwc_lat=zi,
                           walk_lines=k.zeros_walk.expand(R, 0),
                           walk_go=k.ones_walk.expand(R, 0),
                           walk_tags=k.walk_tags))
    l1_miss = active & ~l1_hit

    # ---------------- shared L2 TLB + bypass cache ---------------------
    use_l2, tok_on = dp.use_l2_tlb, dp.tokens_on
    use_byp = _both(tok_on, use_l2)
    l2tlb, byp_tlb = trans.l2tlb, trans.bypass_tlb
    l2_hit = byp_hit = zb
    if _some(use_l2):
        l2tlb, l2_hit = tlb_mod.probe(l2tlb, vpn, asid,
                                      _masked(l1_miss, use_l2), t)
    if _some(use_byp):
        byp_tlb, byp_hit = tlb_mod.probe(byp_tlb, vpn, asid,
                                         _masked(l1_miss & ~l2_hit, use_byp),
                                         t)
    l2_hit_eff = l2_hit | byp_hit
    need_walk = l1_miss & ~l2_hit_eff

    # ---------------- TLB fills on walk return -------------------------
    # tokens go round-robin over the app's cores in warpID order: per-core
    # allowance = tokens / cores_per_app; with tokens off every walk fills
    if _some(use_l2):
        fill_l2 = need_walk
        if _some(tok_on):
            tok_per_core = tokens.tokens[:, sched.app] \
                // k.cores_per_app[sched.app]
            has_tok = sched.slot < tok_per_core
            first = tokens.first_epoch[:, None]
            gate = (has_tok & ~first) | first
            if isinstance(tok_on, torch.Tensor):
                gate = gate | ~tok_on[:, None]
            fill_l2 = need_walk & gate
            byp_tlb = tlb_mod.fill(byp_tlb, vpn, asid,
                                   _masked(need_walk & ~gate, use_l2), t)
        l2tlb = tlb_mod.fill(l2tlb, vpn, asid, _masked(fill_l2, use_l2), t)

    l1 = tlb_mod.fill_bank(l1, vpn, asid, l1_miss, t)

    # ---------------- MSHR merge: outstanding walk for same (vpn, asid)?
    walk_vpn, walk_asid, walk_done = (trans.walk[..., WVPN],
                                      trans.walk[..., WASID],
                                      trans.walk[..., WDONE])     # (R, WT)
    wmatch = (walk_vpn[:, None, :] == vpn[..., None]) & \
             (walk_asid[:, None, :] == asid[..., None]) & \
             (walk_done[:, None, :] > t)                          # (R, C, WT)
    merged = wmatch.any(-1) & need_walk
    merge_done = torch.where(
        merged, torch.where(wmatch, walk_done[:, None, :], 0).amax(-1), 0)
    first_match = wmatch.to(I32).argmax(-1).to(I32)

    new_walk = need_walk & ~merged
    n_live = (walk_done > t).sum(-1, dtype=I32)
    # walker occupancy queue penalty (finite walker threads)
    wt = tr.max_concurrent_walks
    over = (n_live[:, None] + new_walk.cumsum(-1, dtype=I32) - wt) \
        .clamp(min=0)
    queue_pen = over * 30

    # ---------------- page-walk lanes (walk_levels dependent PTE lines)
    L = tr.walk_levels
    pte_lines = pt_mod.pte_line_addresses(
        pt_mod.PageTableConfig(levels=L), asid, vpn)      # (R, C, L)
    walk_lines = pte_lines.transpose(1, 2).reshape(R, L * C)  # wave-major
    walk_active = new_walk.repeat(1, L)

    # fused probe+fill with per-(set, level) fill ports; PTE lines are
    # unique across levels, so the PWC is tag-only
    if _some(dp.use_pwc):
        _, zeros, ones = _lanes(L * C, L * C, cfg.device, R)
        pwc, pwc_hit, _ = tlb_mod.access_fused(
            trans.pwc, walk_lines, zeros, _masked(walk_active, dp.use_pwc),
            ones, _round_time(t, t_host), n_waves=L, track_asids=False)
        walk_go = walk_active & ~pwc_hit
        pwc_lat = 5 * (walk_active & pwc_hit).reshape(R, L, C) \
            .sum(1, dtype=I32)
    else:
        pwc, walk_go, pwc_lat = trans.pwc, walk_active, zi

    return (TransState(l1=l1, l2tlb=l2tlb, bypass_tlb=byp_tlb, pwc=pwc,
                       walk=trans.walk),
            TransProbe(l1_hit=l1_hit, l1_miss=l1_miss, l2_hit=l2_hit,
                       byp_hit=byp_hit, l2_hit_eff=l2_hit_eff,
                       need_walk=need_walk, merged=merged,
                       merge_done=merge_done, first_match=first_match,
                       new_walk=new_walk, queue_pen=queue_pen,
                       pwc_lat=pwc_lat, walk_lines=walk_lines,
                       walk_go=walk_go, walk_tags=k.walk_tags))


# ---------------------------------------------------------------------------
# stage 2b: data-path front (L1D draw + divergent line generation)
# ---------------------------------------------------------------------------

class DataFront(NamedTuple):
    """L1D outcome + the data lanes headed for the shared L2$."""
    l1d_hit: torch.Tensor        # (R, C) bool
    go_l2d: torch.Tensor         # (R, C) bool: reached the shared L2$
    lines: torch.Tensor          # (R, DATA_WIDTH*C) line ids, wave-major


def datapath_front(cfg: SimConfig, params_mat, sched: SchedOut, t
                   ) -> DataFront:
    """Draw the L1D outcome and generate the divergent line addresses."""
    pfn = pt_mod.translate(pt_mod.PageTableConfig(), sched.asid, sched.vpn)
    r = _mix(u32(pfn) + u32(sched.pos))
    l1d_hit = (r % 1024) < params_mat[:, sched.app, FIELD["l1d_hit_milli"]]
    go_l2d = sched.active & ~l1d_hit
    # one memory instruction touches DATA_WIDTH lines, serviced in
    # parallel; `pfn * 32` wraps int32 by design
    r3 = _mix(r[:, None, :] + _consts(cfg).line_salt)     # (R, K, C)
    lines = wrap_i32(pfn.to(torch.int64)[:, None, :] * 32 + r3 % 32)
    R, C = pfn.shape
    return DataFront(l1d_hit=l1d_hit, go_l2d=go_l2d,
                     lines=lines.reshape(R, DATA_WIDTH * C))


# ---------------------------------------------------------------------------
# stage 3: the ONE shared L2$ + DRAM round for all of a cycle's lanes
# ---------------------------------------------------------------------------

class MemOut(NamedTuple):
    """Per-core splits of the fused round (walk part + data part)."""
    walk_lat: torch.Tensor       # (R, C) summed walk-level L2$/DRAM latency
    dram_tlb_lat: torch.Tensor   # (R, C) float32 DRAM latency on walk path
    dram_tlb_n: torch.Tensor     # (R, C) int32
    l2c_tlb_hit: torch.Tensor    # (R,) walk-request hits in the L2$
    l2c_tlb_probe: torch.Tensor  # (R,) walk-request probes of the L2$
    dlat: torch.Tensor           # (R, C) max-over-lines data latency
    l2d_hit: torch.Tensor        # (R, C) bool: any data line hit the L2$


def shared_memory_access(cfg: SimConfig, dp: DesignParams, data: DataState,
                         app, walk_lines, walk_go, walk_tags,
                         data_lines, go_l2d, t,
                         t_host: Optional[int] = None
                         ) -> Tuple[DataState, MemOut]:
    """Shared L2 data cache + DRAM for ALL of a cycle's sub-accesses; the
    L2$ round takes the host cycle `t_host` (default: `t`).

    Lanes are wave-major (walk level 0..L-1, then data line 0..K-1, each
    wave C cores wide), so lane order is the sequential model's program
    order. Either lane group may be empty. app (C,) and walk_tags are the
    same in every row; the other lanes are (R, ...)."""
    R, C = go_l2d.shape
    nw = walk_lines.shape[1]
    nd = data_lines.shape[1]
    L, K = nw // C, nd // C
    dev = go_l2d.device

    lines = torch.cat([walk_lines, data_lines], 1)
    go = torch.cat([walk_go, go_l2d.repeat(1, K)], 1)
    apps = app.repeat(L + K)
    is_tlb, zeros, ones = _lanes(nw + nd, nw, cfg.device, R)
    depth = torch.cat([walk_tags, zeros[0, nw:]])

    l2c, dram, bp_state = data.l2c, data.dram, data.bypass
    # depth 0 (data) always fills; with bypass off every lane may fill
    byp_on = dp.bypass_on
    may_fill = bp_mod.should_fill(bp_state, depth) if _some(byp_on) \
        else ones
    if isinstance(byp_on, torch.Tensor):
        may_fill = may_fill | ~byp_on[:, None]

    # `Static` gives each app an equal slice of the sets/channels
    static = dp.static_part
    if _some(static):
        key = static_partition_index(lines, cfg.l2_sets, cfg.n_apps, apps)
        channel = static_partition_index(lines, cfg.n_channels, cfg.n_apps,
                                         apps)
    if isinstance(static, torch.Tensor):
        key = _pick(static, key, lines % cfg.l2_sets)
        channel = _pick(static, channel, lines % cfg.n_channels)
    elif not static:
        key = lines % cfg.l2_sets
        channel = lines % cfg.n_channels

    # tag = full line id, tag-only cache; `lines * l2_sets` wraps int32
    tag = wrap_i32(lines.to(torch.int64) * cfg.l2_sets + key)
    l2c, hit, _ = tlb_mod.access_fused(
        l2c, tag, zeros, go, may_fill, _round_time(t, t_host),
        n_waves=max(L + K, 1),
        track_asids=False)
    lat = hit.to(I32) * cfg.lat_l2_cache
    miss = go & ~hit

    bank = (lines // cfg.n_channels) % cfg.n_banks
    row = lines // (cfg.n_channels * cfg.n_banks * 32)
    dram, dram_lat = dram_sched.access(
        dram, channel, bank, row, apps, is_tlb, miss,
        mask_enabled=dp.dram_on, thres_max=dp.thres_max,
        waves=max(L + K, 1))
    lat = lat + torch.where(miss, cfg.lat_l2_cache + dram_lat, 0)
    bp_state = bp_mod.record(bp_state, depth, hit, go)

    # ---------------- split back per core ------------------------------
    zi = torch.zeros((R, C), dtype=I32, device=dev)
    zs = torch.zeros(R, dtype=I32, device=dev)
    if nw:
        lat_w = lat[:, :nw].reshape(R, L, C)
        went = walk_go.reshape(R, L, C) & ~hit[:, :nw].reshape(R, L, C)
        walk_lat = lat_w.sum(1, dtype=I32)    # inactive lanes contribute 0
        dram_tlb_lat = torch.where(went, lat_w, 0).sum(1, dtype=I32) \
            .to(torch.float32)
        dram_tlb_n = went.sum(1, dtype=I32)
        l2c_tlb_hit = (hit[:, :nw] & walk_go).sum(-1, dtype=I32)
        l2c_tlb_probe = walk_go.sum(-1, dtype=I32)
    else:
        walk_lat, dram_tlb_n, l2c_tlb_hit, l2c_tlb_probe = zi, zi, zs, zs
        dram_tlb_lat = zi.to(torch.float32)
    if nd:
        dlat = lat[:, nw:].reshape(R, K, C).amax(1)
        l2d_hit = hit[:, nw:].reshape(R, K, C).any(1)
    else:
        dlat = zi
        l2d_hit = zi.to(torch.bool)

    return (DataState(l2c=l2c, dram=dram, bypass=bp_state),
            MemOut(walk_lat=walk_lat, dram_tlb_lat=dram_tlb_lat,
                   dram_tlb_n=dram_tlb_n, l2c_tlb_hit=l2c_tlb_hit,
                   l2c_tlb_probe=l2c_tlb_probe, dlat=dlat,
                   l2d_hit=l2d_hit))


# ---------------------------------------------------------------------------
# stage 4: translation commit (walk latency, walk-table install)
# ---------------------------------------------------------------------------

class TransOut(NamedTuple):
    """Per-core translation results + walk-level L2$ counters."""
    trans_lat: torch.Tensor      # (R, C) translation latency
    l1_hit: torch.Tensor         # (R, C) bool
    l1_miss: torch.Tensor
    l2_hit: torch.Tensor
    byp_hit: torch.Tensor
    l2_hit_eff: torch.Tensor     # L2 or bypass-cache hit
    need_walk: torch.Tensor
    merged: torch.Tensor         # joined an in-flight walk
    new_walk: torch.Tensor       # started a fresh walk
    walk_done_new: torch.Tensor  # (R, C) completion time of fresh walks
    dram_tlb_lat: torch.Tensor   # (R, C) float32 DRAM latency on walk path
    dram_tlb_n: torch.Tensor     # (R, C) int32
    l2c_hit: torch.Tensor        # (R,) walk-request hits in the L2$
    l2c_probe: torch.Tensor      # (R,) walk-request probes of the L2$


def translation_commit(cfg: SimConfig, trans: TransState, probe: TransProbe,
                       mem: MemOut, sched: SchedOut, t
                       ) -> Tuple[TransState, TransOut]:
    """Resolve walk latencies, install fresh walks, settle trans latency."""
    tr = cfg.design.translation
    R, C = sched.active.shape

    if tr.kind == "ideal":
        trans_lat = sched.active.to(I32) * cfg.lat_l1_tlb
        zi = torch.zeros((R, C), dtype=I32, device=trans_lat.device)
        zs = torch.zeros(R, dtype=I32, device=trans_lat.device)
        return trans, TransOut(
            trans_lat=trans_lat, l1_hit=probe.l1_hit, l1_miss=probe.l1_miss,
            l2_hit=probe.l2_hit, byp_hit=probe.byp_hit,
            l2_hit_eff=probe.l2_hit_eff, need_walk=probe.need_walk,
            merged=probe.merged, new_walk=probe.new_walk, walk_done_new=zi,
            dram_tlb_lat=zi.to(torch.float32), dram_tlb_n=zi,
            l2c_hit=zs, l2c_probe=zs)

    walk_lat = mem.walk_lat + probe.pwc_lat + probe.queue_pen
    walk_done_new = t + cfg.lat_l2_tlb + walk_lat

    # install new walks into free slots (expired entries are free); lanes
    # that install nothing go to the trash row
    wt = tr.max_concurrent_walks
    free = trans.walk[..., WDONE] <= t                    # (R, WT)
    order_slots = probe.new_walk.cumsum(-1) - 1
    slots = torch.arange(wt, device=free.device)
    free_sorted = torch.where(free, slots, BIG).sort(-1).values
    slot_for = torch.where(
        probe.new_walk,
        free_sorted.gather(1, order_slots.clamp(0, wt - 1)), BIG)
    slot = torch.where(probe.new_walk & (slot_for < wt), slot_for, wt)
    slot = torch.where(_last_writer(slot, wt), slot, wt)
    rows = torch.stack([sched.vpn, sched.asid, walk_done_new,
                        torch.ones_like(walk_done_new)], -1)  # (R, C, 4)
    walk = torch.cat([trans.walk, trans.walk[:, :1]], 1)
    walk.scatter_(1, slot[..., None].expand(R, C, 4), rows)
    # bump merge counters on the joined in-flight walks
    walk[..., WMERGED].scatter_add_(1, probe.first_match.long(),
                                    probe.merged.to(I32))
    walk = walk[:, :wt]

    # ---------------- translation latency ------------------------------
    trans_lat = torch.where(
        probe.l1_hit, cfg.lat_l1_tlb,
        torch.where(probe.l2_hit_eff, cfg.lat_l2_tlb,
                    torch.where(probe.merged,
                                (probe.merge_done - t).clamp(min=1),
                                (walk_done_new - t).clamp(min=1))))

    return (trans._replace(walk=walk),
            TransOut(trans_lat=trans_lat, l1_hit=probe.l1_hit,
                     l1_miss=probe.l1_miss, l2_hit=probe.l2_hit,
                     byp_hit=probe.byp_hit, l2_hit_eff=probe.l2_hit_eff,
                     need_walk=probe.need_walk, merged=probe.merged,
                     new_walk=probe.new_walk, walk_done_new=walk_done_new,
                     dram_tlb_lat=mem.dram_tlb_lat,
                     dram_tlb_n=mem.dram_tlb_n, l2c_hit=mem.l2c_tlb_hit,
                     l2c_probe=mem.l2c_tlb_probe))


# ---------------------------------------------------------------------------
# data-path result assembly
# ---------------------------------------------------------------------------

class DataOut(NamedTuple):
    """Per-core data-access results, all (R, n_cores)."""
    data_lat: torch.Tensor
    l1d_hit: torch.Tensor
    go_l2d: torch.Tensor         # bool: reached the shared L2$
    dlat: torch.Tensor           # L2$/DRAM part of the latency
    l2d_hit: torch.Tensor        # bool: any of the lines hit the L2$


def _data_out(cfg: SimConfig, front: DataFront, mem: MemOut) -> DataOut:
    """Assemble the data-path result from the shared-round split."""
    data_lat = torch.where(front.l1d_hit, cfg.lat_l1_data,
                           cfg.lat_l1_data + mem.dlat)
    return DataOut(data_lat=data_lat, l1d_hit=front.l1d_hit,
                   go_l2d=front.go_l2d, dlat=mem.dlat, l2d_hit=mem.l2d_hit)


# ---------------------------------------------------------------------------
# stage 5: statistics accumulation (packed planes)
# ---------------------------------------------------------------------------

def accumulate_stats(stats: StatState, n_apps: int, sched: SchedOut,
                     tout: TransOut, dout: DataOut, t) -> StatState:
    """Fold one cycle's per-core outcomes into the packed stat planes.

    The cycle's rows are first summed per app (integer-valued float32, so
    exact in any order) and that sum is added to the accumulators once,
    as the reference's segment-sum does: adding lanes straight into a
    float32 accumulator would round differently."""
    act = sched.active
    i32 = lambda x: x.to(I32)  # noqa: E731
    ints_rows = torch.stack([
        i32(tout.l1_hit), i32(tout.l1_miss), i32(tout.l2_hit),
        i32(tout.need_walk), i32(tout.byp_hit),
        i32(tout.l1_miss & ~tout.l2_hit), i32(tout.new_walk),
        tout.dram_tlb_n, i32(dout.go_l2d),
    ], -1) * i32(act)[..., None]                          # (R, C, N_INT)
    floats_rows = torch.stack([
        torch.where(tout.new_walk, tout.walk_done_new - t, 0)
        .to(torch.float32),
        tout.merged.to(torch.float32),
        tout.dram_tlb_lat,
        torch.where(dout.go_l2d, dout.dlat, 0).to(torch.float32),
    ], -1) * act.to(torch.float32)[..., None]
    app = sched.app
    return StatState(
        ints=stats.ints + torch.zeros_like(stats.ints).index_add_(
            1, app, ints_rows),
        floats=stats.floats + torch.zeros_like(stats.floats).index_add_(
            1, app, floats_rows),
        scalars=stats.scalars + torch.stack([
            tout.l2c_hit, tout.l2c_probe,
            (dout.go_l2d & dout.l2d_hit).sum(-1, dtype=I32),
            dout.go_l2d.sum(-1, dtype=I32)], -1),
    )


# ---------------------------------------------------------------------------
# retire + epoch maintenance
# ---------------------------------------------------------------------------

def retire(stall_until, instr, pos, sched: SchedOut, total_lat, gap, t):
    """Stall issued warps until their latency resolves; credit instrs.
    Each core picks a distinct warp, so a row's writes never collide."""
    w = sched.picked_warp.long()
    act = sched.active
    stall_until = stall_until.scatter(
        1, w, torch.where(act, t + total_lat, stall_until.gather(1, w)))
    instr = instr.scatter(
        1, w, instr.gather(1, w)
        + torch.where(act, (1 + gap).to(torch.float32), 0.0))
    pos = pos.scatter(1, w, pos.gather(1, w) + act.to(I32))
    return stall_until, instr, pos


def epoch_due(cfg: SimConfig, dp: DesignParams, t: int) -> bool:
    """Whether `epoch_maintenance` runs at the host cycle `t`: an
    adaptive mechanism on in some row, and t a multiple of the epoch."""
    return any(_some(k) for k in (dp.tokens_on, dp.dram_on, dp.bypass_on)) \
        and t % cfg.design.epoch_cycles == 0


def epoch_maintenance(cfg: SimConfig, dp: DesignParams, trans: TransState,
                      tokens: tok_mod.TokenState, data: DataState, t: int
                      ) -> Tuple[tok_mod.TokenState, DataState]:
    """Every epoch_cycles: token hill-climb, DRAM pressure, bypass latch,
    in the rows where any adaptive mechanism is on (the reference's
    `lax.cond`, a per-row select under its vmap).

    `trans` must be the PRE-update translation state (the epoch-end
    census of in-flight walks)."""
    if not epoch_due(cfg, dp, t):
        return tokens, data
    adaptive = [k for k in (dp.tokens_on, dp.dram_on, dp.bypass_on)
                if _some(k)]
    na = cfg.n_apps
    walk = trans.walk                                     # (R, WT, 4)
    R, WT = walk.shape[:2]
    live = (walk[..., WDONE] > t).to(I32)
    census = torch.stack([live, walk[..., WMERGED] * live], -1)
    # slot recovery: ASIDs are slot + k*n_apps after churn; invalid rows
    # (asid -1) land on slot n_apps-1 with live=0 and add nothing
    slot = (walk[..., WASID] % na).long()
    census = torch.zeros((R, na, 2), dtype=I32, device=live.device) \
        .scatter_add_(1, slot[..., None].expand(R, WT, 2), census)
    dram = dram_sched.update_pressure(data.dram, census[..., 0],
                                      census[..., 1])
    new_tok = tok_mod.epoch_update(tokens, _consts(cfg).warps_per_app,
                                   step_frac=dp.step_frac)
    bp = bp_mod.epoch_update(data.bypass)
    if all(isinstance(k, torch.Tensor) for k in adaptive):
        # no mechanism is on in every row: the epoch runs in some rows
        on = functools.reduce(torch.logical_or, adaptive)
        new_tok = _pick(on, new_tok, tokens)
        dram = _pick(on, dram, data.dram)
        bp = _pick(on, bp, data.bypass)
    return new_tok, data._replace(dram=dram, bypass=bp)


# ---------------------------------------------------------------------------
# one-cycle transition: thin composition of the stages
# ---------------------------------------------------------------------------

def step(cfg: SimConfig, dp: DesignParams, params_mat, state: SimState,
         cycle: int) -> SimState:
    """One cycle of every row. params_mat: (R, n_apps, N_FIELDS) int32
    workload params, one matrix per row of `state`; dp: one design's
    policy knobs, or each row's (`stack_params`: a knob the rows differ
    on is an (R,) tensor); cycle: the host copy of `state.t`. A state
    without the row axis (`init_state(cfg, dp)`) takes an (n_apps,
    N_FIELDS) matrix and runs as one row.

    On a CUDA device the cycle goes through `replay.GRAPHS`: it replays
    the captured graphs of its key and returns that key's state buffers,
    which the key's next cycle overwrites (`runner.simulate` hands back a
    copy); its key's first cycle and a cycle where the epoch runs run
    `eager_step`, the second is captured. On the CPU it runs `eager_step`.
    Issues no host sync, and the same launches whatever R is; updates the
    shared caches' planes in place."""
    if params_mat.dim() == 2:               # one run without a row axis
        out = step(cfg, dp, params_mat[None],
                   map_state(lambda x: x[None], state), cycle)
        return map_state(lambda x: x[0], out)
    with span("sim.step") as attrs:
        if params_mat.is_cuda:
            with torch.inference_mode():
                state, replayed = replay.GRAPHS.step(cfg, dp, params_mat,
                                                     state, cycle)
        else:
            state, replayed = eager_step(cfg, dp, params_mat, state,
                                         cycle), False
        if attrs is not None:
            attrs["replay"] = int(replayed)
        return state


def eager_step(cfg: SimConfig, dp: DesignParams, params_mat,
               state: SimState, cycle: int) -> SimState:
    """One cycle of a state with the row axis, issued op by op: the
    stages read the cycle from `state.t` on the device; the fused rounds
    and the epoch branch take the host `cycle`."""
    t_host = cycle + 1
    with span("sim.step.sched"):
        t_next = state.t + 1
        t = t_next[0]                        # () the cycle, on the device
        sched = warp_sched(cfg, params_mat, state.stall_until, state.pos,
                           t, asid_of_app=state.asid_of_app)
    with span("sim.step.probe"):
        trans_st, probe = translation_probe(cfg, dp, state.trans,
                                            state.tokens, sched, t, t_host)
    with span("sim.step.front"):
        dfront = datapath_front(cfg, params_mat, sched, t)
    with span("sim.step.memory"):
        data_st, mem = shared_memory_access(
            cfg, dp, state.data, sched.app, probe.walk_lines,
            probe.walk_go, probe.walk_tags, dfront.lines, dfront.go_l2d,
            t, t_host)
    with span("sim.step.commit"):
        trans_st, tout = translation_commit(cfg, trans_st, probe, mem,
                                            sched, t)
    with span("sim.step.retire"):
        dout = _data_out(cfg, dfront, mem)
        gap = params_mat[:, sched.app, FIELD["gap"]]
        total_lat = tout.trans_lat + dout.data_lat + gap
        stall_until, instr, pos = retire(
            state.stall_until, state.instr, state.pos, sched, total_lat,
            gap, t)
        tokens = tok_mod.record(state.tokens, sched.app,
                                tout.l2_hit_eff, tout.l1_miss)
    with span("sim.step.stats"):
        stats = accumulate_stats(state.stats, cfg.n_apps, sched, tout,
                                 dout, t)
    with span("sim.step.epoch"):
        tokens, data_st = epoch_maintenance(cfg, dp, state.trans, tokens,
                                            data_st, t_host)
        return SimState(t=t_next, stall_until=stall_until,
                        instr=instr, pos=pos, trans=trans_st,
                        data=data_st, tokens=tokens, stats=stats,
                        asid_of_app=state.asid_of_app)


# ---------------------------------------------------------------------------
# app churn: membership-change teardown at a segment boundary
# ---------------------------------------------------------------------------

def _flush_slots(st: tlb_mod.TLBState, change, n_apps: int
                 ) -> tlb_mod.TLBState:
    """ASID shootdown for every changed SLOT of an asid-tagged cache:
    planes (R, ..., sets, ways), change (R, n_apps) bool.

    Entries store generation-bumped ASIDs (slot + k*n_apps, see
    SimState.asid_of_app), so the kill predicate recovers the slot with
    `% n_apps`. With an all-False change mask this is the identity, bit
    for bit."""
    R = change.shape[0]
    slot = (st.asids % n_apps).long()
    kill = (st.asids >= 0) & change.gather(1, slot.reshape(R, -1)) \
        .reshape(slot.shape)
    return st._replace(tags=torch.where(kill, -1, st.tags),
                       asids=torch.where(kill, -1, st.asids))


def apply_membership_change(cfg: SimConfig, dp: DesignParams,
                            state: SimState, change) -> SimState:
    """Teardown + cold start for the slots flagged in `change` ((n_apps,)
    bool; (R, n_apps) for a state with a row axis): the departing app's
    state is torn down and the slot is handed to its successor with a
    FRESH address space (paper §5.1 shootdown semantics; the reference's
    docstring lists each mechanism):

      * L1 TLB bank / shared L2 TLB / bypass cache: every entry whose
        ASID maps to a changed slot is invalidated;
      * PWC: tag-only, so a FULL flush when any slot of the row changes;
      * walk table: in-flight walks of changed slots are cancelled;
      * tokens: changed slots restart from the InitialTokens state (the
        shared `first_epoch` latch is left alone);
      * DRAM pressure: the changed slots' Concurrent_i / WrpStalled_i
        are zeroed until the next epoch census;
      * warps of changed slots rewind to a cold stream, ready at `t`;
      * stat planes of changed slots reset; the slot's ASID moves on by
        n_apps (a new generation).

    Every write is a `torch.where` on the change mask (the PWC's on
    `change.any()` as a tensor), so nothing is read back to the host and
    an all-False mask returns `state` bit for bit."""
    change = torch.as_tensor(change, dtype=torch.bool, device=state.t.device)
    if state.t.dim() == 0:                   # one run without a row axis
        out = apply_membership_change(
            cfg, dp, map_state(lambda x: x[None], state), change[None])
        return map_state(lambda x: x[0], out)
    na = cfg.n_apps
    k = _consts(cfg)

    trans = state.trans
    any_c = change.any(-1)[:, None, None]
    walk_asid = trans.walk[..., WASID]
    walk_kill = (walk_asid >= 0) & change.gather(1, (walk_asid % na).long())
    trans = trans._replace(
        l1=_flush_slots(trans.l1, change, na),
        l2tlb=_flush_slots(trans.l2tlb, change, na),
        bypass_tlb=_flush_slots(trans.bypass_tlb, change, na),
        pwc=trans.pwc._replace(tags=torch.where(any_c, -1, trans.pwc.tags)),
        walk=torch.where(walk_kill[..., None], k.empty_walk, trans.walk))

    fresh = tok_mod.init(na, k.warps_per_app, dp.initial_frac)
    tok = state.tokens
    tok = tok._replace(
        tokens=torch.where(change, fresh.tokens, tok.tokens),
        direction=torch.where(change, fresh.direction, tok.direction),
        prev_miss_rate=torch.where(change, fresh.prev_miss_rate,
                                   tok.prev_miss_rate),
        epoch_hits=torch.where(change, 0, tok.epoch_hits),
        epoch_misses=torch.where(change, 0, tok.epoch_misses))

    dram = state.data.dram
    dram = dram._replace(
        conc_walks=torch.where(change, 0, dram.conc_walks),
        warps_stalled=torch.where(change, 0, dram.warps_stalled))

    warp_change = change[:, k.warp_app]                         # (R, W)
    stall_until = torch.where(warp_change, state.t[:, None],
                              state.stall_until)
    instr = torch.where(warp_change, 0.0, state.instr)
    pos = torch.where(warp_change, 0, state.pos)

    stats = state.stats._replace(
        ints=torch.where(change[..., None], 0, state.stats.ints),
        floats=torch.where(change[..., None], 0.0, state.stats.floats))

    return state._replace(
        stall_until=stall_until, instr=instr, pos=pos, trans=trans,
        data=state.data._replace(dram=dram), tokens=tok, stats=stats,
        asid_of_app=torch.where(change, state.asid_of_app + na,
                                state.asid_of_app))
