"""Simulation runner: N-app mixes, solo/pair wrappers, grids, churn
traces, typed experiments.

Port of `repro.sim.runner`'s main path, grid layer and churn runner:

* Raw: `run_mix(design, benches)` co-runs len(benches) applications
  (None entries are idle partners) and returns the per-app stats dict of
  the reference, computed on the host in numpy by the same `_stats`.
  `run_pair` / `run_solo` wrap it; `run_batch` runs many same-size mixes
  of one design in one pass; `run_grid` runs a designs x mixes cross
  product; `predict_mixes` is the serving oracle's entry point;
  `run_trace(design, schedule, seg_cycles)` runs a time-varying mix,
  segment by segment, with teardown and faults at the boundaries.
* Typed: `Experiment(design, mixes, cycles).run()` returns an
  `ExperimentResult` of `MixResult`/`AppStats` objects with the derived
  metrics; `sweep(designs, mixes)` drives many designs.

A pass is `simulate` over a state with a leading row axis: one row per
(design, mix), all rows stepped together by one Python loop over the
cycles, so a cycle issues the same launches whatever the row count (the
reference's `lax.scan` over a vmapped step); on the card each cycle
replays the step's CUDA graphs (`sim/replay.py`). A host copy of the
cycle counter rides beside the state's, so a pass issues no host sync
until its final state is fetched: one synchronous copy per state leaf,
51 a pass. A one-design
pass carries that design's knobs as host scalars; `run_grid` runs the
designs of one static-signature group as the rows of one pass, as the
reference does, with a knob the rows differ on as an (R,) tensor
(`core/design.py` `stack_params`): the step branches on a knob where
every row agrees and masks per row where they differ. Under the torch
profiler a pass, its cold start, the transfer and each row's stats are
spans of `repro_torch.spans` (`sim.pass`, `sim.init_state`,
`sim.to_host`, `sim.stats`).

`TRACE_COUNT` counts PLANS, not traces: the port compiles nothing, and
a plan is one (canonical `SimConfig`, row count) that the runner has set
up, keyed by `canonical_design(static_signature(d))` as the reference
keys its compiles, or one segment of a trace (canonical `SimConfig`,
whose `sim_cycles` is the segment's length). So the reference's laws
hold: an 8-design sweep over one mix size sets up one plan per signature
group, a repeated sweep none, a `predict_mixes` loop with `pad_rows` one
for its lifetime, and every schedule, K and fault plan of one shape
shares one segment plan.

The entry points run on the card unless `device` names another one:
`device=None` means "cuda" and raises where no card is visible.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import (Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.core.design import (Design, DesignParams, as_design,
                                     canonical_design, design_params,
                                     stack_params, static_signature)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim import faults as faults_mod
from repro_torch.sim import replay
from repro_torch.sim.config import SimConfig
from repro_torch.sim.convert import row_of, state_to_numpy
from repro_torch.sim.memsys import (SimState, apply_membership_change,
                                   init_state, step)
from repro_torch.sim.workloads import app_matrix
from repro_torch.spans import span

DesignLike = Union[str, Design]  # legacy DesignPoint also accepted

# plans set up so far: one per distinct (canonical SimConfig, row count);
# tests pin "one plan per signature group" against it
TRACE_COUNT = 0


class ZeroCycleError(RuntimeError):
    """A stats request for a run that simulated no cycles (IPC undefined)."""


class NonFiniteStatsError(RuntimeError):
    """Per-app counters came back NaN/inf: corrupt state, not a metric."""


@torch.inference_mode()
def simulate(cfg: SimConfig, dp: DesignParams, params_mat: torch.Tensor,
             state: Optional[SimState] = None, start: int = 0) -> SimState:
    """Run `cfg.sim_cycles` cycles; returns the state.

    dp: one design's knobs, or each row's (`stack_params`).
    params_mat: (R, n_apps, N_FIELDS), one workload matrix per row, gives
    a state of R rows; an (n_apps, N_FIELDS) matrix gives the reference's
    single state, without the row axis. `state` (default: the cold start)
    is the state to run on and `start` the cycle its clock reads: the host
    copy of `state.t`, which the epoch branch and the fused rounds take,
    so a later segment of a trace runs cycles start .. start + sim_cycles
    - 1. The state returned is the caller's: where the last cycle left it
    in the step's graph buffers, it is a copy (`Graphs.detach`)."""
    if state is None:
        state = init_state(
            cfg, dp, params_mat.shape[0] if params_mat.dim() == 3 else None)
    for cycle in range(start, start + cfg.sim_cycles):
        state = step(cfg, dp, params_mat, state, cycle)
    return replay.GRAPHS.detach(state)


def _canonical(cfg: SimConfig) -> SimConfig:
    """The config with its design replaced by its signature group's
    canonical representative and its fault plan stripped: the plan key.
    The stages read only static-signature fields of the design; its knobs
    travel in `dp`, and fault operands are data."""
    return dataclasses.replace(
        cfg, design=canonical_design(static_signature(cfg.design)),
        fault_plan=None)


@functools.lru_cache(maxsize=64)
def _plan(ccfg: SimConfig, rows: int):
    """The pass of `rows` rows under the canonical config `ccfg`: a
    callable (dp, (rows, n_apps, N_FIELDS) params) -> final state.
    Setting one up bumps `TRACE_COUNT`; a later pass of the same key
    reuses it. On the card its cycles replay the step's CUDA graphs,
    which `sim/replay.py` captures per key (the config without its cycle
    count, the rows, the device and the knobs' kinds)."""
    global TRACE_COUNT
    TRACE_COUNT += 1
    return functools.partial(simulate, ccfg)


@functools.lru_cache(maxsize=64)
def _seg_plan(ccfg: SimConfig):
    """One segment of a trace under the canonical config `ccfg` (its
    `sim_cycles` is the segment's length): membership-change teardown,
    the boundary's faults, then the segment's cycles, over a state with a
    row axis. A callable (dp, params (R, n_apps, N_FIELDS), state, start,
    change (R, n_apps), fault operands of one segment with a row axis) ->
    state. Schedules, change masks, fault operands and K are data, so
    every trace of one shape runs through one plan. With an all-False
    change and no fault the boundary returns the state bit for bit, which
    makes constant-membership segments equal the monolithic run."""
    global TRACE_COUNT
    TRACE_COUNT += 1

    @torch.inference_mode()
    def seg(dp, params_mat, state, start, change, fops):
        state = apply_membership_change(ccfg, dp, state, change | fops.kill)
        state = faults_mod.apply_state_faults(ccfg, state, fops)
        return simulate(ccfg, dp, params_mat, state, start)

    return seg


def _run_rows(cfg: SimConfig, dp: DesignParams,
              mixes: Sequence[Tuple[Optional[str], ...]]) -> SimState:
    """One pass of `mixes` (one row each) under the knobs `dp` (one
    design's, or each row's from `stack_params`); returns the final
    state on the host (numpy leaves), one synchronous copy per state
    leaf (51)."""
    with span("sim.pass", rows=len(mixes), cycles=cfg.sim_cycles):
        pm = torch.tensor(np.stack([_mix_matrix(m) for m in mixes]),
                          device=cfg.device)
        return state_to_numpy(_plan(_canonical(cfg), len(mixes))(dp, pm))


def _audit_enabled(audit: Optional[bool]) -> bool:
    """None defers to env REPRO_AUDIT; True/False force it on/off."""
    if audit is not None:
        return audit
    return os.environ.get("REPRO_AUDIT", "") in ("1", "true", "yes")


def _stats(cfg: SimConfig, st: SimState,
           audit: Optional[bool] = None) -> Dict[str, np.ndarray]:
    """Per-app stats from a one-row state with numpy leaves
    (`state_to_numpy(st, row=r)` or `row_of`); with the audit on
    (`audit=True`, or None and env REPRO_AUDIT set) the state is first
    held to `sim.audit.check_state`."""
    with span("sim.stats"):
        if _audit_enabled(audit):
            from repro_torch.sim.audit import check_state
            check_state(cfg, st)
        na = cfg.n_apps
        warp_app = np.repeat(np.asarray(cfg.app_of_core), cfg.warps_per_core)
        t = float(st.t)
        if not t > 0:
            raise ZeroCycleError(
                f"cannot derive per-app IPC from a {t:.0f}-cycle run "
                f"(design={cfg.design.name!r}): IPC = instructions / cycles "
                "would be NaN/inf — run with cycles >= 1")
        ipc = np.bincount(warp_app, weights=st.instr, minlength=na) / t
        if not np.all(np.isfinite(ipc)):
            raise NonFiniteStatsError(
                f"non-finite per-app IPC {ipc} after {t:.0f} cycles "
                f"(design={cfg.design.name!r}): the retired-instruction "
                "counters are corrupt")
        s = st.stats
        g = lambda x: np.asarray(x, np.float64)  # noqa: E731
        l1p = g(s.s_l1_hit) + g(s.s_l1_miss)
        l2p = g(s.s_l2_hit) + g(s.s_l2_miss)
        return {
            "ipc": ipc,
            "l1_hit_rate": g(s.s_l1_hit) / np.maximum(l1p, 1),
            "l1_miss_rate": g(s.s_l1_miss) / np.maximum(l1p, 1),
            "l2_hit_rate": g(s.s_l2_hit) / np.maximum(l2p, 1),
            "l2_miss_rate": g(s.s_l2_miss) / np.maximum(l2p, 1),
            "byp_hit_rate": g(s.s_byp_hit) / np.maximum(g(s.s_byp_probe), 1),
            "walk_lat": g(s.s_walk_lat) / np.maximum(g(s.s_walks), 1),
            "walks": g(s.s_walks),
            "stalls_per_miss": g(s.s_stall_per_miss)
            / np.maximum(g(s.s_walks), 1),
            "dram_tlb_lat": g(s.s_dram_tlb_lat)
            / np.maximum(g(s.s_dram_tlb_n), 1),
            "dram_data_lat": g(s.s_dram_data_lat)
            / np.maximum(g(s.s_dram_data_n), 1),
            "dram_tlb_n": g(s.s_dram_tlb_n),
            "dram_data_n": g(s.s_dram_data_n),
            "l2c_tlb_hit_rate": (g(s.s_l2c_tlb_hit)
                                 / np.maximum(g(s.s_l2c_tlb_probe), 1)),
            "l2c_data_hit_rate": (g(s.s_l2c_data_hit)
                                  / np.maximum(g(s.s_l2c_data_probe), 1)),
            "tokens": np.asarray(st.tokens.tokens),
            "cycles": float(st.t),
        }


def _mix_matrix(benches: Sequence[Optional[str]]) -> np.ndarray:
    """(n_apps, N_FIELDS) parameter matrix; None entries are idle apps."""
    return app_matrix(list(benches))


def _config(design: DesignLike, n_apps: int, cycles: int,
            device: DeviceLike) -> SimConfig:
    return SimConfig(n_apps=n_apps, sim_cycles=cycles,
                     design=as_design(design), device=device)


def _same_size(bench_mixes) -> int:
    sizes = {len(m) for m in bench_mixes}
    if len(sizes) != 1:
        raise ValueError(f"all mixes must have the same size, got {sizes}")
    return sizes.pop()


def run_mix(design: DesignLike, benches: Sequence[Optional[str]],
            cycles: int = 60_000, device: DeviceLike = None) -> Dict:
    """Co-run N apps under a design; returns per-app stats: a pass of one
    row.

    `benches` may contain None for idle partners (the §6 `IPC_alone`
    emulation keeps the core split but removes the partner's traffic)."""
    cfg = _config(design, len(benches), cycles, device)
    final = _run_rows(cfg, design_params(cfg.design), [tuple(benches)])
    return _stats(cfg, row_of(final, 0))


def run_batch(design: DesignLike,
              bench_mixes: Sequence[Tuple[Optional[str], ...]],
              cycles: int = 60_000, device: DeviceLike = None) -> List[Dict]:
    """Run many same-size workload mixes of one design in one pass, one
    row each. An entry may contain None for a solo run (idle partner)."""
    cfg = _config(design, _same_size(bench_mixes), cycles, device)
    final = _run_rows(cfg, design_params(cfg.design), bench_mixes)
    return [_stats(cfg, row_of(final, i)) for i in range(len(bench_mixes))]


@dataclasses.dataclass(frozen=True, eq=False)
class TraceResult:
    """A segmented churn run: final stats + per-boundary snapshots.

    `stats` is the run_mix-shaped dict of the FINAL state; for a
    constant-membership schedule it is float-hex identical to
    `run_mix(design, schedule[0], cycles=K * seg_cycles)`. `segments[k]`
    is the cumulative stats snapshot after segment k. Counters of a slot
    reset when its membership changes (the arriving app starts cold), so
    a churned slot's numbers read "since its last arrival"; `ipc` always
    divides by the TOTAL elapsed cycles. `final_state` is the port's
    state on its device, without the row axis (`return_state=True`).
    """
    design: Design
    schedule: Tuple[Tuple[Optional[str], ...], ...]
    seg_cycles: int
    stats: Mapping[str, np.ndarray]
    segments: Tuple[Mapping[str, np.ndarray], ...]
    final_state: Optional[SimState] = None

    def __getitem__(self, key: str):
        return self.stats[key]


def run_trace(design: DesignLike,
              schedule: Sequence[Tuple[Optional[str], ...]],
              seg_cycles: int = 2_000,
              fault_plan: Optional[faults_mod.FaultPlan] = None,
              audit: Optional[bool] = None,
              collect_segments: bool = True,
              return_state: bool = False,
              device: DeviceLike = None) -> TraceResult:
    """Run a time-varying mix: one membership tuple per segment.

    `schedule[k]` is the bench tuple live during segment k (None entries
    are idle slots); all tuples must share one length. Between segments,
    every slot whose entry CHANGED gets full teardown + cold-start
    semantics (`memsys.apply_membership_change`: ASID shootdown across the
    TLB hierarchy, walk cancellation, token/DRAM-pressure release, a
    fresh ASID generation, cold warps and counters), and the boundary's
    faults from `fault_plan` are applied (`sim.faults`; its kills join
    the change mask). Segment k runs cycles k*seg_cycles ..
    (k+1)*seg_cycles - 1 of the host's clock, so LRU stamps, stall
    deadlines and epochs run on as in one monolithic run. The schedule's
    workload rows, change masks and fault operands go to the device once,
    as data: the whole trace runs through one segment plan per (signature
    group, n_apps, seg_cycles), and nothing is read back between segments
    but the snapshots.

    `audit`: None defers to env `REPRO_AUDIT` (the state auditor runs on
    every collected snapshot, `sim.audit`); True/False force it.
    `collect_segments=False` skips intermediate snapshots (one transfer
    to the host instead of K). `return_state` attaches the final state.
    """
    schedule = [tuple(s) for s in schedule]
    if not schedule:
        raise ValueError("schedule needs at least one segment")
    sizes = {len(s) for s in schedule}
    if len(sizes) != 1:
        raise ValueError(
            f"all schedule segments must have the same slot count "
            f"(it is an array shape), got {sizes}")
    if seg_cycles < 1:
        raise ValueError(f"seg_cycles must be >= 1, got {seg_cycles}")
    n = sizes.pop()
    K = len(schedule)
    cfg = SimConfig(n_apps=n, sim_cycles=seg_cycles,
                    design=as_design(design), fault_plan=fault_plan,
                    device=device)
    ccfg = _canonical(cfg)
    dp = design_params(cfg.design)
    ops = (faults_mod.plan_operands(fault_plan, cfg, K) if fault_plan
           else faults_mod.empty_operands(cfg, K))
    seg_run = _seg_plan(ccfg)

    # the trace's data, one row per segment's state: (K, 1, ...); segment
    # 0's membership is the cold init itself (no teardown)
    dev = cfg.device
    pms = torch.tensor(np.stack([_mix_matrix(b) for b in schedule])[:, None],
                       device=dev)
    changes = torch.tensor(np.array(
        [[a != b for a, b in zip(p, s)]
         for p, s in zip(schedule[:1] + schedule[:-1], schedule)])[:, None],
        device=dev)
    dev_ops = faults_mod.FaultOps(*(torch.tensor(x[:, None], device=dev)
                                    for x in ops))
    state = init_state(ccfg, dp, rows=1)
    snaps: List[Dict] = []
    for k in range(K):
        state = seg_run(dp, pms[k], state, k * seg_cycles, changes[k],
                        faults_mod.FaultOps(*(x[k] for x in dev_ops)))
        if collect_segments or k == K - 1:
            snaps.append(_stats(cfg, state_to_numpy(state, row=0),
                                audit=audit))
    return TraceResult(
        design=cfg.design, schedule=tuple(schedule), seg_cycles=seg_cycles,
        stats=snaps[-1], segments=tuple(snaps) if collect_segments else (),
        final_state=row_of(state, 0) if return_state else None)


@dataclasses.dataclass(frozen=True)
class FailureRecord:
    """A sweep cell that failed, or every cell of a failed pass.

    Fail-soft sweeps return these IN PLACE of stats/results instead of
    aborting the remaining passes: one poisoned design point costs the
    cells of its pass (in `run_grid`, every design of its chunk), not the
    grid. The record carries everything needed to reproduce the failure
    standalone."""
    designs: Tuple[str, ...]      # design names sharing the failed call
    n_apps: int
    cycles: int
    error_type: str               # exception class name
    message: str
    stage: str                    # e.g. "grid-chunk", "experiment-batch"

    def __bool__(self) -> bool:   # a failed cell is falsy; stats are truthy
        return False

    def reraise(self) -> None:
        raise RuntimeError(
            f"[{self.stage}] designs={self.designs} n_apps={self.n_apps} "
            f"cycles={self.cycles}: {self.error_type}: {self.message}")


def _visible_devices(device: torch.device) -> int:
    """Devices a grid's rows can be sharded over: the visible CUDA devices
    on CUDA, one on the CPU (tests patch this where the reference forces
    host devices with XLA_FLAGS)."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def _shard_devices(device: DeviceLike, n: int) -> List[torch.device]:
    """The devices of `n` row shards: cuda:0 .. cuda:n-1 on CUDA, `n`
    times the CPU on the CPU (its shards run one after another). Raises
    ValueError naming `devices=n` when fewer devices are visible."""
    dev = resolve_device(device)
    visible = _visible_devices(dev)
    if n > visible:
        raise ValueError(
            f"devices={n} but only {visible} {dev.type} device(s) visible")
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def _pad_rows(rows: list, multiple: int) -> list:
    """`rows` padded up to a multiple of `multiple` by repeating its first
    rows, as the reference pads (`src/repro/sim/runner.py:245`):
    repeated rows are valid simulations; callers slice them off."""
    return rows + rows[:(-len(rows)) % multiple]


def _grid_pass(ccfg: SimConfig, designs: Sequence[Design],
               bench_mixes: Sequence[Tuple[Optional[str], ...]]
               ) -> SimState:
    """One pass of a chunk of one signature group: the designs' knobs
    stacked design-major against the mixes tiled once per design, row
    g * M + m for (designs[g], bench_mixes[m]); returns the final state
    on the host."""
    dp = stack_params([design_params(d) for d in designs], len(bench_mixes),
                      ccfg.device)
    return _run_rows(ccfg, dp, [m for _ in designs for m in bench_mixes])


def _sharded_pass(ccfg: SimConfig, designs: Sequence[Design],
                  bench_mixes: Sequence[Tuple[Optional[str], ...]],
                  devices: int) -> SimState:
    """`_grid_pass` over `devices` shards: the rows (design-major) are
    padded to a multiple of N (`_pad_rows`) and cut into N equal shards,
    each run as a row-axis state of its own on its device
    (`_shard_devices`) and brought to the host; the shards' rows are
    joined in order and the padding sliced off. Rows are independent, so
    every row equals the one-device pass bit for bit."""
    devs = _shard_devices(ccfg.device, devices)
    rows = [(d, m) for d in designs for m in bench_mixes]
    padded = _pad_rows(rows, len(devs))
    per = len(padded) // len(devs)
    finals = []
    for i, dev in enumerate(devs):
        shard = padded[i * per:(i + 1) * per]
        scfg = dataclasses.replace(ccfg, device=dev)
        dp = stack_params([design_params(d) for d, _ in shard], 1, dev)
        finals.append(_run_rows(scfg, dp, [m for _, m in shard]))
    return _join_rows(finals, len(rows))


def _join_rows(states: Sequence, n: int):
    """Host states (numpy leaves with a row axis) joined along the rows
    in order, cut to the first `n` rows."""
    first = states[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_join_rows([s[i] for s in states], n)
                             for i in range(len(first))))
    return np.concatenate(states)[:n]


def run_grid(designs: Sequence[DesignLike],
             bench_mixes: Sequence[Tuple[Optional[str], ...]],
             cycles: int = 60_000,
             max_rows: int = 64,
             devices: Optional[int] = None,
             fail_soft: bool = False,
             device: DeviceLike = None
             ) -> List[List[Union[Dict, "FailureRecord"]]]:
    """Run the full designs x mixes cross product, one plan per
    static-signature group and as few passes as `max_rows` allows;
    returns `stats[d][m]` aligned with the inputs, bit for bit equal to
    `run_mix(designs[d], bench_mixes[m], cycles)`.

    As in the reference, designs are grouped by `static_signature`, and a
    group runs as the rows of one pass: its designs' knobs stacked
    design-major against the mixes (`_grid_pass`). A group whose grid
    exceeds `max_rows` rows runs in chunks of whole designs of EQUAL
    width, the largest divisor of the group's size within
    `max(max_rows // M, 1)` designs, so every chunk reuses the group's one
    plan (rows are independent, so chunking changes no result); a
    design's mixes are never split, whatever M is. Each chunk's final
    state comes to the host as one synchronous copy per state leaf (51
    a pass).

    `devices=N` (> 1) shards each chunk's rows over N devices
    (`_sharded_pass`: cuda:0 .. cuda:N-1, or N shards on the CPU one after
    another), padding the rows to a multiple of N with repeated rows
    that are sliced back off; the chunk cap becomes `max_rows * N`, as in
    the reference, so each device still sees at most `max_rows` rows.
    Sharded results are bit for bit the one-device results. More devices
    than are visible raise ValueError naming `devices=N`.

    `fail_soft=True` catches a failing chunk (set-up error, execution
    error, or corrupt stats) into one `FailureRecord` naming every design
    of the chunk, placed in every cell the chunk covered, and CONTINUES
    with the remaining chunks and groups. Default False keeps
    raise-on-first-error semantics.
    """
    sharded = bool(devices) and devices > 1
    if sharded:
        _shard_devices(device, devices)
    ds = [as_design(d) for d in designs]
    n = _same_size(bench_mixes)
    if not ds:
        return []
    M = len(bench_mixes)
    row_cap = max_rows * (devices if sharded else 1)
    designs_per_call = max(row_cap // M, 1)
    out: List[List[Union[Dict, FailureRecord]]] = [[None] * M for _ in ds]
    groups: Dict[object, List[int]] = {}
    for i, d in enumerate(ds):
        groups.setdefault(static_signature(d), []).append(i)
    for sig, g_idxs in groups.items():
        ccfg = SimConfig(n_apps=n, sim_cycles=cycles,
                         design=canonical_design(sig), device=device)
        G = len(g_idxs)
        # equal-width chunks only: a ragged tail would be a second plan
        width = G if G <= designs_per_call else max(
            w for w in range(1, designs_per_call + 1) if G % w == 0)
        for lo in range(0, G, width):
            idxs = g_idxs[lo:lo + width]
            try:
                chunk = [ds[i] for i in idxs]
                final = (_sharded_pass(ccfg, chunk, bench_mixes, devices)
                         if sharded else _grid_pass(ccfg, chunk, bench_mixes))
                for g, di in enumerate(idxs):
                    out[di] = [_stats(ccfg, row_of(final, g * M + m))
                               for m in range(M)]
            except Exception as e:  # noqa: BLE001 — fail-soft boundary
                if not fail_soft:
                    raise
                rec = FailureRecord(
                    designs=tuple(ds[i].name for i in idxs), n_apps=n,
                    cycles=cycles, error_type=type(e).__name__,
                    message=str(e), stage="grid-chunk")
                for di in idxs:
                    out[di] = [rec] * M
    return out


@dataclasses.dataclass(frozen=True)
class MixPrediction:
    """One candidate co-placement's predicted contention metrics.

    Produced by `predict_mixes` (the serving oracle's entry point into
    the simulator): per-app slowdown/speedup are §6 semantics — the solo
    baseline keeps the app's core share (idle partners) and removes
    memory contention, so `slowdown[i]` isolates what SHARING the memory
    system costs app i in this mix."""

    benches: Tuple[str, ...]
    weighted_speedup: float
    max_slowdown: float
    slowdown: Tuple[float, ...]   # aligned with benches
    ipc: Tuple[float, ...]
    solo_ipc: Tuple[float, ...]


def predict_mixes(design: DesignLike,
                  mixes: Sequence[Sequence[str]],
                  cycles: int = 2_000,
                  slots: Optional[int] = None,
                  pad_rows: int = 0,
                  fail_soft: bool = False,
                  solo_cache: Optional[Dict[str, float]] = None,
                  device: DeviceLike = None
                  ) -> List[Union[MixPrediction, FailureRecord]]:
    """Predict contention for candidate co-placement mixes in ONE
    `run_grid` call (the oracle-facing helper).

    Every mix (a tuple of bench names, no Nones) is padded with idle
    partners to a common `slots` count, so candidates of different
    co-run degrees share one pass with the IPC_alone solo-baseline rows
    their benches need; each app holds the same 1/slots core share in its
    mix AND in its baseline, so slowdowns compare across sizes (§6).

    `pad_rows > 0` pads the ROW COUNT up to the next multiple by
    repeating the last row, keeping the pass's shape stable across
    calls: a serving loop that predicts every decision epoch sets up one
    plan for the oracle's lifetime (`TRACE_COUNT`).

    `solo_cache` (mutated in place when given) carries solo IPCs across
    calls so previously-seen benches don't re-simulate their baselines.
    With `fail_soft=True` a failing pass yields `FailureRecord`s in
    place of predictions.
    """
    mixes = [tuple(b for b in m if b is not None) for m in mixes]
    if not mixes:
        return []
    if any(not m for m in mixes):
        raise ValueError("every candidate mix needs at least one bench")
    n = max(len(m) for m in mixes)
    slots = n if slots is None else slots
    if n > slots:
        raise ValueError(f"a candidate mix has {n} apps > slots={slots}")
    solo_cache = {} if solo_cache is None else solo_cache
    need_solo = sorted({b for m in mixes for b in m} - set(solo_cache))
    rows = [m + (None,) * (slots - len(m)) for m in mixes]
    rows += [(b,) + (None,) * (slots - 1) for b in need_solo]
    if pad_rows > 0:
        target = -(-len(rows) // pad_rows) * pad_rows
        rows += [rows[-1]] * (target - len(rows))
    grid = run_grid([design], rows, cycles, fail_soft=fail_soft,
                    device=device)[0]

    solo_fail: Dict[str, FailureRecord] = {}
    for b, s in zip(need_solo, grid[len(mixes):len(mixes) + len(need_solo)]):
        if isinstance(s, FailureRecord):
            solo_fail[b] = s
        else:
            solo_cache[b] = float(s["ipc"][0])
    out: List[Union[MixPrediction, FailureRecord]] = []
    for m, s in zip(mixes, grid[:len(mixes)]):
        if isinstance(s, FailureRecord):
            out.append(s)
            continue
        bad = next((solo_fail[b] for b in m if b in solo_fail), None)
        if bad is not None:
            out.append(bad)
            continue
        solo = tuple(solo_cache[b] for b in m)
        ipc = tuple(float(s["ipc"][i]) for i in range(len(m)))
        slow = tuple(a / max(i, 1e-9) for a, i in zip(solo, ipc))
        out.append(MixPrediction(
            benches=m,
            weighted_speedup=float(sum(i / max(a, 1e-9)
                                       for i, a in zip(ipc, solo))),
            max_slowdown=float(max(slow)),
            slowdown=slow, ipc=ipc, solo_ipc=solo))
    return out


def run_pair(design: DesignLike, bench_a: str, bench_b: str,
             cycles: int = 60_000, device: DeviceLike = None) -> Dict:
    """Co-run two apps under a design; returns per-app stats."""
    return run_mix(design, [bench_a, bench_b], cycles, device=device)


def run_solo(design: DesignLike, bench: str, cycles: int = 60_000,
             device: DeviceLike = None) -> Dict:
    """IPC_alone: same core count as in the shared run (paper §6),
    exclusive memory system, emulated by pairing with an idle app."""
    return run_mix(design, [bench, None], cycles, device=device)


def weighted_speedup(mix_stats, *solos) -> float:
    """Sum of per-app IPC / IPC_alone over the mix (any N)."""
    return float(sum(mix_stats["ipc"][i] / max(s["ipc"][0], 1e-9)
                     for i, s in enumerate(solos)))


def max_slowdown(mix_stats, *solos) -> float:
    """Unfairness: worst per-app IPC_alone / IPC over the mix (any N)."""
    return float(max(s["ipc"][0] / max(mix_stats["ipc"][i], 1e-9)
                     for i, s in enumerate(solos)))


# ---------------------------------------------------------------------------
# typed results layer
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AppStats:
    """One application's slice of a mix run. `ipc_alone` is the §6
    IPC_alone baseline (same core share, idle partners) when the
    experiment computed solo baselines, else None."""

    bench: Optional[str]          # None = idle partner slot
    index: int                    # position in the mix
    ipc: float
    ipc_alone: Optional[float]
    l1_tlb_hit_rate: float
    l2_tlb_hit_rate: float        # shared L2 TLB (Table 3)
    bypass_hit_rate: float        # token bypass cache (Table 4)
    walk_lat: float               # mean page-walk latency (cycles)
    walks: float
    stalls_per_miss: float
    dram_tlb_lat: float           # mean DRAM latency, walk requests
    dram_data_lat: float          # mean DRAM latency, data requests
    tokens: int                   # final TLB-fill token count

    @property
    def speedup(self) -> float:
        """IPC / IPC_alone (this app's weighted-speedup contribution)."""
        if self.ipc_alone is None:
            raise ValueError("run the experiment with solo baselines")
        return self.ipc / max(self.ipc_alone, 1e-9)

    @property
    def slowdown(self) -> float:
        """IPC_alone / IPC (this app's unfairness contribution)."""
        if self.ipc_alone is None:
            raise ValueError("run the experiment with solo baselines")
        return self.ipc_alone / max(self.ipc, 1e-9)


@dataclasses.dataclass(frozen=True, eq=False)
class MixResult:
    """One mix under one design: per-app `AppStats` + mix-level metrics.
    The raw stats dict stays reachable via `.raw` / `res[key]`."""

    design: Design
    benches: Tuple[Optional[str], ...]
    cycles: int
    apps: Tuple[AppStats, ...]
    raw: Mapping[str, np.ndarray]

    def __getitem__(self, key: str):
        return self.raw[key]

    def app(self, bench: str) -> AppStats:
        """First AppStats running `bench` (mixes may repeat a bench)."""
        for a in self.apps:
            if a.bench == bench:
                return a
        raise KeyError(f"{bench!r} not in mix {self.benches}")

    @property
    def real_apps(self) -> Tuple[AppStats, ...]:
        """Apps excluding idle-partner (None) slots."""
        return tuple(a for a in self.apps if a.bench is not None)

    @property
    def l2c_tlb_hit_rate(self) -> float:
        """L2 data-cache hit rate for TLB (walk) requests (Table 5)."""
        return float(self.raw["l2c_tlb_hit_rate"])

    @property
    def l2c_data_hit_rate(self) -> float:
        return float(self.raw["l2c_data_hit_rate"])

    def weighted_speedup(self) -> float:
        """Sum of IPC / IPC_alone over the real apps (paper Eq. WS)."""
        return float(sum(a.speedup for a in self.real_apps))

    def unfairness(self) -> float:
        """Max per-app slowdown over the real apps (paper max slowdown)."""
        return float(max(a.slowdown for a in self.real_apps))

    max_slowdown = unfairness


@dataclasses.dataclass(frozen=True, eq=False)
class ExperimentResult:
    """All mixes of one `Experiment`, aligned with its mix list."""

    design: Design
    cycles: int
    results: Tuple[MixResult, ...]
    solo_ipc: Mapping[Tuple[str, int], float]  # (bench, n_apps) -> IPC_alone

    def __iter__(self):
        return iter(self.results)

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, i) -> MixResult:
        return self.results[i]

    def mean_weighted_speedup(self) -> float:
        return float(np.mean([r.weighted_speedup() for r in self.results]))

    def mean_unfairness(self) -> float:
        return float(np.mean([r.unfairness() for r in self.results]))


def _normalize_mixes(mixes) -> Tuple[Tuple[Optional[str], ...], ...]:
    """Normalize a mix list: bare bench strings become 1-app mixes."""
    if isinstance(mixes, str):
        raise TypeError(
            f"mixes must be a sequence of mixes, got the bare string "
            f"{mixes!r} — did you mean [({mixes!r},)]?")
    norm = tuple((m,) if isinstance(m, str) else tuple(m) for m in mixes)
    if not norm:
        raise ValueError("need at least one mix")
    return norm


class _NPlan(NamedTuple):
    """Per-n_apps slice of an experiment: which simulation rows to run
    (user mixes + IPC_alone solo mixes) and how to map them back."""
    items: Tuple[Tuple[int, Tuple[Optional[str], ...]], ...]  # (orig idx, mix)
    rows: Tuple[Tuple[Optional[str], ...], ...]   # mixes + solo_mixes
    n_mixes: int
    solo_shaped: frozenset                        # user mixes that ARE solos
    solo_mixes: Tuple[Tuple[Optional[str], ...], ...]


def _mix_plan(mixes, solo_baselines: bool) -> Dict[int, _NPlan]:
    """Group normalized mixes by n_apps and plan each group's simulation
    rows, deduplicating solo baselines against solo-shaped user mixes."""
    by_n: Dict[int, List[Tuple[int, Tuple[Optional[str], ...]]]] = {}
    for i, m in enumerate(mixes):
        by_n.setdefault(len(m), []).append((i, m))
    plans: Dict[int, _NPlan] = {}
    for n, items in sorted(by_n.items()):
        ms = [m for _, m in items]
        benches = sorted({b for m in ms for b in m
                          if b is not None}) if solo_baselines else []
        # a user mix that IS the canonical solo shape (bench + idle
        # partners) doubles as its own baseline — don't simulate twice
        solo_shaped = {m for m in ms if m[0] is not None and not any(m[1:])}
        solo_mixes = [(b,) + (None,) * (n - 1) for b in benches]
        solo_mixes = [sm for sm in solo_mixes if sm not in solo_shaped]
        plans[n] = _NPlan(items=tuple(items),
                          rows=tuple(ms) + tuple(solo_mixes),
                          n_mixes=len(ms),
                          solo_shaped=frozenset(solo_shaped),
                          solo_mixes=tuple(solo_mixes))
    return plans


def _mk_mix_result(design: Design, cycles: int, benches, s, solo_ipc,
                   n: int) -> MixResult:
    apps = tuple(
        AppStats(
            bench=b, index=i,
            ipc=float(s["ipc"][i]),
            ipc_alone=solo_ipc.get((b, n)),
            l1_tlb_hit_rate=float(s["l1_hit_rate"][i]),
            l2_tlb_hit_rate=float(s["l2_hit_rate"][i]),
            bypass_hit_rate=float(s["byp_hit_rate"][i]),
            walk_lat=float(s["walk_lat"][i]),
            walks=float(s["walks"][i]),
            stalls_per_miss=float(s["stalls_per_miss"][i]),
            dram_tlb_lat=float(s["dram_tlb_lat"][i]),
            dram_data_lat=float(s["dram_data_lat"][i]),
            tokens=int(s["tokens"][i]),
        ) for i, b in enumerate(benches))
    return MixResult(design=design, benches=tuple(benches),
                     cycles=cycles, apps=apps, raw=s)


def _assemble_result(design: Design, cycles: int, n_results: int,
                     plans: Dict[int, _NPlan],
                     stats_by_n: Dict[int, List[Dict]]) -> ExperimentResult:
    """Fold per-row stats back into an ExperimentResult (shared by the
    per-design `Experiment.run` and the grid-path `sweep`)."""
    results: List[Optional[MixResult]] = [None] * n_results
    solo_ipc: Dict[Tuple[str, int], float] = {}
    for n, plan in sorted(plans.items()):
        stats = stats_by_n[n]
        for m, s in zip(plan.rows[:plan.n_mixes], stats):
            if m in plan.solo_shaped:
                solo_ipc[(m[0], n)] = float(s["ipc"][0])
        for sm, s in zip(plan.solo_mixes, stats[plan.n_mixes:]):
            solo_ipc[(sm[0], n)] = float(s["ipc"][0])
        for (i, m), s in zip(plan.items, stats[:plan.n_mixes]):
            results[i] = _mk_mix_result(design, cycles, m, s, solo_ipc, n)
    return ExperimentResult(design=design, cycles=cycles,
                            results=tuple(results), solo_ipc=solo_ipc)


@dataclasses.dataclass(frozen=True)
class Experiment:
    """Typed façade over `run_batch`: a design × a list of mixes.

    `design` may be a registered name, a `Design`, or a legacy
    `DesignPoint`; `mixes` entries are bench tuples (a bare bench name
    means a 1-app run; None entries are idle partners). Mixes of
    different sizes are allowed — each (design, n_apps) group is one
    pass, with the solo baselines as rows of the same pass.

        exp = Experiment("mask", [("3DS", "BLK"), ("MUM", "RED")])
        res = exp.run()
        res.mean_weighted_speedup()
        res[0].app("3DS").l2_tlb_hit_rate
    """

    design: DesignLike
    mixes: Tuple[Tuple[Optional[str], ...], ...]
    cycles: int = 60_000
    device: DeviceLike = None

    def __post_init__(self):
        object.__setattr__(self, "design", as_design(self.design))
        object.__setattr__(self, "mixes", _normalize_mixes(self.mixes))

    def run(self, solo_baselines: bool = True, fail_soft: bool = False
            ) -> Union[ExperimentResult, FailureRecord]:
        """`fail_soft=True` converts a failure (set-up, execution, or
        corrupt stats) into this experiment's `FailureRecord` instead of
        raising, so sweep loops over many experiments keep going."""
        plans = _mix_plan(self.mixes, solo_baselines)
        # one pass per (design, n_apps): mixes + solos as its rows
        stats_by_n = {}
        for n, plan in plans.items():
            try:
                stats_by_n[n] = run_batch(self.design, plan.rows,
                                          self.cycles, device=self.device)
            except Exception as e:  # noqa: BLE001 — fail-soft boundary
                if not fail_soft:
                    raise
                return FailureRecord(
                    designs=(self.design.name,), n_apps=n,
                    cycles=self.cycles, error_type=type(e).__name__,
                    message=str(e), stage="experiment-batch")
        return _assemble_result(self.design, self.cycles, len(self.mixes),
                                plans, stats_by_n)


def sweep(designs: Sequence[DesignLike],
          mixes: Sequence, cycles: int = 60_000,
          solo_baselines: bool = True,
          grid: bool = True,
          devices: Optional[int] = None,
          fail_soft: bool = False,
          device: DeviceLike = None
          ) -> Dict[str, Union[ExperimentResult, FailureRecord]]:
    """Run several designs over the same mixes, keyed by design name.

    With `grid=True` (default) every n_apps slice — every design x every
    mix of that size, solo baselines included — runs through `run_grid`:
    a signature group's designs as the rows of one pass, as many as its
    default `max_rows` of 64 holds. The solo baselines are rows of the
    slice (a bench with idle partners), so at the paper's 20 pairs a
    design's slice is 42 rows and each design runs as a pass of its own,
    as in the reference; the 8 designs share 2 passes only where a
    slice holds at most 9 rows.
    `grid=False` keeps the per-design `Experiment` loop; results are bit
    for bit identical either way.

    `devices=N` shards each pass's rows over N devices (see `run_grid`);
    it needs the grid path.

    `fail_soft=True`: a failing chunk of a group (or per-design
    experiment with `grid=False`) becomes a `FailureRecord` VALUE for
    each of its design names, and every other design's `ExperimentResult`
    is still computed and returned."""
    ds: List[Design] = []
    for d in designs:
        dd = as_design(d)
        if any(x.name == dd.name for x in ds):
            raise ValueError(f"duplicate design name in sweep: {dd.name!r}")
        ds.append(dd)
    if not grid:
        if devices and devices > 1:
            raise ValueError("devices > 1 requires the grid path "
                             "(sweep(grid=True))")
        return {d.name: Experiment(d, tuple(mixes), cycles, device).run(
            solo_baselines=solo_baselines, fail_soft=fail_soft)
            for d in ds}
    norm = _normalize_mixes(mixes)
    plans = _mix_plan(norm, solo_baselines)
    stats = {n: run_grid(ds, plan.rows, cycles, devices=devices,
                         fail_soft=fail_soft, device=device)
             for n, plan in plans.items()}        # stats[n][design][row]
    out: Dict[str, Union[ExperimentResult, FailureRecord]] = {}
    for i, d in enumerate(ds):
        rows_by_n = {n: stats[n][i] for n in plans}
        failed = [s for rows in rows_by_n.values() for s in rows
                  if isinstance(s, FailureRecord)]
        out[d.name] = failed[0] if failed else _assemble_result(
            d, cycles, len(norm), plans, rows_by_n)
    return out
