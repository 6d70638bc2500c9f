"""Simulation runner: N-app mixes and the solo/pair wrappers.

Port of the main path of `repro.sim.runner`: `run_mix` co-runs
len(benches) applications (None entries are idle partners) and returns
the per-app stats dict of the reference, computed on the host in numpy
by the same `_stats`. The reference's `lax.scan` over the cycles is a
Python loop over `memsys.step`; the cycle counter is kept on the host,
so the loop issues no host sync until the final state is fetched.

The entry points run on the card unless `device` names another one:
`device=None` means "cuda" and raises where no card is visible.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.design import Design, DesignParams, as_design, \
    design_params
from repro_torch.device import DeviceLike
from repro_torch.sim.config import SimConfig
from repro_torch.sim.convert import state_to_numpy
from repro_torch.sim.memsys import SimState, init_state, step
from repro_torch.sim.workloads import app_matrix

DesignLike = Union[str, Design]


class ZeroCycleError(RuntimeError):
    """A stats request for a run that simulated no cycles (IPC undefined)."""


class NonFiniteStatsError(RuntimeError):
    """Per-app counters came back NaN/inf: corrupt state, not a metric."""


@torch.inference_mode()
def simulate(cfg: SimConfig, dp: DesignParams,
             params_mat: torch.Tensor) -> SimState:
    """Run `cfg.sim_cycles` cycles from the cold start; returns the state."""
    st = init_state(cfg, dp)
    for cycle in range(cfg.sim_cycles):
        st = step(cfg, dp, params_mat, st, cycle)
    return st


def _stats(cfg: SimConfig, st: SimState) -> Dict[str, np.ndarray]:
    """Per-app stats from a state with numpy leaves (`state_to_numpy`)."""
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
        "stalls_per_miss": g(s.s_stall_per_miss) / np.maximum(g(s.s_walks), 1),
        "dram_tlb_lat": g(s.s_dram_tlb_lat) / np.maximum(g(s.s_dram_tlb_n), 1),
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


def run_mix(design: DesignLike, benches: Sequence[Optional[str]],
            cycles: int = 60_000, device: DeviceLike = None) -> Dict:
    """Co-run N apps under a design; returns per-app stats.

    `benches` may contain None for idle partners (the §6 `IPC_alone`
    emulation keeps the core split but removes the partner's traffic)."""
    cfg = SimConfig(n_apps=len(benches), sim_cycles=cycles,
                    design=as_design(design), device=device)
    pm = torch.tensor(app_matrix(list(benches)), device=cfg.device)
    return _stats(cfg, state_to_numpy(simulate(cfg, design_params(cfg.design),
                                               pm)))


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
