"""The benchmark's plain reference: a frozen copy of the MASK simulator's
semantics in plain PyTorch, run one design a pass.

It imports nothing of the program under test. The workload matrices come
from the bench names (`workloads.app_matrix`), the designs from their
names (`design.get_design`), the shared caches' round from
`fused_round` (tensor ops, no kernel). `run_rows` gives, for each row, the
per-app stats dict the program's runner returns for it. `moe_lm` is the
prefill cells' plain reference, a module of its own.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import SimConfig
from .design import design_params, get_design
from .memsys import init_state, step
from .workloads import app_matrix

Mix = Tuple[Optional[str], ...]


@torch.inference_mode()
def run_rows(design: str, mixes: Sequence[Mix], cycles: int,
             device: str = "cpu", sizes: Optional[dict] = None
             ) -> List[Dict[str, np.ndarray]]:
    """Run `mixes` (one row each, None entries idle partners) under one
    design for `cycles` cycles from a cold start; one stats dict a row.
    `sizes` overrides the simulated GPU's fields (`config.SimConfig`);
    the configuration files of the benchmark give them."""
    fields = {f.name for f in dataclasses.fields(SimConfig)}
    given = {k: v for k, v in (sizes or {}).items()
             if k in fields and k not in ("design", "device", "n_apps")}
    cfg = SimConfig(design=get_design(design), n_apps=len(mixes[0]),
                    device=str(device), **given)
    dp = design_params(cfg.design)
    pm = torch.tensor(np.stack([app_matrix(list(m)) for m in mixes]),
                      device=cfg.device)
    state = init_state(cfg, dp, len(mixes))
    for cycle in range(cycles):
        state = step(cfg, dp, pm, state, cycle)
    host = _to_numpy(state)
    return [stats(cfg, host, r) for r in range(len(mixes))]


def _to_numpy(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_numpy(x) for x in tree))
    if tree.is_floating_point():
        tree = tree.float()
    return tree.cpu().numpy()


def stats(cfg: SimConfig, st, r: int) -> Dict[str, np.ndarray]:
    """Per-app stats of row `r` of a state with numpy leaves."""
    na = cfg.n_apps
    warp_app = np.repeat(np.asarray(cfg.app_of_core), cfg.warps_per_core)
    t = float(st.t[r])
    g = lambda x: np.asarray(x[r], np.float64)  # noqa: E731
    ipc = np.bincount(warp_app, weights=st.instr[r], minlength=na) / t
    s = st.stats
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
        "tokens": np.asarray(st.tokens.tokens[r]),
        "cycles": t,
    }
