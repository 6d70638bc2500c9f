"""Static partitioning, the legacy design flag bags and the `design(name)`
shim (port of `repro.core.mask`).

`MaskConfig` and `DesignPoint` are the pre-registry flag-bag design
points, kept as in the reference: every entry point that takes a design
accepts a `DesignPoint` and converts it with `design.from_legacy`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.design import Design, get_design


@dataclasses.dataclass(frozen=True)
class MaskConfig:
    """Feature switches + sizing (defaults = paper Table 1 / §5)."""

    # components (ablations: MASK-TLB / MASK-Cache / MASK-DRAM)
    tlb_tokens: bool = True
    l2_bypass: bool = True
    dram_sched: bool = True
    # translation caches
    l1_tlb_entries: int = 64        # fully associative, per core
    l2_tlb_entries: int = 512       # 16-way, ASID-tagged, shared
    l2_tlb_ways: int = 16
    bypass_cache_entries: int = 32  # fully associative
    # policies
    epoch_cycles: int = 8_000       # paper: 100K; scaled to sim length
    initial_token_frac: float = 0.25
    token_step_frac: float = 0.5    # geometric hill-climb step
    thres_max: int = 500
    # page walk
    walk_levels: int = 4
    max_concurrent_walks: int = 64


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """Legacy flag-bag design point (pre-registry API), converted to a
    `Design` by `design.from_legacy` wherever a design is taken."""

    name: str
    use_l2_tlb: bool = True          # shared L2 TLB (Fig. 2b) vs PWC (Fig. 2a)
    use_pwc: bool = False            # page-walk cache design
    mask: MaskConfig = MaskConfig(tlb_tokens=False, l2_bypass=False,
                                  dram_sched=False)
    ideal_tlb: bool = False          # every TLB access hits
    static_partition: bool = False   # L2$/DRAM statically split per app


def static_partition_index(index, n_resources: int, n_apps: int, app):
    """Static resource partitioning (the `Static` design, §6): app `a` owns
    the contiguous slice (a*n)//n_apps .. ((a+1)*n)//n_apps of an index
    space (L2 sets, DRAM channels); at least one unit, clipped into range.

    index/app: int32 tensors (floor mod, as the reference); n_resources
    and n_apps: ints."""
    na = max(n_apps, 1)
    start = (app * n_resources) // na
    span = ((app + 1) * n_resources // na - start).clamp(min=1)
    return torch.clamp(start + index % span, max=n_resources - 1)


def design(name: str) -> Design:
    """The named design point, served by the registry."""
    return get_design(name)


# the paper's named designs
ALL_DESIGNS = ("ideal", "pwc", "gpu-mmu", "static", "mask",
               "mask-tlb", "mask-cache", "mask-dram")
