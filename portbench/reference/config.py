"""The simulated GPU (paper Table 1, Maxwell-class), frozen."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .design import Design


@dataclasses.dataclass(frozen=True)
class SimConfig:
    design: Design
    n_apps: int = 2
    n_cores: int = 30
    warps_per_core: int = 32
    # L2 data cache: 2MB, 16-way, 128B lines -> 1024 sets
    l2_sets: int = 1024
    l2_ways: int = 16
    # page-walk cache (Fig. 2a design): 16-way, 1024 entries (§3 fn. 2)
    pwc_entries: int = 1024
    pwc_ways: int = 16
    # DRAM: 8 channels x 8 banks
    n_channels: int = 8
    n_banks: int = 8
    # latencies (cycles)
    lat_l1_tlb: int = 1
    lat_l2_tlb: int = 10
    lat_l2_cache: int = 10
    lat_l1_data: int = 1
    device: str = "cpu"

    @property
    def total_warps(self) -> int:
        return self.n_cores * self.warps_per_core

    @property
    def app_of_core(self) -> Tuple[int, ...]:
        """(n_cores,) oracle core split (§6): contiguous, near-equal ranges."""
        return tuple((c * self.n_apps) // self.n_cores
                     for c in range(self.n_cores))

    @property
    def cores_per_app(self) -> Tuple[int, ...]:
        counts = [0] * self.n_apps
        for a in self.app_of_core:
            counts[a] += 1
        return tuple(counts)

    @property
    def warps_per_app(self) -> Tuple[int, ...]:
        return tuple(c * self.warps_per_core for c in self.cores_per_app)
