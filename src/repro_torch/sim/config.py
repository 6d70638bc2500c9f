"""Simulator configuration (paper Table 1, Maxwell-class); port of
`repro.sim.config`.

Besides the reference's fields, a config names the device it runs on:
None means "cuda" and raises where no card is visible
(`repro_torch.device.resolve_device`). The fused shared-cache round
follows the device alone (`kernels/fused_tlb/ops.py`): the CUDA kernel
on the card, the plain PyTorch round on the CPU.

The reference's `TLB_BACKENDS` and `resolve_tlb_backend` (and its
`tlb_backend` field) are left out on purpose: they choose between its XLA
round and its Pallas kernel, a choice the port makes by the tensors'
device, so there is nothing left for a config to name.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

from repro_torch.core.design import Design, as_design, get_design
from repro_torch.device import resolve_device

if TYPE_CHECKING:   # sim.faults imports this module; annotation only
    from repro_torch.sim.faults import FaultPlan


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_cores: int = 30
    warps_per_core: int = 32
    n_apps: int = 2
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
    sim_cycles: int = 60_000
    # a repro_torch.core.design.Design; a registered name is coerced
    design: Design = dataclasses.field(
        default_factory=lambda: get_design("gpu-mmu"))
    # deterministic chaos schedule for `runner.run_trace` (sim.faults).
    # Hashable and part of the config's identity, but stripped from the
    # runner's plan key: fault operands are data, so every plan shares
    # the no-fault segment plan.
    fault_plan: Optional[FaultPlan] = None
    device: Optional[str] = None

    def __post_init__(self):
        if not 1 <= self.n_apps <= self.n_cores:
            raise ValueError(
                f"n_apps must be in [1, n_cores={self.n_cores}], "
                f"got {self.n_apps}")
        if not isinstance(self.design, Design):
            object.__setattr__(self, "design", as_design(self.design))
        object.__setattr__(self, "device", str(resolve_device(self.device)))

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
