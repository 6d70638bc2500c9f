"""Address-space identifiers and protection domains (port of
`repro.core.asid`; plain Python, no tensors).

The paper's §5.1: per-core page table root registers (CR3-like) select the
active address space; L2 TLB entries are ASID-tagged; flushes target one
core's L1 TLB + matching-ASID L2 entries. Here an AddressSpace is the unit
of isolation for both the simulator (one per co-scheduled app) and the
serving stack (one per tenant).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class AddressSpace:
    asid: int
    name: str
    # synthetic page-table root (frame number); distinct roots guarantee
    # disjoint PTE addresses across address spaces
    root_frame: int

    def __post_init__(self):
        if not 0 <= self.asid < 256:
            raise ValueError(f"asid {self.asid}: 8-bit ASIDs (paper §7.5)")


class AsidAllocator:
    """Monotonic ASID allocation with recycling (64 concurrent max, matching
    the paper's 6-bit concurrent-walk counters)."""

    def __init__(self, max_live: int = 64):
        self.max_live = max_live
        self._live: Dict[int, AddressSpace] = {}
        self._next = 0

    def allocate(self, name: str) -> AddressSpace:
        if len(self._live) >= self.max_live:
            raise RuntimeError(f"too many live address spaces (max {self.max_live})")
        while self._next % 256 in self._live:
            self._next += 1
        asid = self._next % 256
        self._next += 1
        sp = AddressSpace(asid=asid, name=name, root_frame=(asid + 1) << 20)
        self._live[asid] = sp
        return sp

    def release(self, asid: int):
        self._live.pop(asid, None)

    def get(self, asid: int) -> Optional[AddressSpace]:
        return self._live.get(asid)

    @property
    def live(self):
        return dict(self._live)
