"""Dispatch of the fused TLB round by the tensors' device.

A CPU tensor goes to the plain PyTorch round (`ref.py`); any other
device goes to the CUDA kernel (`kernel.py`), which launches or raises.
Nothing falls back from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.fused_tlb.kernel import fused_tlb_round
from repro_torch.kernels.fused_tlb.ref import fused_tlb_access_ref
from repro_torch.spans import span


def fused_tlb_access(tags, asids, lru, vpn, asid, active, may_fill,
                     time: int, *, n_waves: int = 1,
                     track_asids: bool = True):
    """One fused probe+fill round; returns (tags, asids, lru, hit, filled),
    the planes updated in place, hit/filled as int32 masks."""
    with span("fused_tlb.round"):
        impl = fused_tlb_access_ref if tags.device.type == "cpu" \
            else fused_tlb_round
        return impl(tags, asids, lru, vpn, asid, active, may_fill, time,
                    n_waves=n_waves, track_asids=track_asids)
