"""Public paged decode attention op, dispatched by the tensors' device.

A CPU tensor goes to the plain PyTorch version (`ref.py`); any other
device goes to the CUDA kernel (`kernel.py`), which launches or raises.
Nothing falls back from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels.paged_attention import kernel as _kernel
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, k_pages, v_pages, block_table, seq_lens):
    """q: (B, H, dh); k/v pages: (P, page, KV, dh); block_table: (B, n)
    int32 (logical page -> physical page); seq_lens: (B,) int32.
    Returns (B, H, dh); a sequence of length 0 gives 0."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table,
                                   seq_lens)
    return _kernel.paged_attention(q, k_pages, v_pages, block_table,
                                   seq_lens)
