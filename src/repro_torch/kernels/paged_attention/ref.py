"""Plain PyTorch version of the paged decode attention kernel.

The function of `src/repro/kernels/paged_attention/ref.py`
`paged_attention_ref`: gather each sequence's pages through its block
table, a float32 softmax over positions < seq_len with the finite
`NEG_INF` mask value, the probabilities rounded to v's dtype before the
product with v. One rule differs, the TPU kernel's
(`src/repro/kernels/paged_attention/kernel.py::_kernel`): a sequence of
length 0 has no live page, so its output is 0, where the reference's
plain version softmaxes a row of equal masked scores and returns the mean
of the gathered v.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens):
    """q: (B, H, dh); pages: (P, page, KV, dh); block_table: (B, n) int32;
    seq_lens: (B,) int32. Returns (B, H, dh) in q's dtype."""
    B, H, dh = q.shape
    _, page, KV, _ = k_pages.shape
    n = block_table.shape[1]
    G = H // KV
    bt = block_table.long()
    k = k_pages[bt].reshape(B, n * page, KV, dh)
    v = v_pages[bt].reshape(B, n * page, KV, dh)
    qg = q.reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) / (dh ** 0.5)
    pos = torch.arange(n * page, device=q.device)[None, None, None, :]
    s = torch.where(pos < seq_lens[:, None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v)
    o = torch.where((seq_lens > 0)[:, None, None, None], o, 0)
    return o.reshape(B, H, dh).to(q.dtype)
