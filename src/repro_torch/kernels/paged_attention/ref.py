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

`paged_attention_split_ref` follows the CUDA kernel's split and combine
instead (`kernel.split_plan`'s spans, each span's own max, the fixed-order
merge); only the tests and `scripts/torch_paged_variants.py` call it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.kernel import split_plan

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens, *,
                        scale=None):
    """q: (B, H, dh); pages: (P, page, KV, dh); block_table: (B, n) int32;
    seq_lens: (B,) int32. Returns (B, H, dh) in q's dtype. The scores are
    scaled by 1 / sqrt(dh), or by `scale` where given (a head zero-padded
    past its true width keeps the true width's scale)."""
    B, H, dh = q.shape
    _, page, KV, _ = k_pages.shape
    n = block_table.shape[1]
    G = H // KV
    bt = block_table.long()
    k = k_pages[bt].reshape(B, n * page, KV, dh)
    v = v_pages[bt].reshape(B, n * page, KV, dh)
    qg = q.reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float())
    s = s / (dh ** 0.5) if scale is None else s * scale
    pos = torch.arange(n * page, device=q.device)[None, None, None, :]
    s = torch.where(pos < seq_lens[:, None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v)
    o = torch.where((seq_lens > 0)[:, None, None, None], o, 0)
    return o.reshape(B, H, dh).to(q.dtype)


def paged_attention_split_ref(q, k_pages, v_pages, block_table, seq_lens):
    """`paged_attention_ref`'s function computed as the CUDA kernel splits
    it: each span of `split_plan(page, n)` pages gets its own max m_i over
    its positions < seq_len, its p = exp(s - m_i) (l_i sums p, acc_i sums
    p rounded to v's dtype times v, in float32), a span with no such
    position gives m_i = NEG_INF, l_i = 0; the spans merge in order as
    sum_i e^(m_i - m*) acc_i / max(sum_i e^(m_i - m*) l_i, 1e-30) over the
    spans with l_i > 0, m* = max_i m_i. (The kernel takes the max over its
    span tile by tile, so its p may round against a smaller running max.)
    Returns (B, H, dh) in q's dtype."""
    B, H, dh = q.shape
    _, page, KV, _ = k_pages.shape
    n = block_table.shape[1]
    G = H // KV
    pps, n_splits = split_plan(page, n)
    span = pps * page
    bt = block_table.long()
    pad = n_splits * span - n * page

    def spans(pages):
        x = pages[bt].reshape(B, n * page, KV, dh)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(B, n_splits, span, KV, dh)
    k, v = spans(k_pages), spans(v_pages)
    qg = q.reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,bitkd->bkgit", qg.float(), k.float()) / dh ** 0.5
    pos = torch.arange(n_splits * span, device=q.device).reshape(
        n_splits, span)
    valid = (pos < seq_lens[:, None, None, None, None]) & (pos < n * page)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(-1)                                   # (B, KV, G, splits)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkgit,bitkd->bkgid", p.to(v.dtype).float(),
                       v.float())
    live = l > 0
    w = torch.where(live, torch.exp(m - m.amax(-1, keepdim=True)), 0.0)
    num = (w[..., None] * acc).sum(-2)
    den = (w * l).sum(-1)
    o = num / den.clamp_min(1e-30)[..., None]
    return o.reshape(B, H, dh).to(q.dtype)
