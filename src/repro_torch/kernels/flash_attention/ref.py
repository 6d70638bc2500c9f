"""Plain PyTorch version of the flash attention kernel.

The same function as `src/repro/kernels/flash_attention/ref.py`
`attention_ref`: the full score matrix in float32, a float32 softmax with
the finite `NEG_INF` mask value, the probabilities rounded to v's dtype
before the product with v.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window: Optional[int] = None):
    """q: (B, H, Sq, dh); k, v: (B, KV, Sk, dh). fp32 softmax.
    Query head h reads KV head h // (H // KV)."""
    B, H, Sq, dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, dh)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) / (dh ** 0.5)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype), v)
    return o.reshape(B, H, Sq, dh)
