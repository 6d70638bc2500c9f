"""Plain PyTorch version of the flash attention kernel.

The same function as `src/repro/kernels/flash_attention/ref.py`
`attention_ref`: the full score matrix in float32, a float32 softmax with
the finite `NEG_INF` mask value, the probabilities rounded to v's dtype
before the product with v.

`attention_split_ref` is the float32 function with the CUDA kernel's
arithmetic (`csrc/flash_attention.cu`): both products in split TF32,
a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with a_hi = tf32(a) and
a_lo = tf32(a - a_hi) (`_tf32.tf32_round`, as `cvt.rna.tf32.f32`
rounds), the probabilities unnormalised in the product with v and the sum
divided out at the end, as the kernel's online softmax does. It lets the
CPU tests hold that arithmetic to the reference; nothing on a model path
calls it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._tf32 import split_einsum

NEG_INF = -1e30


def _mask(Sq, Sk, causal, window, device):
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q, k, v, *, causal=True, window: Optional[int] = None,
                  scale: Optional[float] = None):
    """q: (B, H, Sq, dh); k: (B, KV, Sk, dh); v: (B, KV, Sk, dv) -> (B, H,
    Sq, dv). fp32 softmax. Query head h reads KV head h // (H // KV). The
    scores are scaled by 1 / sqrt(dh), or by `scale` where given (a head
    zero-padded past its true width keeps the true width's scale)."""
    B, H, Sq, dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, Sq, dh)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float())
    s = s / (dh ** 0.5) if scale is None else s * scale
    s = torch.where(_mask(Sq, Sk, causal, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype), v)
    return o.reshape(B, H, Sq, v.shape[3])


def attention_split_ref(q, k, v, *, causal=True,
                        window: Optional[int] = None):
    """`attention_ref` in float32 with both products in split TF32, as the
    CUDA kernel computes them."""
    B, H, Sq, dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, Sq, dh)
    s = split_einsum("bkgqd,bksd->bkgqs", qg, k.float()) * (1.0 / dh ** 0.5)
    s = torch.where(_mask(Sq, Sk, causal, window, q.device), s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = split_einsum("bkgqs,bksd->bkgqd", p, v.float())
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, H, Sq, dh)
