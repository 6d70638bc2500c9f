"""Attention: GQA + RoPE + qk-norm + sliding-window, in three implementations.

* ``naive``        — full O(S^2) softmax; oracle for tests (small shapes only).
* ``xla_blocked``  — memory-bounded blocked attention with an online
                     softmax, in plain PyTorch (Python loops over q/k blocks).
* ``pallas_flash`` — the flash attention kernel
                     (`repro_torch.kernels.flash_attention`): the CUDA kernel
                     for tensors on the card, its plain version on the CPU.

Decode uses the dense-cache path (`decode_attention_dense`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import whole_dims
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, dot, head_rmsnorm_params
from repro_torch.models.params import Param

NEG_INF = -1e30


def _scale(dh: int) -> float:
    """1/sqrt(dh) as the reference forms it: both steps in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def attn_params(d_model: int, n_heads: int, n_kv: int, dh: int,
                qk_norm: bool = False):
    p = {
        "wq": Param((d_model, n_heads * dh), ("embed", "heads")),
        "wk": Param((d_model, n_kv * dh), ("embed", "heads")),
        "wv": Param((d_model, n_kv * dh), ("embed", "heads")),
        "wo": Param((n_heads * dh, d_model), ("heads", "embed")),
    }
    if qk_norm:
        p["q_norm"] = head_rmsnorm_params(dh)
        p["k_norm"] = head_rmsnorm_params(dh)
    return p


def _head_norm(scale, x, eps=1e-5):
    """Per-head RMSNorm (qk-norm). Its eps is fixed at 1e-5, not the
    config's norm_eps, as in the reference."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale["scale"]).to(x.dtype)


def project_qkv(params, x, *, n_heads, n_kv, dh, positions, rope_theta,
                qk_norm=False, use_rope=True):
    """x: (B, S, d) -> q (B,S,H,dh), k,v (B,S,KV,dh)."""
    B, S, _ = x.shape
    q = dot(x, params["wq"]).reshape(B, S, n_heads, dh)
    k = dot(x, params["wk"]).reshape(B, S, n_kv, dh)
    v = dot(x, params["wv"]).reshape(B, S, n_kv, dh)
    if qk_norm:
        q = _head_norm(params["q_norm"], q)
        k = _head_norm(params["k_norm"], k)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _common(*ts):
    """Cast tensors to their promoted dtype (JAX promotes mixed operands of
    an einsum; torch refuses them)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


# ---------------------------------------------------------------------------
# Naive oracle
# ---------------------------------------------------------------------------

def naive_attention(q, k, v, *, causal=True, window: Optional[int] = None,
                    q_offset: int = 0):
    """q: (B,Sq,H,dh); k,v: (B,Sk,KV,dh). GQA by head grouping. fp32 softmax."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg, kc = _common(q.reshape(B, Sq, KV, G, dh), k)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kc).float()
    scores = scores * _scale(dh)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", *_common(probs.to(v.dtype), v))
    return out.reshape(B, Sq, H, dh)


# ---------------------------------------------------------------------------
# Blocked (flash-style) attention in plain PyTorch
# ---------------------------------------------------------------------------

def _block_attend(q, k, v, mask, m_prev, l_prev, acc_prev, sm_scale):
    """One (q_block, k_block) tile of online softmax — flat-head layout.

    q: (B,Bq,H,dh)  k,v: (B,Bk,H,dh)  mask: (Bq,Bk) bool
    state: m,l (B,H,Bq), acc (B,Bq,H,dh) fp32.
    """
    s = torch.einsum("bqhd,bshd->bhqs", *_common(q, k)).float() * sm_scale
    s = torch.where(mask, s, NEG_INF)
    m_cur = s.amax(dim=-1)
    m_new = torch.maximum(m_prev, m_cur)
    p = torch.exp(s - m_new[..., None])
    correction = torch.exp(m_prev - m_new)
    l_new = l_prev * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqs,bshd->bqhd", *_common(p.to(v.dtype), v)).float()
    acc_new = acc_prev * correction.movedim(-1, 1)[..., None] + pv
    return m_new, l_new, acc_new


def blocked_attention(q, k, v, *, causal=True, window: Optional[int] = None,
                      block_q=512, block_k=1024):
    """Memory-bounded attention, the reference's `xla_blocked` path. GQA k/v
    are repeated to H heads up front. Causal tiles are all visited (masked);
    with a window, a fixed count of k tiles ending at the q tile's index is
    visited. A k tile whose start passes the end is read from the last full
    tile while its mask keeps the unclamped positions, as the reference's
    `dynamic_slice` clamps it. The visited k tiles are counted from the q
    tile's INDEX, so with a window and block_q != block_k the result can
    differ from `naive_attention`; the reference does the same, and the
    port keeps its results (ROADMAP Queue 3)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if KV != H:
        G = H // KV
        # a DTensor sharded along the kv heads is made whole along them
        # first: DTensor cannot view the repeat's (KV, G) pair back into
        # a sharded dim
        k = whole_dims(k, 2).repeat_interleave(G, dim=2)
        v = whole_dims(v, 2).repeat_interleave(G, dim=2)
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    if Sq % block_q or Sk % block_k:
        raise ValueError(f"blocked_attention: {(Sq, block_q, Sk, block_k)}")
    nq, nk = Sq // block_q, Sk // block_k
    sm_scale = _scale(dh)
    dev = q.device
    nk_vis = min(nk, window // block_k + 2) if window is not None else nk

    outs = []
    for qi in range(nq):
        qb = q[:, qi * block_q:(qi + 1) * block_q]
        qpos = qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, H, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, block_q, H, dh), dtype=torch.float32,
                          device=dev)
        k_first = max(qi - (nk_vis - 1), 0) if window is not None else 0
        for kj in range(k_first, k_first + nk_vis):
            start = min(kj * block_k, Sk - block_k)      # dynamic_slice clamp
            kb = k[:, start:start + block_k]
            vb = v[:, start:start + block_k]
            kpos = kj * block_k + torch.arange(block_k, device=dev)
            mask = torch.ones((block_q, block_k), dtype=torch.bool,
                              device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kpos[None, :] > (qpos[:, None] - window)
            m, l, acc = _block_attend(qb, kb, vb, mask, m, l, acc, sm_scale)
        out = acc / l.clamp_min(1e-30).movedim(-1, 1)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------

def decode_attention_dense(q, k_cache, v_cache, cache_len, *,
                           window: Optional[int] = None):
    """q: (B,1,H,dh); caches: (B,S,KV,dh); cache_len: (B,) valid lengths.

    Reads the whole cache; masked beyond length and outside the sliding
    window.
    """
    B, S, KV, dh = k_cache.shape
    H = q.shape[2]
    G = H // KV
    qg, kc = _common(q.reshape(B, KV, G, dh), k_cache)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kc).float()
    s = s * _scale(dh)
    kpos = torch.arange(S, device=q.device)[None, :]
    valid = kpos < cache_len[:, None]
    if window is not None:
        valid &= kpos > (cache_len[:, None] - 1 - window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", *_common(p.to(v_cache.dtype),
                                                   v_cache))
    return out.reshape(B, 1, H, dh)


def attention(q, k, v, *, impl="xla_blocked", causal=True, window=None,
              block_q=512, block_k=1024):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window)
    if impl == "xla_blocked":
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 block_q=block_q, block_k=block_k)
    if impl == "pallas_flash":
        # the reference passes no block sizes here: the kernel's 512 x 512
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attention impl {impl!r}")
