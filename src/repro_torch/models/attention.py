"""Attention: GQA + RoPE + qk-norm + sliding-window, in three implementations,
and latent attention (MLA, DeepSeek-V2) projected onto them.

* ``naive``        — full O(S^2) softmax; oracle for tests (small shapes only).
* ``xla_blocked``  — memory-bounded blocked attention with an online
                     softmax, in plain PyTorch (Python loops over q/k blocks).
* ``pallas_flash`` — the flash attention kernel
                     (`repro_torch.kernels.flash_attention`): the CUDA kernel
                     for tensors on the card, its plain version on the CPU.

Decode uses the dense-cache path (`decode_attention_dense`).

Each takes the softmax scale (`scale`, default 1/sqrt(dh) of q) and a v
whose head is narrower or wider than q's and k's: the output has v's
width. MLA (`mla_params`, `mla_project`, `mla_expand`): q = x W_q, split
into a nope and a rope part; [c_kv, k_pe] = x W_kv_a, c_kv RMS-normed
(the latent); [k_nope, v] = c_kv W_kv_b; the rope parts turn by YaRN's
frequencies on the published interleaved pairs; k_pe is one head,
broadcast to all; the scale is (nope + rope)^-1/2 times YaRN's mscale
squared (`mla_scale`). The latent and the rotated k_pe are what a decode
cache keeps a token.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import (shard_ranks, split_last,
                                               whole_dims)
from repro_torch.kernels._dtensor import is_dtensor, run_local
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import (apply_rope, apply_rope_pairs, dot,
                                       head_rmsnorm_params, rmsnorm,
                                       rmsnorm_params, yarn_freqs,
                                       yarn_mscale)
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
    q = split_last(dot(x, params["wq"]), n_heads, dh)
    k = split_last(dot(x, params["wk"]), n_kv, dh)
    v = split_last(dot(x, params["wv"]), n_kv, dh)
    if qk_norm:
        q = _head_norm(params["q_norm"], q)
        k = _head_norm(params["k_norm"], k)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def mla_params(cfg):
    """Weights of an MLA layer without a q LoRA."""
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    return {
        "wq": Param((d, H * cfg.qk_head_dim), ("embed", "heads")),
        "wkv_a": Param((d, cfg.latent_dim), ("embed", None)),
        "kv_norm": rmsnorm_params(r),
        "wkv_b": Param((r, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
                       (None, "heads")),
        "wo": Param((H * cfg.v_head_dim, d), ("heads", "embed")),
    }


def mla_scale(cfg) -> float:
    """The softmax scale: (qk_nope + qk_rope)^-1/2 times YaRN's mscale of
    `yarn_mscale_all_dim`, squared."""
    m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) \
        if cfg.yarn_mscale_all_dim else 1.0
    return cfg.qk_head_dim ** -0.5 * m * m


def _mla_rope(cfg, x, positions):
    inv = yarn_freqs(cfg.qk_rope_head_dim, cfg.rope_theta, cfg.yarn_factor,
                     cfg.yarn_original_max_pos, cfg.yarn_beta_fast,
                     cfg.yarn_beta_slow, x.device)
    ratio = 1.0
    if cfg.yarn_mscale_all_dim:
        ratio = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) / yarn_mscale(
            cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    return apply_rope_pairs(x, positions, inv, ratio)


def mla_project(params, x, cfg, positions):
    """x: (B, S, d) -> q (B, S, H, nope + rope), its rope part rotated,
    and the latent (B, S, kv_lora_rank + rope): the normed c_kv and the
    rotated k_pe, what the cache keeps."""
    H, dn, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = split_last(dot(x, params["wq"]), H, cfg.qk_head_dim)
    q = torch.cat([q[..., :dn], _mla_rope(cfg, q[..., dn:], positions)],
                  dim=-1)
    kv_a = dot(x, params["wkv_a"])
    c_kv = rmsnorm(params["kv_norm"], kv_a[..., :r], cfg.norm_eps)
    k_pe = _mla_rope(cfg, kv_a[..., None, r:], positions)[..., 0, :]
    return q, torch.cat([c_kv, k_pe], dim=-1)


def mla_expand(params, latent, cfg):
    """The latent (B, S, kv_lora_rank + rope) -> k (B, S, H, nope + rope)
    and v (B, S, H, v_head_dim): [k_nope, v] = c_kv W_kv_b, k_pe broadcast
    to every head. v is a view of the product (its head dim contiguous)."""
    H, dn, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    kv = split_last(dot(latent[..., :r], params["wkv_b"]), H,
                    dn + cfg.v_head_dim)
    k_pe = latent[..., None, r:].expand(*kv.shape[:-1], cfg.qk_rope_head_dim)
    return torch.cat([kv[..., :dn], k_pe], dim=-1), kv[..., dn:]


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

def _on_head_shards(fn, name, q, k, v):
    """`fn(q, k, v)` of DTensors, run by each rank on its own shards: each
    (batch, head) is attended on its own, and q's and k/v's heads split
    over the same ranks keep every GQA group on one rank. Kv heads that
    do not split that way are whole already (`split_last`) and are
    repeated to H on each rank, which moves nothing."""
    H, KV = q.shape[2], k.shape[2]
    if KV != H and KV % shard_ranks(q, 2):
        k = whole_dims(k, 2).repeat_interleave(H // KV, dim=2)
        v = whole_dims(v, 2).repeat_interleave(H // KV, dim=2)
    dims = {"batch": 0, "heads": 2}
    return run_local(fn, name, (q, k, v), (dims,) * 3, (dims,))


def naive_attention(q, k, v, *, causal=True, window: Optional[int] = None,
                    q_offset: int = 0, scale: Optional[float] = None):
    """q: (B,Sq,H,dh); k: (B,Sk,KV,dh); v: (B,Sk,KV,dv) -> (B,Sq,H,dv). GQA
    by head grouping. fp32 softmax; scores times `scale` (default
    1/sqrt(dh)). DTensors run on each rank's batch and head shards."""
    if is_dtensor(q, k, v):
        return _on_head_shards(
            functools.partial(naive_attention, causal=causal, window=window,
                              q_offset=q_offset, scale=scale),
            "naive_attention", q, k, v)
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg, kc = _common(q.reshape(B, Sq, KV, G, dh), k)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kc).float()
    scores = scores * (_scale(dh) if scale is None else scale)
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
    return out.reshape(B, Sq, H, v.shape[-1])


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
                      block_q=512, block_k=1024, scale: Optional[float] = None):
    """Memory-bounded attention, the reference's `xla_blocked` path. GQA k/v
    are repeated to H heads up front. Causal tiles are all visited (masked);
    with a window, a fixed count of k tiles ending at the q tile's index is
    visited. A k tile whose start passes the end is read from the last full
    tile while its mask keeps the unclamped positions, as the reference's
    `dynamic_slice` clamps it. The visited k tiles are counted from the q
    tile's INDEX, so with a window and block_q != block_k the result can
    differ from `naive_attention`; the reference does the same, and the
    port keeps its results (ROADMAP Queue 3). v may be of another width
    than q and k; `scale` defaults to 1/sqrt(dh)."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if is_dtensor(q, k, v):
        return _on_head_shards(
            functools.partial(blocked_attention, causal=causal,
                              window=window, block_q=block_q,
                              block_k=block_k, scale=scale),
            "blocked_attention", q, k, v)
    if KV != H:
        G = H // KV
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    block_q = min(block_q, Sq)
    block_k = min(block_k, Sk)
    if Sq % block_q or Sk % block_k:
        raise ValueError(f"blocked_attention: {(Sq, block_q, Sk, block_k)}")
    nq, nk = Sq // block_q, Sk // block_k
    sm_scale = _scale(dh) if scale is None else scale
    dev = q.device
    nk_vis = min(nk, window // block_k + 2) if window is not None else nk

    outs = []
    for qi in range(nq):
        qb = q[:, qi * block_q:(qi + 1) * block_q]
        qpos = qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, H, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, block_q, H, v.shape[-1]), dtype=torch.float32,
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
                           window: Optional[int] = None,
                           scale: Optional[float] = None):
    """q: (B,1,H,dh); caches: (B,S,KV,dh) and (B,S,KV,dv); cache_len: (B,)
    valid lengths -> (B,1,H,dv).

    Reads the whole cache; masked beyond length and outside the sliding
    window. Scores times `scale` (default 1/sqrt(dh)).
    """
    B, S, KV, dh = k_cache.shape
    H = q.shape[2]
    G = H // KV
    # a DTensor q (one token a sequence) is made whole along its heads:
    # the cache is split along its length, and q's head shards would
    # split the KV groups' products across it
    q = whole_dims(q, 2)
    qg, kc = _common(q.reshape(B, KV, G, dh), k_cache)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kc).float()
    s = s * (_scale(dh) if scale is None else scale)
    kpos = torch.arange(S, device=q.device)[None, :]
    valid = kpos < cache_len[:, None]
    if window is not None:
        valid &= kpos > (cache_len[:, None] - 1 - window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", *_common(p.to(v_cache.dtype),
                                                   v_cache))
    return out.reshape(B, 1, H, v_cache.shape[-1])


def attention(q, k, v, *, impl="xla_blocked", causal=True, window=None,
              block_q=512, block_k=1024, scale=None):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    if impl == "xla_blocked":
        return blocked_attention(q, k, v, causal=causal, window=window,
                                 block_q=block_q, block_k=block_k,
                                 scale=scale)
    if impl == "pallas_flash":
        # the reference passes no block sizes here: the kernel's 512 x 512
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
