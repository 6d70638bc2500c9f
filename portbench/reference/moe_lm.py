"""A decoder LM with a mixture-of-experts FFN in every layer, in plain
PyTorch and float32: what a prefill computes, written out from its
equations, to decide `correct` of the prefill cells.

Each layer: x + attention(rmsnorm(x)), then x + moe(rmsnorm(x)).
Attention is causal multi-head attention with RoPE (the half-split
rotation, position p at angle p / theta^(2i / dh)) over query blocks,
scores scaled by 1 / sqrt(dh), a softmax over the keys. The MoE routes
each sequence on its own: router logits and their softmax over the
experts; the top k taken from a stable descending sort (ties to the lower
expert); the k gates renormalised to sum to 1; each expert takes at most
`capacity` assignments of a sequence, the first in (token, rank) order,
and drops the rest; an expert is a SwiGLU, silu(x W_gate) * (x W_up)
W_down, and a token adds its kept experts' outputs times their gates.
After the last layer, an RMSNorm and the LM head at the last position.

Every product runs in float32 with TF32 off; the weights, in whatever
type they are given, are upcast one layer at a time, and each layer runs
over every input before the next. It imports nothing of the program.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional

import torch


@contextlib.contextmanager
def exact_float32():
    """Float32 products as float32 (TF32 off for matmuls and cuDNN)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """x: (B, S, heads, dh) at positions 0 .. S-1."""
    S, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, block_bytes: int = 1 << 28):
    """q: (B, S, H, dh); k, v: (B, S, KV, dh), H a multiple of KV. Query
    blocks sized so that one block's scores take at most `block_bytes`."""
    B, S, H, dh = q.shape
    k = k.repeat_interleave(H // k.shape[2], dim=2)
    v = v.repeat_interleave(H // v.shape[2], dim=2)
    bq = max(1, min(S, block_bytes // (4 * B * H * S)))
    out = torch.empty_like(q)
    for s0 in range(0, S, bq):
        e = min(s0 + bq, S)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, s0:e], k[:, :e])
        s = s / math.sqrt(dh)
        qpos = torch.arange(s0, e, device=q.device)[:, None]
        kpos = torch.arange(e, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        out[:, s0:e] = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1),
                                    v[:, :e])
    return out


def capacity(S: int, k: int, n_experts: int, factor: float) -> int:
    """Assignments an expert keeps of a sequence of S tokens: S k / E times
    the factor, rounded half to even, at least 1, up to a multiple of 8,
    at most S k."""
    cap = max(1, round(S * k / n_experts * factor))
    return min(((cap + 7) // 8) * 8, S * k)


def moe(x, lw: dict, top_k: int, factor: float):
    """x: (B, S, d), each sequence routed on its own."""
    B, S, d = x.shape
    probs = (x @ lw["router"]).softmax(-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[..., :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    chosen = idx[..., :top_k].reshape(B, S * top_k)
    gates = gates.reshape(B, S * top_k)
    cap = capacity(S, top_k, probs.shape[-1], factor)
    out = torch.zeros_like(x)
    for e in range(probs.shape[-1]):
        hit = chosen == e
        kept = hit & (hit.cumsum(dim=1) <= cap)
        b, j = kept.nonzero(as_tuple=True)
        if b.numel() == 0:
            continue
        tok = j // top_k
        xe = x[b, tok]
        h = torch.nn.functional.silu(xe @ lw["w_gate"][e]) * (
            xe @ lw["w_up"][e])
        out.index_put_((b, tok), (h @ lw["w_down"][e]) * gates[b, j, None],
                       accumulate=True)
    return out


def layer(x, lw: dict, cfg: dict):
    """One layer over x (B, S, d); returns (x, k, v), k after RoPE."""
    B, S, d = x.shape
    H, KV, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    h = rmsnorm(x, lw["norm1"], cfg["norm_eps"])
    q = rope((h @ lw["wq"]).view(B, S, H, dh), cfg["rope_theta"])
    k = rope((h @ lw["wk"]).view(B, S, KV, dh), cfg["rope_theta"])
    v = (h @ lw["wv"]).view(B, S, KV, dh)
    x = x + causal_attention(q, k, v).reshape(B, S, H * dh) @ lw["wo"]
    h = rmsnorm(x, lw["norm2"], cfg["norm_eps"])
    return x + moe(h, lw, cfg["top_k"], cfg["capacity_factor"]), k, v


@torch.inference_mode()
def prefill(cfg: dict, weights: dict, inputs: List[torch.Tensor],
            on_layer: Optional[Callable] = None) -> List[torch.Tensor]:
    """The last position's logits (B, vocab), float32, of each token batch
    (B, S) of `inputs`. `weights`: "embed" and "lm_head" (vocab, d),
    "final_norm" (d,), and "layers", one dict a layer ("norm1", "wq",
    "wk", "wv", "wo", "norm2", "router" (d, E), "w_gate", "w_up" (E, d,
    f), "w_down" (E, f, d)). `on_layer(r, i, k, v)` sees layer r's keys
    (after RoPE) and values of input i."""
    with exact_float32():
        f32 = lambda w: w.to(torch.float32)  # noqa: E731
        xs = [f32(weights["embed"][t.long()]) for t in inputs]
        for r, lw in enumerate(weights["layers"]):
            lw = {n: f32(w) for n, w in lw.items()}
            for i, x in enumerate(xs):
                xs[i], k, v = layer(x, lw, cfg)
                if on_layer is not None:
                    on_layer(r, i, k, v)
                del k, v
            del lw
        head = f32(weights["lm_head"])
        norm = f32(weights["final_norm"])
        return [rmsnorm(x[:, -1], norm, cfg["norm_eps"]) @ head.T
                for x in xs]
