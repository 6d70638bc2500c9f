"""A decoder LM with latent attention (MLA), YaRN RoPE, a leading dense
layer and a mixture of routed and shared experts (DeepSeek-V2), in plain
PyTorch and float32: what a prefill computes, written out from its
equations (arXiv 2405.04434, and the published config's `rope_scaling`),
to decide `correct` of the MLA prefill cells.

Each layer: x + mla(rmsnorm(x)), then x + ffn(rmsnorm(x)).

MLA, with no LoRA on q: q = h W_q, (B, S, H, nope + rope), split into
q_nope and q_pe; [c_kv, k_pe] = h W_kv_a; c_kv RMS-normed (its own
scale); [k_nope, v] = c_kv W_kv_b, (B, S, H, nope + v); q_pe and k_pe
(one head) turn by RoPE on the interleaved pairs (2i, 2i + 1), pair i at
angle position x f_i, where YaRN sets f_i: theta^(-2i/rope) below the
correction range, divided by the factor above it, a linear ramp between
(the range's ends are the pairs whose wavelength turns beta_fast and
beta_slow times over the original positions, floor and ceil); cos and sin
times mscale(mscale) / mscale(mscale_all_dim), mscale(m) = 0.1 m ln(factor)
+ 1. k = [k_nope, k_pe] with k_pe on every head. Causal attention over
query blocks, scores times (nope + rope)^-1/2 mscale(mscale_all_dim)^2, a
softmax over the keys, then the output projection of the H v heads.
The latent a token a layer, what a decode cache keeps, is [c_kv (normed),
k_pe (rotated)].

The FFN: a SwiGLU, silu(h W_gate) * (h W_up) W_down, in the first
`first_dense_layers` layers; after them the MoE: each sequence routed on
its own, router logits and their softmax over the experts, the top k from
a stable descending sort (ties to the lower expert), the k gates as they
are (renormalised to sum to 1 only with `norm_topk_prob`; the published
`routed_scaling_factor` is 1), each expert keeping at most `capacity` of a
sequence's assignments (the first in (token, rank) order: the program's
law, `moe_lm.capacity`), a token adding its kept experts' SwiGLUs times
their gates; plus the shared experts, one SwiGLU of n_shared x expert
width over every token. After the last layer, an RMSNorm and the LM head
at the last position.

Every product runs in float32 with TF32 off; the weights, in whatever
type they are given, are upcast one layer at a time, and each layer runs
over every input before the next. It imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import torch

from .moe_lm import capacity, exact_float32, rmsnorm


def yarn_mscale(factor: float, m: float) -> float:
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(cfg: dict, device) -> torch.Tensor:
    """(rope / 2,) float32 frequencies of the rotary pairs."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    factor, orig = cfg["yarn_factor"], cfg["yarn_original_max_pos"]
    power = base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim)
    if factor <= 1:
        return 1.0 / power

    def turns_at(turns):      # the pair whose wavelength turns `turns` times
        return dim * math.log(orig / (turns * 2 * math.pi)) / (
            2 * math.log(base))

    low = max(math.floor(turns_at(cfg["yarn_beta_fast"])), 0)
    high = min(math.ceil(turns_at(cfg["yarn_beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
             - low) / max(high - low, 1e-3)).clamp(0, 1)
    return ramp / (factor * power) + (1 - ramp) / power


def softmax_scale(cfg: dict) -> float:
    m = yarn_mscale(cfg["yarn_factor"], cfg["yarn_mscale_all_dim"]) \
        if cfg["yarn_mscale_all_dim"] else 1.0
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rope_pairs(x, cfg: dict):
    """x: (B, S, heads, rope) at positions 0 .. S-1, pairs (2i, 2i + 1)
    turned in place."""
    S = x.shape[1]
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * yarn_inv_freq(cfg, x.device)
    ratio = 1.0
    if cfg["yarn_mscale_all_dim"]:
        ratio = yarn_mscale(cfg["yarn_factor"], cfg["yarn_mscale"]) / \
            yarn_mscale(cfg["yarn_factor"], cfg["yarn_mscale_all_dim"])
    cos = (ang.cos() * ratio)[:, None, :]
    sin = (ang.sin() * ratio)[:, None, :]
    even, odd = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = even * cos - odd * sin
    out[..., 1::2] = even * sin + odd * cos
    return out


def causal_attention(q, k, v, scale: float, block_bytes: int = 1 << 28):
    """q, k: (B, S, H, dqk); v: (B, S, H, dv). Query blocks sized so that
    one block's scores take at most `block_bytes`."""
    B, S, H, _ = q.shape
    bq = max(1, min(S, block_bytes // (4 * B * H * S)))
    out = q.new_empty((B, S, H, v.shape[-1]))
    for s0 in range(0, S, bq):
        e = min(s0 + bq, S)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, s0:e], k[:, :e]) * scale
        qpos = torch.arange(s0, e, device=q.device)[:, None]
        kpos = torch.arange(e, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        out[:, s0:e] = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1),
                                    v[:, :e])
    return out


def mla(x, lw: dict, cfg: dict):
    """(attention output (B, S, d), the latent (B, S, rank + rope))."""
    B, S, _ = x.shape
    H, dn, dr = cfg["n_heads"], cfg["qk_nope_head_dim"], \
        cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    q = (x @ lw["wq"]).view(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope_pairs(q[..., dn:], cfg)], dim=-1)
    kv_a = x @ lw["wkv_a"]
    c_kv = rmsnorm(kv_a[..., :r], lw["kv_norm"], cfg["norm_eps"])
    k_pe = rope_pairs(kv_a[..., None, r:], cfg)
    kv = (c_kv @ lw["wkv_b"]).view(B, S, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe.expand(B, S, H, dr)], dim=-1)
    o = causal_attention(q, k, kv[..., dn:], softmax_scale(cfg))
    return o.reshape(B, S, H * dv) @ lw["wo"], torch.cat(
        [c_kv, k_pe[:, :, 0]], dim=-1)


def swiglu(x, w_gate, w_up, w_down):
    return (torch.nn.functional.silu(x @ w_gate) * (x @ w_up)) @ w_down


def moe(x, lw: dict, cfg: dict):
    """x: (B, S, d), each sequence routed on its own; plus the shared
    experts."""
    B, S, d = x.shape
    k = cfg["top_k"]
    probs = (x @ lw["router"]).softmax(-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[..., :k]
    if cfg["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    gates = gates.reshape(B, S * k)
    chosen = idx[..., :k].reshape(B, S * k)
    cap = capacity(S, k, probs.shape[-1], cfg["capacity_factor"])
    out = torch.zeros_like(x)
    for e in range(probs.shape[-1]):
        hit = chosen == e
        kept = hit & (hit.cumsum(dim=1) <= cap)
        b, j = kept.nonzero(as_tuple=True)
        if b.numel() == 0:
            continue
        tok = j // k
        y = swiglu(x[b, tok], lw["w_gate"][e], lw["w_up"][e],
                   lw["w_down"][e])
        out.index_put_((b, tok), y * gates[b, j, None], accumulate=True)
    return out + swiglu(x, lw["shared_gate"], lw["shared_up"],
                        lw["shared_down"])


def layer(x, lw: dict, cfg: dict, dense: bool):
    """One layer over x (B, S, d); returns (x, the latent)."""
    o, latent = mla(rmsnorm(x, lw["norm1"], cfg["norm_eps"]), lw, cfg)
    x = x + o
    h = rmsnorm(x, lw["norm2"], cfg["norm_eps"])
    y = swiglu(h, lw["w_gate"], lw["w_up"], lw["w_down"]) if dense \
        else moe(h, lw, cfg)
    return x + y, latent


@torch.inference_mode()
def prefill(cfg: dict, weights: dict, inputs: List[torch.Tensor],
            on_layer: Optional[Callable] = None) -> List[torch.Tensor]:
    """The last position's logits (B, vocab), float32, of each token batch
    (B, S) of `inputs`. `weights`: "embed" and "lm_head" (vocab, d),
    "final_norm" (d,), and "layers", one dict a layer: "norm1", "wq" (d,
    H (nope + rope)), "wkv_a" (d, rank + rope), "kv_norm" (rank,),
    "wkv_b" (rank, H (nope + v)), "wo" (H v, d), "norm2", and a dense
    layer's "w_gate", "w_up" (d, f), "w_down" (f, d), or an MoE layer's
    "router" (d, E), "w_gate", "w_up" (E, d, f), "w_down" (E, f, d),
    "shared_gate", "shared_up" (d, n_shared f), "shared_down". `on_layer(r,
    i, latent)` sees layer r's latent of input i."""
    with exact_float32():
        f32 = lambda w: w.to(torch.float32)  # noqa: E731
        xs = [f32(weights["embed"][t.long()]) for t in inputs]
        for r, lw in enumerate(weights["layers"]):
            lw = {n: f32(w) for n, w in lw.items()}
            dense = r < cfg["first_dense_layers"]
            for i, x in enumerate(xs):
                xs[i], latent = layer(x, lw, cfg, dense)
                if on_layer is not None:
                    on_layer(r, i, latent)
                del latent
            del lw
        head = f32(weights["lm_head"])
        norm = f32(weights["final_norm"])
        return [rmsnorm(x[:, -1], norm, cfg["norm_eps"]) @ head.T
                for x in xs]
