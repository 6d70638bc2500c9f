"""Model assembly for decoder LMs with attention and Mamba2 (SSM) layers.

The structure is the reference's: an embedding, a loop over parameter
*blocks* (a block = the smallest repeating layer pattern; the block
params are stacked along a leading axis of R repeats), a final norm and a
(possibly tied) vocab projection. Where the reference scans over the
stacked axis with `lax.scan`, the port loops in Python over views
`blocks[...][i]`.

Modes:
  * ``full``   — train / prefill over (B, S); optionally emits KV caches.
  * ``decode`` — one token per sequence against the caches.

Caches are dicts with the reference's keys: ``cache_len`` (B,) int32;
``k``/``v`` of shape (R, n_attn, B, S, KV, dh) when there are attention
layers; ``ssm_h`` (R, n_ssm, B, nh, hd, ds) float32 and ``ssm_conv``
(R, n_ssm, B, W-1, conv_dim) when there are SSM layers.
`forward_decode` writes the new token's k/v and the new SSM state into
the caches IN PLACE and returns the same tensors with a new
``cache_len``.

Dense attention and Mamba2 layers are ported. MoE FFNs, the
encoder-decoder (whisper) and patch-embedding (vlm) inputs, and
int8-quantized weights raise `NotImplementedError` (ROADMAP Queue 1,
item 6); so does jamba, whose hybrid layers carry MoE FFNs.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models.params import TensorSpec, stack_params, tree_map

_UNPORTED = "is not ported yet (ROADMAP Queue 1, item 6)"


def _check_supported(cfg: ModelConfig, run: RunConfig = None):
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: moe layers {_UNPORTED}")
    if cfg.is_enc_dec:
        raise NotImplementedError(f"{cfg.name}: is_enc_dec {_UNPORTED}")
    if cfg.n_patches:
        raise NotImplementedError(f"{cfg.name}: n_patches {_UNPORTED}")
    if run is not None and run.quantize_weights:
        raise NotImplementedError(f"quantize_weights {_UNPORTED}")


# ---------------------------------------------------------------------------
# Block pattern
# ---------------------------------------------------------------------------

def block_pattern(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...],
                                             Tuple[str, ...]]:
    """Return (period P, kinds[:P], ffns[:P]) — smallest repeating pattern."""
    kinds, ffns = cfg.layer_kinds(), cfg.ffn_kinds()
    n = cfg.n_layers
    for p in range(1, n + 1):
        if n % p:
            continue
        if all(kinds[i] == kinds[i % p] and ffns[i] == ffns[i % p]
               for i in range(n)):
            return p, kinds[:p], ffns[:p]
    return n, kinds, ffns


def _layer_param_tree(cfg: ModelConfig, kind: str, ffn: str) -> Dict[str, Any]:
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": L.rmsnorm_params(d)}
    if kind == "attn":
        p["attn"] = attn_mod.attn_params(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.qk_norm)
    else:
        p["ssm"] = m2.mamba2_params(cfg)
    if cfg.d_ff > 0:
        p["norm2"] = L.rmsnorm_params(d)
        p["mlp"] = L.mlp_params(d, cfg.d_ff)
    return p


def build_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Full model Param-spec tree (see repro_torch.models.params)."""
    _check_supported(cfg)
    P, kinds, ffns = block_pattern(cfg)
    R = cfg.n_layers // P
    block = {f"layer{j}": _layer_param_tree(cfg, kinds[j], ffns[j])
             for j in range(P)}
    blocks = stack_params([block] * R) if R > 1 else block
    specs: Dict[str, Any] = {
        "embed": L.embed_params(cfg.padded_vocab, cfg.d_model),
        "final_norm": L.rmsnorm_params(cfg.d_model),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = L.lm_head_params(cfg.padded_vocab, cfg.d_model)
    return specs


# ---------------------------------------------------------------------------
# Cache specs (decode)
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """Shape/dtype tree of the decode cache. SWA archs get a ring buffer
    bounded by the window; SSM layers get O(1) state."""
    _check_supported(cfg)
    P, kinds, _ = block_pattern(cfg)
    R = cfg.n_layers // P
    n_attn = sum(1 for k in kinds if k == "attn")
    n_ssm = P - n_attn
    S = max_len if cfg.sliding_window is None \
        else min(max_len, cfg.sliding_window)
    out: Dict[str, Any] = {"cache_len": TensorSpec((batch,), torch.int32)}
    if n_attn:
        kv = TensorSpec((R, n_attn, batch, S, cfg.n_kv_heads, cfg.head_dim),
                        torch.bfloat16)
        out["k"] = kv
        out["v"] = kv
    if n_ssm:
        st = m2.ssm_state_specs(cfg, batch)
        out["ssm_h"] = TensorSpec((R, n_ssm) + st.h.shape, st.h.dtype)
        out["ssm_conv"] = TensorSpec((R, n_ssm) + st.conv.shape,
                                     st.conv.dtype)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None):
    dev = resolve_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in cache_shapes(cfg, batch, max_len).items()}


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _self_attention_full(cfg, run, lp, x, positions, build_cache):
    q, k, v = attn_mod.project_qkv(
        lp["attn"], x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        dh=cfg.head_dim, positions=positions, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm)
    o = attn_mod.attention(
        q, k, v, impl=run.attention_impl, causal=True,
        window=cfg.sliding_window, block_q=run.attn_block_q,
        block_k=run.attn_block_k)
    o = o.reshape(o.shape[0], o.shape[1], cfg.n_heads * cfg.head_dim)
    out = o @ lp["attn"]["wo"]
    return out, ((k, v) if build_cache else None)


def _self_attention_decode(cfg, run, lp, x, cache_k, cache_v, cache_len):
    """x: (B,1,d); cache_k/v: (B,S,KV,dh), written in place at this token's
    slot: a ring slot under a sliding window no wider than the cache, else
    min(cache_len, S-1) (the last slot is overwritten once full)."""
    B = x.shape[0]
    positions = cache_len[:, None]  # absolute positions (B,1)
    q, k, v = attn_mod.project_qkv(
        lp["attn"], x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        dh=cfg.head_dim, positions=positions, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm)
    S = cache_k.shape[1]
    ring = cfg.sliding_window is not None and S <= cfg.sliding_window
    slot = cache_len % S if ring else cache_len.clamp_max(S - 1)
    bidx = torch.arange(B, device=x.device)
    cache_k[bidx, slot.long()] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, slot.long()] = v[:, 0].to(cache_v.dtype)
    if ring:
        # ring: everything currently stored is in-window and valid
        n_valid = (cache_len + 1).clamp_max(S)
        o = attn_mod.decode_attention_dense(q, cache_k, cache_v, n_valid)
    else:
        o = attn_mod.decode_attention_dense(
            q, cache_k, cache_v, cache_len + 1, window=cfg.sliding_window)
    o = o.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return o @ lp["attn"]["wo"]


def _ffn(cfg, run, lp, x):
    return L.mlp(lp["mlp"], x)


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def backbone(cfg: ModelConfig, run: RunConfig, params, x, positions, *,
             mode: str = "full", caches=None, build_cache=False):
    """x: (B,S,d) embedded inputs. Returns (hidden, new_caches, aux_losses).
    In decode mode the k/v caches and the SSM state are updated in place
    (the state is cast to the cache's dtype)."""
    _check_supported(cfg, run)
    P, kinds, _ = block_pattern(cfg)
    R = cfg.n_layers // P
    attn_ix = [j for j in range(P) if kinds[j] == "attn"]
    ssm_ix = [j for j in range(P) if kinds[j] == "ssm"]
    blocks = params["blocks"]
    cache_len = caches["cache_len"] if caches else None
    kv_out, ssm_out = [], []
    for r in range(R):
        bp = tree_map(lambda a, _r=r: a[_r], blocks) if R > 1 else blocks
        block_kv, block_ssm = [], []
        for j in range(P):
            lp = bp[f"layer{j}"]
            h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
            if kinds[j] == "attn":
                a = attn_ix.index(j)
                if mode == "decode":
                    o = _self_attention_decode(
                        cfg, run, lp, h, caches["k"][r, a],
                        caches["v"][r, a], cache_len)
                else:
                    o, kv = _self_attention_full(
                        cfg, run, lp, h, positions, build_cache)
                    if build_cache:
                        block_kv.append(kv)
            else:
                m = ssm_ix.index(j)
                if mode == "decode":
                    st = m2.SSMState(h=caches["ssm_h"][r, m],
                                     conv=caches["ssm_conv"][r, m])
                    o, new = m2.mamba2_decode(lp["ssm"], cfg, h, st)
                    st.h.copy_(new.h)
                    st.conv.copy_(new.conv)
                else:
                    o, st = m2.mamba2_forward(lp["ssm"], cfg, h)
                    if build_cache:
                        block_ssm.append(st)
            x = x + o
            if "norm2" in lp:
                h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
                x = x + _ffn(cfg, run, lp, h)
        if block_kv:
            kv_out.append(block_kv)
        if block_ssm:
            ssm_out.append(block_ssm)

    if mode == "decode":
        new_caches = dict(caches, cache_len=cache_len + 1)
    elif build_cache:
        def stacked(blocks_out, field):
            return torch.stack([torch.stack([field(e) for e in b])
                                for b in blocks_out])
        new_caches = {"cache_len": torch.full(
            (x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)}
        if kv_out:
            new_caches["k"] = stacked(kv_out, lambda kv: kv[0])
            new_caches["v"] = stacked(kv_out, lambda kv: kv[1])
        if ssm_out:
            new_caches["ssm_h"] = stacked(ssm_out, lambda st: st.h)
            new_caches["ssm_conv"] = stacked(ssm_out, lambda st: st.conv)
    else:
        new_caches = None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, new_caches, aux


# ---------------------------------------------------------------------------
# Top-level entries
# ---------------------------------------------------------------------------

def embed_inputs(cfg, params, batch):
    """Assemble (B,S,d) input embeddings from the batch dict."""
    return L.embed(params["embed"], batch["tokens"])


def logits_fn(cfg, params, hidden):
    """(B,S,d) -> (B,S,padded_vocab) logits."""
    table = params["embed"]["table"] if cfg.tie_embeddings \
        else params["lm_head"]["table"]
    return hidden @ table.T


def _positions(x):
    return torch.arange(x.shape[1], device=x.device)[None, :]


def forward_train(cfg, run, params, batch):
    """Forward only. Returns (logits, aux_loss)."""
    x = embed_inputs(cfg, params, batch)
    h, _, aux = backbone(cfg, run, params, x, _positions(x), mode="full")
    return logits_fn(cfg, params, h), aux


def forward_prefill(cfg, run, params, batch, max_len):
    """Returns (last-token logits, caches ready for decode)."""
    x = embed_inputs(cfg, params, batch)
    h, caches, _ = backbone(cfg, run, params, x, _positions(x), mode="full",
                            build_cache=True)
    logits = logits_fn(cfg, params, h[:, -1:])
    return logits, _pad_prefill_caches(cfg, caches, max_len)


def _pad_prefill_caches(cfg, caches, max_len):
    """Grow prefill KV to the decode cache capacity (right-padded); SSM
    state stays as it is."""
    out = dict(caches)
    for key in ("k", "v"):
        if key in caches:
            arr = caches[key]  # (R, A, B, S, KV, dh)
            S = arr.shape[3]
            cap = max_len if cfg.sliding_window is None \
                else min(max_len, cfg.sliding_window)
            if cap > S:
                out[key] = torch.nn.functional.pad(
                    arr, (0, 0, 0, 0, 0, cap - S))
            elif cap < S:
                out[key] = arr[:, :, :, S - cap:]
    return out


def forward_decode(cfg, run, params, token_batch, caches):
    """token_batch: {'tokens': (B,1)}; returns (logits (B,1,V), caches).
    The caches' k/v and SSM state are updated in place; the returned dict
    holds the same tensors and cache_len + 1."""
    x = embed_inputs(cfg, params, token_batch)
    h, new_caches, _ = backbone(cfg, run, params, x, None, mode="decode",
                                caches=caches)
    return logits_fn(cfg, params, h), new_caches
