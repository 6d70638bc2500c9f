"""Model assembly: decoder LMs with attention, Mamba2 (SSM) and hybrid
layers, dense or MoE FFNs, an encoder-decoder (whisper) and patch inputs
(vlm); weights in bf16 or int8.

The structure is the reference's: an embedding, a loop over parameter
*blocks* (a block = the smallest repeating layer pattern: one layer for
homogeneous models, 8 for jamba's 1:7 attention:mamba interleave; the
block params are stacked along a leading axis of R repeats), a final norm
and a (possibly tied) vocab projection. Where the reference scans over the
stacked axis with `lax.scan`, the port loops in Python over views
`blocks[...][i]`; with `run.quantize_weights` each block's {"q", "scale"}
leaves are dequantized to bf16 as the block runs (`models/quant.py`).

Modes:
  * ``full``   — train / prefill over (B, S); optionally emits KV caches.
  * ``decode`` — one token per sequence against the caches.

Caches are dicts with the reference's keys: ``cache_len`` (B,) int32;
``k``/``v`` of shape (R, n_attn, B, S, KV, dh) when there are attention
layers; ``latent`` (R, n_mla, B, S, kv_lora_rank + qk_rope_head_dim) for
latent-attention (MLA) layers, the normed latent and the rotated k_pe a
token, from which decode expands k and v through W_kv_b each step; ``ssm_h`` (R, n_ssm, B, nh, hd, ds) float32 and ``ssm_conv``
(R, n_ssm, B, W-1, conv_dim) when there are SSM layers; ``cross_k`` /
``cross_v`` (R, n_attn, B, enc_len, KV, dh) for the encoder-decoder,
built at prefill from the encoder's output and only read at decode.
`forward_decode` writes the new token's k/v and the new SSM state into
the caches IN PLACE and returns the same tensors with a new
``cache_len``.

The MoE FFNs' aux losses are summed per layer as `lb_loss + 1e-3 *
z_loss` (`forward_train` returns the sum). `forward_train` is what the
train step differentiates (`train/step.py`). With `run.remat` and grad
enabled, a training forward is rematerialized as the reference's
`jax.checkpoint` does it, with `torch.utils.checkpoint` (non-reentrant):
each layer of a multi-layer block (jamba's 8) on its own, and each block,
nested in groups of `_scan_group(R)` blocks for deep stacks (only the
group boundaries stay alive; one group's block boundaries are rebuilt at
a time). Remat changes no value; prefill and decode never use it.

Sharding hooks: every entry point takes the reference's `constrain(x,
axes)` at the reference's sites (the activations' logical axes, e.g.
("batch", None, "embed") after each residual branch; q and k by heads;
the decode caches by kvseq; the logits by vocab). The default is a no-op,
so a call without it computes exactly what it did before;
`distributed.sharding.Sharder.constrain` redistributes DTensor
activations over a `DeviceMesh`.

Dtypes follow the reference's promotion: a product of mixed operands runs
in their promoted dtype (`layers.dot`, each weight cast at its use, so
its gradient comes back in the param's dtype). So float32 encoder frames
run the encoder in float32 over bf16 weights, and the decoder from its
first cross attention, as in the reference.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import (plain_as_replicated,
                                               shard_index, split_last)
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models.params import (Param, TensorSpec, stack_params,
                                       tree_leaves, tree_map)
from repro_torch.models.quant import dequant_tree
from repro_torch.spans import span

Constrain = Callable[[torch.Tensor, Tuple[Optional[str], ...]], torch.Tensor]


def _noop_constrain(x, axes):
    return x


# ---------------------------------------------------------------------------
# Block pattern
# ---------------------------------------------------------------------------

def _scan_group(R: int) -> int:
    """Largest divisor of R in [4, 16] closest to sqrt(R); 1 if R < 24."""
    if R < 24:
        return 1
    target = R ** 0.5
    divs = [g for g in range(4, 17) if R % g == 0]
    if not divs:
        return 1
    return min(divs, key=lambda g: abs(g - target))


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
    if kind == "mla":
        p["attn"] = attn_mod.mla_params(cfg)
    elif kind == "attn":
        p["attn"] = attn_mod.attn_params(
            d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.qk_norm)
        if cfg.is_enc_dec:
            p["cross_norm"] = L.rmsnorm_params(d)
            p["cross"] = attn_mod.attn_params(
                d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, False)
    else:
        p["ssm"] = m2.mamba2_params(cfg)
    if cfg.d_ff > 0 or ffn == "moe":
        p["norm2"] = L.rmsnorm_params(d)
        if ffn == "moe":
            p["moe"] = moe_mod.moe_params(d, cfg.expert_d_ff, cfg.n_experts,
                                          cfg.n_shared_experts)
        else:
            p["mlp"] = L.mlp_params(d, cfg.d_ff)
    return p


def build_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """Full model Param-spec tree (see repro_torch.models.params)."""
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
    if cfg.n_patches:
        specs["patch_proj"] = {
            "w": Param((cfg.d_model, cfg.d_model), ("embed", "embed2"))}
    if cfg.is_enc_dec:
        enc_layer = {
            "norm1": L.rmsnorm_params(cfg.d_model),
            "attn": attn_mod.attn_params(
                cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                False),
            "norm2": L.rmsnorm_params(cfg.d_model),
            "mlp": L.mlp_params(cfg.d_model, cfg.d_ff),
        }
        specs["encoder"] = {
            "blocks": stack_params([enc_layer] * cfg.n_enc_layers)
            if cfg.n_enc_layers > 1 else enc_layer,
            "norm": L.rmsnorm_params(cfg.d_model),
        }
    return specs


# ---------------------------------------------------------------------------
# Cache specs (decode)
# ---------------------------------------------------------------------------

def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """Shape/dtype tree of the decode cache. SWA archs get a ring buffer
    bounded by the window; SSM layers get O(1) state; the encoder-decoder
    gets the cross-attention k/v over its enc_len frames."""
    P, kinds, _ = block_pattern(cfg)
    R = cfg.n_layers // P
    n_attn = sum(1 for k in kinds if k == "attn")
    n_mla = sum(1 for k in kinds if k == "mla")
    n_ssm = P - n_attn - n_mla
    S = max_len if cfg.sliding_window is None \
        else min(max_len, cfg.sliding_window)
    out: Dict[str, Any] = {"cache_len": TensorSpec((batch,), torch.int32)}
    if n_attn:
        kv = TensorSpec((R, n_attn, batch, S, cfg.n_kv_heads, cfg.head_dim),
                        torch.bfloat16)
        out["k"] = kv
        out["v"] = kv
    if n_mla:
        out["latent"] = TensorSpec((R, n_mla, batch, S, cfg.latent_dim),
                                   torch.bfloat16)
    if n_ssm:
        st = m2.ssm_state_specs(cfg, batch)
        out["ssm_h"] = TensorSpec((R, n_ssm) + st.h.shape, st.h.dtype)
        out["ssm_conv"] = TensorSpec((R, n_ssm) + st.conv.shape,
                                     st.conv.dtype)
    if cfg.is_enc_dec and n_attn:
        ckv = TensorSpec((R, n_attn, batch, cfg.enc_len, cfg.n_kv_heads,
                          cfg.head_dim), torch.bfloat16)
        out["cross_k"] = ckv
        out["cross_v"] = ckv
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None):
    dev = resolve_device(device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
            for k, s in cache_shapes(cfg, batch, max_len).items()}


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _merge_heads(o, constrain):
    """(B, S, H, dh) -> (B, S, H * dh), constrained by heads: the gradient
    then comes back split by heads, or whole, never split inside a head
    (`wo`'s backward splits it over the model axis, which the view back
    to (H, dh) cannot take when H does not split that way)."""
    return constrain(o.reshape(o.shape[0], o.shape[1], -1),
                     ("batch", None, "heads"))


def _self_attention_full(cfg, run, lp, x, positions, constrain, build_cache):
    q, k, v = attn_mod.project_qkv(
        lp["attn"], x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        dh=cfg.head_dim, positions=positions, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm)
    q = constrain(q, ("batch", None, "heads", None))
    k = constrain(k, ("batch", None, "kv_heads", None))
    # the reference leaves v to GSPMD's propagation; a DTensor's view of
    # the projection may shard it along dh, which the flash kernel's
    # local run refuses, so v gets k's layout here
    v = constrain(v, ("batch", None, "kv_heads", None))
    o = attn_mod.attention(
        q, k, v, impl=run.attention_impl, causal=True,
        window=cfg.sliding_window, block_q=run.attn_block_q,
        block_k=run.attn_block_k)
    o = _merge_heads(o, constrain)
    out = L.dot(o, lp["attn"]["wo"])
    return (constrain(out, ("batch", None, "embed")),
            ((k, v) if build_cache else None))


def _write_slot(cache, slot, new):
    """cache[b, slot[b]] = new[b] in place; cache (B, S, KV, dh), slot (B,),
    new (B, KV, dh). A DTensor cache (batch and kvseq shards) is written
    on each rank's own shard: `new` and `slot` are brought to the cache's
    batch and head shards, and a slot outside this rank's kvseq range
    writes back what is there. DTensor has no in-place rule for the
    scatter, where the reference's GSPMD partitions it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(cache, DTensor):
        cache[torch.arange(cache.shape[0], device=cache.device),
              slot.long()] = new.to(cache.dtype)
        return
    mesh, pls = cache.device_mesh, cache.placements
    new, slot = (t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        for t in (new, slot))
    to_new = {0: Shard(0), 2: Shard(1), 3: Shard(2)}
    new_l = new.redistribute(mesh, [to_new.get(pl.dim, Replicate())
                                    if isinstance(pl, Shard) else Replicate()
                                    for pl in pls]).to_local()
    slot_l = slot.redistribute(mesh, [
        Shard(0) if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
        for pl in pls]).to_local().long()
    # this rank's first position along the kvseq dim (shards are even)
    local = cache.to_local()
    pos = slot_l - shard_index(cache, 1)[0] * local.shape[1]
    ok = (pos >= 0) & (pos < local.shape[1])
    rows = torch.arange(local.shape[0], device=local.device)
    at = pos.clamp(0, local.shape[1] - 1)
    local[rows, at] = torch.where(ok[:, None, None], new_l.to(local.dtype),
                                  local[rows, at])


def _self_attention_decode(cfg, run, lp, x, cache_k, cache_v, cache_len,
                           constrain):
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
    _write_slot(cache_k, slot, k[:, 0])
    _write_slot(cache_v, slot, v[:, 0])
    cache_k = constrain(cache_k, ("batch", "kvseq", "kv_heads", None))
    cache_v = constrain(cache_v, ("batch", "kvseq", "kv_heads", None))
    if ring:
        # ring: everything currently stored is in-window and valid
        n_valid = (cache_len + 1).clamp_max(S)
        o = attn_mod.decode_attention_dense(q, cache_k, cache_v, n_valid)
    else:
        o = attn_mod.decode_attention_dense(
            q, cache_k, cache_v, cache_len + 1, window=cfg.sliding_window)
    o = o.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return constrain(L.dot(o, lp["attn"]["wo"]), ("batch", None, "embed"))


def _mla_full(cfg, run, lp, x, positions, constrain, build_cache):
    """Latent attention over (B, S, d): the latent and q projected, k and v
    expanded from the latent, causal attention at the MLA's scale, the
    output projection. Returns (out, the latent (B, S, latent_dim) when
    building caches)."""
    B, S, _ = x.shape
    with span("model.mla") as rec:
        q, latent = attn_mod.mla_project(lp["attn"], x, cfg, positions)
        k, v = attn_mod.mla_expand(lp["attn"], latent, cfg)
        o = attn_mod.attention(
            constrain(q, ("batch", None, "heads", None)),
            constrain(k, ("batch", None, "heads", None)),
            constrain(v, ("batch", None, "heads", None)),
            impl=run.attention_impl, causal=True, block_q=run.attn_block_q,
            block_k=run.attn_block_k, scale=attn_mod.mla_scale(cfg))
        out = L.dot(_merge_heads(o, constrain), lp["attn"]["wo"])
        if rec is not None and build_cache:
            rec["bytes"] = latent.numel() * latent.element_size()
    return (constrain(out, ("batch", None, "embed")),
            latent if build_cache else None)


def _mla_decode(cfg, run, lp, x, cache, cache_len, constrain):
    """x: (B, 1, d); cache: (B, S, latent_dim), this token's latent written
    in place at slot min(cache_len, S - 1); k and v expanded from the
    whole cache through W_kv_b, attention over the valid slots."""
    B = x.shape[0]
    with span("model.mla") as rec:
        q, latent = attn_mod.mla_project(lp["attn"], x, cfg,
                                         cache_len[:, None])
        _write_slot(cache, cache_len.clamp_max(cache.shape[1] - 1),
                    latent[:, 0])
        k, v = attn_mod.mla_expand(lp["attn"], cache, cfg)
        o = attn_mod.decode_attention_dense(q, k, v, cache_len + 1,
                                            scale=attn_mod.mla_scale(cfg))
        out = L.dot(o.reshape(B, 1, -1), lp["attn"]["wo"])
        if rec is not None:
            rec["bytes"] = latent.numel() * latent.element_size()
    return constrain(out, ("batch", None, "embed"))


def _cross_attention(cfg, run, lp, x, enc_out=None, cross_kv=None,
                     constrain=_noop_constrain):
    """Cross attention over the encoder's frames: k/v projected from
    `enc_out` in full mode, read from the cache (`cross_kv`) in decode.
    Naive (all frames at once) when S == 1 or S * enc_len <= 2**20, else
    q-blocked with the whole k/v per block, as the reference. Float32
    encoder output over bf16 weights gives float32 k/v, attention and
    output, as the reference's promotion."""
    B, S, _ = x.shape
    dh, KV = cfg.head_dim, cfg.n_kv_heads
    q = split_last(L.dot(x, lp["cross"]["wq"]), cfg.n_heads, dh)
    if cross_kv is None:
        k = split_last(L.dot(enc_out, lp["cross"]["wk"]), KV, dh)
        v = split_last(L.dot(enc_out, lp["cross"]["wv"]), KV, dh)
    else:
        k, v = cross_kv
    if S == 1 or S * k.shape[1] <= 1 << 20:
        o = attn_mod.naive_attention(q, k, v, causal=False)
    else:
        bq = S // max(1, S // min(run.attn_block_q, S))
        while S % bq:
            bq -= 1
        o = attn_mod.blocked_attention(q, k, v, causal=False, block_q=bq,
                                       block_k=k.shape[1])
    o = _merge_heads(o, constrain)
    out = L.dot(o, lp["cross"]["wo"])
    return constrain(out, ("batch", None, "embed")), (k, v)


def _ffn(cfg, run, lp, x, constrain):
    """Dense SwiGLU or MoE FFN. Returns (y, aux dict or None)."""
    aux = None
    if "moe" in lp:
        y, aux = moe_mod.moe_apply(
            lp["moe"], x, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
            norm_topk_prob=cfg.norm_topk_prob,
            constrain=constrain)
    else:
        y = L.mlp(lp["mlp"], x)
    return constrain(y, ("batch", None, "embed")), aux


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def _stacked(blocks_out, field):
    return torch.stack([torch.stack([field(e) for e in b])
                        for b in blocks_out])


def _check_stacked(blocks, R: int):
    """Every leaf of stacked blocks leads with the R repeats, as the
    reference's `lax.scan` over them demands (it raises ValueError
    otherwise). An int8 tree misses this where a stacked 1-D bf16 leaf
    (Mamba2's conv_b) was quantized as a 2-D weight, its scales over the
    layer axis: the reference refuses it, and so does the port (ROADMAP
    Queue 3)."""
    sizes = sorted({int(a.shape[0]) if a.dim() else -1
                    for a in tree_leaves(blocks)})
    if sizes != [R]:
        raise ValueError(f"blocks: leaves lead with axis sizes {sizes}, not "
                         f"the {R} stacked repeats")


_checkpoint = functools.partial(torch.utils.checkpoint.checkpoint,
                                use_reentrant=False, preserve_rng_state=False)


def _layer(cfg, run, kind, ix, r, x, lp, positions, *, decode, caches,
           enc_out, build_cache, constrain):
    """One layer of block r (params `lp`; `ix` its index among the block's
    layers of its kind), the reference's layer body. Returns (x, its aux
    loss or None when it has none, its k/v (an MLA layer's latent), SSM
    state and cross k/v, each
    None unless building caches)."""
    kv = st = ckv = None
    h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    if kind == "mla":
        if decode:
            o = _mla_decode(cfg, run, lp, h, caches["latent"][r, ix],
                            caches["cache_len"], constrain)
        else:
            o, kv = _mla_full(cfg, run, lp, h, positions, constrain,
                              build_cache)
        x = x + o
    elif kind == "attn":
        if decode:
            o = _self_attention_decode(
                cfg, run, lp, h, caches["k"][r, ix], caches["v"][r, ix],
                caches["cache_len"], constrain)
        else:
            o, kv = _self_attention_full(cfg, run, lp, h, positions,
                                         constrain, build_cache)
        x = x + o
        if cfg.is_enc_dec:
            h = L.rmsnorm(lp["cross_norm"], x, cfg.norm_eps)
            ckv = ((caches["cross_k"][r, ix], caches["cross_v"][r, ix])
                   if decode else None)
            o, ckv = _cross_attention(cfg, run, lp, h, enc_out=enc_out,
                                      cross_kv=ckv, constrain=constrain)
            x = x + o
    else:
        if decode:
            st = m2.SSMState(h=caches["ssm_h"][r, ix],
                             conv=caches["ssm_conv"][r, ix])
            o, new = m2.mamba2_decode(lp["ssm"], cfg, h, st)
            st.h.copy_(new.h)
            st.conv.copy_(new.conv)
        else:
            o, st = m2.mamba2_forward(lp["ssm"], cfg, h,
                                      constrain=constrain)
        x = x + constrain(o, ("batch", None, "embed"))
    a = None
    if "norm2" in lp:
        h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
        y, ffn_aux = _ffn(cfg, run, lp, h, constrain)
        x = x + y
        if ffn_aux is not None:
            a = ffn_aux["lb_loss"] + 1e-3 * ffn_aux["z_loss"]
    if not build_cache:
        kv = st = ckv = None
    return x, a, kv, st, ckv


def _apply_block(cfg, run, bp, r, x, positions, *, decode, caches,
                 enc_out, build_cache, layer_remat, constrain):
    """Block r (params `bp`) of P layers, each through `_checkpoint` when
    `layer_remat`. Returns (x, the block's aux sum, its k/v, SSM states
    and cross k/v when building caches)."""
    P, kinds, _ = block_pattern(cfg)
    block_kv, block_ssm, block_cross = [], [], []
    aux_b = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(P):
        ix = [i for i in range(P) if kinds[i] == kinds[j]].index(j)
        layer = functools.partial(
            _layer, cfg, run, kinds[j], ix, r, decode=decode, caches=caches,
            enc_out=enc_out, build_cache=build_cache, constrain=constrain)
        lp = bp[f"layer{j}"]
        x, a_j, kv, st, ckv = (_checkpoint(layer, x, lp, positions)
                               if layer_remat else layer(x, lp, positions))
        if a_j is not None:
            aux_b = aux_b + a_j
        for out, o in ((block_kv, kv), (block_ssm, st), (block_cross, ckv)):
            if o is not None:
                out.append(o)
    return x, aux_b, (block_kv, block_ssm, block_cross)


def backbone(cfg: ModelConfig, run: RunConfig, params, x, positions, *,
             mode: str = "full", caches=None, enc_out=None,
             constrain: Constrain = _noop_constrain, build_cache=False):
    """x: (B,S,d) embedded inputs. Returns (hidden, new_caches, aux_losses).
    In decode mode the k/v caches and the SSM state are updated in place
    (the state is cast to the cache's dtype); the cross k/v are read.
    A training forward (full mode, no caches, grad enabled) with
    `run.remat` is rematerialized per layer (P > 1) and per block (R > 1,
    nested in groups of `_scan_group(R)`)."""
    P, _, _ = block_pattern(cfg)
    R = cfg.n_layers // P
    blocks = params["blocks"]
    if R > 1:
        _check_stacked(blocks, R)
    cache_len = caches["cache_len"] if caches else None
    decode = mode == "decode"
    remat = (run.remat and mode == "full" and not build_cache
             and torch.is_grad_enabled())
    kw = dict(decode=decode, caches=caches, enc_out=enc_out,
              build_cache=build_cache, layer_remat=remat and P > 1,
              constrain=constrain)

    def block(x, aux, r):
        bp = tree_map(lambda a: a[r], blocks) if R > 1 else blocks
        if run.quantize_weights:
            bp = dequant_tree(bp)       # this block's bf16 weights only
        x, aux_b, outs = _apply_block(cfg, run, bp, r, x, positions, **kw)
        return x, aux + aux_b, outs

    def remat_block(x, aux, r):
        x, aux, _ = block(x, aux, r)
        return x, aux

    def remat_group(x, aux, g, size):
        for r in range(g * size, (g + 1) * size):
            x, aux = _checkpoint(remat_block, x, aux, r)
        return x, aux

    kv_out, ssm_out, cross_out = [], [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if remat and R > 1:
        size = _scan_group(R)
        for g in range(R // size):
            if size > 1:
                x, aux = _checkpoint(remat_group, x, aux, g, size)
            else:
                x, aux = _checkpoint(remat_block, x, aux, g)
    else:
        for r in range(R):
            x, aux, outs = block(x, aux, r)
            for out, block_out in zip((kv_out, ssm_out, cross_out), outs):
                if block_out:
                    out.append(block_out)

    if decode:
        new_caches = dict(caches, cache_len=cache_len + 1)
    elif build_cache:
        new_caches = {"cache_len": torch.full(
            (x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)}
        attn = ((("latent", kv_out, lambda c: c),) if cfg.is_mla else
                (("k", kv_out, lambda kv: kv[0]),
                 ("v", kv_out, lambda kv: kv[1])))
        for key, blocks_out, field in attn + (
                ("ssm_h", ssm_out, lambda st: st.h),
                ("ssm_conv", ssm_out, lambda st: st.conv),
                ("cross_k", cross_out, lambda kv: kv[0]),
                ("cross_v", cross_out, lambda kv: kv[1])):
            if blocks_out:
                new_caches[key] = _stacked(blocks_out, field)
    else:
        new_caches = None
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, new_caches, aux


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, run: RunConfig, params, frames,
           constrain: Constrain = _noop_constrain):
    """frames: (B, enc_len, d) precomputed frame embeddings (the frontend is
    a stub, as in the reference). The encoder computes in the frames'
    dtype promoted with the weights' (float32 frames over bf16 weights run
    in float32). Bidirectional attention: naive when enc_len <= 2048, else
    `run.attention_impl`. The reference constrains nothing inside the
    encoder and leaves its layouts to GSPMD; the port pins the residual
    to ("batch", None, "embed") after each add (a no-op off a mesh), or
    DTensor may reduce a pending sum into a sequence shard that the
    products after it cannot take."""
    enc = params["encoder"]
    positions = torch.arange(frames.shape[1], device=frames.device)[None, :]
    impl = "naive" if frames.shape[1] <= 2048 else run.attention_impl
    n = cfg.n_enc_layers
    x = frames
    for i in range(n):
        lp = tree_map(lambda a, _i=i: a[_i], enc["blocks"]) if n > 1 \
            else enc["blocks"]
        h = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(
            lp["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            dh=cfg.head_dim, positions=positions, rope_theta=cfg.rope_theta)
        o = attn_mod.attention(q, k, v, impl=impl, causal=False)
        x = constrain(x + L.dot(_merge_heads(o, constrain),
                                lp["attn"]["wo"]), ("batch", None, "embed"))
        h = L.rmsnorm(lp["norm2"], x, cfg.norm_eps)
        x = constrain(x + L.mlp(lp["mlp"], h), ("batch", None, "embed"))
    return L.rmsnorm(enc["norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Top-level entries
# ---------------------------------------------------------------------------

def embed_inputs(cfg, params, batch, constrain: Constrain = _noop_constrain):
    """Assemble (B,S,d) input embeddings from the batch dict: the patch
    embeddings (projected) ahead of the token embeddings when the config
    has patches and the batch carries them."""
    x = L.embed(params["embed"], batch["tokens"])
    if cfg.n_patches and "patch_embeds" in batch:
        pe = L.dot(batch["patch_embeds"], params["patch_proj"]["w"])
        x = torch.cat([pe.to(x.dtype), x], dim=1)
    return constrain(x, ("batch", None, "embed"))


def logits_fn(cfg, params, hidden, constrain: Constrain = _noop_constrain):
    """(B,S,d) -> (B,S,padded_vocab) logits."""
    table = params["embed"]["table"] if cfg.tie_embeddings \
        else params["lm_head"]["table"]
    return constrain(L.unembed({"table": table}, hidden),
                     ("batch", None, "vocab"))


def _positions(x):
    return torch.arange(x.shape[1], device=x.device)[None, :]


def _encoder_out(cfg, run, params, batch, constrain):
    return encode(cfg, run, params, batch["frames"], constrain) \
        if cfg.is_enc_dec else None


def forward_train(cfg, run, params, batch,
                  constrain: Constrain = _noop_constrain):
    """Returns (logits, aux_loss); differentiable (`train/step.py`)."""
    with plain_as_replicated(params):
        enc_out = _encoder_out(cfg, run, params, batch, constrain)
        x = embed_inputs(cfg, params, batch, constrain)
        h, _, aux = backbone(cfg, run, params, x, _positions(x),
                             mode="full", enc_out=enc_out,
                             constrain=constrain)
        return logits_fn(cfg, params, h, constrain), aux


def forward_prefill(cfg, run, params, batch, max_len,
                    constrain: Constrain = _noop_constrain):
    """Returns (last-token logits, caches ready for decode)."""
    with plain_as_replicated(params):
        enc_out = _encoder_out(cfg, run, params, batch, constrain)
        x = embed_inputs(cfg, params, batch, constrain)
        h, caches, _ = backbone(cfg, run, params, x, _positions(x),
                                mode="full", enc_out=enc_out,
                                constrain=constrain, build_cache=True)
        logits = logits_fn(cfg, params, h[:, -1:], constrain)
        return logits, _pad_prefill_caches(cfg, caches, max_len)


def _pad_prefill_caches(cfg, caches, max_len):
    """Grow prefill KV to the decode cache capacity (right-padded); SSM
    state and cross k/v stay as they are. Under a sliding window narrower
    than the prompt the LAST `window` positions are kept at ring slots
    0..window-1, as in the reference, whose decode then writes position p
    at slot p % window: a key still inside the window is overwritten
    (ROADMAP Queue 3)."""
    out = dict(caches)
    for key in ("k", "v", "latent"):
        if key in caches:
            arr = caches[key]  # (R, A, B, S, KV, dh) or (R, A, B, S, c)
            S = arr.shape[3]
            cap = max_len if cfg.sliding_window is None \
                else min(max_len, cfg.sliding_window)
            if cap > S:
                out[key] = torch.nn.functional.pad(
                    arr, (0, 0) * (arr.dim() - 4) + (0, cap - S))
            elif cap < S:
                out[key] = arr[:, :, :, S - cap:]
    return out


def forward_decode(cfg, run, params, token_batch, caches, enc_out=None,
                   constrain: Constrain = _noop_constrain):
    """token_batch: {'tokens': (B,1)}; returns (logits (B,1,V), caches).
    The caches' k/v and SSM state are updated in place; the returned dict
    holds the same tensors and cache_len + 1. `enc_out` is taken for the
    reference's signature: decode reads the cross k/v from the caches."""
    with plain_as_replicated(params):
        x = embed_inputs(cfg, params, token_batch, constrain)
        h, new_caches, _ = backbone(cfg, run, params, x, None,
                                    mode="decode", caches=caches,
                                    enc_out=enc_out, constrain=constrain)
        return logits_fn(cfg, params, h, constrain), new_caches
