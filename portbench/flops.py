"""Model FLOPs of one prefill call, counted from its shape, the bytes its
MoE FFN and attention must move, and the card's peaks they are held to.

What the model's mathematics needs, whatever computes it: each layer's
q, k, v and o projections, causal attention (QK^T and PV over the pairs
the mask lets through), the router, and every routed expert's three
GEMMs for each token and each of its top-k experts (an assignment the
program drops past capacity still counts: the model asks for it); the
LM head at the last position only, which is all `forward_prefill`
computes there. Elementwise work, norms, softmax and the embedding
lookup are not counted. A multiply-add is 2 FLOPs.

Bytes, for the rooflines: each input read once and each output written
once. The MoE FFN reads its weights (bf16 experts, a float32 router) and
its input and writes its output; attention reads q, k and v and writes o
(bf16).
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet: dense bf16 on the tensor cores, HBM3
PEAK_BF16_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def prefill(config: dict, B: int, S: int) -> Dict[str, float]:
    """FLOPs of a (B, S) prefill of the configuration `config` (the keys
    of `configs/<name>.json`), by part: "projections", "attention",
    "router", "experts", "lm_head", and "moe" (router + experts) and
    "total"; and the bytes "moe_bytes" and "attention_bytes"."""
    L, d = config["n_layers"], config["d_model"]
    H, KV, dh = config["n_heads"], config["n_kv_heads"], config["head_dim"]
    E, K, f = config["n_experts"], config["top_k"], config["d_ff"]
    T = B * S
    out = {
        "projections": L * 2.0 * T * d * (2 * H * dh + 2 * KV * dh),
        "attention": L * 2.0 * B * H * dh * S * (S + 1),
        "router": L * 2.0 * T * d * E,
        "experts": L * 2.0 * T * K * 3 * d * f,
        "lm_head": 2.0 * B * d * config["vocab_size"],
    }
    out["moe"] = out["router"] + out["experts"]
    out["total"] = (out["projections"] + out["attention"] + out["moe"]
                    + out["lm_head"])
    out["moe_bytes"] = L * (2.0 * E * 3 * d * f + 4.0 * d * E
                            + 2 * 2.0 * T * d)
    out["attention_bytes"] = L * 2.0 * T * dh * (2 * H + 2 * KV)
    return out


def roofline_pct(flop: float, nbytes: float, seconds: float) -> float:
    """The least time of the work on the card (the larger of its FLOPs at
    the bf16 peak and its bytes at the HBM rate) over `seconds`, in %."""
    least = max(flop / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
    return 100.0 * least / seconds


def of_calls(run):
    """The FLOPs dicts of the profiled calls' plans (`Plan.flops`), or None
    where there is no trace, the completed calls are not the profiled
    ones, or a plan carries no FLOPs."""
    tr = run.trace
    if tr is None or not run.calls or len(run.calls) != len(tr.calls) \
            or any(getattr(c.plan, "flops", None) is None
                   for c in run.calls):
        return None
    return [c.plan.flops for c in run.calls]
