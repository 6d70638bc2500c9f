"""Common layers in plain PyTorch: RMSNorm, RoPE, SwiGLU MLP, embeddings."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import Param


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_params(d: int):
    return {"scale": Param((d,), ("embed",), init="ones", dtype=torch.float32)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Computed in float32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def head_rmsnorm_params(dh: int):
    return {"scale": Param((dh,), (None,), init="ones", dtype=torch.float32)}


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (dh//2,), float32."""
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, dh); positions: broadcastable to (..., seq).
    Half-split rotation (first half with second half) in float32 angles."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    ang = positions[..., :, None].float() * inv            # (..., seq, dh/2)
    sin = torch.sin(ang)[..., None, :]                     # (..., seq, 1, dh/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_params(d: int, d_ff: int):
    return {
        "w_gate": Param((d, d_ff), ("embed", "ffn")),
        "w_up": Param((d, d_ff), ("embed", "ffn")),
        "w_down": Param((d_ff, d), ("ffn", "embed")),
    }


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the operands' promoted dtype, as JAX promotes an einsum's
    mixed operands (torch refuses them): a bf16 weight under float32
    activations is cast at its use, so its gradient comes back in bf16.
    Operands of one dtype run as `x @ w`."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """silu of the gate in float32, cast to x's dtype, times the up
    projection."""
    g = dot(x, params["w_gate"])
    u = dot(x, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return dot(h, params["w_down"])


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_params(vocab: int, d: int):
    return {"table": Param((vocab, d), ("vocab", "embed"), scale=1.0)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Logits (..., vocab): x against the (vocab, d) table."""
    return dot(x, params["table"].T)


def lm_head_params(vocab: int, d: int):
    return {"table": Param((vocab, d), ("vocab", "embed"))}
