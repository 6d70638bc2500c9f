"""Mamba2 (SSD, state-space duality) block: chunked scan + O(1) decode.

Port of `repro.models.mamba2`. Prefill and training use the chunked SSD
algorithm [arXiv:2405.21060]: the intra-chunk quadratic part runs in
`kernels/ssd_scan` (the CUDA kernel on the card, its plain version on the
CPU), the inter-chunk state recurrence is a loop over chunks
(`kernels/ssd_scan/ops.py::ssd_scan`). Decode is the O(1) recurrent
update.

Numerics follow the reference: softplus is `logaddexp(x, 0)` (JAX's;
`torch.nn.functional.softplus` switches to x above 20), and a float32
tensor times a bfloat16 weight is computed in float32, as JAX promotes.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import split_last
from repro_torch.kernels._dtensor import is_dtensor, run_local
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.params import Param, TensorSpec


class SSMState(NamedTuple):
    h: torch.Tensor      # (B, nh, hd, d_state) fp32
    conv: torch.Tensor   # (B, conv_w - 1, conv_dim)


def mamba2_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, nh, conv_dim


def mamba2_params(cfg):
    d_in, nh, conv_dim = mamba2_dims(cfg)
    d = cfg.d_model
    f32 = torch.float32
    return {
        "in_proj": Param((d, 2 * d_in + 2 * cfg.ssm_state + nh),
                         ("embed", "ssm")),
        "conv_w": Param((cfg.ssm_conv_width, conv_dim), (None, "ssm")),
        "conv_b": Param((conv_dim,), ("ssm",), init="zeros"),
        "A_log": Param((nh,), (None,), dtype=f32, init="constant",
                       const=0.0),
        "dt_bias": Param((nh,), (None,), dtype=f32, init="zeros"),
        "D": Param((nh,), (None,), dtype=f32, init="ones"),
        "norm_scale": Param((d_in,), ("ssm",), dtype=f32, init="ones"),
        "out_proj": Param((d_in, d), ("ssm", "embed")),
    }


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(cfg, proj):
    d_in, nh, _ = mamba2_dims(cfg)
    z, xbc, dt = torch.split(
        proj, [d_in, d_in + 2 * cfg.ssm_state, nh], dim=-1)
    return z, xbc, dt  # dt: (..., nh)


def _causal_conv(xbc, conv_w, conv_b, prev=None):
    """Depthwise causal conv, width W. xbc: (B,S,C); prev: (B,W-1,C) or
    None. Returns (silu(conv) in xbc's dtype, the last W-1 inputs).
    DTensor inputs run on each rank's batch and channel shards
    (`run_local`): each (row, channel) is convolved on its own, and the
    zeros of a missing `prev` then take the shard's rows."""
    if is_dtensor(xbc, conv_w, conv_b):
        rows = {"batch": 0, "chan": 2}
        args = (xbc, conv_w, conv_b) + (() if prev is None else (prev,))
        dims = (rows, {"chan": 1}, {"chan": 0}, rows)
        return run_local(_causal_conv, "causal_conv", args,
                         dims[:len(args)], (rows, rows))
    W = conv_w.shape[0]
    if prev is None:
        prev = xbc.new_zeros((xbc.shape[0], W - 1, xbc.shape[2]))
    xp = torch.cat([prev, xbc], dim=1)
    S = xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(W):
        out = out + xp[:, i:i + S].float() * conv_w[i].float()
    out = out + conv_b.float()
    return F.silu(out).to(xbc.dtype), xp[:, xp.shape[1] - (W - 1):]


def _segsum(x):
    """x: (..., Q) -> (..., Q, Q): out[..., i, j] = sum_{k=j+1..i} x[..., k]
    on and below the diagonal, -inf above."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(Q, device=x.device)
    return diff.masked_fill(~(ii[:, None] >= ii[None, :]), float("-inf"))


def _noop_constrain(x, axes):
    return x


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None, constrain=None):
    """Chunked SSD scan.

    x: (b, S, nh, hd)   dt: (b, S, nh)   A: (nh,) negative
    B, C: (b, S, ds)    returns y: (b, S, nh, hd), h_final (b, nh, hd, ds)

    The chunk is the largest divisor of S that is at most `chunk`, as in
    the reference, so a chunk may hold any number of rows from 1 up.
    `constrain` keeps x, dt and y sharded by heads, where the reference
    constrains the chunked x * dt, dt * A and y_intra (its (Q, Q) decays
    must never replicate across the model axis)."""
    cb = constrain if constrain is not None else _noop_constrain
    S = x.shape[1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    x = cb(x, ("batch", None, "heads", None))
    dt = cb(dt, ("batch", None, "heads"))
    y, h = ssd_scan(x, dt, A, B, C, chunk=chunk, h0=h0)
    return cb(y, ("batch", None, "heads", None)), h


def _gated_norm_out(params, y, z, dtype):
    """Gated RMSNorm (norm before out_proj), then out_proj in `dtype`."""
    y = y * F.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-5) * params["norm_scale"]
    return y.to(dtype) @ params["out_proj"]


def mamba2_forward(params, cfg, x, state: SSMState = None, constrain=None):
    """Full block (prefill/train). x: (B,S,d). Returns (y, new_state)."""
    cb = constrain if constrain is not None else _noop_constrain
    d_in, nh, _ = mamba2_dims(cfg)
    proj = cb(x @ params["in_proj"], ("batch", None, "ssm"))
    z, xbc, dt = _split_proj(cfg, proj)
    prev = state.conv if state is not None else None
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   prev)
    xs, B, C = torch.split(xbc, [d_in, cfg.ssm_state, cfg.ssm_state], dim=-1)
    xs = split_last(xs, nh, cfg.ssm_head_dim)
    dtp = _softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())
    h0 = state.h if state is not None else None
    y, h = ssd_chunked(xs, dtp, A, B, C, cfg.ssm_chunk, h0,
                       constrain=constrain)
    y = y + params["D"][None, None, :, None] * xs.float()
    y = y.reshape(*y.shape[:2], d_in)
    return _gated_norm_out(params, y, z, x.dtype), SSMState(h=h,
                                                           conv=conv_state)


def mamba2_decode(params, cfg, x, state: SSMState):
    """O(1) single-token update. x: (B,1,d). Returns (y, new_state); the
    state's tensors are new, the given ones are not changed."""
    d_in, nh, _ = mamba2_dims(cfg)
    proj = x @ params["in_proj"]
    z, xbc, dt = _split_proj(cfg, proj)
    xp = torch.cat([state.conv, xbc], dim=1)                 # (B, W, C)
    out = torch.einsum("bwc,wc->bc", xp.float(), params["conv_w"].float())
    out = F.silu(out + params["conv_b"].float())[:, None, :].to(x.dtype)
    conv_state = xp[:, 1:]
    xs, B, C = torch.split(out, [d_in, cfg.ssm_state, cfg.ssm_state], dim=-1)
    xs = split_last(xs[:, 0], nh, cfg.ssm_head_dim)          # (B,nh,hd)
    dtp = _softplus(dt[:, 0].float() + params["dt_bias"])    # (B,nh)
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(dtp * A[None, :])                      # (B,nh)
    Bv = B[:, 0].float()                                     # (B,ds)
    Cv = C[:, 0].float()
    xin = xs.float() * dtp[..., None]                        # (B,nh,hd)
    h = state.h * decay[..., None, None] + torch.einsum("bhp,bd->bhpd",
                                                        xin, Bv)
    y = torch.einsum("bhpd,bd->bhp", h, Cv)
    y = y + params["D"][None, :, None] * xs.float()
    y = y.reshape(y.shape[0], 1, d_in)
    return _gated_norm_out(params, y, z, x.dtype), SSMState(h=h,
                                                           conv=conv_state)


def ssm_state_specs(cfg, batch: int) -> SSMState:
    d_in, nh, conv_dim = mamba2_dims(cfg)
    return SSMState(
        h=TensorSpec((batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                     torch.float32),
        conv=TensorSpec((batch, cfg.ssm_conv_width - 1, conv_dim),
                        torch.bfloat16))
