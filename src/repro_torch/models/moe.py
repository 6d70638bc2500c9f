"""Mixture-of-Experts FFN with group-local, sort-based capacity dispatch.

Port of `repro.models.moe`. Each *sequence* routes its own tokens (group =
sequence); decode with one token per sequence routes the whole batch as
one group. Per-group capacity is `cap = min(round_up(max(1, round(S * K /
E * capacity_factor)), 8), S * K)` slots per expert; assignments past it
are dropped (`dropped_frac`).

Routing follows the reference exactly: the router and its softmax in
float32, the top K taken from a STABLE descending sort (ties go to the
lower expert index, as `jax.lax.top_k` breaks them; `torch.topk`
promises no order), slot positions from a stable sort of the expert ids,
slot tables with a trash slot that is sliced away. The experts are
batched products over (group, expert) of an (B, E, cap, d) buffer
gathered from the tokens (the reference computes them outside any Pallas
kernel, so they are library GEMMs here too).

The combine is a GATHER, not the reference's scatter-add: each token
reads its own <= K weighted expert rows and adds them in ascending slot
order, in the output dtype, one rounding per add, which is the order and
rounding of the reference's `.at[tok].add`. A scatter-add on the card is
atomic and run-order dependent in bf16; the gather makes two runs bit
equal.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.distributed.sharding import whole_dims
from repro_torch.kernels._dtensor import is_dtensor, run_local
from repro_torch.models.params import Param


def moe_params(d: int, d_ff: int, n_experts: int):
    return {
        "router": Param((d, n_experts), ("embed", "experts"),
                        dtype=torch.float32),
        "w_gate": Param((n_experts, d, d_ff), ("experts", "embed", "ffn")),
        "w_up": Param((n_experts, d, d_ff), ("experts", "embed", "ffn")),
        "w_down": Param((n_experts, d_ff, d), ("experts", "ffn", "embed")),
    }


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(S: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert in a group of S tokens (host ints; `round` is
    Python's half-to-even, as in the reference)."""
    cap = _round_up(int(max(1, round(S * top_k / n_experts
                                     * capacity_factor))), 8)
    return min(cap, S * top_k)


def route(params, x: torch.Tensor, top_k: int):
    """Router logits (float32), softmax, top-k experts and renormalised
    gates. x: (B, S, d) -> logits, probs (B, S, E), gate_vals, gate_idx
    (B, S, K)."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(
        1e-9)
    return logits, probs, gate_vals, gate_idx


def slot_tables(gate_vals, gate_idx, n_experts: int, cap: int):
    """Per-group slot assignment. Returns (slot (B, S*K) with E*cap for a
    dropped assignment, tok_tbl and w_tbl (B, E*cap): the token (S for an
    empty slot) and gate weight of each slot, valid (B, S*K))."""
    B, S, K = gate_idx.shape
    E, SK = n_experts, S * K
    dev = gate_idx.device
    eids = gate_idx.reshape(B, SK)
    tok_of = torch.arange(S, device=dev).repeat_interleave(K)
    tok_of = tok_of[None].expand(B, SK)
    w_of = gate_vals.reshape(B, SK)
    sorted_eids, order = torch.sort(eids, dim=1, stable=True)
    counts = torch.zeros((B, E), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, eids, torch.ones_like(eids))
    starts = torch.cumsum(counts, dim=1) - counts            # exclusive
    pos_sorted = torch.arange(SK, device=dev)[None] - starts.gather(
        1, sorted_eids)
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    valid = pos < cap
    slot = torch.where(valid, eids * cap + pos, E * cap)
    n_slots = E * cap + 1                                    # last = trash
    tok_tbl = torch.full((B, n_slots), S, dtype=torch.int64, device=dev)
    tok_tbl.scatter_(1, slot, tok_of)
    w_tbl = torch.zeros((B, n_slots), dtype=torch.float32, device=dev)
    w_tbl.scatter_(1, slot, torch.where(valid, w_of, 0.0))
    return slot, tok_tbl[:, :E * cap], w_tbl[:, :E * cap], valid


def combine(y, w_tbl, slot, S: int, top_k: int):
    """Weighted combine as a gather: token s of group b adds the rows of its
    own K slots in ascending slot order (a dropped assignment reads a zero
    row), in y's dtype. y: (B, E, cap, d) -> (B, S, d)."""
    B, E, cap, d = y.shape
    contrib = y.reshape(B, E * cap, d) * w_tbl[..., None].to(y.dtype)
    contrib = torch.cat([contrib, contrib.new_zeros((B, 1, d))], dim=1)
    slots = slot.reshape(B, S, top_k).sort(dim=-1).values
    rows = contrib.gather(1, slots.reshape(B, S * top_k, 1).expand(-1, -1, d))
    rows = rows.reshape(B, S, top_k, d)
    out = rows[:, :, 0]
    for k in range(1, top_k):
        out = out + rows[:, :, k]
    return out


def _dispatch(x, router, top_k: int, cap: int):
    """One group per row of x (B, S, d): routing, the aux-loss terms, the
    slot tables and the gathered expert buffer. Returns ebuf (B, E, cap,
    d), slot (B, S*K), w_tbl (B, E*cap), the per-group sum of me * ce
    (B,), each token's squared logsumexp (B, S) and the dropped
    assignments (B, S*K)."""
    B, S, d = x.shape
    E = router.shape[-1]
    logits, probs, gate_vals, gate_idx = route({"router": router}, x, top_k)
    me = probs.mean(dim=1)                                   # (B, E)
    onehot = torch.zeros((B, S, E), dtype=torch.float32, device=x.device)
    onehot.scatter_(2, gate_idx, 1.0)                        # K distinct ids
    ce = onehot.mean(dim=1)                                  # (B, E)
    lse2 = torch.logsumexp(logits, dim=-1).square()
    slot, tok_tbl, w_tbl, valid = slot_tables(gate_vals, gate_idx, E, cap)
    xp = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)
    ebuf = xp.gather(1, tok_tbl[..., None].expand(-1, -1, d)).reshape(
        B, E, cap, d)
    return ebuf, slot, w_tbl, (me * ce).sum(dim=-1), lse2, ~valid


def moe_apply(params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, constrain=None):
    """x: (B, S, d) -> (B, S, d), aux dict (lb_loss, z_loss, dropped_frac:
    0-d float32 tensors). Routing is per sequence (group); with S == 1 and
    B > 1 the batch routes as ONE group.

    A DTensor x routes each rank's groups on the rank (`run_local`: the
    router whole, the group's tokens whole, the batch of groups sharded),
    as does the combine (the expert rows whole); the experts run as
    DTensor products on the buffer constrained by experts."""
    cb = constrain if constrain is not None else (lambda a, axes: a)
    B, S, d = x.shape
    if S == 1 and B > 1:
        out, aux = moe_apply(params, whole_dims(x, 0).reshape(1, B, d),
                             top_k=top_k, capacity_factor=capacity_factor,
                             constrain=constrain)
        return out.reshape(B, S, d), aux
    E = params["router"].shape[-1]
    cap = capacity(S, top_k, E, capacity_factor)
    dispatch = functools.partial(_dispatch, top_k=top_k, cap=cap)
    if is_dtensor(x):
        rows = {"batch": 0}
        ebuf, slot, w_tbl, lb, lse2, dropped = run_local(
            dispatch, "moe_dispatch",
            (whole_dims(x, 1, 2), whole_dims(params["router"], 0, 1)),
            (rows, {}), (rows,) * 6)
    else:
        ebuf, slot, w_tbl, lb, lse2, dropped = dispatch(x, params["router"])
    # ---- aux losses (Switch formulation, averaged over groups) ----
    lb_loss = E * lb.mean()
    z_loss = lse2.mean()
    ebuf = cb(ebuf, ("batch", "experts", None, None))
    # SwiGLU experts, batched over (group, expert); silu(g) = g * sigmoid(g)
    # with each op rounded to the buffer's dtype, as the reference's
    # `jax.nn.silu` on a bf16 gate
    g = torch.einsum("becd,edf->becf", ebuf, params["w_gate"])
    u = torch.einsum("becd,edf->becf", ebuf, params["w_up"])
    y = torch.einsum("becf,efd->becd", g * torch.sigmoid(g) * u,
                     params["w_down"])
    y = cb(y, ("batch", "experts", None, None))
    mix = functools.partial(combine, S=S, top_k=top_k)
    if is_dtensor(y):
        rows = {"batch": 0}
        out = run_local(mix, "moe_combine",
                        (whole_dims(y, 1, 2, 3), w_tbl, slot),
                        (rows,) * 3, (rows,))
    else:
        out = mix(y, w_tbl, slot)
    out = cb(out, ("batch", None, None))
    dropped = dropped.sum().float() / (B * S * top_k)
    return out, {"lb_loss": lb_loss, "z_loss": z_loss,
                 "dropped_frac": dropped}
