"""Cross-entropy over (possibly padded) vocab logits.

Port of `repro.models.losses`; the math is the reference's, in float32
whatever the logits' dtype. Logits that are a DTensor whose vocab is
split over more than one rank stay split (`_sharded_terms`): each rank
takes its own shard's max, sum of exponentials, label logit and argmax,
and the ranks of the vocab combine them by all-reduces of (B, S) values,
as the reference's GSPMD partitions the logsumexp and the label gather.
Otherwise (a plain tensor, or a vocab on one rank) the logits are made
whole along the vocab (`whole_dims`, which reduces a pending sum) and
the terms are taken as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (shard_index, shard_ranks,
                                               whole_dims)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None,
                  real_vocab=None):
    """logits: (B, S, V_padded); labels: (B, S) int; mask: (B, S) optional.

    ``real_vocab``: logical vocab size; the padded tail columns are set to
    -1e30 (embedding tables are padded to a 128 multiple). Returns
    (mean_loss, {"loss", "accuracy", "tokens"}), 0-d float32 tensors."""
    if shard_ranks(logits, -1) > 1:
        lse, ll, pred = _sharded_terms(logits, labels, real_vocab)
    else:
        lf = whole_dims(logits.float(), -1)
        if real_vocab is not None and real_vocab < logits.shape[-1]:
            vmask = torch.arange(logits.shape[-1], device=lf.device) \
                < real_vocab
            lf = torch.where(vmask, lf, -1e30)
        lse = torch.logsumexp(lf, dim=-1)
        ll = lf.gather(-1, labels.long()[..., None])[..., 0]
        pred = lf.argmax(dim=-1)
    nll = lse - ll
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    acc = ((pred == labels).float() * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


def _sharded_terms(logits, labels, real_vocab):
    """(logsumexp, label logit, argmax), each (B, S) and placed like the
    logits' (B, S) dims, from vocab-sharded DTensor logits, with no
    gather of the vocab. Each rank works on its local (b, s, v) shard
    (`to_local` / `from_local` carry the gradient); the vocab's mesh dims
    then all-reduce: the max, the sum of exp(l - max), the label's logit
    (0 on every rank but the one that holds it), and for the argmax the
    largest value and then the smallest global index that reaches it, as
    `argmax` breaks ties."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if any(pl.is_partial() for pl in logits.placements):
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if pl.is_partial() else pl
            for pl in logits.placements])
    mesh = logits.device_mesh
    idx, vocab_dims = shard_index(logits, -1)
    # (B, S) placements: the logits' without the vocab's shards
    rows = [Replicate() if m in vocab_dims else pl
            for m, pl in enumerate(logits.placements)]
    lf = logits.float().to_local()
    V = lf.shape[-1]
    vid = idx * V + torch.arange(V, device=lf.device)   # global vocab ids
    if real_vocab is not None and real_vocab < logits.shape[-1]:
        lf = torch.where(vid < real_vocab, lf, -1e30)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, rows).to_local().long()

    def over_vocab(t, op):
        """The local (b, s) `t` reduced by `op` over the vocab's ranks."""
        return DTensor.from_local(
            t, mesh, [Partial(op) if m in vocab_dims else pl
                      for m, pl in enumerate(rows)],
            run_check=False).redistribute(mesh, rows)

    m = over_vocab(lf.detach().amax(dim=-1), "max")
    m_l = m.to_local()
    lse = m + torch.log(over_vocab(
        torch.exp(lf - m_l[..., None]).sum(dim=-1), "sum"))
    own = (lab >= idx * V) & (lab < idx * V + V)
    picked = lf.gather(-1, (lab - idx * V).clamp(0, V - 1)[..., None])[..., 0]
    ll = over_vocab(torch.where(own, picked, torch.zeros_like(picked)), "sum")
    val, arg = lf.detach().max(dim=-1)
    top = over_vocab(val, "max").to_local()
    first = torch.where(val == top, arg + idx * V,
                        torch.full_like(arg, logits.shape[-1]))
    pred = over_vocab(first, "min")
    return lse, ll, pred
