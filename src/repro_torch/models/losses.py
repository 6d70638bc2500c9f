"""Cross-entropy over (possibly padded) vocab logits.

Port of `repro.models.losses`; the math is the reference's, in float32
whatever the logits' dtype. Logits that are a DTensor are first made
whole along the vocab (`whole_dims`): DTensor has no rule for the label
gather over a sharded vocab, where the reference's GSPMD partitions it.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import whole_dims


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None,
                  real_vocab=None):
    """logits: (B, S, V_padded); labels: (B, S) int; mask: (B, S) optional.

    ``real_vocab``: logical vocab size; the padded tail columns are set to
    -1e30 (embedding tables are padded to a 128 multiple). Returns
    (mean_loss, {"loss", "accuracy", "tokens"}), 0-d float32 tensors."""
    lf = whole_dims(logits.float(), -1)
    if real_vocab is not None and real_vocab < logits.shape[-1]:
        vmask = torch.arange(logits.shape[-1], device=lf.device) < real_vocab
        lf = torch.where(vmask, lf, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    acc = ((lf.argmax(dim=-1) == labels).float() * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
