"""Step builders: train_step (grad accumulation + optimizer), prefill_step,
decode_step.

Port of `repro.train.step`. Where the reference jits the step with
`jax.value_and_grad`, the port runs eagerly and takes the gradient with
`torch.autograd.grad` over the param leaves (`value_and_grad`).
`constrain` (default a no-op) reaches every `forward_*` call, as in the
reference: with `distributed.sharding.Sharder.constrain` and DTensor
params and optimizer state the same step runs sharded over a
`DeviceMesh`, the batch given whole on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import (contiguous_strides,
                                               plain_as_replicated,
                                               whole_dims)
from repro_torch.models import model as M
from repro_torch.models.losses import cross_entropy
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import optimizer as opt_mod

AUX_WEIGHT = 1e-2


def _loss_mask(cfg: ModelConfig, labels):
    """(1, S) float32 mask of the text positions under patch inputs (its
    sum, the loss's denominator, counts one row, as the reference's)."""
    if cfg.n_patches:
        pos = torch.arange(labels.shape[1], device=labels.device)[None, :]
        return (pos >= cfg.n_patches).float()
    return None


def build_loss_fn(cfg: ModelConfig, run: RunConfig, constrain=None):
    """loss_fn(params, batch) -> (loss + AUX_WEIGHT * aux, metrics)."""

    constrain = constrain or (lambda x, axes: x)

    def loss_fn(params, batch):
        logits, aux = M.forward_train(cfg, run, params, batch, constrain)
        with plain_as_replicated(params):
            loss, metrics = cross_entropy(logits, batch["labels"],
                                          _loss_mask(cfg, batch["labels"]),
                                          real_vocab=cfg.vocab_size)
        total = loss + AUX_WEIGHT * aux
        return total, dict(metrics, aux=aux)

    return loss_fn


def value_and_grad(loss_fn):
    """The counterpart of `jax.value_and_grad(loss_fn, has_aux=True)`:
    grad_fn(params, batch) -> ((loss, metrics), grads), the grads a tree
    like params, each in its param's dtype (zeros for a leaf the loss does
    not reach). The params themselves are not marked as needing grad."""

    def grad_fn(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        tracked = tree_map(lambda _: next(it), params)
        with torch.enable_grad(), plain_as_replicated(params):
            loss, metrics = loss_fn(tracked, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads))
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                tree_map(lambda _: next(it), params))

    return grad_fn


def split_micro(x: torch.Tensor, M_: int) -> torch.Tensor:
    """(B, ...) -> (M_, B // M_, ...), the reference's `split_micro`. A
    DTensor sharded along the batch is split on each rank's own rows
    (local (b, ...) -> (M_, b // M_, ...), the batch shard moved to dim
    1), so that every microbatch stays sharded along its batch and
    nothing moves: microbatch i then holds rows i * b / M_ .. of each
    rank's shard, not the reference's i * B / M_ .., which sums to the
    same gradient. Where a rank's rows do not split M_ ways, the batch is
    made whole first."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(x, DTensor) and any(
            isinstance(pl, Shard) and pl.dim == 0 for pl in x.placements):
        local = x.to_local()
        if local.shape[0] % M_ == 0:
            shape = (M_, x.shape[0] // M_) + tuple(x.shape[1:])
            return DTensor.from_local(
                local.reshape((M_, local.shape[0] // M_) + local.shape[1:]),
                x.device_mesh,
                [Shard(1) if isinstance(pl, Shard) and pl.dim == 0 else pl
                 for pl in x.placements],
                run_check=False, shape=shape,
                stride=contiguous_strides(shape))
        x = whole_dims(x, 0)
    return x.reshape((M_, x.shape[0] // M_) + x.shape[1:])


def build_train_step(cfg: ModelConfig, run: RunConfig,
                     opt_cfg: opt_mod.OptConfig, constrain=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). With run.microbatches = M > 1 the batch is split into M
    microbatches along its first axis; their grads are summed in float32
    (bf16 under run.bf16_moments), divided by M, and so is the loss. The
    params and moments are updated in place (`optimizer.update`)."""
    grad_fn = value_and_grad(build_loss_fn(cfg, run, constrain))
    M_ = run.microbatches
    acc_dt = torch.bfloat16 if run.bf16_moments else torch.float32

    def train_step(params, opt_state, batch):
        if M_ == 1:
            (loss, metrics), grads = grad_fn(params, batch)
        else:
            micro = {k: split_micro(v, M_) for k, v in batch.items()}
            # sharded like the params, as the reference's accumulator
            grads = tree_map(lambda p: opt_mod.zeros_like_param(p, acc_dt),
                             params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=batch["labels"].device)
            for i in range(M_):
                (loss_i, _), g = grad_fn(params, {k: v[i]
                                                  for k, v in micro.items()})
                tree_map(lambda a, b: a.add_(b.to(acc_dt)), grads, g)
                del g
                with plain_as_replicated(params):
                    loss_sum = loss_sum + loss_i
            grads = tree_map(lambda g: g.div_(M_), grads)
            metrics = {"loss": loss_sum / M_}
        params, opt_state, opt_metrics = opt_mod.update(
            params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, **opt_metrics)
        return params, opt_state, {k: v.float() for k, v in metrics.items()}

    return train_step


def build_prefill_step(cfg: ModelConfig, run: RunConfig, max_len: int,
                       constrain=None):
    constrain = constrain or (lambda x, axes: x)

    def prefill_step(params, batch):
        return M.forward_prefill(cfg, run, params, batch, max_len, constrain)

    return prefill_step


def build_decode_step(cfg: ModelConfig, run: RunConfig, constrain=None):
    constrain = constrain or (lambda x, axes: x)

    def decode_step(params, caches, batch):
        return M.forward_decode(cfg, run, params, batch, caches,
                                constrain=constrain)

    return decode_step
