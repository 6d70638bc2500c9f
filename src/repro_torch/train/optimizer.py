"""Optimizers (no external deps): AdamW with optional bf16 moments, and
Adafactor for memory-constrained giants.

Port of `repro.train.optimizer`. The update runs leaf by leaf in the
reference's leaf order (sorted dict keys) and writes each leaf's new
params and moments IN PLACE, so only one leaf's float32 temporaries are
alive at a time: the counterpart of the reference's `donate_argnums` and
of its `sequential_updates` barriers. Moments of a DTensor param are
DTensors sharded like it, as the reference's moments shard like their
params. The step counter is a 0-d int32 tensor and every scalar
(clip scale, learning rate, bias corrections) stays on the params'
device: an update reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import (Param, TensorSpec, tree_items,
                                       tree_leaves, tree_map, subtree)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    bf16_moments: bool = False
    warmup_steps: int = 100
    # the reference's switch for optimization barriers between leaf
    # updates; the port runs eagerly and always updates leaf by leaf, so
    # True and False give the same update, value for value
    sequential_updates: bool = True


def lr_schedule(cfg: OptConfig, step):
    """Linear warmup to cfg.lr; `step` an int tensor -> float32 tensor."""
    warm = (torch.as_tensor(step) / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    return cfg.lr * warm


def _moment_dtype(cfg: OptConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.bf16_moments else torch.float32


def _zeros(p, dtype, drop=None) -> torch.Tensor:
    """Zeros of p's shape, or of p's shape without dim `drop` (Adafactor's
    factored moments), beside the param `p`: on its device, and for a
    DTensor param a DTensor on its mesh that keeps each of p's shards on
    the dim it lands on (a shard of the dropped dim replicates). Moments
    shard like their param, as the reference's."""
    from torch.distributed.tensor import DTensor

    shape = list(p.shape)
    if drop is not None:
        drop %= p.dim()
        del shape[drop]
    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import zeros as dzeros

    placements = []
    for pl in p.placements:
        if isinstance(pl, Shard) and drop is not None:
            d = pl.dim % p.dim()
            pl = (Replicate() if d == drop
                  else Shard(d - 1) if d > drop else pl)
        placements.append(pl)
    return dzeros(shape, dtype=dtype, device_mesh=p.device_mesh,
                  placements=placements)


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params, cfg: OptConfig):
    mdt = _moment_dtype(cfg)

    return {"m": tree_map(lambda p: _zeros(p, mdt), params),
            "v": tree_map(lambda p: _zeros(p, mdt), params),
            "step": _step0(params)}


def _global_norm(tree):
    """sqrt of the float32 sum of squares, summed leaf by leaf in order."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig):
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    scale = (cfg.grad_clip / (gnorm + 1e-9)).clamp(max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    def upd(p, g, m, v):
        gf = g.float() * scale
        mf = m.float() * b1 + gf * (1 - b1)
        vf = v.float() * b2 + torch.square(gf) * (1 - b2)
        u = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
        m.copy_(mf)
        v.copy_(vf)

    tree_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; rank>=2 leaves factored)
# ---------------------------------------------------------------------------

def adafactor_init(params, cfg: OptConfig):
    def factored(p):
        f32 = torch.float32
        if p.dim() >= 2:
            return {"vr": _zeros(p, f32, drop=-1),
                    "vc": _zeros(p, f32, drop=-2)}
        return {"v": _zeros(p, f32)}

    return {"v": tree_map(factored, params), "step": _step0(params)}


@torch.no_grad()
def adafactor_update(params, grads, state, cfg: OptConfig):
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    decay = 1.0 - step.float() ** -0.8

    def upd(p, g, v):
        gf = g.float()
        g2 = torch.square(gf) + 1e-30
        if p.dim() >= 2:
            vr = v["vr"] * decay + g2.mean(dim=-1) * (1 - decay)
            vc = v["vc"] * decay + g2.mean(dim=-2) * (1 - decay)
            denom = (vr[..., None] * vc[..., None, :]
                     / vr.mean(dim=-1, keepdim=True).clamp_min(1e-30)
                     [..., None])
            u = gf * torch.rsqrt(denom + 1e-30)
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            nv = v["v"] * decay + g2 * (1 - decay)
            u = gf * torch.rsqrt(nv + 1e-30)
            v["v"].copy_(nv)
        # update clipping (RMS <= 1)
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
        u = u / rms.clamp(min=1.0)
        # weight decay times the param in the param's dtype, as the
        # reference's `weight_decay * p`
        p.copy_(p.float() - lr * (u + cfg.weight_decay * p))

    for path, p in tree_items(params):
        upd(p, subtree(grads, path), subtree(state["v"], path))
    return params, {"v": state["v"], "step": step}, {"lr": lr}


def init(params, cfg: OptConfig):
    return (adafactor_init if cfg.name == "adafactor" else adamw_init)(
        params, cfg)


def update(params, grads, state, cfg: OptConfig):
    """One optimizer step. The params and moments are updated in place; the
    returned trees hold the same tensors (and a new step counter)."""
    fn = adafactor_update if cfg.name == "adafactor" else adamw_update
    return fn(params, grads, state, cfg)


def abstract_state(param_specs_tree, cfg: OptConfig, sharding_fn=None):
    """TensorSpec tree of the optimizer state of a Param-spec tree.

    sharding_fn: Param -> sharding (moments shard like their param; a
    factored Adafactor moment as a Param of its own axes, as the
    reference's)."""
    f32 = torch.float32

    def moment(p: Param, dtype):
        q = dataclasses.replace(p, dtype=dtype)
        return TensorSpec(q.shape, q.dtype,
                          None if sharding_fn is None else sharding_fn(q))

    step = TensorSpec((), torch.int32)
    if cfg.name == "adafactor":
        def fac(p: Param):
            if len(p.shape) >= 2:
                vr = dataclasses.replace(p, shape=p.shape[:-1],
                                         axes=p.axes[:-1])
                vc = dataclasses.replace(p, shape=p.shape[:-2] + p.shape[-1:],
                                         axes=p.axes[:-2] + p.axes[-1:])
                return {"vr": moment(vr, f32), "vc": moment(vc, f32)}
            return {"v": moment(p, f32)}

        return {"v": tree_map(fac, param_specs_tree), "step": step}
    mdt = _moment_dtype(cfg)
    return {"m": tree_map(lambda p: moment(p, mdt), param_specs_tree),
            "v": tree_map(lambda p: moment(p, mdt), param_specs_tree),
            "step": step}
