"""Optimizers (no external deps): AdamW with optional bf16 moments, and
Adafactor for memory-constrained giants.

Port of `repro.train.optimizer`. The update runs leaf by leaf in the
reference's leaf order (sorted dict keys) and writes each leaf's new
params and moments IN PLACE, so only one leaf's float32 temporaries are
alive at a time: the counterpart of the reference's `donate_argnums` and
of its `sequential_updates` barriers, which is why `OptConfig` has no
such option. The step counter is a 0-d int32 tensor and every scalar
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


def lr_schedule(cfg: OptConfig, step):
    """Linear warmup to cfg.lr; `step` an int tensor -> float32 tensor."""
    warm = (torch.as_tensor(step) / max(cfg.warmup_steps, 1)).clamp(max=1.0)
    return cfg.lr * warm


def _moment_dtype(cfg: OptConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.bf16_moments else torch.float32


def _step0(params) -> torch.Tensor:
    dev = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params, cfg: OptConfig):
    mdt = _moment_dtype(cfg)

    def zeros_like(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return {"m": tree_map(zeros_like, params),
            "v": tree_map(zeros_like, params),
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
        f32, dev = torch.float32, p.device
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=f32, device=dev),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=f32, device=dev)}
        return {"v": torch.zeros(p.shape, dtype=f32, device=dev)}

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


def abstract_state(param_specs_tree, cfg: OptConfig):
    """TensorSpec tree of the optimizer state of a Param-spec tree."""
    f32 = torch.float32
    step = TensorSpec((), torch.int32)
    if cfg.name == "adafactor":
        def fac(p: Param):
            if len(p.shape) >= 2:
                return {"vr": TensorSpec(p.shape[:-1], f32),
                        "vc": TensorSpec(p.shape[:-2] + p.shape[-1:], f32)}
            return {"v": TensorSpec(p.shape, f32)}

        return {"v": tree_map(fac, param_specs_tree), "step": step}
    mdt = _moment_dtype(cfg)
    return {"m": tree_map(lambda p: TensorSpec(p.shape, mdt),
                          param_specs_tree),
            "v": tree_map(lambda p: TensorSpec(p.shape, mdt),
                          param_specs_tree),
            "step": step}
