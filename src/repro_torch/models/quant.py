"""Int8 weight-only quantization for serving.

Port of `repro.models.quant`. Transformer-block weights of rank >= 2 in
bf16 are stored as {"q": int8, "scale": float32} and dequantized per block
inside the layer loop (`lm.backbone`), so the whole bf16 copy is never
held. Scales are per out-channel (the last axis) for a 2-D weight, and
per (leading slice, out-channel) for a weight of rank >= 3: a stacked
block weight or an expert stack, reduced over axes 1..ndim-2. Norms,
scalars, float32 leaves and the embedding / lm-head tables are left as
they are.

`quantize_arrays` is symmetric: scale = max(|w|, 1e-8) / 127 in float32,
q = clip(round(w / scale), -127, 127) with round-half-to-even, so its int8
and scales are bit-equal to the reference's. `dequant_tree` multiplies
q and scale in bf16, as the reference does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import Param, tree_map


def _quantizable(p: Param) -> bool:
    return len(p.shape) >= 2 and p.dtype == torch.bfloat16


def quantize_spec_tree(tree):
    """Param-spec tree -> the same tree with {"q", "scale"} leaf dicts."""

    def q(p: Param):
        if not _quantizable(p):
            return p
        if len(p.shape) >= 3:   # stacked layers / experts: per-slice scales
            sshape, saxes = (p.shape[0], p.shape[-1]), (p.axes[0], p.axes[-1])
        else:
            sshape, saxes = p.shape[-1:], (p.axes[-1],)
        return {"q": dataclasses.replace(p, dtype=torch.int8),
                "scale": Param(sshape, saxes, dtype=torch.float32,
                               init="ones")}

    return tree_map(q, tree)


def quantize_arrays(tree):
    """bf16 tensors of rank >= 2 -> {"q": int8, "scale": float32}."""

    def q(arr):
        if not (isinstance(arr, torch.Tensor) and arr.dim() >= 2
                and arr.dtype == torch.bfloat16):
            return arr
        a = arr.float()
        red = tuple(range(1, a.dim() - 1)) if a.dim() >= 3 \
            else tuple(range(a.dim() - 1))
        scale = a.abs().amax(dim=red).clamp_min(1e-8) / 127.0
        bshape = ((scale.shape[0],) + (1,) * (a.dim() - 2)
                  + (scale.shape[-1],)) if a.dim() >= 3 else scale.shape
        qv = torch.round(a / scale.reshape(bshape)).clamp(-127, 127)
        return {"q": qv.to(torch.int8), "scale": scale}

    return tree_map(q, tree)


def is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "scale"}


def dequant_tree(tree):
    """{"q", "scale"} leaves -> bf16 tensors; every other leaf as it is. A
    2-D scale of a q of rank >= 3 is (slice, out-channel); a 1-D scale is
    per out-channel."""
    if is_qleaf(tree):
        q, s = tree["q"], tree["scale"]
        if q.dim() >= 3 and s.dim() == 2:
            s = s.reshape((s.shape[0],) + (1,) * (q.dim() - 2)
                          + (s.shape[-1],))
        return q.to(torch.bfloat16) * s.to(torch.bfloat16)
    if isinstance(tree, dict):
        return {k: dequant_tree(v) for k, v in tree.items()}
    return tree
