"""Public flash attention op in the model's (B, S, H, dh) layout.

A CPU tensor goes to the plain PyTorch version (`ref.py`); any other
device goes to the CUDA kernels (`kernel.py`: bf16 to the wgmma kernel,
fp32 to the split-TF32 kernel), which launch or raise. Nothing falls
back from one to another. Both devices hold sequence lengths to the same
tiling (`kernel.check_tiling`). The CPU route takes any head dim; on the
card both kernels take a head dim up to `kernel.HEAD_DIM_MAX` (256) and
raise ValueError above it; a head of whole 16-byte pieces with 16-byte
aligned addresses and strides runs in place, any other input through
zero-padded copies (`kernel.plan`, `kernel.stage`).

Neither route takes a gradient: the reference cannot differentiate its
Pallas kernel either, and trains with `attention_impl="xla_blocked"`.
Under a gradient `flash_attention` raises rather than let a training
graph lose its attention gradient.

DTensor q/k/v (a sharded model, `distributed/sharding.py`) run the kernel
on each rank's local shards (`kernels/_dtensor.run_local`): batch and
heads may be sharded, q's heads and k/v's over the same mesh dims (GQA
groups stay whole); a shard along the sequence or head dim raises.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels._dtensor import is_dtensor, run_local
from repro_torch.kernels.flash_attention.kernel import (
    check_tiling, flash_attention_bhsd)
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q, k, v, *, causal=True, window: Optional[int] = None,
                    block_q: int = 512, block_k: int = 512,
                    scale: Optional[float] = None):
    """q: (B, S, H, dh); k: (B, S, KV, dh); v: (B, S, KV, dv) -> (B, S, H,
    dv), scores scaled by `scale` (default 1/sqrt(dh)).

    Axes 1 and 2 are swapped as views; the kernel reads the strided layout
    and writes its output in q's layout, so no copy is made. Raises
    NotImplementedError when grad is enabled and q, k or v requires it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward (nor has the reference's "
            "Pallas kernel): train with attention_impl=\"xla_blocked\"")
    if is_dtensor(q, k, v):
        dims = {"batch": 0, "heads": 2}
        return run_local(
            functools.partial(flash_attention, causal=causal, window=window,
                              block_q=block_q, block_k=block_k, scale=scale),
            "flash_attention", (q, k, v), (dims,) * 3, (dims,))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cpu":
        check_tiling(q.shape[1], k.shape[1], block_q, block_k)
        out = attention_ref(qt, kt, vt, causal=causal, window=window,
                            scale=scale)
    else:
        out = flash_attention_bhsd(qt, kt, vt, causal=causal, window=window,
                                   block_q=block_q, block_k=block_k,
                                   scale=scale)
    return out.transpose(1, 2)
