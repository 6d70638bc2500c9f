"""Python wrapper of the Hopper flash attention kernel
(`csrc/flash_attention.cu`).

`flash_attention_bhsd` checks its tensors, allocates the output with
`torch.empty_like(q)` (so it keeps q's memory layout), launches the kernel
on the current stream and raises if the launch failed. It does not
synchronise. q, k and v may be strided views, as long as the head
dimension is contiguous: the model passes (B, S, H, dh) tensors with axes
1 and 2 swapped, and the kernel reads them in place, with no copy.
`flash_attention_bhsd.launches` counts the launches, so a run can show
that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)        # the kernel's template instances
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_tiling(Sq: int, Sk: int, block_q: int, block_k: int):
    """The reference kernel's contract on shapes: each sequence length is a
    multiple of its block, the block cut to the length."""
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if bq < 1 or bk < 1 or Sq % bq or Sk % bk:
        raise ValueError(f"flash_attention: Sq={Sq} and Sk={Sk} must be "
                         f"multiples of block_q={bq} and block_k={bk}")


def flash_attention_bhsd(q, k, v, *, causal=True,
                         window: Optional[int] = None,
                         block_q: int = 512, block_k: int = 512):
    """Forward attention on the card.

    q: (B, H, Sq, dh); k, v: (B, KV, Sk, dh) -> (B, H, Sq, dh), float32 or
    bfloat16, dh in HEAD_DIMS, H a multiple of KV. `block_q`/`block_k`
    only set the accepted shapes (`check_tiling`); the kernel tiles by 64."""
    dev = q.device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention kernel needs tensors on the "
                         f"current CUDA device, got {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, H, Sq, dh) and two equal (B, KV, Sk, dh)")
    B, H, Sq, dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype not in _DTYPES or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}; q, k, v must share one of "
                             f"{list(_DTYPES)} on {dev}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             "contiguous")
    check_tiling(Sq, Sk, block_q, block_k)

    o = torch.empty_like(q)          # q's layout (dense) or contiguous
    if o.numel() == 0:
        return o
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, H, KV, Sq, Sk, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), int(window is not None),
        int(window) if window is not None else 0,
        float(1.0 / dh ** 0.5), _DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (B={B}, H={H}, KV={KV}, Sq={Sq}, "
                           f"Sk={Sk}, dh={dh}, {q.dtype})")
    flash_attention_bhsd.launches += 1
    return o


flash_attention_bhsd.launches = 0
