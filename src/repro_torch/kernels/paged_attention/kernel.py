"""Python wrapper of the Hopper paged decode attention kernel
(`csrc/paged_attention.cu`).

`paged_attention` checks its tensors, allocates the output with
`torch.empty_like(q)`, launches the kernel on the current stream and
raises if the launch failed. It does not synchronise.
`paged_attention.launches` counts the launches, so a run can show that it
went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 96, 128)    # the kernel's template instances
G_MAX = 16                       # query heads per KV head
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("paged_attention").paged_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def paged_attention(q, k_pages, v_pages, block_table, seq_lens):
    """One-token decode attention on the card. q: (B, H, dh); k/v pages:
    (P, page, KV, dh), q's dtype (float32 or bfloat16), dh in HEAD_DIMS,
    H a multiple of KV with at most G_MAX query heads per KV head;
    block_table: (B, n) int32; seq_lens: (B,) int32; all contiguous on
    the current CUDA device. Returns (B, H, dh)."""
    dev = q.device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"paged_attention kernel needs tensors on the "
                         f"current CUDA device, got {dev}")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k_pages.shape)}, v {tuple(v_pages.shape)}"
                         " are not (B, H, dh) and two equal (P, page, KV, "
                         "dh)")
    B, H, dh = q.shape
    P, page, KV, _ = k_pages.shape
    if k_pages.shape[3] != dh or KV < 1 or H % KV or H // KV > G_MAX:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not "
                         f"match pages {tuple(k_pages.shape)} (at most "
                         f"{G_MAX} query heads per KV head)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"paged_attention: block_table "
                         f"{tuple(block_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} do not match B={B}")
    for t, name, dts in ((q, "q", _DTYPES), (k_pages, "k_pages", _DTYPES),
                         (v_pages, "v_pages", _DTYPES),
                         (block_table, "block_table", (torch.int32,)),
                         (seq_lens, "seq_lens", (torch.int32,))):
        if t.dtype not in dts or t.device != dev or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} is {t.dtype} on "
                             f"{t.device}; it must be contiguous, one of "
                             f"{list(dts)}, on {dev}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_attention: q, k_pages, v_pages must share "
                         "one dtype")
    if B == 0 or block_table.shape[1] == 0 or P == 0:
        raise ValueError(f"paged_attention: empty input (B={B}, P={P}, "
                         f"pages per sequence {block_table.shape[1]})")
    o = torch.empty_like(q)
    err = _entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
        B, H, KV, dh, page, block_table.shape[1], P,
        float(1.0 / dh ** 0.5), _DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err} (B={B}, H={H}, KV={KV}, dh={dh}, "
                           f"page={page}, P={P}, {q.dtype})")
    paged_attention.launches += 1
    return o


paged_attention.launches = 0
