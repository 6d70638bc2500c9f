"""Python wrapper of the Hopper flash attention kernels.

The dtype alone picks the kernel (`route`): bfloat16 goes to the
tensor-core kernel (`csrc/flash_attention_sm90.cu`: wgmma, TMA, a ring of
K/V tiles), float32 to the split-TF32 kernel (`csrc/flash_attention.cu`:
mma.sync, each product as three TF32 passes, which keep the reference's
2e-5 tolerance). Nothing catches one kernel's failure and runs the other:
a refused launch raises.

`flash_attention_bhsd` checks its tensors, allocates the output with
`torch.empty_like(q)` (so it keeps q's memory layout), launches the kernel
on the current stream and raises if the launch failed. It does not
synchronise. q, k and v may be strided views, as long as the head
dimension is contiguous: the model passes (B, S, H, dh) tensors with axes
1 and 2 swapped, and the kernels read them in place, with no copy. Both
kernels read 16-byte pieces (TMA in bf16, cp.async and vector loads in
fp32), which need 16-byte aligned base addresses and strides
(`tma_strides`); the model's tensors always qualify.
`flash_attention_bhsd.launches` counts every launch, and
`flash_attention_bhsd.route_launches[route]` those of each kernel, so a run
can show which kernel it went through. Each call reports its work to an
active step counter (`roofline.counter.kernel_work`, by `work`). Fake CUDA
tensors (`FakeTensorMode`, a traced step) pass the same checks, but for
the address (a fake tensor has none), and get their output allocated
(fake) and their work counted; nothing is built or launched, and
`flash_attention_bhsd.fake_calls` counts those calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.roofline.counter import counting, kernel_work

HEAD_DIMS = (32, 64, 96, 128)    # head dims both kernels take
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "split_tf32"}
SOURCES = {"wgmma": "flash_attention_sm90", "split_tf32": "flash_attention"}
TMA_ALIGN = 16                   # bytes: both kernels' addresses, strides


@functools.lru_cache(maxsize=None)
def _entry(route_name: str):
    name = SOURCES[route_name]          # csrc/<name>.cu exports <name>_fwd
    fn = getattr(_build.load(name), f"{name}_fwd")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def route(dtype) -> str:
    """The kernel that takes q, k, v of `dtype` on the card: "wgmma" (the
    tensor-core kernel) for bfloat16, "split_tf32" for float32."""
    if dtype not in ROUTES:
        raise ValueError(f"flash_attention: {dtype} is not one of "
                         f"{list(ROUTES)}")
    return ROUTES[dtype]


def tma_strides(t, name: str):
    """The (b, h, s) strides of `t`, in elements, as the tensor-core
    kernel's tensor map describes them (the fp32 kernel takes the same).
    Raises ValueError, naming the tensor, unless its address and the
    strides of its dims longer than 1 are multiples of 16 bytes, which TMA
    and the fp32 kernel's 16-byte copies need. A dim of length 1 is never
    stepped over, so its stride is replaced by the head dim's length. A
    fake tensor's address is not checked."""
    nbytes = t.element_size()
    if not is_fake(t) and t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"flash_attention: {name}'s address is not "
                         f"{TMA_ALIGN}-byte aligned (16-byte loads need it)")
    out = []
    for dim in range(3):
        stride = t.stride(dim)
        if t.shape[dim] == 1:
            stride = t.shape[3]
        elif stride <= 0 or stride * nbytes % TMA_ALIGN:
            raise ValueError(f"flash_attention: {name}'s stride {stride} of "
                             f"dim {dim} is not a positive multiple of "
                             f"{TMA_ALIGN} bytes (16-byte loads need it)")
        out.append(stride)
    return out


def check_tiling(Sq: int, Sk: int, block_q: int, block_k: int):
    """The reference kernel's contract on shapes: each sequence length is a
    multiple of its block, the block cut to the length."""
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if bq < 1 or bk < 1 or Sq % bq or Sk % bk:
        raise ValueError(f"flash_attention: Sq={Sq} and Sk={Sk} must be "
                         f"multiples of block_q={bq} and block_k={bk}")


def work(q, k, causal=True, window: Optional[int] = None):
    """(flop, bytes) of one call: 4 dh flop for each (q, k) pair the mask
    lets through, per (batch, head), and the bytes of q, k, v and o, each
    read or written once (the formulas of the kernel's bound in
    `chip_smoke.py`)."""
    B, H, Sq, dh = q.shape
    Sk = k.shape[2]
    qpos = np.arange(Sq)
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, int)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return float(4 * dh * B * H * pairs), float(nbytes)


def flash_attention_bhsd(q, k, v, *, causal=True,
                         window: Optional[int] = None,
                         block_q: int = 512, block_k: int = 512):
    """Forward attention on the card.

    q: (B, H, Sq, dh); k, v: (B, KV, Sk, dh) -> (B, H, Sq, dh), float32 or
    bfloat16, dh in HEAD_DIMS, H a multiple of KV. `block_q`/`block_k`
    only set the accepted shapes (`check_tiling`); the kernels tile by 128
    (wgmma) or 64 (split_tf32). Every check runs before any build or
    launch."""
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
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype not in ROUTES or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}; q, k, v must share one of "
                             f"{list(ROUTES)} on {dev}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             "contiguous")
    check_tiling(Sq, Sk, block_q, block_k)
    kind = route(q.dtype)
    strides = [s for t, name in ((q, "q"), (k, "k"), (v, "v"))
               for s in tma_strides(t, name)]
    fake = is_fake(q)
    if dev.type != "cuda" or not (
            fake or dev.index == torch.cuda.current_device()):
        raise ValueError(f"flash_attention kernel needs tensors on the "
                         f"current CUDA device, got {dev}")

    o = torch.empty_like(q)          # q's layout (dense) or contiguous
    if o.numel() == 0:
        return o
    if counting():
        kernel_work("flash_attention", *work(q, k, causal, window))
    if fake:
        flash_attention_bhsd.fake_calls += 1
        return o
    err = _entry(kind)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, H, KV, Sq, Sk, dh, *strides, *o.stride()[:3],
        int(causal), int(window is not None),
        int(window) if window is not None else 0,
        float(1.0 / dh ** 0.5), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        what = (f"tensor map encoding failed: CUresult {err - 1000}"
                if err >= 1000 else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention {kind} kernel launch failed: "
                           f"{what} (B={B}, H={H}, KV={KV}, Sq={Sq}, "
                           f"Sk={Sk}, dh={dh}, {q.dtype})")
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.route_launches[kind] += 1
    return o


flash_attention_bhsd.launches = 0
flash_attention_bhsd.fake_calls = 0
flash_attention_bhsd.route_launches = {kind: 0 for kind in SOURCES}
