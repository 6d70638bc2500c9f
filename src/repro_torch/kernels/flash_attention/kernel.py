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
1 and 2 swapped, and the kernels read them in place, with no copy.

`plan` picks the compiled instance: each kernel is compiled for a few
padded head widths (`INSTANCES`) and reads a narrower head through them,
the columns past dh read as zeros (TMA's fill in bf16, cp.async's source
size in fp32), which add nothing to q.k and are not stored. Both kernels
read 16-byte pieces (TMA in bf16, cp.async and vector loads in fp32),
which need 16-byte aligned base addresses and strides (`tma_strides`) and
a head of whole 16-byte pieces (dh a multiple of 8 in bf16, 4 in fp32).
The model's tensors always qualify. Any other input is staged: copied
into fresh zero-padded contiguous buffers (`stage`), run through the same
kernel with the scale of its true dh, and returned as the slice of its
dh columns; `flash_attention_bhsd.staged` counts such calls (a copy, not
a fallback: the kernel still runs and is counted).
`flash_attention_bhsd.launches` counts every launch, and
`flash_attention_bhsd.route_launches[route]` those of each kernel, so a run
can show which kernel it went through.

v may have another head width (dv) than q and k (dh), as latent attention
has (q/k 192, v 128): the output then has dv columns, and the caller may
give the softmax scale (`scale`; default 1/sqrt(dh)). Such a call runs
through an instance of two widths (`SPLIT_INSTANCES`: the tensor-core
kernel's <192 q/k, 128 v>); any other pair of unequal widths is refused.
Each call reports its work to an active step counter
(`roofline.counter.kernel_work`, by `work`). Fake CUDA tensors
(`FakeTensorMode`, a traced step) pass the same checks, but for the
address (a fake tensor has none), and get their output allocated (fake)
and their work counted; nothing is built or launched, and
`flash_attention_bhsd.fake_calls` counts those calls.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.roofline.counter import counting, kernel_work

HEAD_DIM_MAX = 256               # the widest instance of either kernel
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "split_tf32"}
SOURCES = {"wgmma": "flash_attention_sm90", "split_tf32": "flash_attention"}
# the padded head widths each kernel is compiled for
INSTANCES = {"wgmma": (64, 128, 192, 256),
             "split_tf32": tuple(range(32, HEAD_DIM_MAX + 1, 32))}
# the (q/k, v) head widths of the instances whose v is narrower: the only
# pairs of unequal widths a call may have
SPLIT_INSTANCES = {"wgmma": ((192, 128),), "split_tf32": ()}
TMA_ALIGN = 16                   # bytes: both kernels' addresses, strides


class Plan(NamedTuple):
    """How a call runs: the head width the kernel reads (`dh`: the true
    one rounded up to whole 16-byte pieces), the compiled instance, and
    whether the inputs are first copied into zero-padded contiguous
    buffers (`staged`)."""
    dh: int
    instance: int
    staged: bool


@functools.lru_cache(maxsize=None)
def _entry(route_name: str, split: bool = False):
    """csrc/<name>.cu's <name>_fwd, or with `split` its <name>_dv_fwd,
    which takes v's width after q's."""
    name = SOURCES[route_name]
    fn = getattr(_build.load(name), f"{name}_dv_fwd" if split
                 else f"{name}_fwd")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * (7 if split
                                                             else 6)
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


def plan(dtype, dh: int, aligned: bool = True) -> Plan:
    """The plan of a call on q, k, v of `dtype` and head dim `dh` whose
    addresses and strides are (`aligned`) or are not 16-byte aligned.
    The kernel reads dh rounded up to whole 16-byte pieces through the
    narrowest instance at or above it; a call is staged where that
    rounding moves dh or the layout is not aligned. Raises ValueError on
    a dtype no kernel takes or a head dim above HEAD_DIM_MAX."""
    kind = route(dtype)
    if not 1 <= dh <= HEAD_DIM_MAX:
        raise ValueError(f"flash_attention: head dim {dh} is not in 1.."
                         f"{HEAD_DIM_MAX} (the widest instance)")
    step = TMA_ALIGN // dtype.itemsize
    dk = -(-dh // step) * step
    width = min(w for w in INSTANCES[kind] if w >= dk)
    return Plan(dk, width, dk != dh or not aligned)


def stage(t, dh: int):
    """A fresh contiguous copy of the (B, n, S, d) tensor `t`, widened to
    `dh` columns with zeros."""
    out = t.new_zeros(tuple(t.shape[:3]) + (dh,))
    out[..., :t.shape[3]] = t
    return out


def _stride_fault(t, name: str):
    """Why `t` cannot go to the kernels as it lies (its address or a
    stride off 16 bytes), or None. A dim of length 1 is never stepped
    over; a fake tensor's address is not checked."""
    if not is_fake(t) and t.data_ptr() % TMA_ALIGN:
        return (f"flash_attention: {name}'s address is not {TMA_ALIGN}-byte"
                f" aligned (16-byte loads need it)")
    for dim in range(3):
        stride = t.stride(dim)
        if t.shape[dim] != 1 and (stride <= 0 or
                                  stride * t.element_size() % TMA_ALIGN):
            return (f"flash_attention: {name}'s stride {stride} of dim {dim}"
                    f" is not a positive multiple of {TMA_ALIGN} bytes "
                    f"(16-byte loads need it)")
    return None


def tma_strides(t, name: str):
    """The (b, h, s) strides of `t`, in elements, as the tensor-core
    kernel's tensor map describes them (the fp32 kernel takes the same).
    Raises ValueError, naming the tensor, unless its address and the
    strides of its dims longer than 1 are multiples of 16 bytes, which TMA
    and the fp32 kernel's 16-byte copies need (`flash_attention_bhsd`
    stages such a tensor first). A dim of length 1 is never stepped over,
    so its stride is replaced by the head dim's length. A fake tensor's
    address is not checked."""
    fault = _stride_fault(t, name)
    if fault:
        raise ValueError(fault)
    return [t.shape[3] if t.shape[dim] == 1 else t.stride(dim)
            for dim in range(3)]


def check_tiling(Sq: int, Sk: int, block_q: int, block_k: int):
    """The reference kernel's contract on shapes: each sequence length is a
    multiple of its block, the block cut to the length."""
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if bq < 1 or bk < 1 or Sq % bq or Sk % bk:
        raise ValueError(f"flash_attention: Sq={Sq} and Sk={Sk} must be "
                         f"multiples of block_q={bq} and block_k={bk}")


def work(q, k, causal=True, window: Optional[int] = None, v=None):
    """(flop, bytes) of one call: 2 (dh + dv) flop (q.k and p.v) for each
    (q, k) pair the mask lets through, per (batch, head), 4 dh where v is
    k's width; and the bytes of q, k, v and o, each read or written once
    (the formulas of the kernel's bound in `chip_smoke.py`). `v` defaults
    to a tensor of k's shape."""
    B, H, Sq, dh = q.shape
    Sk = k.shape[2]
    dv = dh if v is None else v.shape[3]
    qpos = np.arange(Sq)
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, int)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    if v is None:
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    else:
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                     + q.numel() // dh * dv)
    return float(2 * (dh + dv) * B * H * pairs), float(nbytes)


def flash_attention_bhsd(q, k, v, *, causal=True,
                         window: Optional[int] = None,
                         block_q: int = 512, block_k: int = 512,
                         scale: Optional[float] = None):
    """Forward attention on the card.

    q: (B, H, Sq, dh); k: (B, KV, Sk, dh); v: (B, KV, Sk, dv) -> (B, H, Sq,
    dv), float32 or bfloat16, dh and dv <= HEAD_DIM_MAX, H a multiple of
    KV. Scores are scaled by `scale`, by default 1/sqrt(dh). `block_q`/
    `block_k` only set the accepted shapes (`check_tiling`); the kernels
    tile by 128 (wgmma) or 64 (split_tf32). dv != dh only as a pair of
    `SPLIT_INSTANCES`. A staged call (`plan`) returns a slice of a padded
    buffer. Every check runs before any build or launch."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, H, Sq, dh), (B, KV, Sk, dh) and (B, KV, Sk, "
                         "dv)")
    B, H, Sq, dh = q.shape
    KV, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != dh or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
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
    split = dv != dh
    if split and (dh, dv) not in SPLIT_INSTANCES[kind]:
        raise ValueError(f"flash_attention: no {kind} instance takes q/k of "
                         f"{dh} and v of {dv} columns; its pairs of unequal "
                         f"widths: {list(SPLIT_INSTANCES[kind])}")
    aligned = all(_stride_fault(t, name) is None
                  for t, name in ((q, "q"), (k, "k"), (v, "v")))
    how = plan(q.dtype, dh, aligned)
    wv = dv if split else how.dh     # a pair's widths are whole pieces
    fake = is_fake(q)
    if dev.type != "cuda" or not (
            fake or dev.index == torch.cuda.current_device()):
        raise ValueError(f"flash_attention kernel needs tensors on the "
                         f"current CUDA device, got {dev}")

    def empty(width):                # (B, H, Sq, width), laid (B, Sq, H)
        return q.new_empty_strided((B, H, Sq, width),
                                   (Sq * H * width, width, H * width, 1))

    if q.numel() == 0:
        return empty(dv) if split else torch.empty_like(q)
    if counting():
        kernel_work("flash_attention", *work(q, k, causal, window, v))
    if fake:
        flash_attention_bhsd.fake_calls += 1
        return empty(dv) if split else torch.empty_like(q)
    if how.staged:
        q, k = (stage(t, how.dh) for t in (q, k))
        v = stage(v, wv)
    # q's layout (dense) or contiguous; of v's width, as the model lays q
    o = empty(dv) if split else torch.empty_like(q)
    strides = [s for t, name in ((q, "q"), (k, "k"), (v, "v"))
               for s in tma_strides(t, name)]
    widths = (how.dh, dv) if split else (how.dh,)
    err = _entry(kind, split)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, H, KV, Sq, Sk, *widths, *strides, *o.stride()[:3],
        int(causal), int(window is not None),
        int(window) if window is not None else 0,
        float(1.0 / dh ** 0.5) if scale is None else float(scale),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        what = (f"tensor map encoding failed: CUresult {err - 1000}"
                if err >= 1000 else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention {kind} kernel launch failed: "
                           f"{what} (B={B}, H={H}, KV={KV}, Sq={Sq}, "
                           f"Sk={Sk}, dh={dh}, dv={dv}, {q.dtype})")
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.route_launches[kind] += 1
    if how.staged:
        flash_attention_bhsd.staged += 1
        return o[..., :dv]
    return o


flash_attention_bhsd.launches = 0
flash_attention_bhsd.staged = 0
flash_attention_bhsd.fake_calls = 0
flash_attention_bhsd.route_launches = {kind: 0 for kind in SOURCES}
