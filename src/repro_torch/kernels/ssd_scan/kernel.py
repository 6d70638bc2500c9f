"""Python wrapper of the Hopper SSD intra-chunk kernel (`csrc/ssd_scan.cu`).

`ssd_intra_chunk` checks its tensors, allocates the three outputs with
`torch.empty`, reports the call's work to an active step counter
(`roofline.counter.kernel_work`, by `work`), launches the kernel on the
current stream and raises if the launch failed. It does not synchronise.
`ssd_intra_chunk.launches` counts the launches, so a run can show that it
went through the kernel. Fake CUDA tensors (`FakeTensorMode`, a traced
step) pass the same checks and get their outputs allocated (fake) and
their work counted, but nothing is built or launched:
`ssd_intra_chunk.fake_calls` counts those calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.roofline.counter import counting, kernel_work

HD_MAX, DS_MAX = 64, 128          # the kernel's tile limits
Q_MAX = 30656                     # chunk rows whose tile prefixes fit on chip


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("ssd_scan").ssd_intra_chunk_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def work(B, nc, Q, nh, hd, ds):
    """(flop, bytes) of one call: the products once (per (b, chunk) the
    Gram C.B^T on the s <= q pairs, 2 ds flop a pair; per head y, 2 hd a
    pair, and the chunk state, 2 Q hd ds), not times the kernel's three
    split-TF32 passes; the bytes of x, dA, B, C, y, S and decay, each
    read or written once (the formulas of the kernel's bound in
    `chip_smoke.py`)."""
    pairs = Q * (Q + 1) // 2
    flops = B * nc * (2 * ds * pairs + nh * (2 * hd * pairs + 2 * Q * hd * ds))
    nbytes = 4 * B * nc * (2 * Q * nh * hd + Q * nh + 2 * Q * ds
                           + nh * (hd * ds + 1))
    return float(flops), float(nbytes)


def ssd_intra_chunk(x, dA, Bm, Cm):
    """x: (B, nc, Q, nh, hd); dA: (B, nc, Q, nh); Bm/Cm: (B, nc, Q, ds),
    float32 and contiguous on the current CUDA device, hd <= HD_MAX,
    ds <= DS_MAX, Q <= Q_MAX. Returns y (B, nc, Q, nh, hd), S (B, nc, nh,
    hd, ds), decay (B, nc, nh), float32."""
    dev, fake = x.device, is_fake(x)
    if dev.type != "cuda" or not (
            fake or dev.index == torch.cuda.current_device()):
        raise ValueError(f"ssd_scan kernel needs tensors on the current "
                         f"CUDA device, got {dev}")
    if x.dim() != 5 or dA.dim() != 4 or Bm.dim() != 4 \
            or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dA "
                         f"{tuple(dA.shape)}, B {tuple(Bm.shape)}, C "
                         f"{tuple(Cm.shape)} are not (B, nc, Q, nh, hd), "
                         "(B, nc, Q, nh) and two equal (B, nc, Q, ds)")
    B, nc, Q, nh, hd = x.shape
    ds = Bm.shape[3]
    if tuple(dA.shape) != (B, nc, Q, nh) or tuple(Bm.shape[:3]) != (B, nc, Q):
        raise ValueError(f"ssd_scan: dA {tuple(dA.shape)} or B/C "
                         f"{tuple(Bm.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if hd > HD_MAX or ds > DS_MAX or Q > Q_MAX:
        raise ValueError(f"ssd_scan: head dim {hd} > {HD_MAX}, state dim "
                         f"{ds} > {DS_MAX} or chunk {Q} > {Q_MAX}")
    for t, name in ((x, "x"), (dA, "dA"), (Bm, "B"), (Cm, "C")):
        if t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous float32 "
                             f"on {dev}, got {t.dtype} on {t.device}")
    if x.numel() == 0 or ds == 0:
        raise ValueError(f"ssd_scan: empty input {tuple(x.shape)}, ds={ds}")
    y = torch.empty_like(x)
    S = torch.empty((B, nc, nh, hd, ds), dtype=torch.float32, device=dev)
    decay = torch.empty((B, nc, nh), dtype=torch.float32, device=dev)
    if counting():
        kernel_work("ssd_intra_chunk", *work(B, nc, Q, nh, hd, ds))
    if fake:
        ssd_intra_chunk.fake_calls += 1
        return y, S, decay
    err = _entry()(x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                   y.data_ptr(), S.data_ptr(), decay.data_ptr(),
                   B, nc, Q, nh, hd, ds,
                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err} (B={B}, nc={nc}, Q={Q}, nh={nh}, hd={hd}, "
                           f"ds={ds})")
    ssd_intra_chunk.launches += 1
    return y, S, decay


ssd_intra_chunk.launches = 0
ssd_intra_chunk.fake_calls = 0
