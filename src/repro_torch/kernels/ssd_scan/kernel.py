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

`plan` says how a call runs: the kernel's tiles are 64 columns of hd
and 128 of ds; wider heads (up to HD_MAX) run the kernel's WIDE
instance, a block per 64-column slice of hd and a loop over 128-column
slices of ds, and chunks past 768 rows the instance with cs windows.
The kernel reads contiguous inputs; any other is first copied to a
contiguous one (`ssd_intra_chunk.staged` counts such calls; the model's
inputs never need it).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build
from repro_torch.roofline.counter import counting, kernel_work

HD_TILE, DS_TILE = 64, 128        # the kernel's tile widths
HD_MAX, DS_MAX = 256, 256         # the widest it walks in tile slices
Q_MAX = 30656                     # chunk rows whose tile prefixes fit on chip
Q_WHOLE = 768                     # chunk rows whose whole cumsums fit


class Plan(NamedTuple):
    """How a call runs: blocks per (head tile, chunk) (`hd_slices`, one per
    64 columns of hd), the loop over 128 columns of ds (`ds_slices`),
    whether the WIDE instance runs (any slicing), whether the cs windows'
    instance runs (`windows`, chunks past Q_WHOLE rows), and whether the
    inputs are first copied to contiguous ones (`staged`)."""
    hd_slices: int
    ds_slices: int
    wide: bool
    windows: bool
    staged: bool


def plan(hd: int, ds: int, Q: int, contiguous: bool = True) -> Plan:
    """The plan of a call at head width hd, state width ds and chunk Q;
    raises ValueError past HD_MAX, DS_MAX or Q_MAX."""
    if not (1 <= hd <= HD_MAX and 1 <= ds <= DS_MAX and 1 <= Q <= Q_MAX):
        raise ValueError(f"ssd_scan: head dim {hd}, state dim {ds} or chunk "
                         f"{Q} is not within 1..{HD_MAX}, 1..{DS_MAX}, "
                         f"1..{Q_MAX}")
    nhs, nds = -(-hd // HD_TILE), -(-ds // DS_TILE)
    return Plan(nhs, nds, nhs > 1 or nds > 1, Q > Q_WHOLE, not contiguous)


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
    float32 on the current CUDA device, hd <= HD_MAX, ds <= DS_MAX, Q <=
    Q_MAX (`plan`). Returns y (B, nc, Q, nh, hd), S (B, nc, nh, hd, ds),
    decay (B, nc, nh), float32."""
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
    if x.numel() == 0 or ds == 0:
        raise ValueError(f"ssd_scan: empty input {tuple(x.shape)}, ds={ds}")
    for t, name in ((x, "x"), (dA, "dA"), (Bm, "B"), (Cm, "C")):
        if t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"ssd_scan: {name} must be float32 on {dev}, "
                             f"got {t.dtype} on {t.device}")
    how = plan(hd, ds, Q, all(t.is_contiguous() for t in (x, dA, Bm, Cm)))
    y = torch.empty(x.shape, dtype=torch.float32, device=dev)
    S = torch.empty((B, nc, nh, hd, ds), dtype=torch.float32, device=dev)
    decay = torch.empty((B, nc, nh), dtype=torch.float32, device=dev)
    if counting():
        kernel_work("ssd_intra_chunk", *work(B, nc, Q, nh, hd, ds))
    if fake:
        ssd_intra_chunk.fake_calls += 1
        return y, S, decay
    if how.staged:
        x, dA, Bm, Cm = (t.contiguous() for t in (x, dA, Bm, Cm))
    err = _entry()(x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                   y.data_ptr(), S.data_ptr(), decay.data_ptr(),
                   B, nc, Q, nh, hd, ds,
                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err} (B={B}, nc={nc}, Q={Q}, nh={nh}, hd={hd}, "
                           f"ds={ds})")
    ssd_intra_chunk.launches += 1
    ssd_intra_chunk.staged += how.staged
    return y, S, decay


ssd_intra_chunk.launches = 0
ssd_intra_chunk.staged = 0
ssd_intra_chunk.fake_calls = 0
