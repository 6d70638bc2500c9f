"""Python wrapper of the Hopper fused TLB round (`csrc/fused_tlb.cu`).

`fused_tlb_round` checks its tensors, allocates the outputs and the
owner scratch with `torch.empty`, launches the kernel on the current
stream and raises if the launch failed. It does not synchronise. The
tags/asids/lru planes are updated in place and returned, as the TPU
kernel's aliased outputs are. `fused_tlb_round.launches` counts the
launches, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_LANES = 1024                 # one thread per lane, one thread block
MAX_SMEM = 227 * 1024            # dynamic shared memory of one H100 block


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("fused_tlb").fused_tlb_round
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype is not dtype or t.shape != shape or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"fused_tlb: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def fused_tlb_round(tags, asids, lru, vpn, asid, active, may_fill,
                    time: int, *, n_waves: int = 1,
                    track_asids: bool = True):
    """One fused cross-wave probe+fill round on the card.

    tags/asids/lru: (sets, ways) int32 on the current CUDA device, updated
    in place. vpn/asid: (N,) int32; active/may_fill: (N,) bool; N
    divisible by n_waves, 1 <= N <= 1024.
    Returns (tags, asids, lru, hit (N,) int32, filled (N,) int32)."""
    dev = tags.device
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"fused_tlb kernel needs tensors on the current "
                         f"CUDA device, got {dev}")
    n_sets, n_ways = tags.shape
    N = vpn.shape[0]
    plane, lanes = (n_sets, n_ways), (N,)
    for t, name, dtype, shape in (
            (tags, "tags", torch.int32, plane),
            (asids, "asids", torch.int32, plane),
            (lru, "lru", torch.int32, plane),
            (vpn, "vpn", torch.int32, lanes),
            (asid, "asid", torch.int32, lanes),
            (active, "active", torch.bool, lanes),
            (may_fill, "may_fill", torch.bool, lanes)):
        _check(t, name, dtype, shape, dev)
    if not 1 <= N <= MAX_LANES or N % n_waves:
        raise ValueError(f"fused_tlb: lane count {N} must be in "
                         f"1..{MAX_LANES} and divisible by n_waves={n_waves}")
    smem = 4 * (n_sets * n_waves + 2 * N)
    if smem > MAX_SMEM:
        raise ValueError(f"fused_tlb: fill-port table needs {smem} B of "
                         f"shared memory > {MAX_SMEM}")
    if not -2**31 <= time < 2**31:
        raise ValueError(f"fused_tlb: time {time} does not fit int32")

    # hit, filled and the per-slot owner scratch in one allocation
    out = torch.empty(2 * N + n_sets * n_ways, dtype=torch.int32, device=dev)
    hit, filled = out[:N], out[N:2 * N]
    err = _entry()(tags.data_ptr(), asids.data_ptr(), lru.data_ptr(),
                   vpn.data_ptr(), asid.data_ptr(), active.data_ptr(),
                   may_fill.data_ptr(), hit.data_ptr(), filled.data_ptr(),
                   out[2 * N:].data_ptr(), n_sets, n_ways, N, n_waves,
                   int(track_asids), int(time),
                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tlb kernel launch failed: CUDA error "
                           f"{err} ({n_sets}x{n_ways}, N={N}, W={n_waves})")
    fused_tlb_round.launches += 1
    return tags, asids, lru, hit, filled


fused_tlb_round.launches = 0
