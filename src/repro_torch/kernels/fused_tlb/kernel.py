"""Python wrapper of the Hopper fused TLB round (`csrc/fused_tlb.cu`).

`fused_tlb_round` checks its tensors, allocates the outputs with
`torch.empty`, picks the kernel's instance for the way count
(`instance`), launches it on the current stream and raises if the launch
failed. It does not synchronise. The tags/asids/lru planes are updated in
place and returned, as the TPU kernel's aliased outputs are. With a
leading row axis (planes (R, sets, ways), lanes (R, N)) the R rounds are
independent and run in ONE launch, one thread block per row. The kernel
reads the planes' rows with 16-byte loads, so every row's address must be
16-byte aligned: the base (a whole torch allocation is) and the row
stride of sets * ways * 4 bytes. `fused_tlb_round.launches` counts the
launches, not the rows, so a run can show that it went through the
kernel and how many rounds shared each launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

MAX_LANES = 1024                 # one thread per lane, one thread block a row
MAX_ROWS = 2**31 - 1             # one block per row: the grid's x limit
MAX_SMEM = 227 * 1024            # dynamic shared memory of one H100 block
WAY_INSTANCE = 16                # the main path's way count, compiled as such
ROW_ALIGN = 16                   # bytes: the planes' rows are read by int4


def instance(n_ways: int) -> int:
    """The kernel instance that takes `n_ways` ways: 16 for the main path's
    16-way rounds, which `csrc/fused_tlb.cu` compiles as such, else 0, the
    instance that reads the count at run time."""
    return n_ways if n_ways == WAY_INSTANCE else 0


def hash_bits(n_lanes: int) -> int:
    """log2 of the write-owner hash table's size: at least 2 entries per
    lane, at least 32."""
    return max(5, (2 * n_lanes - 1).bit_length())


def shared_bytes(n_sets: int, n_waves: int, n_lanes: int) -> int:
    """Dynamic shared memory of one launch: the (sets, waves) fill ports,
    the lanes' lines and candidate flags, the owner hash table's keys and
    owners."""
    return 4 * (n_sets * n_waves + 2 * n_lanes + 2 * (1 << hash_bits(n_lanes)))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("fused_tlb").fused_tlb_round
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
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
    """One fused cross-wave probe+fill round on the card, or R of them.

    tags/asids/lru: (sets, ways) int32 on the current CUDA device, or (R,
    sets, ways) for R independent rounds (one per row), updated in place.
    vpn/asid: (N,) (rows: (R, N)) int32; active/may_fill: (N,) (rows:
    (R, N)) bool; N divisible by n_waves, 1 <= N <= 1024; every row's
    planes 16-byte aligned. The rows share `time`, `n_waves` and
    `track_asids`. Returns (tags, asids, lru, hit, filled), hit/filled
    (N,) (rows: (R, N)) int32. Every check runs before any build or
    launch."""
    dev = tags.device
    rows = tags.dim() == 3
    if tags.dim() not in (2, 3) or vpn.dim() != tags.dim() - 1:
        raise ValueError(f"fused_tlb: tags {tuple(tags.shape)} is not "
                         f"([R,] sets, ways) or vpn {tuple(vpn.shape)} not "
                         f"([R,] N)")
    R = tags.shape[0] if rows else 1
    n_sets, n_ways = tags.shape[-2:]
    N = vpn.shape[-1]
    lead = (R,) if rows else ()
    plane, lanes = lead + (n_sets, n_ways), lead + (N,)
    for t, name, dtype, shape in (
            (tags, "tags", torch.int32, plane),
            (asids, "asids", torch.int32, plane),
            (lru, "lru", torch.int32, plane),
            (vpn, "vpn", torch.int32, lanes),
            (asid, "asid", torch.int32, lanes),
            (active, "active", torch.bool, lanes),
            (may_fill, "may_fill", torch.bool, lanes)):
        _check(t, name, dtype, shape, dev)
        if shape is plane and t.data_ptr() % ROW_ALIGN:
            raise ValueError(f"fused_tlb: {name}'s address is not "
                             f"{ROW_ALIGN}-byte aligned (the kernel reads "
                             f"rows by int4)")
    if not 1 <= R <= MAX_ROWS:
        raise ValueError(f"fused_tlb: {R} rows; one block per row takes "
                         f"1..{MAX_ROWS}")
    if R > 1 and (n_sets * n_ways * 4) % ROW_ALIGN:
        raise ValueError(f"fused_tlb: a row's planes are {n_sets} x "
                         f"{n_ways} x 4 bytes, not a multiple of "
                         f"{ROW_ALIGN}: row 1's address would not be "
                         f"{ROW_ALIGN}-byte aligned")
    if not 1 <= N <= MAX_LANES or N % n_waves:
        raise ValueError(f"fused_tlb: lane count {N} must be in "
                         f"1..{MAX_LANES} and divisible by n_waves={n_waves}")
    smem = shared_bytes(n_sets, n_waves, N)
    if smem > MAX_SMEM:
        raise ValueError(f"fused_tlb: fill-port and owner tables need {smem}"
                         f" B of shared memory > {MAX_SMEM}")
    if not -2**31 <= time < 2**31:
        raise ValueError(f"fused_tlb: time {time} does not fit int32")
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"fused_tlb kernel needs tensors on the current "
                         f"CUDA device, got {dev}")

    out = torch.empty((2,) + lanes, dtype=torch.int32, device=dev)
    hit, filled = out[0], out[1]
    err = _entry()(tags.data_ptr(), asids.data_ptr(), lru.data_ptr(),
                   vpn.data_ptr(), asid.data_ptr(), active.data_ptr(),
                   may_fill.data_ptr(), hit.data_ptr(), filled.data_ptr(),
                   instance(n_ways), R, n_sets, n_ways, N, n_waves,
                   int(track_asids), int(time), hash_bits(N),
                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tlb kernel launch failed: CUDA error "
                           f"{err} ({R} x {n_sets}x{n_ways}, N={N}, "
                           f"W={n_waves})")
    fused_tlb_round.launches += 1
    return tags, asids, lru, hit, filled


fused_tlb_round.launches = 0
