"""Python wrapper of the Hopper fused TLB round (`csrc/fused_tlb.cu`).

`fused_tlb_round` checks its tensors, allocates the outputs with
`torch.empty`, picks the kernel's instance for the way count
(`instance`), launches it on the current stream and raises if the launch
failed. It does not synchronise. The tags/asids/lru planes are updated in
place and returned, as the TPU kernel's aliased outputs are. With a
leading row axis (planes (R, sets, ways), lanes (R, N)) the R rounds are
independent and run in ONE launch, one thread block per row. The
16-way instance reads the planes' rows with 16-byte loads, so it runs
only where every row's address is 16-byte aligned (the base and the row
stride of sets * ways * 4 bytes); any other layout runs the instance
that reads words (`instance`). Up to 1024 lanes take a thread each; more
(up to MAX_LANES) run the wide instances, whose threads take lanes t,
t + 1024, ... (`lanes_per_thread`). `fused_tlb_round.launches` counts the
launches, not the rows, so a run can show that it went through the
kernel and how many rounds shared each launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

THREADS = 1024                   # one thread block a row
LANES_WIDE = 8                   # lanes a thread of the wide instances
MAX_LANES = THREADS * LANES_WIDE
MAX_ROWS = 2**31 - 1             # one block per row: the grid's x limit
MAX_SMEM = 227 * 1024            # dynamic shared memory of one H100 block
WAY_INSTANCE = 16                # the main path's way count, compiled as such
ROW_ALIGN = 16                   # bytes: the planes' rows are read by int4


def instance(n_ways: int, rows_aligned: bool = True) -> int:
    """The kernel instance that takes `n_ways` ways: 16 for the main path's
    16-way rounds, which `csrc/fused_tlb.cu` compiles as such and which
    read rows by 16-byte loads, when every row of the planes is 16-byte
    aligned (`rows_aligned`); else 0, the instance that reads the count at
    run time and the rows word by word."""
    return n_ways if n_ways == WAY_INSTANCE and rows_aligned else 0


def lanes_per_thread(n_lanes: int) -> int:
    """Lanes each thread of the launch takes: 1 up to THREADS lanes (a
    thread a lane), else LANES_WIDE (the wide instance: THREADS threads,
    thread t taking lanes t, t + THREADS, ...)."""
    return 1 if n_lanes <= THREADS else LANES_WIDE


def rows_aligned(planes, n_rows: int) -> bool:
    """Whether every row of each plane (sets, ways) or (R, sets, ways)
    starts on a 16-byte boundary: its base address and, for R > 1, the
    row stride of sets * ways * 4 bytes."""
    n_sets, n_ways = planes[0].shape[-2:]
    return all(p.data_ptr() % ROW_ALIGN == 0 for p in planes) and (
        n_rows == 1 or (n_sets * n_ways * 4) % ROW_ALIGN == 0)


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
    (R, N)) bool; N divisible by n_waves, 1 <= N <= MAX_LANES, the
    tables within a block's shared memory (`shared_bytes`). The rows share
    `time`, `n_waves` and `track_asids`. Returns (tags, asids, lru, hit,
    filled), hit/filled (N,) (rows: (R, N)) int32. Every check runs before
    any build or launch."""
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
    if not 1 <= R <= MAX_ROWS:
        raise ValueError(f"fused_tlb: {R} rows; one block per row takes "
                         f"1..{MAX_ROWS}")
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
                   instance(n_ways, rows_aligned((tags, asids, lru), R)),
                   R, n_sets, n_ways, N, n_waves,
                   int(track_asids), int(time), hash_bits(N),
                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_tlb kernel launch failed: CUDA error "
                           f"{err} ({R} x {n_sets}x{n_ways}, N={N}, "
                           f"W={n_waves})")
    fused_tlb_round.launches += 1
    return tags, asids, lru, hit, filled


fused_tlb_round.launches = 0
