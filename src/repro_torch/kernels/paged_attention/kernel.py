"""Python wrapper of the Hopper paged decode attention kernel
(`csrc/paged_attention.cu`), the port of the TPU kernel
`src/repro/kernels/paged_attention/kernel.py::_kernel`.

The function is bound by bytes: every live K and V row is read once for
4 G flop per 4 bytes (G query heads per KV head), so the kernel streams
rows and does its products as FMAs on the CUDA cores. One call is two
CUDA launches on the current stream:
  * split: one block of 128 threads per (span of pages, head group, KV
    head, sequence): a head group is at most G_MAX of the G query heads
    of a KV head, G cut into `plan`'s equal groups. The span comes from
    `split_plan`, a pure function of the
    page size and the block table's width (~128 tokens): the host never
    reads `seq_lens`, so a call does not synchronise. A block past the
    sequence's live pages writes the empty partial (m = -1e30, l = 0);
    the others stream their span's K and V rows, 32 tokens at a time,
    through a 2-stage shared-memory ring by 16-byte `cp.async` (each row
    found through the block table, so a tile may cross pages) and write
    the span's online-softmax partial (m, l, acc) in float32 to scratch;
  * combine: one block per (query head, sequence) merges its partials in
    split order, without atomics, so results repeat bit for bit.
Registers, shared memory and spills of each template instance are listed
at the head of the CUDA source (from `nvcc -Xptxas -v`): 56 registers
per thread and 39,444 bytes of shared memory per block, no spills, at
the pool's shape (bf16, dh 128, G 4).

The kernel is compiled for the head widths the models run, with one
head group (`EXACT_WIDTHS`), and for padded widths (`PADDED_WIDTHS`,
blocks of up to G_MAX heads), through which any other call runs: a head
narrower than its instance reads the columns past dh as zeros. It reads
K and V rows by 16-byte copies, so it takes tensors in place only when
q, k_pages and v_pages are contiguous and 16-byte aligned, block_table
and seq_lens contiguous, and dh whole 16-byte pieces (a multiple of 8 in
bf16, 4 in fp32); any other call is staged (`plan`, `stage`): copied
into fresh contiguous buffers, the head zero-padded, run through the same
kernel with the scale of its true dh, and returned as the slice of its
dh columns. `paged_attention.staged` counts such calls; the pool's own
tensors never need it.

`paged_attention` checks its tensors (device, dtype, shape), allocates
the output and the scratch with `torch.empty`, launches and raises if a
launch failed. `paged_attention.launches` counts calls, so a run can
show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

EXACT_WIDTHS = (32, 64, 96, 128)   # dh == the width, one head group
PADDED_WIDTHS = (128, 192, 256)    # any other call, 16-head blocks
HEAD_DIM_MAX = PADDED_WIDTHS[-1]
G_MAX = 16                       # query heads of a block (a head group)
SPLIT_TOKENS = 128               # tokens a split aims at
ALIGN = 16                       # bytes: the kernel's copies
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    """How a call runs: the head width the kernel reads (`dh`: the true
    one rounded up to whole 16-byte pieces), the compiled instance, the
    query heads of a block (`heads`) and the blocks a KV head's G heads
    take (`groups`), and whether the inputs are first copied into fresh
    contiguous, zero-padded buffers (`staged`)."""
    dh: int
    instance: int
    heads: int
    groups: int
    staged: bool


def plan(dtype, dh: int, G: int, in_place: bool = True) -> Plan:
    """The plan of a call on tensors of `dtype`, head dim `dh` and G query
    heads per KV head, whose layout the kernel can (`in_place`) or cannot
    read as it lies. G is cut into ceil(G / G_MAX) groups of equal size
    (the last may be short); dh is rounded up to whole 16-byte pieces;
    the instance is the exact one of that width where there is one and G
    is one group, else the narrowest padded width at or above it; a call
    is staged where the rounding moves dh or the layout is not in place.
    Raises
    ValueError on a dtype the kernel does not take or a head dim above
    HEAD_DIM_MAX."""
    if dtype not in _DTYPES:
        raise ValueError(f"paged_attention: {dtype} is not one of "
                         f"{list(_DTYPES)}")
    if not 1 <= dh <= HEAD_DIM_MAX:
        raise ValueError(f"paged_attention: head dim {dh} is not in 1.."
                         f"{HEAD_DIM_MAX} (the widest instance)")
    if G < 1:
        raise ValueError(f"paged_attention: {G} query heads per KV head")
    step = ALIGN // dtype.itemsize
    dk = -(-dh // step) * step
    groups = -(-G // G_MAX)
    width = dk if dk in EXACT_WIDTHS and groups == 1 else \
        min(w for w in PADDED_WIDTHS if w >= dk)
    return Plan(dk, width, -(-G // groups), groups, dk != dh or not in_place)


def stage(t, dh: int):
    """A fresh contiguous copy of `t`, its last dim widened to `dh` with
    zeros."""
    out = t.new_zeros(tuple(t.shape[:-1]) + (dh,))
    out[..., :t.shape[-1]] = t
    return out


def in_place(q, k_pages, v_pages, block_table, seq_lens) -> bool:
    """Whether the kernel reads these tensors as they lie: q and the pages
    contiguous and 16-byte aligned, the table and lengths contiguous."""
    return all(t.is_contiguous() and t.data_ptr() % ALIGN == 0
               for t in (q, k_pages, v_pages)) and \
        block_table.is_contiguous() and seq_lens.is_contiguous()


def split_plan(page, n_pages):
    """(pages per split, splits per sequence) for a block table of
    `n_pages` logical pages of `page` tokens: spans of about SPLIT_TOKENS
    tokens and at least one page. Split i covers the logical pages
    [i * pps, min((i + 1) * pps, n_pages))."""
    pps = min(max(1, SPLIT_TOKENS // page), n_pages)
    return pps, -(-n_pages // pps)


def bind(fn):
    """Set the argument types of a `paged_attention_fwd` C entry point."""
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11 \
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry():
    return bind(_build.load("paged_attention").paged_attention_fwd)


def _check(q, k_pages, v_pages, block_table, seq_lens):
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
    if k_pages.shape[3] != dh or KV < 1 or H % KV:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} does not "
                         f"match pages {tuple(k_pages.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"paged_attention: block_table "
                         f"{tuple(block_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} do not match B={B}")
    for t, name, dts in ((q, "q", _DTYPES), (k_pages, "k_pages", _DTYPES),
                         (v_pages, "v_pages", _DTYPES),
                         (block_table, "block_table", (torch.int32,)),
                         (seq_lens, "seq_lens", (torch.int32,))):
        if t.dtype not in dts or t.device != dev:
            raise ValueError(f"paged_attention: {name} is {t.dtype} on "
                             f"{t.device}; it must be one of {list(dts)}, "
                             f"on {dev}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_attention: q, k_pages, v_pages must share "
                         "one dtype")
    if B == 0 or block_table.shape[1] == 0 or P == 0:
        raise ValueError(f"paged_attention: empty input (B={B}, P={P}, "
                         f"pages per sequence {block_table.shape[1]})")
    return plan(q.dtype, dh, H // KV,
                in_place(q, k_pages, v_pages, block_table, seq_lens))


def launch_split(q, k_pages, v_pages, block_table, seq_lens, plan=None,
                 entry=None):
    """Check the tensors and run one call's two launches with the split
    `plan` = (pages per split, splits), by default `split_plan`'s, through
    the C entry point `entry` (a bound `paged_attention_fwd` of a build of
    the source), by default the kernel's, staging the inputs where the
    call's `Plan` says so. Returns (output, the call's `Plan`); counts
    nothing."""
    how = _check(q, k_pages, v_pages, block_table, seq_lens)
    entry = entry or _entry()
    B, H, dh = q.shape
    P, page, KV, _ = k_pages.shape
    pps, n_splits = plan or split_plan(page, block_table.shape[1])
    if how.staged:
        q, k_pages, v_pages = (stage(t, how.dh) for t in (q, k_pages,
                                                         v_pages))
        block_table = block_table.contiguous()
        seq_lens = seq_lens.contiguous()
    o = torch.empty_like(q)
    rows = B * H * n_splits                 # one scratch buffer: m, l, acc
    scratch = torch.empty(rows * (how.instance + 2), dtype=torch.float32,
                          device=q.device)
    part_m, part_l, part_acc = scratch[:rows], scratch[rows:2 * rows], \
        scratch[2 * rows:]
    err = entry(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), seq_lens.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), o.data_ptr(),
        B, H, KV, how.dh, how.instance, how.heads, page,
        block_table.shape[1], P, pps, n_splits, float(1.0 / dh ** 0.5),
        _DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err} (B={B}, H={H}, KV={KV}, dh={dh}, "
                           f"page={page}, P={P}, {pps} pages x {n_splits} "
                           f"splits, {how}, {q.dtype})")
    return (o[..., :dh] if how.staged else o), how


def paged_attention(q, k_pages, v_pages, block_table, seq_lens):
    """One-token decode attention on the card. q: (B, H, dh); k/v pages:
    (P, page, KV, dh), q's dtype (float32 or bfloat16), dh <=
    HEAD_DIM_MAX, H a multiple of KV; block_table: (B, n) int32;
    seq_lens: (B,) int32; all on the current CUDA device. Returns (B, H,
    dh) (a slice of a padded buffer when the call was staged)."""
    o, how = launch_split(q, k_pages, v_pages, block_table, seq_lens)
    paged_attention.launches += 1
    paged_attention.staged += how.staged
    return o


paged_attention.launches = 0
paged_attention.staged = 0
