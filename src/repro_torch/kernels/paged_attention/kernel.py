"""Python wrapper of the Hopper paged decode attention kernel
(`csrc/paged_attention.cu`), the port of the TPU kernel
`src/repro/kernels/paged_attention/kernel.py::_kernel`.

The function is bound by bytes: every live K and V row is read once for
4 G flop per 4 bytes (G query heads per KV head), so the kernel streams
rows and does its products as FMAs on the CUDA cores. One call is two
CUDA launches on the current stream:
  * split: one block of 128 threads per (span of pages, KV head,
    sequence). The span comes from `split_plan`, a pure function of the
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

`paged_attention` checks its tensors (device, dtype, shape, contiguity,
16-byte alignment), allocates the output and the scratch with
`torch.empty`, launches and raises if a launch failed.
`paged_attention.launches` counts calls, so a run can show that it went
through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 96, 128)    # the kernel's template instances
G_MAX = 16                       # query heads per KV head
GRID_MAX = 65535                 # the card's limit on grid y and z
SPLIT_TOKENS = 128               # tokens a split aims at
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_plan(page, n_pages):
    """(pages per split, splits per sequence) for a block table of
    `n_pages` logical pages of `page` tokens: spans of about SPLIT_TOKENS
    tokens and at least one page. Split i covers the logical pages
    [i * pps, min((i + 1) * pps, n_pages))."""
    pps = min(max(1, SPLIT_TOKENS // page), n_pages)
    return pps, -(-n_pages // pps)


def bind(fn):
    """Set the argument types of a `paged_attention_fwd` C entry point."""
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 \
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
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             f"aligned (data_ptr {t.data_ptr():#x})")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError("paged_attention: q, k_pages, v_pages must share "
                         "one dtype")
    if B == 0 or block_table.shape[1] == 0 or P == 0:
        raise ValueError(f"paged_attention: empty input (B={B}, P={P}, "
                         f"pages per sequence {block_table.shape[1]})")
    if B > GRID_MAX or KV > GRID_MAX:
        raise ValueError(f"paged_attention: B={B} or KV={KV} above the "
                         f"grid's {GRID_MAX}")


def launch_split(q, k_pages, v_pages, block_table, seq_lens, plan=None,
                 entry=None):
    """Check the tensors and run one call's two launches with the split
    `plan` = (pages per split, splits), by default `split_plan`'s, through
    the C entry point `entry` (a bound `paged_attention_fwd` of a build of
    the source), by default the kernel's. Counts nothing."""
    _check(q, k_pages, v_pages, block_table, seq_lens)
    entry = entry or _entry()
    B, H, dh = q.shape
    P, page, KV, _ = k_pages.shape
    pps, n_splits = plan or split_plan(page, block_table.shape[1])
    o = torch.empty_like(q)
    rows = B * H * n_splits                 # one scratch buffer: m, l, acc
    scratch = torch.empty(rows * (dh + 2), dtype=torch.float32,
                          device=q.device)
    part_m, part_l, part_acc = scratch[:rows], scratch[rows:2 * rows], \
        scratch[2 * rows:]
    err = entry(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_table.data_ptr(), seq_lens.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), part_acc.data_ptr(), o.data_ptr(),
        B, H, KV, dh, page, block_table.shape[1], P, pps, n_splits,
        float(1.0 / dh ** 0.5), _DTYPES[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err} (B={B}, H={H}, KV={KV}, dh={dh}, "
                           f"page={page}, P={P}, {pps} pages x {n_splits} "
                           f"splits, {q.dtype})")
    return o


def paged_attention(q, k_pages, v_pages, block_table, seq_lens):
    """One-token decode attention on the card. q: (B, H, dh); k/v pages:
    (P, page, KV, dh), q's dtype (float32 or bfloat16), dh in HEAD_DIMS,
    H a multiple of KV with at most G_MAX query heads per KV head;
    block_table: (B, n) int32; seq_lens: (B,) int32; all contiguous and
    16-byte aligned on the current CUDA device. Returns (B, H, dh)."""
    o = launch_split(q, k_pages, v_pages, block_table, seq_lens)
    paged_attention.launches += 1
    return o


paged_attention.launches = 0
