"""Set-associative, ASID-tagged TLBs as tensor state (port of `repro.core.tlb`).

One structure covers the per-core L1 TLB (a bank with a leading (n_cores,)
axis), the shared L2 TLB, the bypass cache, the page-walk cache and the
line-addressed L2 data cache. Fills are batched with one fill per set per
call (first lane wins).

Every function also takes a leading row axis: planes (R, sets, ways) (a
bank's (R, n_banks, sets, ways)) with lanes (R, N) (a bank's (R,
n_banks)), one independent structure per row, as the reference's grid
vmaps them. Set rows are gathered and written along the trailing axes,
so a row's lanes never touch another row's planes. A call without the
row axis is the reference's single structure.

The reference drops masked lanes by scattering them out of bounds
(`mode="drop"`). Torch has no drop mode, so `_scatter_drop` appends one
trash slot to each row's flattened plane, routes masked lanes there and
slices it off.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.fused_tlb import ops as fused_ops

# while a cycle step is captured as CUDA graphs (`sim/replay.py`), the
# capture's splitter, called in each fused round's place as
# `_split(round, args, kwargs)`: it ends the captured stretch before the
# round, runs the round and starts the next stretch after it
_split = None


@contextlib.contextmanager
def split_rounds(splitter):
    """Route every fused round of `access_fused` through `splitter`
    inside the block."""
    global _split
    prev, _split = _split, splitter
    try:
        yield
    finally:
        _split = prev


class TLBState(NamedTuple):
    tags: torch.Tensor      # (sets, ways) int32 vpn  (-1 invalid)
    asids: torch.Tensor     # (sets, ways) int32
    lru: torch.Tensor       # (sets, ways) int32 last-use time
    hits: torch.Tensor      # () int32 cumulative
    misses: torch.Tensor    # () int32


def _scatter_drop(plane: torch.Tensor, flat: torch.Tensor, values
                  ) -> torch.Tensor:
    """`plane.at[flat].set(values, mode="drop")` over each structure's
    flattened (sets, ways) plane: plane (..., sets, ways), flat (..., N)
    indices into sets * ways, where sets * ways is dropped. `values` is a
    tensor of flat's shape, a 0-dim tensor or a host scalar. Kept indices
    must be distinct, or carry equal values (scatter_ gives duplicates no
    defined order)."""
    lead = plane.shape[:-2]
    ext = torch.cat([plane.flatten(-2), plane.new_empty(lead + (1,))], -1)
    if isinstance(values, torch.Tensor) and values.dim() == 0:
        values = values.expand(flat.shape)
    ext.scatter_(-1, flat, values)
    return ext[..., :-1].reshape(plane.shape)


def _set_index(vpn: torch.Tensor, n_sets: int) -> torch.Tensor:
    if n_sets > 1:
        return (vpn % n_sets).long()
    return torch.zeros_like(vpn, dtype=torch.long)


def _set_rows(plane: torch.Tensor, set_ix: torch.Tensor) -> torch.Tensor:
    """(..., N, ways): the set row of each lane; plane (..., sets, ways),
    set_ix (..., N)."""
    return plane.gather(-2, set_ix[..., None].expand(
        set_ix.shape + plane.shape[-1:]))


def init(n_entries: int, n_ways: int, device) -> TLBState:
    n_sets = max(n_entries // n_ways, 1)
    shape = (n_sets, n_ways)
    i32 = dict(dtype=torch.int32, device=device)
    return TLBState(
        tags=torch.full(shape, -1, **i32),
        asids=torch.full(shape, -1, **i32),
        lru=torch.zeros(shape, **i32),
        hits=torch.zeros((), **i32),
        misses=torch.zeros((), **i32),
    )


def probe(state: TLBState, vpn, asid, active, time
          ) -> Tuple[TLBState, torch.Tensor]:
    """Batched probe. vpn/asid/active: (..., N) for planes (..., sets,
    ways); `time` the LRU stamp, a host int or a 0-dim int32 tensor.
    Returns (state', hit (..., N) bool).

    LRU is updated for hits; hit/miss counters accumulate only active lanes.
    """
    n_sets, n_ways = state.tags.shape[-2:]
    set_ix = _set_index(vpn, n_sets)
    match = (_set_rows(state.tags, set_ix) == vpn[..., None]) \
        & (_set_rows(state.asids, set_ix) == asid[..., None])
    hit = match.any(-1) & active
    way = match.to(torch.int32).argmax(-1)
    # LRU touch for hits only; miss lanes go to the trash slot
    flat = torch.where(hit, set_ix * n_ways + way, n_sets * n_ways)
    lru = _scatter_drop(state.lru, flat, time)
    hits = state.hits + hit.sum(-1, dtype=torch.int32)
    misses = state.misses + (active & ~hit).sum(-1, dtype=torch.int32)
    return state._replace(lru=lru, hits=hits, misses=misses), hit


def fill(state: TLBState, vpn, asid, do_fill, time) -> TLBState:
    """Batched fill with LRU victim selection. do_fill: (..., N) bool;
    `time` as `probe` takes it.

    One fill per set per call (first lane wins): fill-port limits."""
    n_sets, n_ways = state.tags.shape[-2:]
    set_ix = _set_index(vpn, n_sets)
    N = vpn.shape[-1]
    if N > 1:
        order = torch.arange(N, device=vpn.device)
        same_earlier = (set_ix[..., None, :] == set_ix[..., :, None]) \
            & (order[None, :] < order[:, None]) & do_fill[..., None, :]
        do_fill = do_fill & ~same_earlier.any(-1)

    victim = _set_rows(state.lru, set_ix).argmin(-1)
    # after the port model every set has at most one filling lane, so the
    # kept indices are distinct
    flat = torch.where(do_fill, set_ix * n_ways + victim, n_sets * n_ways)
    return state._replace(tags=_scatter_drop(state.tags, flat, vpn),
                          asids=_scatter_drop(state.asids, flat, asid),
                          lru=_scatter_drop(state.lru, flat, time))


def init_bank(n_banks: int, n_entries: int, n_ways: int, device) -> TLBState:
    """A bank of identical TLBs: one TLBState with leading axis (n_banks,)."""
    single = init(n_entries, n_ways, device)
    return TLBState(*(x.expand((n_banks,) + x.shape).clone()
                      for x in single))


def probe_bank(state: TLBState, vpn, asid, active, time
               ) -> Tuple[TLBState, torch.Tensor]:
    """Probe a bank of TLBs, one request per bank. vpn/asid/active:
    (..., B) for a bank of (..., B, sets, ways): `probe` with one lane
    per TLB."""
    state, hit = probe(state, vpn[..., None], asid[..., None],
                       active[..., None], time)
    return state, hit[..., 0]


def fill_bank(state: TLBState, vpn, asid, do_fill, time) -> TLBState:
    """Fill a bank of TLBs, one request per bank. vpn/asid/do_fill:
    (..., B): `fill` with one lane per TLB."""
    return fill(state, vpn[..., None], asid[..., None], do_fill[..., None],
                time)


def access_fused(state: TLBState, vpn, asid, active, may_fill, time: int,
                 n_waves: int = 1, track_asids: bool = True,
                 backend: str | None = None,
                 ) -> Tuple[TLBState, torch.Tensor, torch.Tensor]:
    """One-call probe+fill for a whole cycle's sub-accesses ("waves").

    Same contract as the reference (`repro.core.tlb.access_fused`): the
    lanes are `n_waves` contiguous equal groups; one fill per set per wave
    (first candidate wins), per-position duplicate suppression across
    waves, k-th-LRU victim chains, forwarding from the post-fill table,
    and at most n_ways fills per set per cycle. Where a pre-hit lane and a
    same-cycle winner write one slot, the higher lane index wins, as the
    reference's serial scatter gives.

    The round runs in `kernels/fused_tlb`: the CUDA kernel on a CUDA
    tensor (one thread block per row, all rows in one launch), the plain
    PyTorch round on a CPU tensor, called as `ops.fused_tlb_access` with
    the host int `time` (or through `split_rounds`' splitter while a step
    is captured). `backend` ("cuda" or "torch"), where
    given, states which one the caller expects, as the reference's
    `backend=` names its implementation; a mismatch raises. The
    tags/asids/lru planes are updated in place and returned, as the
    hardware structure is; the hit/miss counters are computed here for
    both. Planes (..., sets, ways), lanes (..., N), at most one leading
    row axis.
    Returns (state', hit (..., N) bool, filled (..., N) bool).
    """
    if backend is not None and backend != ("cuda" if vpn.is_cuda
                                           else "torch"):
        raise ValueError(f"tlb backend {backend!r} does not run on device "
                         f"{vpn.device}")
    args = (state.tags, state.asids, state.lru, vpn, asid, active, may_fill,
            time)
    kwargs = dict(n_waves=n_waves, track_asids=track_asids)
    if _split is None:
        out = fused_ops.fused_tlb_access(*args, **kwargs)
    else:
        out = _split(fused_ops.fused_tlb_access, args, kwargs)
    tags, asids, lru, hit_i, filled_i = out
    hit = hit_i != 0
    filled = filled_i != 0
    hits = state.hits + hit.sum(-1, dtype=torch.int32)
    misses = state.misses + (active & ~hit).sum(-1, dtype=torch.int32)
    return (state._replace(tags=tags, asids=asids, lru=lru, hits=hits,
                           misses=misses), hit, filled)


def flush_asid(state: TLBState, asid: int) -> TLBState:
    """TLB shootdown for one address space (paper §5.1), in every row."""
    kill = state.asids == asid
    return state._replace(tags=state.tags.masked_fill(kill, -1),
                          asids=state.asids.masked_fill(kill, -1))


def occupancy_by_asid(state: TLBState, n_asids: int, rows: bool = False
                      ) -> torch.Tensor:
    """(n_asids,) live-entry counts over every entry axis (banked states
    too), or (R, n_asids) per row with `rows=True` for a state whose
    leading axis is the row axis.

    An ASID outside 0..n_asids-1 (such as -1) counts nowhere, as the
    reference's one-hot does."""
    valid = state.tags >= 0
    ids = torch.arange(n_asids, device=state.asids.device)
    oh = (state.asids[..., None] == ids) & valid[..., None]
    lead = state.tags.shape[:1] if rows else ()
    return oh.reshape(lead + (-1, n_asids)).sum(-2, dtype=torch.int32)
