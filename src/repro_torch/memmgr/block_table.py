"""Two-level block tables for the multi-tenant paged KV cache (port of
`repro.memmgr.block_table`).

Logical layout per tenant: sequence -> logical pages -> physical page slots
in the shared pool. The *root* level (per-tenant page directory) is tiny
and hot; leaf rows stream.

The functions are functional, as the reference's are: each returns new
tables and leaves its input as it was. Scalars (slot, page, count, asid)
may be Python ints or 0-d integer tensors on the tables' device; nothing
here reads a tensor back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

FREE = -1


class BlockTables(NamedTuple):
    leaf: torch.Tensor        # (max_seqs, pages_per_seq) physical page or -1
    root: torch.Tensor        # (max_tenants, seqs_per_tenant) slot or -1
    owner: torch.Tensor       # (n_pages,) owner asid or -1 (§5.1)
    free_head: torch.Tensor   # () int32: count of allocated pages
    free_list: torch.Tensor   # (n_pages,) int32 permutation of page ids


def init(n_pages: int, max_seqs: int, pages_per_seq: int, max_tenants: int,
         seqs_per_tenant: int, device: DeviceLike = None) -> BlockTables:
    """Empty tables on `device` (None means the card, and raises without
    one)."""
    i32 = dict(dtype=torch.int32, device=resolve_device(device))
    return BlockTables(
        leaf=torch.full((max_seqs, pages_per_seq), FREE, **i32),
        root=torch.full((max_tenants, seqs_per_tenant), FREE, **i32),
        owner=torch.full((n_pages,), FREE, **i32),
        free_head=torch.zeros((), **i32),
        free_list=torch.arange(n_pages, **i32),
    )


def _i32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int32, device=device)


def n_free(bt: BlockTables) -> torch.Tensor:
    return bt.free_list.shape[0] - bt.free_head


def alloc_pages(bt: BlockTables, seq_slot, start_page, count, asid
                ) -> Tuple[BlockTables, torch.Tensor]:
    """Allocate `count` physical pages for seq_slot's logical pages
    [start_page, start_page+count). Returns (bt', ok), ok a 0-d bool.

    An allocation past the sequence's logical capacity fails WHOLE: a page
    granted but unmappable would hold an owner while no leaf entry
    references it, and `free_seq` could never reclaim it."""
    dev = bt.leaf.device
    seq_slot, start_page, count, asid = (
        _i32(v, dev) for v in (seq_slot, start_page, count, asid))
    max_count = bt.leaf.shape[1]
    n_pages = bt.owner.shape[0]
    idx = torch.arange(max_count, dtype=torch.int32, device=dev)
    take = idx < count
    ok = (count <= n_free(bt)) & (start_page + count <= max_count)
    phys = bt.free_list[((bt.free_head + idx) % n_pages).long()]
    phys = torch.where(take & ok, phys, FREE)
    logical = start_page + idx
    write = take & ok & (logical < max_count)
    # inactive lanes scatter into a trash slot (never into index 0: a stale
    # read-back there would clobber an active lane's write)
    row = torch.cat([bt.leaf[seq_slot.long()],
                     torch.zeros(1, dtype=torch.int32, device=dev)])
    row = row.index_put((torch.where(write, logical, max_count).long(),),
                        torch.where(write, phys, 0))
    leaf = bt.leaf.index_copy(0, seq_slot.long().reshape(1),
                              row[None, :max_count])
    owner = torch.cat([bt.owner,
                       torch.zeros(1, dtype=torch.int32, device=dev)])
    owner = owner.index_put((torch.where(phys >= 0, phys, n_pages).long(),),
                            torch.where(phys >= 0, asid, 0))
    head = bt.free_head + torch.where(ok, count, 0)
    return bt._replace(leaf=leaf, owner=owner[:n_pages], free_head=head), ok


def free_seq(bt: BlockTables, seq_slot) -> BlockTables:
    """Return a sequence's pages to the pool (lazy free-list append)."""
    dev = bt.leaf.device
    slot = _i32(seq_slot, dev).long()
    row = bt.leaf[slot]
    n_pages = bt.owner.shape[0]
    live = row >= 0
    n = live.sum(dtype=torch.int32)
    # compact the freed ids to the tail region of the ring
    order = torch.argsort((~live).to(torch.int32), stable=True)
    freed = row[order]
    start = bt.free_head - n
    lanes = torch.arange(row.shape[0], dtype=torch.int32, device=dev)
    pos = ((start + lanes) % n_pages).long()
    free_list = bt.free_list.index_put(
        (pos,), torch.where(lanes < n, freed, bt.free_list[pos]))
    owner = torch.cat([bt.owner,
                       torch.zeros(1, dtype=torch.int32, device=dev)])
    owner = owner.index_put((torch.where(live, row, n_pages).long(),),
                            torch.full_like(row, FREE))
    leaf = bt.leaf.index_fill(0, slot.reshape(1), FREE)
    return bt._replace(leaf=leaf, owner=owner[:n_pages], free_list=free_list,
                       free_head=start)


def translate(bt: BlockTables, seq_slot, logical_page, asid
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logical page -> physical page with protection check.

    Returns (phys, fault): fault is True on an unmapped page or an ASID
    mismatch (cross-address-space access attempt), and phys is 0 there."""
    phys = bt.leaf[seq_slot.long(), logical_page.long()]
    bad = (phys < 0) | (bt.owner[phys.clamp(min=0).long()] != asid)
    return torch.where(bad, 0, phys), bad
