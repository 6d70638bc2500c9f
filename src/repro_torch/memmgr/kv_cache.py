"""Physical paged KV pool + MASK-style translation caching for serving
(port of `repro.memmgr.kv_cache`).

The pool is (n_pages, page_size, KV, dh) per layer; tenants (ASIDs) own
disjoint page sets enforced by `block_table.translate`. A small software
translation cache (`core.tlb`, ASID-tagged, the same structure as the
hardware L2 TLB) fronts the two-level table; per-tenant fill tokens
(`core.tokens`) throttle which decode streams may install entries when
tenants thrash it. `kernels/paged_attention` reads K/V through the block
table that `gather_block_table` hands out.

Differences from the reference, none of them in results:
* the translation cache's logical clock is a host int, so a lookup reads
  nothing back from the card;
* `write_kv` writes the new token's K/V into the pool's k/v tensors IN
  PLACE (the pool holds gigabytes; the reference returns new arrays); the
  tables, lengths and translation state are new tensors, as in the
  reference;
* `append_token_alloc` allocates `need_page` pages (0 or 1) where the
  reference branches with `lax.cond`: the same tables and `ok` without
  reading `need_page` on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import tlb as tlb_mod
from repro_torch.core import tokens as tok_mod
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.memmgr import block_table as bt_mod
from repro_torch.models.convert import tensor_from_numpy, tensor_to_numpy


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    n_pages: int
    page_size: int
    n_kv: int
    head_dim: int
    n_layers: int
    max_seqs: int
    pages_per_seq: int
    max_tenants: int = 8
    seqs_per_tenant: int = 64
    tcache_entries: int = 256
    tcache_ways: int = 8


class KVPool(NamedTuple):
    k: torch.Tensor                 # (L, n_pages, page, KV, dh) bf16
    v: torch.Tensor
    tables: bt_mod.BlockTables
    tcache: tlb_mod.TLBState        # translation cache over (seq, page) keys
    tokens: tok_mod.TokenState      # per-tenant fill tokens
    seq_lens: torch.Tensor          # (max_seqs,) int32
    seq_asid: torch.Tensor          # (max_seqs,) int32
    clock: int                      # logical time for LRU, on the host


def init(cfg: PoolConfig, device: DeviceLike = None) -> KVPool:
    """An empty pool on `device` (None means the card, and raises without
    one)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, cfg.n_pages, cfg.page_size, cfg.n_kv,
             cfg.head_dim)
    i32 = dict(dtype=torch.int32, device=dev)
    return KVPool(
        k=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        v=torch.zeros(shape, dtype=torch.bfloat16, device=dev),
        tables=bt_mod.init(cfg.n_pages, cfg.max_seqs, cfg.pages_per_seq,
                           cfg.max_tenants, cfg.seqs_per_tenant, dev),
        tcache=tlb_mod.init(cfg.tcache_entries, cfg.tcache_ways, dev),
        tokens=tok_mod.init(cfg.max_tenants,
                            torch.full((cfg.max_tenants,), cfg.max_seqs,
                                       **i32)),
        seq_lens=torch.zeros((cfg.max_seqs,), **i32),
        seq_asid=torch.full((cfg.max_seqs,), -1, **i32),
        clock=0,
    )


def _i32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int32, device=device)


def _set(plane: torch.Tensor, slot: torch.Tensor, value) -> torch.Tensor:
    """`plane.at[slot].set(value)` for a 0-d slot: a new tensor."""
    return plane.index_copy(0, slot.long().reshape(1),
                            _i32(value, plane.device).reshape(1))


def lookup(cfg: PoolConfig, pool: KVPool, seq_slot, logical_page
           ) -> Tuple[KVPool, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched translation through the cache. seq_slot/logical_page: (N,)
    int32. Returns (pool', phys_page, fault, tcache_hit)."""
    asid = pool.seq_asid[seq_slot.long()]
    key = seq_slot * cfg.pages_per_seq + logical_page
    active = torch.ones(key.shape, dtype=torch.bool, device=key.device)
    tc, hit = tlb_mod.probe(pool.tcache, key, asid, active, pool.clock)
    phys, fault = bt_mod.translate(pool.tables, seq_slot, logical_page, asid)
    # the reference counts tenant max(asid, 0) by a one-hot (a tenant past
    # max_tenants counts nowhere) and reads its tokens by a clamped gather
    app = asid.clamp(min=0)
    counted = app < cfg.max_tenants
    app = app.clamp(max=cfg.max_tenants - 1)
    tokens = tok_mod.record(pool.tokens, app, hit, active & counted)
    # fill policy: misses fill only when the tenant holds tokens
    has_tok = tok_mod.has_token(tokens, app, seq_slot % cfg.seqs_per_tenant)
    tc = tlb_mod.fill(tc, key, asid, ~hit & ~fault & has_tok, pool.clock)
    return pool._replace(tcache=tc, tokens=tokens,
                         clock=pool.clock + 1), phys, fault, hit


def admit_seq(cfg: PoolConfig, pool: KVPool, seq_slot, asid, prompt_len
              ) -> Tuple[KVPool, torch.Tensor]:
    """Admit a sequence: allocate pages for the prompt. Returns (pool',
    ok), ok a 0-d bool tensor."""
    dev = pool.seq_lens.device
    seq_slot, asid, prompt_len = (_i32(v, dev)
                                  for v in (seq_slot, asid, prompt_len))
    pages = (prompt_len + cfg.page_size - 1) // cfg.page_size
    tables, ok = bt_mod.alloc_pages(pool.tables, seq_slot, 0, pages, asid)
    slot = seq_slot.long()
    return pool._replace(
        tables=tables,
        seq_lens=_set(pool.seq_lens, seq_slot,
                      torch.where(ok, prompt_len, pool.seq_lens[slot])),
        seq_asid=_set(pool.seq_asid, seq_slot,
                      torch.where(ok, asid, pool.seq_asid[slot]))), ok


def append_token_alloc(cfg: PoolConfig, pool: KVPool, seq_slot
                       ) -> Tuple[KVPool, torch.Tensor]:
    """Grow a sequence by one token; allocates a new page on a boundary.

    The reference allocates one page under `lax.cond(need_page, ...)`;
    here `alloc_pages` takes count = need_page (0 or 1). With count 0 it
    maps nothing, moves no free-list head and reports ok (a sequence off
    a page boundary has len // page < pages_per_seq), so the tables and
    ok equal the reference's without a host read."""
    dev = pool.seq_lens.device
    seq_slot = _i32(seq_slot, dev)
    slot = seq_slot.long()
    ln = pool.seq_lens[slot]
    need_page = (ln % cfg.page_size) == 0
    tables, ok = bt_mod.alloc_pages(pool.tables, seq_slot,
                                    ln // cfg.page_size,
                                    need_page.to(torch.int32),
                                    pool.seq_asid[slot])
    return pool._replace(
        tables=tables,
        seq_lens=_set(pool.seq_lens, seq_slot,
                      torch.where(ok, ln + 1, ln))), ok


def release_seq(cfg: PoolConfig, pool: KVPool, seq_slot) -> KVPool:
    seq_slot = _i32(seq_slot, pool.seq_lens.device)
    return pool._replace(
        tables=bt_mod.free_seq(pool.tables, seq_slot),
        seq_lens=_set(pool.seq_lens, seq_slot, 0),
        seq_asid=_set(pool.seq_asid, seq_slot, -1))


def write_kv(cfg: PoolConfig, pool: KVPool, layer: int, seq_slots, k_new,
             v_new) -> Tuple[KVPool, torch.Tensor]:
    """Write one new token's K/V for a batch of sequences at `layer`, into
    the pool's k/v IN PLACE. k_new/v_new: (B, KV, dh). Returns (pool',
    fault).

    A faulted lane is sent to page 0 and writes back the value it read
    there. Where two lanes name one (page, offset) cell, the HIGHER lane
    wins, as in the reference's scatter (XLA applies updates in lane
    order): a faulted lane after a live one on the same cell undoes the
    live lane's write. Every lane writes its cell's winning value, so the
    duplicate indices of the scatter carry equal values and any order of
    the card's writes gives that result."""
    ln = pool.seq_lens[seq_slots.long()] - 1      # position of the new token
    logical = ln // cfg.page_size
    offset = (ln % cfg.page_size).long()
    pool, phys, fault, _ = lookup(cfg, pool, seq_slots, logical)
    phys = phys.long()
    cell = phys * cfg.page_size + offset
    lanes = torch.arange(cell.shape[0], device=cell.device)
    winner = torch.where(cell[:, None] == cell[None, :], lanes[None, :],
                         -1).amax(dim=1)
    keep = fault[:, None, None]
    for plane, new in ((pool.k[layer], k_new), (pool.v[layer], v_new)):
        val = torch.where(keep, plane[phys, offset], new.to(plane.dtype))
        plane.index_put_((phys, offset), val[winner])
    return pool, fault


def gather_block_table(cfg: PoolConfig, pool: KVPool, seq_slots
                       ) -> torch.Tensor:
    """(B, pages_per_seq) physical page ids for the paged-attention kernel
    (unmapped entries read page 0; the kernel masks them by length)."""
    return pool.tables.leaf[seq_slots.long()].clamp(min=0)


# The reference's jitted entry points; the port runs eagerly.
admit_seq_jit = admit_seq
append_token_alloc_jit = append_token_alloc
release_seq_jit = release_seq


class PoolPressure(NamedTuple):
    """Host-side occupancy snapshot for admission/placement decisions."""

    used_frac: float                  # fraction of physical pages in use
    free_pages: int
    free_seqs: int                    # unoccupied sequence slots
    pages_by_tenant: Dict[int, int]   # ASID -> pages held


# ASID reserved for fault-injected phantom sequences (pool-exhaustion
# spikes): far outside any tenant universe, filtered out of per-tenant
# page attribution but counted in used_frac: the spike IS the pressure.
PHANTOM_ASID = 1_000_003


def occupy_pages(cfg: PoolConfig, pool: KVPool, free_slots: list,
                 pages: int) -> Tuple[KVPool, list]:
    """Admit phantom sequences under `PHANTOM_ASID` occupying up to
    `pages` KV pages (a deterministic pool-exhaustion spike for fault
    injection). Consumes slots from `free_slots` (mutated in place);
    stops early when the pool or the slot list runs out. Returns (pool',
    used_slots); the caller releases each slot through `release_seq` to
    end the spike. Reads each admission's ok on the host."""
    used: list = []
    left = int(pages)
    while left > 0 and free_slots:
        take = min(left, cfg.pages_per_seq)
        slot = free_slots.pop()
        pool, ok = admit_seq(cfg, pool, slot, PHANTOM_ASID,
                             take * cfg.page_size)
        if not bool(ok):
            free_slots.append(slot)
            break
        used.append(slot)
        left -= take
    return pool, used


def pool_pressure(cfg: PoolConfig, pool: KVPool) -> PoolPressure:
    """Surface KV-pool pressure to the placement layer (one small
    device->host transfer)."""
    owner = pool.tables.owner.cpu().numpy()
    seq_asid = pool.seq_asid.cpu().numpy()
    free = int(cfg.n_pages - (owner >= 0).sum())
    live = owner[owner >= 0]
    by_tenant = {int(t): int((live == t).sum()) for t in np.unique(live)}
    return PoolPressure(
        used_frac=1.0 - free / max(cfg.n_pages, 1),
        free_pages=free,
        free_seqs=int((seq_asid < 0).sum()),
        pages_by_tenant=by_tenant)


# ---------------------------------------------------------------------------
# Carrier: the reference's pool <-> the port's, through numpy
# ---------------------------------------------------------------------------

_PARTS = {"tables": bt_mod.BlockTables, "tcache": tlb_mod.TLBState,
          "tokens": tok_mod.TokenState}


def pool_from_numpy(ref_pool, device: DeviceLike = None) -> KVPool:
    """A reference pool fetched to the host (`jax.device_get` of a
    `repro.memmgr.kv_cache.KVPool`: NamedTuples of numpy arrays, k/v in
    JAX's bfloat16) -> the port's pool on `device`, bit for bit."""
    dev = resolve_device(device)

    def part(cls, src):
        return cls(*(tensor_from_numpy(getattr(src, f), dev)
                     for f in cls._fields))

    fields = {}
    for f in KVPool._fields:
        src = getattr(ref_pool, f)
        if f in _PARTS:
            fields[f] = part(_PARTS[f], src)
        elif f == "clock":
            fields[f] = int(src)
        else:
            fields[f] = tensor_from_numpy(src, dev)
    return KVPool(**fields)


def pool_to_numpy(pool: KVPool) -> Dict[str, object]:
    """The port's pool -> nested dicts of numpy arrays keyed by field name
    (k/v widened to float32 exactly; the clock as an int32 scalar), the
    reference's NamedTuples' fields in the same order."""
    out: Dict[str, object] = {}
    for f in KVPool._fields:
        val = getattr(pool, f)
        if f in _PARTS:
            out[f] = {g: tensor_to_numpy(getattr(val, g))
                      for g in _PARTS[f]._fields}
        elif f == "clock":
            out[f] = np.int32(val)
        else:
            out[f] = tensor_to_numpy(val)
    return out
