"""Plain PyTorch version of the fused cross-wave TLB round.

The same function as the CUDA kernel (`csrc/fused_tlb.cu`) and as the
reference's `repro.core.tlb.access_fused` round, written with tensor ops.
The CPU path of the port runs it, the parity tests hold it against the
reference, and `chip_smoke.py` holds the kernel against it on the card.
The card's main path never calls it.

Like the kernel, it updates the tags/asids/lru planes in place.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def _layout(N: int, W: int, device: torch.device):
    """Lane order, wave of each lane, (N, W) earlier-wave mask and
    (W, W, 1) strictly-earlier-wave mask."""
    order = torch.arange(N, device=device)
    wave = order // (N // W)
    w_ix = torch.arange(W, device=device)
    earlier_w = w_ix[None, :] < wave[:, None]
    tri_w = w_ix[:, None, None] < w_ix[None, :, None]
    return order, wave, earlier_w, tri_w


def fused_tlb_access_ref(tags, asids, lru, vpn, asid, active, may_fill,
                         time: int, *, n_waves: int = 1,
                         track_asids: bool = True):
    """One fused probe+fill round; returns (tags, asids, lru, hit, filled).

    tags/asids/lru: (sets, ways) int32, updated in place and returned.
    vpn/asid: (N,) int32; active/may_fill: (N,) bool; N divisible by
    n_waves. hit/filled come back as (N,) int32 masks."""
    n_sets, n_ways = tags.shape
    N = vpn.shape[0]
    W = n_waves
    if N % W:
        raise ValueError(f"lane count {N} not divisible by n_waves={W}")
    C = N // W
    dev = vpn.device
    order, wave, earlier_w, tri_w = _layout(N, W, dev)
    set_ix = ((vpn % n_sets).long() if n_sets > 1
              else torch.zeros(N, dtype=torch.long, device=dev))
    match = tags[set_ix] == vpn[:, None]
    if track_asids:
        match = match & (asids[set_ix] == asid[:, None])
    pre_hit = match.any(1) & active
    way = match.to(torch.int32).argmax(1)

    # ---- fill candidates, per-position duplicate suppression -------------
    cand = active & ~pre_hit & may_fill
    if W > 1:
        lines_wc = vpn.reshape(W, C)
        cand_wc = cand.reshape(W, C)
        dup = ((lines_wc[:, None, :] == lines_wc[None, :, :])
               & tri_w & cand_wc[:, None, :]).any(0).reshape(N)
        cand = cand & ~dup

    # ---- per-(set, wave) fill port: first candidate wins -----------------
    key = set_ix * W + wave
    port = torch.full((n_sets * W + 1,), N, dtype=torch.long, device=dev)
    port.scatter_reduce_(0, torch.where(cand, key, n_sets * W), order,
                         reduce="amin")
    port = port[:-1]
    winner = cand & (port[key] == order)
    filled_sw = (port.reshape(n_sets, W) < N)[set_ix]            # (N, W)
    rank = (filled_sw & earlier_w).sum(1)
    # a set takes at most n_ways fills per cycle
    winner = winner & (rank < n_ways)

    # ---- victim: the rank-th way in stable (lru, way) order ---------------
    by_age = lru[set_ix].sort(dim=1, stable=True).indices        # (N, ways)
    victim = by_age.gather(1, rank.clamp(max=n_ways - 1)[:, None])[:, 0]

    # ---- one merged write: pre-hits touch their way, winners fill ---------
    trash = n_sets * n_ways
    flat = torch.where(pre_hit, set_ix * n_ways + way,
                       torch.where(winner, set_ix * n_ways + victim, trash))
    # a pre-hit lane and a winner can name one slot (victims come from the
    # start-of-cycle LRU); the higher lane index wins that slot
    owner = torch.full((trash + 1,), -1, dtype=torch.long, device=dev)
    owner.scatter_reduce_(0, flat, order, reduce="amax")
    flat = torch.where(owner[flat] == order, flat, trash)
    planes = [(tags, vpn), (lru, None)] + (
        [(asids, asid)] if track_asids else [])
    for plane, val in planes:
        ext = torch.cat([plane.reshape(-1), plane.new_empty(1)])
        if val is None:
            ext.index_fill_(0, flat, time)
        else:
            ext.index_put_((flat,), val)
        plane.copy_(ext[:-1].reshape(plane.shape))

    # ---- final hit resolution against the post-fill table (forwarding) ---
    post = tags[set_ix] == vpn[:, None]
    if track_asids:
        post = post & (asids[set_ix] == asid[:, None])
    hit = pre_hit | (active & ~winner & post.any(1))
    return (tags, asids, lru, hit.to(torch.int32), winner.to(torch.int32))
