"""The fused cross-wave probe+fill round of the shared caches, in plain
PyTorch: the one round a cycle runs over the L2 data cache (and the PWC)
for every lane at once. Like the hardware structure, it updates the
tags/asids/lru planes in place.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def _layout(N: int, W: int, device: torch.device):
    """Lane order, wave of each lane, (N, W) earlier-wave mask and
    (W, W, 1) strictly-earlier-wave mask ([j, i]: wave j before wave i)."""
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

    tags/asids/lru: (sets, ways) int32, or (R, sets, ways) for R rows,
    each an independent round; updated in place and returned.
    vpn/asid: (N,) int32 (rows: (R, N)); active/may_fill: (N,) bool; N
    divisible by n_waves. The rows share `time`, `n_waves` and
    `track_asids`. hit/filled come back as (N,) (rows: (R, N)) int32
    masks. Every scatter runs along a row's own flattened plane, so rows
    never collide."""
    if tags.dim() == 2:                 # one round: a row axis of one
        *_, hit, filled = fused_tlb_access_ref(
            tags[None], asids[None], lru[None], vpn[None], asid[None],
            active[None], may_fill[None], time, n_waves=n_waves,
            track_asids=track_asids)
        return tags, asids, lru, hit[0], filled[0]
    R, n_sets, n_ways = tags.shape
    N = vpn.shape[-1]
    W = n_waves
    if N % W:
        raise ValueError(f"lane count {N} not divisible by n_waves={W}")
    C = N // W
    dev = vpn.device
    order, wave, earlier_w, tri_w = _layout(N, W, dev)
    lane = order.expand(R, N)
    set_ix = ((vpn % n_sets).long() if n_sets > 1
              else torch.zeros((R, N), dtype=torch.long, device=dev))

    def set_rows(plane):                # (R, N, ways)
        return plane.gather(1, set_ix[..., None].expand(R, N, n_ways))

    match = set_rows(tags) == vpn[..., None]
    if track_asids:
        match = match & (set_rows(asids) == asid[..., None])
    pre_hit = match.any(-1) & active
    way = match.to(torch.int32).argmax(-1)

    # ---- fill candidates, per-position duplicate suppression -------------
    cand = active & ~pre_hit & may_fill
    if W > 1:
        lines_wc = vpn.reshape(R, W, 1, C)
        cand_wc = cand.reshape(R, W, 1, C)
        dup = ((lines_wc == vpn.reshape(R, 1, W, C)) & tri_w & cand_wc) \
            .any(1).reshape(R, N)
        cand = cand & ~dup

    # ---- per-(set, wave) fill port: first candidate wins -----------------
    key = set_ix * W + wave
    port = torch.full((R, n_sets * W + 1), N, dtype=torch.long, device=dev)
    port.scatter_reduce_(1, torch.where(cand, key, n_sets * W), lane,
                         reduce="amin")
    port = port[:, :-1]
    winner = cand & (port.gather(1, key) == order)
    filled_sw = (port.reshape(R, n_sets, W) < N).gather(
        1, set_ix[..., None].expand(R, N, W))                    # (R, N, W)
    rank = (filled_sw & earlier_w).sum(-1)
    # a set takes at most n_ways fills per cycle
    winner = winner & (rank < n_ways)

    # ---- victim: the rank-th way in stable (lru, way) order ---------------
    by_age = set_rows(lru).sort(dim=-1, stable=True).indices     # (R, N, ways)
    victim = by_age.gather(-1, rank.clamp(max=n_ways - 1)[..., None])[..., 0]

    # ---- one merged write: pre-hits touch their way, winners fill ---------
    trash = n_sets * n_ways
    flat = torch.where(pre_hit, set_ix * n_ways + way,
                       torch.where(winner, set_ix * n_ways + victim, trash))
    # a pre-hit lane and a winner can name one slot (victims come from the
    # start-of-cycle LRU); the higher lane index wins that slot
    owner = torch.full((R, trash + 1), -1, dtype=torch.long, device=dev)
    owner.scatter_reduce_(1, flat, lane, reduce="amax")
    flat = torch.where(owner.gather(1, flat) == order, flat, trash)
    planes = [(tags, vpn), (lru, time)] + (
        [(asids, asid)] if track_asids else [])
    for plane, val in planes:
        ext = torch.cat([plane.reshape(R, trash), plane.new_empty(R, 1)], 1)
        ext.scatter_(1, flat, val)
        plane.copy_(ext[:, :-1].reshape(plane.shape))

    # ---- final hit resolution against the post-fill table (forwarding) ---
    post = set_rows(tags) == vpn[..., None]
    if track_asids:
        post = post & (set_rows(asids) == asid[..., None])
    hit = pre_hit | (active & ~winner & post.any(-1))
    return (tags, asids, lru, hit.to(torch.int32), winner.to(torch.int32))
