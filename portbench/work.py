"""The work of one fused TLB round, counted from its inputs and outputs,
and the least time the H100 could take for it.

Bytes: the tag row (and the asid row when tracked) of each set an active
lane maps to, and the LRU row of each set with a winner, read once; each
plane word the round changes, written once; the lane inputs read once
(vpn, and asid when tracked, int32; active, may_fill bool); hit/filled
written (int32). Operations: each active lane compares its line with its
set's ways twice (probe and post-fill probe; twice as many compares with
asids), with its own lines of every earlier wave, and each winner ranks
its set's ways once. The least time is the larger of the bytes over the
HBM rate and the operations over the CUDA cores' rate: the round's
integer compares run on the CUDA cores, at no higher a rate than their
float32 one.
"""
from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
CUDA_CORE_OPS_PER_S = 67e12          # float32 outside the tensor cores


def least_time(nbytes, ops):
    """(ms, "bytes" | "operations"): the least time and what bounds it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def round_work(case, out):
    """(bytes, operations) of one round without a row axis: `case` holds
    the inputs as numpy arrays (tags, asids, lru, vpn, asid, active,
    may_fill, n_waves, track_asids), `out` the round's (tags, asids, lru,
    hit, filled)."""
    sets, ways = case["tags"].shape
    N, W = len(case["vpn"]), case["n_waves"]
    track = case["track_asids"]
    act = np.asarray(case["active"], bool)
    filled = np.asarray(out[4]).astype(bool)
    set_of = np.asarray(case["vpn"], np.int64) % sets    # floor mod
    probed = len(np.unique(set_of[act])) * (2 if track else 1)
    ranked = len(np.unique(set_of[filled]))
    changed = sum(int((np.asarray(new) != case[k]).sum())
                  for k, new in zip(("tags", "asids", "lru"), out[:3]))
    nbytes = ((probed + ranked) * ways * 4 + changed * 4
              + N * (4 * (2 if track else 1) + 2) + N * 8)
    wave = np.arange(N) // (N // W)
    ops = (2 * int(act.sum()) * ways * (2 if track else 1)
           + int(wave[act].sum()) + int(filled.sum()) * ways)
    return nbytes, ops


def _sets_touched(set_of, mask, sets):
    """(R,) count of distinct sets among each row's masked lanes."""
    R = set_of.shape[0]
    hit = torch.zeros((R, sets + 1), dtype=torch.bool, device=set_of.device)
    hit.scatter_(1, torch.where(mask, set_of, sets), True)
    return hit[:, :sets].sum(-1)


def round_work_rows(before, vpn, active, out, n_waves, track_asids):
    """(bytes, operations) of one round over a row axis, summed over its
    rows, computed on the round's device: `round_work` of each row.
    `before` is (tags, asids, lru) as they were before the round, (R,
    sets, ways); vpn/active (R, N); `out` the round's (tags, asids, lru,
    hit, filled)."""
    R, sets, ways = before[0].shape
    N = vpn.shape[-1]
    mult = 2 if track_asids else 1
    act = active.bool()
    filled = out[4].bool()
    set_of = torch.remainder(vpn.long(), sets)
    probed = int(_sets_touched(set_of, act, sets).sum()) * mult
    ranked = int(_sets_touched(set_of, filled, sets).sum())
    changed = sum(int((new != old).sum()) for new, old in zip(out[:3],
                                                               before))
    nbytes = ((probed + ranked) * ways * 4 + changed * 4
              + R * N * (4 * mult + 2) + R * N * 8)
    wave = torch.arange(N, device=vpn.device) // (N // n_waves)
    ops = (2 * int(act.sum()) * ways * mult
           + int((wave * act).sum()) + int(filled.sum()) * ways)
    return nbytes, ops
