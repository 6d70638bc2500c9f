"""TLB-Request-Aware L2 Bypass (paper §5.3).

Memory requests carry a 3-bit page-walk-depth tag (0 = data, 1..6 = walk
level, 7 = deeper). A walk level may fill the shared L2 data cache only
while its previous-epoch hit rate is at least the data hit rate; every
4th epoch samples (all levels fill) so a bypassed level can recover.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MAX_DEPTH = 8  # tag values 0..7
SAMPLE_EVERY = 4


class BypassState(NamedTuple):
    hits: torch.Tensor       # (MAX_DEPTH,) per-tag L2 hits this epoch
    accesses: torch.Tensor   # (MAX_DEPTH,)
    rate_q10: torch.Tensor   # (MAX_DEPTH,) int32 prev-epoch rate in 1/1024
    have_rates: torch.Tensor  # () bool: at least one epoch measured
    epoch_idx: torch.Tensor   # () int32


def init(device) -> BypassState:
    i32 = dict(dtype=torch.int32, device=device)
    return BypassState(hits=torch.zeros(MAX_DEPTH, **i32),
                       accesses=torch.zeros(MAX_DEPTH, **i32),
                       rate_q10=torch.zeros(MAX_DEPTH, **i32),
                       have_rates=torch.zeros((), dtype=torch.bool,
                                              device=device),
                       epoch_idx=torch.zeros((), **i32))


def record(state: BypassState, depth_tag, hit, active) -> BypassState:
    depth = depth_tag.long()
    h = torch.zeros_like(state.hits).index_add_(
        -1, depth, (active & hit).to(torch.int32))
    a = torch.zeros_like(state.accesses).index_add_(
        -1, depth, active.to(torch.int32))
    return state._replace(hits=state.hits + h, accesses=state.accesses + a)


def should_fill(state: BypassState, depth_tag) -> torch.Tensor:
    """(N,) bool (rows: (R, N)): may this request fill the shared L2 data
    cache? depth_tag: (N,), the same in every row."""
    sampling = (state.epoch_idx % SAMPLE_EVERY) == 0
    level_ok = (state.rate_q10 >= state.rate_q10[..., :1]) \
        | ~state.have_rates[..., None] | sampling[..., None]
    # data (depth 0) always fills; a fill kernel, not a host-to-device
    # copy of a Python scalar, so no host sync
    level_ok = torch.cat([torch.ones_like(level_ok[..., :1]),
                          level_ok[..., 1:]], -1)
    return level_ok[..., depth_tag.long()]


def epoch_update(state: BypassState) -> BypassState:
    """Latch this epoch's rates for next epoch's decisions; reset counters."""
    measured = state.accesses > 32
    rate = (state.hits * 1024) // state.accesses.clamp(min=1)
    # unmeasured levels inherit the previous estimate
    rate = torch.where(measured, rate, state.rate_q10)
    return BypassState(
        hits=torch.zeros_like(state.hits),
        accesses=torch.zeros_like(state.accesses),
        rate_q10=rate.to(torch.int32),
        have_rates=state.have_rates | measured[..., 0],
        epoch_idx=state.epoch_idx + 1,
    )
