"""TLB-Fill Tokens (paper §5.2).

Every warp may probe the shared L2 TLB; only token-holding warps may fill
it. Token counts are per application and hill-climb each epoch on the
shared-TLB miss-rate delta. The float arithmetic runs in
`precision.FLOAT` (float32). Every field may carry a leading row axis.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import precision


class TokenState(NamedTuple):
    tokens: torch.Tensor          # (n_apps,) int32 current token count
    direction: torch.Tensor       # (n_apps,) int32 in {-1, +1}
    prev_miss_rate: torch.Tensor  # (n_apps,) float32
    epoch_hits: torch.Tensor      # (n_apps,) int32
    epoch_misses: torch.Tensor    # (n_apps,) int32
    first_epoch: torch.Tensor     # () bool: no bypassing during warm-up


def _per_row(knob):
    """A host knob as a Python float."""
    return float(np.float32(knob))


def init(n_apps: int, warps_per_app: torch.Tensor,
         initial_frac=np.float32(0.8)) -> TokenState:
    """warps_per_app: (n_apps,) int32 tensor on the state's device."""
    dev = warps_per_app.device
    i32 = dict(dtype=torch.int32, device=dev)
    return TokenState(
        tokens=(warps_per_app.to(precision.FLOAT) * _per_row(initial_frac))
        .to(torch.int32).clamp(min=1),
        # fills start restricted-downward; the climb reverses if that fails
        direction=torch.full((n_apps,), -1, **i32),
        prev_miss_rate=torch.ones(n_apps, dtype=precision.FLOAT, device=dev),
        epoch_hits=torch.zeros(n_apps, **i32),
        epoch_misses=torch.zeros(n_apps, **i32),
        first_epoch=torch.ones((), dtype=torch.bool, device=dev),
    )


def record(state: TokenState, app, hit, active) -> TokenState:
    """Accumulate per-app shared-TLB hit/miss counters. app: (N,), the
    same lane-to-app map in every row; hit/active: (N,) (rows: (R, N))."""
    h = torch.zeros_like(state.epoch_hits).index_add_(
        -1, app, (hit & active).to(torch.int32))
    m = torch.zeros_like(state.epoch_misses).index_add_(
        -1, app, (~hit & active).to(torch.int32))
    return state._replace(epoch_hits=state.epoch_hits + h,
                          epoch_misses=state.epoch_misses + m)


def epoch_update(state: TokenState, warps_per_app: torch.Tensor,
                 step_frac=np.float32(0.5), min_tokens: int = 1
                 ) -> TokenState:
    """End-of-epoch token adjustment (Fig. 13b hill-climb), in float32."""
    total = (state.epoch_hits + state.epoch_misses).clamp(min=1)
    miss_rate = (state.epoch_misses / total).to(precision.FLOAT)

    improved = miss_rate <= state.prev_miss_rate - np.float32(0.01).item()
    new_dir = torch.where(improved, state.direction, -state.direction)
    step = (state.tokens.to(precision.FLOAT) * _per_row(step_frac)) \
        .to(torch.int32).clamp(min=1)
    proposed = state.tokens + new_dir * step
    new_tokens = torch.minimum(proposed.clamp(min=min_tokens), warps_per_app)
    # bounce off the clip bounds instead of saturating there
    new_dir = torch.where(proposed != new_tokens, -new_dir, new_dir)
    # during the warm-up epoch no bypassing happens: only install baselines
    first = state.first_epoch[..., None]
    new_tokens = torch.where(first, state.tokens, new_tokens)
    new_dir = torch.where(first, state.direction, new_dir)

    return TokenState(
        tokens=new_tokens,
        direction=new_dir,
        prev_miss_rate=miss_rate,
        epoch_hits=torch.zeros_like(state.epoch_hits),
        epoch_misses=torch.zeros_like(state.epoch_misses),
        first_epoch=torch.zeros_like(state.first_epoch),
    )
