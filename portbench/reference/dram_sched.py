"""Address-Space-Aware DRAM Scheduler (paper §5.4).

Three queues per memory channel: Golden (all page-walk requests, FIFO,
always first), Silver (data requests of one application at a time, quota
per Eq. (1)), Normal (everything else, FR-FCFS). Each call ranks a batch
of requests and returns their latencies; the open rows, silver accounting
and per-class backlog update functionally. Every field carries a leading
row axis R, with lanes (R, N); per-lane scatters and gathers run along a
row's own flattened table, so rows never collide.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import precision

T_ROW_HIT = 100      # cycles: CAS-only access (GPU clock domain)
T_ROW_MISS = 250     # cycles: precharge + activate + CAS
T_QUEUE_UNIT = 50    # serialization per queued-ahead request


class DramState(NamedTuple):
    open_row: torch.Tensor        # (channels, banks) int32 open row id
    silver_app: torch.Tensor      # () int32: app currently owning Silver
    silver_left: torch.Tensor     # () int32: remaining silver quota
    conc_walks: torch.Tensor      # (n_apps,) int32 'Concurrent_i'
    warps_stalled: torch.Tensor   # (n_apps,) int32 'WrpStalled_i'
    queue_len: torch.Tensor       # (channels, 3) int32 backlog per class


def init(n_channels: int, n_banks: int, n_apps: int, device) -> DramState:
    i32 = dict(dtype=torch.int32, device=device)
    return DramState(
        open_row=torch.full((n_channels, n_banks), -1, **i32),
        silver_app=torch.zeros((), **i32),
        silver_left=torch.ones((), **i32),
        conc_walks=torch.zeros(n_apps, **i32),
        warps_stalled=torch.zeros(n_apps, **i32),
        queue_len=torch.zeros((n_channels, 3), **i32),
    )


def silver_quota(state: DramState, thres_max=500) -> torch.Tensor:
    """(n_apps,) (rows: (R, n_apps)) Eq. (1) thresholds, in float32. The
    weights are integers below 2**24, so their sum is exact in any order."""
    w = (state.conc_walks * state.warps_stalled).to(precision.FLOAT)
    tot = w.sum(-1, keepdim=True).clamp(min=1.0)
    return (thres_max * w / tot).to(torch.int32).clamp(min=1)


def classify(state: DramState, app, is_tlb, mask_enabled):
    """Queue class per request: 0 golden, 1 silver, 2 normal. Disabled
    means one FR-FCFS queue: everything is class 2. app/is_tlb: (N,),
    or (R, N) for a state with rows; `mask_enabled`: a bool."""
    if not mask_enabled:
        return torch.full_like(app, 2, dtype=torch.int32)
    silver = app == state.silver_app[..., None]
    return (2 - silver.to(torch.int32)).masked_fill(is_tlb, 0)


def access(state: DramState, channel, bank, row, app, is_tlb, active,
           mask_enabled, thres_max=500,
           fr_fcfs: bool = True, waves: int = 1
           ) -> Tuple[DramState, torch.Tensor]:
    """Batched DRAM access model. channel/bank/row/active: (N,), or (R, N)
    for a state with rows; app/is_tlb: (N,) shared by the rows, or (R, N).
    Returns (state', latency).

    Latency = service (row hit/miss) + (requests ranked ahead on the same
    (channel, bank) + standing backlog) * T_QUEUE_UNIT. `waves` splits the
    batch into contiguous equal groups queued independently, exactly as
    the sequential per-round calls were."""
    if state.open_row.dim() == 2:       # one DRAM: a row axis of one
        st, latency = access(
            DramState(*(x[None] for x in state)), channel[None], bank[None],
            row[None], app, is_tlb, active[None], mask_enabled, thres_max,
            fr_fcfs, waves)
        return DramState(*(x[0] for x in st)), latency[0]
    R, n_channels, n_banks = state.open_row.shape
    cls = classify(state, app, is_tlb, mask_enabled).expand(R, -1)
    dev = channel.device

    N = channel.shape[1]
    C = N // waves
    cb_flat = (channel * n_banks + bank).long()                  # (R, N)
    row_hit = state.open_row.reshape(R, -1).gather(1, cb_flat) == row
    act_w = active.reshape(R, waves, C)
    if waves > 1:
        # progressive open rows across waves, per flat position: [r, j, i]
        # is wave j before wave i
        row_w = row.reshape(R, waves, C)
        cb_w = cb_flat.reshape(R, waves, C)
        w_ix = torch.arange(waves, device=dev)
        tri_w = w_ix[:, None, None] < w_ix[None, :, None]
        opened = ((row_w[:, :, None] == row_w[:, None])
                  & (cb_w[:, :, None] == cb_w[:, None])
                  & tri_w & act_w[:, :, None]).any(1).reshape(R, N)
        row_hit = row_hit | opened
    service = torch.where(row_hit, T_ROW_HIT, T_ROW_MISS).to(torch.int32)

    # rank = requests ahead of me on my (channel, bank) within my wave;
    # [r, w, i, j] is lane j against lane i
    cb = cb_flat.reshape(R, waves, 1, C)
    key = cls * 2 + (~row_hit).to(torch.int32) if fr_fcfs else cls * 2
    key = key.reshape(R, waves, 1, C)
    key_i = key.transpose(2, 3)
    c_ix = torch.arange(C, device=dev)
    tri = c_ix[None, :] < c_ix[:, None]                       # j before i
    ahead = (cb == cb.transpose(2, 3)) & act_w[:, :, None] \
        & ((key < key_i) | ((key == key_i) & tri))
    n_ahead = ahead.sum(-1, dtype=torch.int32).reshape(R, N)

    # standing backlog + EWMA decay toward the observed per-class pressure,
    # chained once per wave; each wave reads the backlog its round saw.
    # (wave, channel, class) of each lane, flat within its row:
    act_i = active.to(torch.int32)
    wave_ix = torch.arange(N, device=dev) // C
    wcc = (wave_ix * n_channels + channel.long()) * 3 + cls.long()
    counts = torch.zeros((R, waves * n_channels * 3), dtype=torch.int32,
                         device=dev).scatter_add_(1, wcc, act_i) \
        .reshape(R, waves, n_channels, 3)
    qs = []
    queue_len = state.queue_len
    for counts_k in counts.unbind(1):
        qs.append(queue_len)
        queue_len = torch.add(counts_k, queue_len, alpha=3) // 4
    backlog = torch.stack(qs, 1).reshape(R, -1).gather(1, wcc)

    latency = service + (n_ahead + backlog) * T_QUEUE_UNIT
    latency = latency * act_i

    # ---- state updates ----
    # open rows: the LAST active request per (channel, bank) wins, as a
    # serial scatter gives; scatter has no order for duplicate indices,
    # so take the highest active lane of each (channel, bank) explicitly
    # and gather its row.
    n_cb = n_channels * n_banks
    last = torch.full((R, n_cb + 1), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(1, torch.where(active, cb_flat, n_cb),
                         torch.arange(N, device=dev).expand(R, N),
                         reduce="amax")
    last = last[:, :-1]
    new_open = torch.where(last >= 0, row.gather(1, last.clamp(min=0)),
                           state.open_row.reshape(R, -1)) \
        .reshape(R, n_channels, n_banks)

    # silver rotation: consume quota per wave (at most one rotation per
    # wave); classification keeps the cycle-start silver app. With the
    # MASK scheduler off no request is silver, and silver_left >= 1 holds
    # in every state (it starts at 1, a rotation reloads a quota >= 1, and
    # it is otherwise only decremented while it stays > 0): nothing would
    # rotate, so the rotation is skipped.
    silver_app, silver_left = state.silver_app, state.silver_left
    if mask_enabled:
        n_apps = state.conc_walks.shape[-1]
        # the app index advances by at most one per wave, so a table of
        # waves + 1 copies of next_quota[a] = quota[(a + 1) % n_apps]
        # needs no modulo inside the loop
        next_quota = silver_quota(state, thres_max).roll(-1, -1) \
            .repeat(1, waves + 1)
        served_w = (active & (cls == 1)).reshape(R, waves, C) \
            .sum(-1, dtype=torch.int32)
        # an (R, 1) index: indexing with a 0-d tensor would read it on the
        # host
        app_ix = silver_app.long()[:, None]
        for served in served_w.unbind(1):
            left = silver_left - served
            rotate = left <= 0
            silver_left = torch.where(rotate,
                                      next_quota.gather(1, app_ix)[:, 0],
                                      left)
            app_ix = app_ix + rotate[:, None]
        silver_app = (app_ix[:, 0] % n_apps).to(torch.int32)

    return state._replace(open_row=new_open, silver_app=silver_app,
                          silver_left=silver_left,
                          queue_len=queue_len), latency


def update_pressure(state: DramState, conc_walks, warps_stalled) -> DramState:
    """Refresh the Eq. (1) inputs (reset each epoch, §5.4)."""
    return state._replace(conc_walks=conc_walks.to(torch.int32),
                          warps_stalled=warps_stalled.to(torch.int32))
