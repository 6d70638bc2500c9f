"""Synthetic GPGPU address streams of the paper's 27 benchmarks.

The benchmarks (Table 2) fall into four locality categories by (L1 TLB,
L2 TLB) miss rates. One deterministic generator per benchmark: parameters
are drawn per category with a stable per-name md5 jitter. Streams mix
sequential striding, a hot page set, a per-group warm set and
uniform-random far pages. The parameter tables are host numpy; `gen_vpn`
runs on tensors.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from .page_table import _mix, mul_u32, u32

# Table 2 categorization
CATEGORY: Dict[str, Tuple[str, str]] = {}
for _n in ("LUD", "NN"):
    CATEGORY[_n] = ("low", "low")
for _n in ("BFS2", "FFT", "HISTO", "NW", "QTC", "RAY", "SAD", "SCP"):
    CATEGORY[_n] = ("low", "high")
for _n in ("BP", "GUP", "HS", "LPS"):
    CATEGORY[_n] = ("high", "low")
for _n in ("3DS", "BLK", "CFD", "CONS", "FWT", "LUH", "MM", "MUM", "RED",
           "SC", "SCAN", "SRAD", "TRD"):
    CATEGORY[_n] = ("high", "high")

BENCHES: List[str] = sorted(CATEGORY)


@dataclasses.dataclass(frozen=True)
class AppParams:
    """Scalar params of one application's stream: a hot, a warm, a
    sequential and a uniform-random tier."""

    name: str
    ws_pages: int        # total working-set size in pages (cold reach)
    hot_pages: int       # zipf-hot subset
    hot_milli: int       # P(hot access) in 1/1024
    warm_pages: int      # per-group mid-temperature set (L2-TLB-scale reuse)
    warm_milli: int      # P(warm access)
    seq_milli: int       # P(sequential-stream access)
    stride: int          # pages per sequential step
    gap: int             # compute instructions between memory ops
    l1d_hit_milli: int   # L1 data-cache hit probability (1/1024)
    revisit: int         # accesses per page before moving on (spatial loc.)

    def as_array(self) -> np.ndarray:
        out = np.array([getattr(self, f) for f in FIELDS], np.int32)
        assert out.shape == (N_FIELDS,)
        return out


# field order of the (n_apps, N_FIELDS) parameter matrices
FIELDS: Tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(AppParams) if f.name != "name")
FIELD: Dict[str, int] = {name: i for i, name in enumerate(FIELDS)}
N_FIELDS = len(FIELDS)


def _jitter(name: str, lo: float, hi: float) -> float:
    h = int(hashlib.md5(name.encode()).hexdigest()[:8], 16)
    return lo + (h / 0xFFFFFFFF) * (hi - lo)


def make_app(name: str) -> AppParams:
    l1c, l2c = CATEGORY[name]
    j = lambda lo, hi: _jitter(name, lo, hi)  # noqa: E731
    warm, warm_m = 1, 0
    if (l1c, l2c) == ("low", "low"):
        # tiny working set: everything fits the 64-entry L1 TLB
        ws = int(j(24, 48))
        hot, hot_m, seq_m, rev = ws // 2, 700, 280, 24
    elif (l1c, l2c) == ("low", "high"):
        # streaming: page-level spatial reuse, reach beyond the L2 TLB
        ws = int(j(16384, 65536))
        hot, hot_m, seq_m, rev = 16, 50, 900, int(j(16, 32))
        warm, warm_m = 64, 40
    elif (l1c, l2c) == ("high", "low"):
        # scattered within a modest set that fits the shared L2 TLB
        ws = int(j(160, 300))
        hot, hot_m, seq_m, rev = 8, 80, 80, 1
        warm, warm_m = ws, 520
    else:  # high, high
        # warm tier sized between the baseline and token-restricted
        # eviction horizons: the regime TLB-Fill Tokens exploit
        ws = int(j(16384, 65536))
        hot, hot_m = 64, int(j(100, 160))
        warm, warm_m = int(j(224, 384)), int(j(360, 440))
        seq_m, rev = int(j(120, 220)), int(j(1, 3))
    return AppParams(
        name=name,
        ws_pages=ws,
        hot_pages=max(hot, 1),
        hot_milli=hot_m,
        warm_pages=max(warm, 1),
        warm_milli=warm_m,
        seq_milli=seq_m,
        stride=1,
        gap=int(j(6, 28)),
        l1d_hit_milli=int(j(350, 800)),
        revisit=max(rev, 1),
    )


def idle_app() -> AppParams:
    """Partner that effectively never issues and never misses: the §6
    `IPC_alone` baseline keeps the app's core share without contention."""
    return AppParams(name="__idle__", ws_pages=1, hot_pages=1, hot_milli=1024,
                     warm_pages=1, warm_milli=0, seq_milli=0, stride=1,
                     gap=4000, l1d_hit_milli=1024, revisit=1)


IDLE_ROW = idle_app().as_array()


def app_matrix(names) -> np.ndarray:
    """(n_apps, N_FIELDS) int32 parameter matrix. None entries -> idle app."""
    return np.stack([make_app(n).as_array() if n is not None else IDLE_ROW
                     for n in names])


def gen_vpn(params_row, app_id, warp_id, pos, t: int) -> torch.Tensor:
    """Deterministic VPN for one access, int32.

    params_row: (..., N_FIELDS) int32 rows of the issuing apps (the
    simulator passes (R, n_cores, N_FIELDS), gathered from the rows'
    (R, n_apps, N_FIELDS) matrices); app_id, warp_id, pos: int32 tensors
    broadcasting against it; t: the host cycle counter."""
    f = lambda name: params_row[..., FIELD[name]]  # noqa: E731
    ws, hot, hot_m = f("ws_pages"), f("hot_pages"), f("hot_milli")
    warm, warm_m, seq_m = f("warm_pages"), f("warm_milli"), f("seq_milli")
    stride, rev = f("stride"), f("revisit")
    # page index advances every `rev` accesses; the stream selector is
    # drawn per page-epoch so revisits return to the SAME page
    pg = pos // rev.clamp(min=1)
    r = _mix(mul_u32(u32(pg), 2654435761) + mul_u32(u32(warp_id), 40503)
             + u32(app_id))
    sel = r % 1024
    r2 = _mix(r + 0x9E3779B9)
    # zipf-ish skew within the hot set (nested modulus ~ 1/rank weights)
    hot_span = 1 + _mix(r2) % u32(hot)
    hot_vpn = (r2 % hot_span).to(torch.int32)
    group = warp_id // 8
    warm_vpn = hot + (r2 % u32(warm)).to(torch.int32)
    warm_hi = hot + warm
    # the sequential stream is time-based and shared app-wide
    seq_vpn = warm_hi + ((t // 64) * stride + group % 4) % ws
    rnd_vpn = warm_hi + (r2 % u32(ws)).to(torch.int32)
    vpn = torch.where(
        sel < hot_m, hot_vpn,
        torch.where(sel < hot_m + warm_m, warm_vpn,
                    torch.where(sel < hot_m + warm_m + seq_m, seq_vpn,
                                rnd_vpn)))
    # per-app base offset keeps address spaces visibly disjoint
    return vpn + app_id * (1 << 22)


# the benchmarks a mix draws from: every one outside the (low, low) class
ELIGIBLE: List[str] = [b for b in BENCHES if CATEGORY[b] != ("low", "low")]
