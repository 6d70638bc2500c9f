"""Spans inside the program, recorded while a torch profiler records.

`span(name, **attrs)` marks a stretch of host time: the simulator's pass,
its cold start, each stage of the cycle step, the fused round, the final
state's transfer and the per-row stats; on the model path each latent
attention layer (`model.mla`, with `bytes`, the latent cache it writes)
and the shared experts (`model.moe.shared`). With no profiler recording it
returns one shared no-op context: no clock is read and nothing is kept.
Under `torch.profiler.profile` each span becomes a record

    (name, start_ns, end_ns, parent, attrs)

on `time.time_ns()`, the clock of the profiler's host events, so a span
and the device operations launched inside it can be joined without
translation. `parent` is the index in `log()` of the enclosing record, or
-1 at the top (or where the enclosing record has been dropped). The log
lives in memory and keeps the newest `LOG_SIZE` records; nothing is
written to disk.

No span or attribute reads a device tensor's value: sizes come from
`numel()` and `element_size()`, so tracing adds no host sync and launches
nothing. Records are kept per process and assume one thread issues the
spans, as the simulator's and the model's loops do.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

from torch.autograd import profiler as _profiler

LOG_SIZE = 2 ** 20
Record = Tuple[str, int, int, int, dict]

# records as [name, start_ns, end_ns, parent's sequence number, attrs];
# a record's sequence number is _made - len(_log) + its index
_log: collections.deque = collections.deque(maxlen=LOG_SIZE)
_made = 0
_open: List[int] = []          # sequence numbers of the open spans


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name: str, attrs: dict):
        self.rec = [name, 0, 0, -1, attrs]

    def __enter__(self) -> dict:
        global _made
        if _open:
            self.rec[3] = _open[-1]
        _log.append(self.rec)
        _open.append(_made)
        _made += 1
        self.rec[1] = time.time_ns()
        return self.rec[4]

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        _open.pop()
        return False


def span(name: str, **attrs):
    """A context manager that records `name` with `attrs` while a torch
    profiler records, and does nothing otherwise. Entered, it gives the
    record's attribute dict (None when not recording), so attributes
    known only inside the span can be added to it."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, attrs)


def log() -> List[Record]:
    """The kept records, oldest first (parents before their children)."""
    first = _made - len(_log)
    return [(n, s, e, p - first if p >= first else -1, a)
            for n, s, e, p, a in _log]


def summary(records: Optional[List[Record]] = None) -> Dict[str, dict]:
    """For each span name: `count`, `total_ns`, `self_ns` (each span's
    duration less the time its child spans cover) and the sum of each
    numeric attribute. `records` is a list as `log()` gives it (default:
    the whole log)."""
    records = log() if records is None else records
    child_ns = [0] * len(records)
    for n, s, e, p, a in records:
        if p >= 0:
            child_ns[p] += e - s
    out: Dict[str, dict] = {}
    for i, (n, s, e, p, a) in enumerate(records):
        row = out.setdefault(n, {"count": 0, "total_ns": 0, "self_ns": 0})
        row["count"] += 1
        row["total_ns"] += e - s
        row["self_ns"] += e - s - child_ns[i]
        for k, v in a.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                row[k] = row.get(k, 0) + v
    return out
