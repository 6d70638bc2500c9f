"""The program's own spans (`repro_torch.spans`) inside the profiled
calls of a traced run.

The program records its spans on `time.time_ns()`, the clock of the
profiler's host events, so the calls' bounds (`Trace.calls`) select the
spans of this run's window and leave out those of earlier profiler
sessions in the same process. A program without spans of its own gives
nothing, and its readers then report no value.
"""
from __future__ import annotations

from typing import List, Optional


def records(run, name: str) -> Optional[List[tuple]]:
    """The program's records named `name` whose start lies inside one of
    the profiled calls, or None: no trace, no such span, or a program
    with no `repro_torch.spans`."""
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    out = [r for r in spans.log() if r[0] == name
           and any(cs <= r[1] < ce for cs, ce in tr.calls)]
    return out or None
