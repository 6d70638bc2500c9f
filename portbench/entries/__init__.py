"""Entry types: how a cell's traffic drives the program, and how what it
answers is judged.

A module here exposes `make(config, traffic, device, shrink=None) ->
Entry`; a traffic file names its entry type by the module's name
("entry"). The harness only times, traces and reports: everything that
belongs to one kind of work (its inputs, set-up, reference and
comparison) sits behind the `Entry`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

Span = Tuple[str, str, str]          # (module, attribute, span name)


@dataclasses.dataclass
class Entry:
    """`answers`: answers one call gives (for `attempted`); `work`: units
    of work one call completes (what the rate metrics count);
    `plan(seed, k)`: the input of call `k` of a run with `--seed seed`;
    `call(plan)`: one timed call of the program; `warm()`: set-up, the
    libraries and every shape the window uses; `check(calls)`: after the
    window, every call's answers against the plain reference, as
    ({name: {"value", "limit"}}, answers that never came); `spans`:
    functions of the program wrapped in named spans in a traced run;
    `after_trace(calls)`: readings taken after a traced window (for the
    metric readers, as `Trace.extra`)."""
    answers: int
    work: int
    plan: Callable[[int, int], Any]
    call: Callable[[Any], Any]
    warm: Callable[[], None]
    check: Callable[[list], Tuple[Dict[str, dict], int]]
    spans: Sequence[Span] = ()
    after_trace: Optional[Callable[[list], Dict[str, Any]]] = None


@dataclasses.dataclass
class Call:
    """One timed call: its input, host clock span (s), work, and what it
    returned or raised."""
    plan: Any
    start: float
    end: float = 0.0
    work: int = 0
    results: Any = None
    error: Optional[str] = None
