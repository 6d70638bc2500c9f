"""Entry types: how a cell's traffic drives the program, and how what it
answers is judged.

A module here exposes `make(config, traffic, device, shrink=None) ->
Entry`; a traffic file names its entry type by the module's name
("entry"). The harness only times, traces and reports: everything that
belongs to one kind of work (its inputs, set-up, reference and
comparison) sits behind the `Entry`.

A module also exposes `control(config, traffic, device, shrink=None) ->
Entry`, the control of its `correct` in the program's place
(`portbench/control.py`), and `TESTS`, what the benchmark's own CPU tests
take from it (`Tests`).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple)

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
    metric readers, as `Trace.extra`); `prepare(seed)`: set-up that
    depends on `--seed` (weights, inputs), before `warm`; `min_calls`:
    the fewest calls a window makes, however short."""
    answers: int
    work: int
    plan: Callable[[int, int], Any]
    call: Callable[[Any], Any]
    warm: Callable[[], None]
    check: Callable[[list], Tuple[Dict[str, dict], int]]
    spans: Sequence[Span] = ()
    after_trace: Optional[Callable[[list], Dict[str, Any]]] = None
    prepare: Optional[Callable[[int], None]] = None
    min_calls: int = 1


class Fault(NamedTuple):
    """A fault the CPU tests plant under a run, `plant(monkeypatch,
    shrink)`, and the checks of which it must raise one past its limit."""
    plant: Callable[[Any, dict], None]
    trips: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Tests:
    """What the benchmark's CPU tests take from an entry type: the shrink
    of the dry run (`test_portbench_cells.py`) and of the runs that plant
    faults (`test_portbench_faults.py`); the faults; and the checks of
    which the control must raise one past its limit."""
    dry_run: dict
    faults_shrink: dict
    faults: Sequence[Fault]
    control_checks: Tuple[str, ...]


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
