"""The traced run: spans around the program's layers, a profiler window
over whole entry calls (`TRACE_SECONDS` of them, at least one), and its
reduction to what the metric readers read.

Spans come from the benchmark's own wrappers, put around the program's
functions that the entry names (`Entry.spans`) for the traced run only
(`instrument`), and around each entry call. The profiler's events are
read in memory (`reduce`); no trace file is written. Each device
operation keeps the time the host launched it (the runtime call with its
correlation id), so a reader can take the operations launched inside
one span: the layer that issued them.

On the card, a device operation is a kernel, copy or fill that the
profiler saw on the GPU. On the CPU, which only the benchmark's own tests
use, a device operation is a top-level `aten::` op, launched at its
start: the readers then run, but what they give is no device number.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch

# a traced run profiles whole calls until one ends past this many seconds
# (or `--seconds`, if shorter): the profiler's events of a longer window
# take minutes to read
TRACE_SECONDS = 12.0
CALL = "portbench.call"
Span = Tuple[str, int, int]           # (name, start_ns, end_ns)
Op = Tuple[str, int, int, int]        # (name, start_ns, end_ns, launch_ns)


@dataclasses.dataclass
class Trace:
    calls: List[Tuple[int, int]]      # profiled entry calls (ns)
    work: int                         # the entry's work in them
    counts: Dict[str, int]            # calls of each wrapped span's function
    device_ops: List[Op]              # launched inside the calls, by start
    host_spans: List[Span]            # the wrappers' spans, by start
    on_device: bool                   # device ops are the card's
    unlinked: int = 0                 # ops whose launch was not found
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def window_ns(self) -> int:
        return self.calls[-1][1] - self.calls[0][0]

    def busy_ns(self) -> int:
        """Time in the window in which some device operation ran."""
        busy, end = 0, None
        for _, s, e, _ in self.device_ops:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def spans(self, name: str) -> List[Tuple[int, int]]:
        return [(s, e) for n, s, e in self.host_spans if n == name]

    def launched_in(self, name: str) -> List[Op]:
        """The device operations launched while the host was inside a
        span `name` (spans of one name do not overlap)."""
        spans, out, j = self.spans(name), [], 0
        for op in sorted(self.device_ops, key=lambda o: o[3]):
            while j < len(spans) and spans[j][1] <= op[3]:
                j += 1
            if j < len(spans) and spans[j][0] <= op[3]:
                out.append(op)
        return out

    def gaps(self) -> List[Tuple[int, int]]:
        """Idle intervals of the device inside the profiled calls."""
        out = []
        spans = sorted((s, e) for _, s, e, _ in self.device_ops)
        for cs, ce in self.calls:
            cur = cs
            for s, e in spans:
                if e <= cs or s >= ce:
                    continue
                if s > cur:
                    out.append((cur, s))
                cur = max(cur, e)
            if ce > cur:
                out.append((cur, ce))
        return out


@contextlib.contextmanager
def instrument(spans: Sequence[Tuple[str, str, str]], counts: dict):
    """Wrap each (module, attribute, span) function in its span, and
    count its calls in `counts[span]`."""
    import importlib
    saved = []
    for mod_name, attr, span in spans:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, _wrap(fn, span, counts))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _wrap(fn, span, counts):
    def wrapped(*args, **kwargs):
        counts[span] = counts.get(span, 0) + 1
        with torch.profiler.record_function(span):
            return fn(*args, **kwargs)
    return wrapped


def _top_level(ops: List[Span]) -> List[Span]:
    """The ops not nested inside another one (CPU `aten::` ops)."""
    out, end = [], None
    for op in sorted(ops, key=lambda o: (o[1], -o[2])):
        if end is None or op[1] >= end:
            out.append(op)
            end = op[2]
    return out


def reduce(prof, work_per_call: int, counts: Dict[str, int],
           on_cuda: bool) -> Trace:
    """The profiler's events, cut to the profiled entry calls."""
    host, dev, launch = [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device's copies of the host spans are no device work
            if on_cuda and not (name.startswith("portbench.")
                                or e.is_user_annotation()):
                dev.append((name, e.start_ns(), e.end_ns(),
                            e.correlation_id()))
        elif name.startswith("portbench."):
            host.append((name, e.start_ns(), e.end_ns()))
        elif on_cuda and name.startswith("cu"):
            # a runtime call (cudaLaunchKernel, cudaMemcpyAsync, ...): its
            # device operation carries the same correlation id
            launch[e.correlation_id()] = e.start_ns()
        elif not on_cuda and name.startswith("aten::"):
            dev.append((name, e.start_ns(), e.end_ns(), 0))
    calls = sorted((s, e) for n, s, e in host if n == CALL)
    unlinked = 0
    if on_cuda:
        unlinked = sum(c not in launch for _, _, _, c in dev)
        ops = [(n, s, e, launch.get(c, s)) for n, s, e, c in dev]
    else:
        ops = [(n, s, e, s) for n, s, e in
               _top_level([(n, s, e) for n, s, e, _ in dev])]
    inside = lambda t: any(cs <= t < ce for cs, ce in calls)  # noqa: E731
    ops = sorted((o for o in ops if inside(o[3])), key=lambda o: o[1])
    return Trace(calls=calls, work=work_per_call * len(calls),
                 counts=dict(counts), device_ops=ops,
                 host_spans=sorted((h for h in host if h[0] != CALL),
                                   key=lambda h: h[1]),
                 on_device=on_cuda, unlinked=unlinked)


def short(name: str, width: int = 96) -> str:
    """A kernel's name cut to its head: `void ` and template arguments
    past `width` characters dropped."""
    name = name.removeprefix("void ")
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time and the longest idle
    gaps by the innermost span the host was in, at most 10 each."""
    by_op: dict = {}
    for n, s, e, _ in tr.device_ops:
        key = short(n)
        by_op[key] = by_op.get(key, 0) + (e - s)
    by_gap: dict = {}
    spans = tr.host_spans
    stack: list = []
    i = 0
    for gs, ge in tr.gaps():
        while i < len(spans) and spans[i][1] <= gs:
            while stack and stack[-1][2] <= spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] <= gs:
            stack.pop()
        label = stack[-1][0] if stack else CALL
        by_gap[label] = by_gap.get(label, 0) + (ge - gs)
    top = lambda d: [[k, v / 1e9] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_gap)}
