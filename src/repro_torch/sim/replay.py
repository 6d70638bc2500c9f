"""The cycle step as CUDA graphs, split at the hand-written fused rounds.

On a CUDA device `memsys.step` runs each cycle through `GRAPHS.step`.
A cycle's key is everything that changes what it issues: the config
without its cycle count, the row count, the device, which design knobs
are (R,) tensors together with the host values of the others, and
whether the state carries `asid_of_app`. A key's first cycle runs
`memsys.eager_step` (the library loads, the cached constant tensors are
made). Its second is captured:

  * the key gets static buffers: the state, the parameter matrix and
    the knobs that are tensors, copied in;
  * `eager_step` runs once over them with a capture open; where a fused
    round is entered (`tlb.split_rounds`), the capture ends, the stretch
    captured so far is replayed (so the round gets its real operands),
    the round runs from Python with its host `time`, and the next
    stretch is captured after it;
  * the last stretch ends by copying the new state into the state
    buffers, where it was not updated in place.

Every later cycle of the key replays that record:

    graph0 -> round -> graph1 [-> round -> graph2]

each round called as `ops.fused_tlb_access` with the cycle's host time
and the operands it had at capture, its fresh hit/filled copied into the
buffers the next graph reads. A state, parameter matrix or knob that is
not the key's buffer is copied in first (a cold start, a carried-over
segment, a new pass). A cycle where the epoch runs (`memsys.epoch_due`)
runs `eager_step` over the buffers. All graphs of a key share one
memory pool; the cache keeps `MAX_KEYS` keys, the least recently used
goes, and with it its graphs, pool and buffers.

The cached constant tensors a step reads (`memsys._consts`, `_lanes`)
pass through `held`, so the graphs keep them alive. Under the torch
profiler a capture is the span `sim.step.capture` (attrs `rows`,
`graphs`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch.core import tlb as tlb_mod
from repro_torch.kernels.fused_tlb import ops as fused_ops
from repro_torch.spans import span

MAX_KEYS = 8                 # keys (and memory pools) the cache holds

# the list a capture keeps its constant tensors in, while one runs
_keep: Optional[list] = None


def held(x):
    """`x`, kept alive beside the graphs being captured, if a capture
    runs: a cached constant the step reads, which its cache may drop
    while the graphs still read it."""
    if _keep is not None:
        _keep.append(x)
    return x


@contextlib.contextmanager
def _holding(keep: list):
    global _keep
    prev, _keep = _keep, keep
    try:
        yield
    finally:
        _keep = prev


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


class _Round(NamedTuple):
    """A fused round of the record: its tensor operands as captured, its
    `time` less the cycle's host t, its keywords, and the buffers that
    the next graph reads its hit/filled from."""
    args: tuple
    dt: int
    kwargs: dict
    hit: torch.Tensor
    filled: torch.Tensor


@dataclasses.dataclass
class Entry:
    """One key's record: its static buffers, graphs and rounds."""
    state: Any                   # the state buffers (a SimState)
    params: torch.Tensor
    knobs: dict                  # knob name -> its (R,) buffer
    graphs: list
    rounds: List[_Round]
    keep: list                   # constants the graphs read
    pool: Any
    ptrs: frozenset              # the state buffers' addresses
    sources: dict                # input name -> the tensor last copied in


class _Recorder:
    """Captures one cycle stretch by stretch, splitting at each round."""

    def __init__(self, graph, device: torch.device, t_host: int):
        self.graph = graph
        self.cuda = device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.t_host = t_host
        self.graphs: list = []
        self.rounds: List[_Round] = []
        self.keep: list = []
        self.open = False

    def begin(self) -> None:
        g = self.graph()
        if self.cuda:
            self.prev = torch.cuda.current_stream()
            self.stream.wait_stream(self.prev)
            torch.cuda.set_stream(self.stream)
        self.open = True
        g.capture_begin(pool=self.pool)
        self.graphs.append(g)

    def close(self) -> None:
        self.open = False
        try:
            self.graphs[-1].capture_end()
        finally:
            if self.cuda:
                torch.cuda.set_stream(self.prev)
                self.prev.wait_stream(self.stream)

    def end(self) -> None:
        """Close the open stretch and run it: the cycle's own work."""
        self.close()
        self.graphs[-1].replay()

    def split(self, round_fn, args, kwargs):
        self.end()
        out = round_fn(*args, **kwargs)
        self.rounds.append(_Round(args=args[:7], dt=args[7] - self.t_host,
                                  kwargs=dict(kwargs), hit=out[3],
                                  filled=out[4]))
        self.begin()
        return out


def _write_back(buffers, out) -> None:
    """Copy each leaf of `out` that is not its buffer into it. A new leaf
    may not share a buffer's storage: copied in turn, it could read a
    buffer already overwritten."""
    bufs = _leaves(buffers)
    stores = {b.untyped_storage().data_ptr() for b in bufs}
    for b, o in zip(bufs, _leaves(out)):
        if o.data_ptr() == b.data_ptr():
            continue
        if o.untyped_storage().data_ptr() in stores:
            raise RuntimeError("replay: a new state leaf aliases a state "
                               "buffer; the copy-back cannot order it")
        b.copy_(o)


class Graphs:
    """The cache of captured cycles, by key. `graph` is the graph class
    (default `torch.cuda.CUDAGraph`): anything with `capture_begin(pool=)`,
    `capture_end()` and `replay()`. `maxsize` bounds the keys."""

    def __init__(self, graph=None, maxsize: int = MAX_KEYS):
        self.graph = graph
        self.maxsize = maxsize
        self.entries: "collections.OrderedDict[tuple, Optional[Entry]]" = \
            collections.OrderedDict()
        self.captures = 0
        self._last: tuple = (None, None, None, None)

    def key(self, cfg, dp, params_mat, state) -> tuple:
        last_cfg, last_dp, last_pm, k = self._last
        if cfg is last_cfg and dp is last_dp and params_mat is last_pm:
            return k + (state.asid_of_app is None,)
        k = (dataclasses.replace(cfg, sim_cycles=0), params_mat.shape[0],
             str(params_mat.device),
             tuple(("tensor", v.dtype) if isinstance(v, torch.Tensor)
                   else v for v in dp))
        self._last = (cfg, dp, params_mat, k)
        return k + (state.asid_of_app is None,)

    def step(self, cfg, dp, params_mat, state, cycle: int):
        """One cycle of a state with the row axis: (state, whether the
        cycle replayed its graphs)."""
        from repro_torch.sim import memsys
        if memsys.epoch_due(cfg, dp, cycle + 1):
            return memsys.eager_step(cfg, dp, params_mat, state, cycle), \
                False
        key = self.key(cfg, dp, params_mat, state)
        if key not in self.entries:
            self.entries[key] = None
            self._evict()
            return memsys.eager_step(cfg, dp, params_mat, state, cycle), \
                False
        self.entries.move_to_end(key)
        e = self.entries[key]
        if e is None:
            e = self.entries[key] = self._capture(cfg, dp, params_mat,
                                                  state, cycle)
            return e.state, False
        self._load(e, dp, params_mat, state)
        t_host = cycle + 1
        for i, g in enumerate(e.graphs):
            g.replay()
            if i < len(e.rounds):
                r = e.rounds[i]
                out = fused_ops.fused_tlb_access(*r.args, t_host + r.dt,
                                                 **r.kwargs)
                r.hit.copy_(out[3])
                r.filled.copy_(out[4])
        return e.state, True

    def _evict(self) -> None:
        while len(self.entries) > self.maxsize:
            self.entries.popitem(last=False)

    def _copy_in(self, e: Entry, name: str, buf, src) -> None:
        if e.sources.get(name) is not src:
            buf.copy_(src)
            e.sources[name] = src

    def _load(self, e: Entry, dp, params_mat, state) -> None:
        self._copy_in(e, "params", e.params, params_mat)
        for f, buf in e.knobs.items():
            self._copy_in(e, f, buf, getattr(dp, f))
        if state is not e.state:
            for b, x in zip(_leaves(e.state), _leaves(state)):
                if x.data_ptr() != b.data_ptr():
                    b.copy_(x)

    def _capture(self, cfg, dp, params_mat, state, cycle: int) -> Entry:
        from repro_torch.sim import memsys
        R = params_mat.shape[0]
        with span("sim.step.capture", rows=R) as attrs:
            buffers = memsys.map_state(
                lambda x: x.clone(memory_format=torch.contiguous_format),
                state)
            params = params_mat.clone()
            knobs = {f: v.clone() for f, v in zip(dp._fields, dp)
                     if isinstance(v, torch.Tensor)}
            rec = _Recorder(self.graph or torch.cuda.CUDAGraph,
                            params_mat.device, cycle + 1)
            with tlb_mod.split_rounds(rec.split), _holding(rec.keep):
                rec.begin()
                try:
                    out = memsys.eager_step(cfg, dp._replace(**knobs),
                                            params, buffers, cycle)
                    _write_back(buffers, out)
                except BaseException:
                    if rec.open:
                        rec.close()
                    raise
                rec.end()
            if attrs is not None:
                attrs["graphs"] = len(rec.graphs)
        self.captures += 1
        return Entry(state=buffers, params=params, knobs=knobs,
                     graphs=rec.graphs, rounds=rec.rounds, keep=rec.keep,
                     pool=rec.pool,
                     ptrs=frozenset(b.data_ptr() for b in _leaves(buffers)),
                     sources={"params": params_mat,
                              **{f: getattr(dp, f) for f in knobs}})

    def detach(self, state):
        """`state` with each leaf that is a key's state buffer cloned, so
        no later cycle of that key overwrites what the caller holds."""
        ptrs = set()
        for e in self.entries.values():
            if e is not None:
                ptrs |= e.ptrs
        if not ptrs:
            return state
        from repro_torch.sim import memsys
        return memsys.map_state(
            lambda x: x.clone() if x.data_ptr() in ptrs else x, state)


GRAPHS = Graphs()
