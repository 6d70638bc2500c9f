"""FLOPs, HBM bytes, collective bytes and peak live bytes of a torch step,
per device.

The counterpart, for the port's eager steps, of what
`roofline.hlo_parse.analyze_hlo` reads from a compiled HLO module, with
the reference's keys and meaning, per device (per rank):

* ``dot_flops``: the FLOPs of the matrix products and convolutions that
  ran on this rank, by `torch.utils.flop_counter`'s formulas (the
  registry `FlopCounterMode` counts with), from each op's local shapes.
  A loop of matmuls counts every trip. A hand-written CUDA kernel
  (`kernels/`, launched through ctypes, or its fake branch under
  `FakeTensorMode`) is no aten op: its wrapper reports the products of
  one call through `kernel_work`, by the formula its bound uses, and
  they count here.
* ``hbm_bytes``: each aten op's operand and result bytes on this rank,
  summed (`analyze_hlo`'s ``(out_b + in_b) * mult`` for every
  cost-bearing instruction, `src/repro/roofline/hlo_parse.py:269`), plus
  the bytes a kernel reports through `kernel_work`. Views, metadata ops
  and allocations without a fill count 0. Eager torch fuses nothing, so
  this is the traffic of the unfused step.
* ``coll_by_op`` / ``coll_bytes``: the bytes of each functional
  collective this rank issued (the larger of its operand's and its
  result's, as `analyze_hlo` counts an HLO collective), by the
  reference's op names (all-gather, all-reduce, reduce-scatter,
  all-to-all), and their sum. `CommDebugMode` gives counts only.
* ``peak_bytes``: the most bytes of storage alive at once over the step,
  on this rank: every storage an op makes counts from then until it is
  freed (a weakref finalizer on the storage), a view or an in-place
  result adds nothing, and tensors that exist before the step count
  from the start only when passed to `track` (the step's arguments).
* ``kernels``: per kernel name, the calls, flops and bytes reported
  through `kernel_work`.

DTensor ops are let through to DTensor (the mode answers NotImplemented,
as `CommDebugMode` does), so what is counted is the local ops and the
collectives they desugar into: what this rank runs (not the ops DTensor
runs on global-shape fake tensors to learn an output's shape). Under
`FakeTensorMode` (enter it first, then the counter) nothing runs and
every number is the same as for real tensors of the same shapes.
"""
from __future__ import annotations

import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
# ops that move no data: allocations without a fill, and waits
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "wait_tensor", "lift_fresh",
               "_local_scalar_dense", "resize_"}

_ACTIVE: List["StepCounter"] = []    # counters entered, innermost last
_PROPAGATING = [0]   # depth of DTensor's output-metadata propagation


def _skip_propagation():
    """Make DTensor's sharding propagator raise `_PROPAGATING` while it
    runs an op on fake tensors of the GLOBAL shape to learn the output's
    metadata (under a `FakeTensorMode` that a counter's dispatch sees):
    that op is not part of any rank's work and is not counted. Patched
    once, by the first counter made; nothing else changes."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name)
    if getattr(orig, "_counter_skips", False):
        return

    def propagate(self, op_schema):
        _PROPAGATING[0] += 1
        try:
            return orig(self, op_schema)
        finally:
            _PROPAGATING[0] -= 1

    propagate._counter_skips = True
    setattr(ShardingPropagator, name, propagate)


def counting() -> bool:
    """Whether a `StepCounter` is active (a kernel wrapper computes its
    work only then)."""
    return bool(_ACTIVE)


def kernel_work(name: str, flops: float, nbytes: float) -> None:
    """A hand-written kernel's work for one call (its products' flop, the
    bytes it reads and writes), added to every active `StepCounter`."""
    for c in _ACTIVE:
        c.dot_flops += flops
        c.hbm_bytes += nbytes
        k = c.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                        "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class StepCounter(TorchDispatchMode):
    """Counts while active: `with StepCounter() as c: step(...)`, then
    `c.totals()`. With `log` (a text stream) every op is also written to
    it, a line each: the op, the local shapes of its operands and
    results, its flop and its bytes, tab-separated."""

    def __init__(self, log=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        _skip_propagation()
        self.dot_flops = 0
        self.hbm_bytes = 0
        self.coll_by_op: Dict[str, int] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}      # id(storage) -> bytes
        self.log = log

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------- live bytes
    def _free(self, key):
        self.live -= self._storages.pop(key, 0)

    def _add(self, st) -> None:
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)

    def track(self, *trees) -> int:
        """Count the storages of the tensors in `trees` (dicts, lists of
        tensors or DTensors: each rank's local shard) as alive from now,
        as the step's arguments are; returns the bytes added."""
        before = self.live
        for t in _tensors(list(trees)):
            self._add(_local(t).untyped_storage())
        return self.live - before

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _PROPAGATING[0]:
            return out
        packet = func._overloadpacket
        name = packet.__name__
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            if id(st) not in seen and t.device.type != "meta":
                self._add(st)
        flops = moved = 0
        if packet in self._flop_registry:
            flops = int(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
            self.dot_flops += flops
        elif func.namespace == "_c10d_functional":
            op = _COLLECTIVES.get(name)
            if op is not None:
                coll = max(_bytes(args[0]), _bytes(out))
                self.coll_by_op[op] = self.coll_by_op.get(op, 0) + coll
        if not (func.is_view or name in _NO_TRAFFIC):
            moved = _bytes(ins) + _bytes(outs)
            self.hbm_bytes += moved
        if self.log is not None:
            self.log.write(f"{func}\t{[tuple(t.shape) for t in ins]}\t"
                           f"{[tuple(t.shape) for t in outs]}\t{flops}\t"
                           f"{moved}\n")
        return out

    def totals(self) -> Dict[str, object]:
        return {"dot_flops": float(self.dot_flops),
                "hbm_bytes": float(self.hbm_bytes),
                "coll_bytes": float(sum(self.coll_by_op.values())),
                "coll_by_op": {k: float(v)
                               for k, v in self.coll_by_op.items()},
                "peak_bytes": float(self.peak),
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def count_step(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its `StepCounter` totals on this rank)."""
    with StepCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.totals()
