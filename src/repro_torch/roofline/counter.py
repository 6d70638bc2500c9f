"""FLOPs and collective bytes of a torch step, per device.

The counterpart, for the port's eager steps, of what
`roofline.hlo_parse.analyze_hlo` reads from a compiled HLO module, with
the reference's keys and meaning, per device (per rank):

* ``dot_flops``: the FLOPs of the matrix products and convolutions that
  ran on this rank, by `torch.utils.flop_counter`'s formulas (the
  registry `FlopCounterMode` counts with), from each op's local shapes.
  A loop of matmuls counts every trip. A hand-written CUDA kernel
  (`kernels/`, launched through ctypes) is no aten op and counts 0 here.
* ``coll_by_op`` / ``coll_bytes``: the bytes of each functional
  collective this rank issued (the larger of its operand's and its
  result's, as `analyze_hlo` counts an HLO collective), by the
  reference's op names (all-gather, all-reduce, reduce-scatter,
  all-to-all), and their sum. `CommDebugMode` gives counts only.

DTensor ops are let through to DTensor (the mode answers NotImplemented,
as `CommDebugMode` does), so what is counted is the local ops and the
collectives they desugar into: what this rank runs.
"""
from __future__ import annotations

from typing import Dict

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


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


class StepCounter(TorchDispatchMode):
    """Counts while active: `with StepCounter() as c: step(...)`, then
    `c.totals()`."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.dot_flops = 0
        self.coll_by_op: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.dot_flops += int(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        elif func.namespace == "_c10d_functional":
            op = _COLLECTIVES.get(packet.__name__)
            if op is not None:
                moved = max(_bytes(args[0]), _bytes(out))
                self.coll_by_op[op] = self.coll_by_op.get(op, 0) + moved
        return out

    def totals(self) -> Dict[str, object]:
        return {"dot_flops": float(self.dot_flops),
                "coll_bytes": float(sum(self.coll_by_op.values())),
                "coll_by_op": {k: float(v)
                               for k, v in self.coll_by_op.items()}}


def count_step(fn, *args, **kwargs):
    """(fn(*args, **kwargs), its `StepCounter` totals on this rank)."""
    with StepCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.totals()
