"""Hand-written kernels on DTensor inputs.

The CUDA kernels read raw pointers, so a DTensor never reaches one: each
rank runs the kernel (or on the CPU its plain version) on its local
shards through `torch.distributed.tensor.experimental.local_map`, and the
results are wrapped back as DTensors. That is right only where the
kernel computes each index of a sharded dim on its own (batch, heads,
chunks): `run_local` takes, for every input and output, the tensor dim
of each such independent logical dim, and raises ValueError for an input
sharded along any other dim, or unevenly.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

Dims = Dict[str, int]


def is_dtensor(*ts) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in ts)


def run_local(fn: Callable, name: str, args: Sequence[torch.Tensor],
              arg_dims: Sequence[Dims], out_dims: Sequence[Dims]):
    """`fn(*local shards)` on every rank, its outputs (one per entry of
    `out_dims`; a single output when there is one) wrapped as DTensors.
    Each mesh dim shards one logical dim of `arg_dims` or none: the first
    input sharded on it names the dim, every input that has that logical
    dim is brought to `Shard` on it and every input without it to
    `Replicate` (by `redistribute`, before the call)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not all(isinstance(a, DTensor) for a in args):
        raise TypeError(f"{name}: DTensor and plain tensor inputs mixed")
    mesh = args[0].device_mesh
    names = [None] * mesh.ndim
    for i, (a, dims) in enumerate(zip(args, arg_dims)):
        for m, pl in enumerate(a.placements):
            if not isinstance(pl, Shard):
                continue
            d = pl.dim % a.dim()
            logical = next((n for n, dd in dims.items() if dd == d), None)
            if logical is None:
                raise ValueError(
                    f"{name}: input {i} is sharded along dim {d}, which the "
                    f"kernel couples; only {sorted(dims)} may be sharded")
            if names[m] is None:
                names[m] = logical
            elif names[m] != logical:
                raise ValueError(
                    f"{name}: mesh dim {m} shards {names[m]} and {logical}")

    def placements(dims: Dims):
        return tuple(Shard(dims[n]) if n in dims else Replicate()
                     for n in names)

    ins = []
    for i, (a, dims) in enumerate(zip(args, arg_dims)):
        want = placements(dims)
        for m, pl in enumerate(want):
            if isinstance(pl, Shard) and a.shape[pl.dim] % mesh.size(m):
                raise ValueError(
                    f"{name}: input {i}'s dim {pl.dim} ({a.shape[pl.dim]}) "
                    f"does not split evenly over mesh dim {m} "
                    f"({mesh.size(m)})")
        ins.append(a if tuple(a.placements) == want
                   else a.redistribute(mesh, want))
    # one list of placements per output (a bare tuple of placements would
    # read as one per output)
    return local_map(fn,
                     out_placements=tuple(list(placements(d))
                                          for d in out_dims),
                     in_placements=tuple(list(placements(d))
                                         for d in arg_dims),
                     device_mesh=mesh)(*ins)
