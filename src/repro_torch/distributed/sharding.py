"""Logical-axis -> mesh-axis mapping (DP / TP / FSDP / EP / SP) on a torch
`DeviceMesh`.

Port of `repro.distributed.sharding`. Params carry *logical* axis names
(`repro_torch.models.params.Param.axes`); activations are constrained with
logical names at the reference's points in the model (`models/lm.py`'s
`constrain` hook). A ``Sharder`` binds those names to mesh axes for a
given (mesh, RunConfig):

  TP   : heads / kv_heads / ffn / vocab / experts / ssm  -> 'model'
  DP   : batch                                           -> ('pod','data')
  FSDP : first large replicated weight axis              -> ('pod','data')
  SP   : decode KV length ('kvseq')                      -> 'model'
          (or ('data','model') when the batch is smaller than the data
           axes: `wide_kvseq`)

Every mapping is divisibility-checked: a dim that does not divide evenly
falls back to replication.

A spec (`param_spec`, `act_spec`) is a tuple with one entry per tensor
dim: None, a mesh-axis name, or a tuple of two or more names (one tensor
dim split over several mesh dims, major to minor), the entries of the
reference's `PartitionSpec`. Specs read only `mesh.shape` and `mesh.mesh_dim_names`,
so a stub mesh with those two attributes drives them without devices.
A sharding (`param_sharding`, `act_sharding`, `replicated`) is the
DTensor placements of that spec, one per mesh dim: `Shard(d)` on each
mesh dim named in tensor dim d's entry, `Replicate()` elsewhere. Where
one tensor dim is split over two mesh dims, DTensor shards it in mesh-dim
order, which is the entry's major-to-minor order for every entry a
`Sharder` makes (('pod', 'data') and ('data', 'model') follow the mesh).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models.params import Param

_TP_PARAM_AXES = {"heads", "ffn", "vocab", "experts", "ssm"}

Spec = Tuple[object, ...]


def whole_dims(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """A DTensor redistributed so that each of `dims` is whole on every
    rank: a mesh dim that shards one of them replicates instead, and a
    pending sum (`Partial`) is reduced; other shards stay. A plain tensor
    as it is. For ops that DTensor has no sharding rule for along a
    sharded dim (a view into heads that a shard would split, a group of
    MoE tokens routed together)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    want = tuple(pl if isinstance(pl, Shard) and pl.dim % x.dim() not in dims
                 else Replicate() for pl in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def split_last(x: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """(..., n * size) -> (..., n, size). A DTensor sharded along its last
    dim over more ranks than divide `n` is made whole along it first:
    DTensor cannot view a shard that ends inside one of the `n` pieces
    (GQA's 8 kv heads on a 16-wide "model" axis), where the reference's
    GSPMD splits the piece."""
    if n % shard_ranks(x, -1):
        x = whole_dims(x, -1)
    return x.reshape(x.shape[:-1] + (n, size))


def shard_ranks(x: torch.Tensor, dim: int) -> int:
    """How many ranks split dim `dim` of a DTensor (the product of the mesh
    dims that shard it); 1 for a plain tensor."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return 1
    dim %= x.dim()
    return int(np.prod([x.device_mesh.size(m)
                        for m, pl in enumerate(x.placements)
                        if isinstance(pl, Shard) and pl.dim % x.dim() == dim]))


def contiguous_strides(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of `shape` (for `from_local`,
    without making a tensor of the global shape)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def shard_index(x: torch.Tensor, dim: int):
    """(this rank's index among the even shards of DTensor `x` along
    `dim`, the mesh dims that shard it, major first): the shard starts
    at index * its local length."""
    from torch.distributed.tensor import Shard

    mesh, nd = x.device_mesh, x.dim()
    dims = [m for m, pl in enumerate(x.placements)
            if isinstance(pl, Shard) and pl.dim % nd == dim % nd]
    idx, coord = 0, mesh.get_coordinate()
    for m in dims:
        idx = idx * mesh.size(m) + coord[m]
    return idx, dims


def _spec(entries) -> Spec:
    """A spec as the reference's `PartitionSpec` holds it: an entry of one
    mesh axis is that axis's name, not a 1-tuple."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


_replicating = [0]   # depth of nested `plain_as_replicated` contexts


def plain_as_replicated(*trees):
    """A context in which a plain tensor that meets a DTensor counts as
    replicated (`implicit_replication`), when any leaf of `trees` (dicts
    of tensors, or tensors) is a DTensor; else a context that does
    nothing. A sharded step makes positions, masks and constants as plain
    tensors and takes its batch whole on every rank: the same on every
    rank, so replicated is what they are. Contexts nest (torch's own
    switches the flag off at the first exit), so a forward inside a
    gradient keeps the flag on for the backward."""
    from torch.distributed.tensor import DTensor

    def leaves(t):
        return [x for v in t.values() for x in leaves(v)] \
            if isinstance(t, dict) else [t]

    if not any(isinstance(x, DTensor) for t in trees for x in leaves(t)):
        return contextlib.nullcontext()
    return _replicating_plain()


@contextlib.contextmanager
def _replicating_plain():
    from torch.distributed.tensor.experimental import implicit_replication

    _replicating[0] += 1
    try:
        if _replicating[0] > 1:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _replicating[0] -= 1


class _Constrain(torch.autograd.Function):
    """x redistributed to `want`; the gradient redistributed to `want`,
    then to x's placements. Without the first step a gradient keeps
    whatever placement the op after the constraint gave it (a sequence
    shard from a slice's backward), which DTensor may then be unable to
    take through the product before it."""

    @staticmethod
    def forward(ctx, x, want):
        from torch.distributed.tensor import Replicate

        ctx.want = want
        out = (x if tuple(x.placements) == want
               else x.redistribute(x.device_mesh, want))
        # the gradient of a pending sum is replicated, as DTensor's own
        # redistribute takes it back
        ctx.have = tuple(Replicate() if pl.is_partial() else pl
                         for pl in x.placements)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        mesh = g.device_mesh
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(mesh, ctx.want)
        if ctx.have != ctx.want:
            g = g.redistribute(mesh, ctx.have)
        return g, None


class Sharder:
    def __init__(self, mesh, run: RunConfig):
        self.mesh = mesh
        self.run = run
        self.axis_names: Tuple[str, ...] = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(self.axis_names,
                              (int(s) for s in mesh.shape)))
        self.multi_pod = "pod" in self.axis_names
        self.dp: Tuple[str, ...] = (("pod", "data") if self.multi_pod
                                    else ("data",))
        self.model_size = self.sizes["model"]
        self.dp_size = int(np.prod([self.sizes[a] for a in self.dp]))
        # long-context decode with batch < dp: spread KV over data too
        self.wide_kvseq = (run.seq_shard_decode
                           and run.shape.global_batch < self.dp_size)

    def _axis_size(self, entry) -> int:
        if entry is None:
            return 1
        if isinstance(entry, tuple):
            return int(np.prod([self.sizes[a] for a in entry]))
        return self.sizes[entry]

    def _fit(self, entry, size: Optional[int]):
        """Divisibility fallback: drop the mapping if it doesn't divide."""
        if size is None:
            return entry
        return entry if (self._axis_size(entry) and
                         size % self._axis_size(entry) == 0) else None

    # ----------------------------------------------------------- params
    def param_spec(self, p: Param) -> Spec:
        entries = [None] * len(p.shape)
        # pass 1: tensor parallelism (first fitting TP axis -> 'model')
        used_model = False
        for i, (ax, size) in enumerate(zip(p.axes, p.shape)):
            if ax in _TP_PARAM_AXES and not used_model:
                e = self._fit("model", size)
                if e is not None:
                    entries[i] = e
                    used_model = True
        # pass 2: data-axis placement under FSDP: an expert weight's free
        # 'ffn' dim (2D sharding), else ZeRO-3 on the first large 'embed'
        # dim (gathered at use)
        if self.run.fsdp and len(p.shape) >= 2:
            cand = None
            if len(p.shape) >= 3 and "experts" in p.axes:
                for i, (ax, size) in enumerate(zip(p.axes, p.shape)):
                    if (ax == "ffn" and entries[i] is None
                            and size % self.dp_size == 0):
                        cand = i
                        break
            if cand is None:
                for i, (ax, size) in enumerate(zip(p.axes, p.shape)):
                    if (ax == "embed" and entries[i] is None and size >= 1024
                            and size % self.dp_size == 0):
                        cand = i
                        break
            if cand is not None:
                entries[cand] = self.dp
        return _spec(entries)

    def param_sharding(self, p: Param):
        return self.placements(self.param_spec(p))

    # ------------------------------------------------------- activations
    def act_spec(self, axes, shape: Optional[Tuple[int, ...]] = None) -> Spec:
        spec = []
        used = set()
        relax = (self.run.decode_relax_batch and self.run.shape.is_decode
                 and "kvseq" not in axes)
        for i, ax in enumerate(axes):
            size = shape[i] if shape is not None else None
            if ax == "batch":
                entry = None if relax else self._fit(self.dp, size)
            elif ax == "kvseq":
                e = ("data", "model") if self.wide_kvseq else "model"
                entry = self._fit(e, size)
            elif ax in ("heads", "kv_heads", "ffn", "vocab", "experts", "ssm"):
                entry = self._fit("model", size)
            else:
                entry = None
            # a mesh axis may appear at most once per spec
            names = (entry if isinstance(entry, tuple)
                     else (entry,) if entry else ())
            if any(n in used for n in names):
                entry = None
            else:
                used.update(names)
            spec.append(entry)
        return _spec(spec)

    def act_sharding(self, axes, shape=None):
        return self.placements(self.act_spec(axes, shape))

    def constrain(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Redistribute a DTensor to the placements of `axes` at its shape,
        and its gradient to them on the way back (the counterpart of
        `with_sharding_constraint`, whose transpose constrains the
        cotangent alike); a plain tensor is returned as it is."""
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        want = self.act_sharding(axes, tuple(x.shape))
        if not (torch.is_grad_enabled() and x.requires_grad):
            return (x if tuple(x.placements) == want
                    else x.redistribute(x.device_mesh, want))
        return _Constrain.apply(x, want)

    # ------------------------------------------------------------- misc
    def replicated(self):
        return self.placements(())

    def placements(self, spec: Spec):
        """DTensor placements of a spec, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * len(self.axis_names)
        for dim, entry in enumerate(spec):
            for name in (entry if isinstance(entry, tuple)
                         else (entry,) if entry else ()):
                out[self.axis_names.index(name)] = Shard(dim)
        return tuple(out)
