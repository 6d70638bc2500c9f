"""Parameter-spec system.

Models are described as nested dicts with :class:`Param` leaves. Each leaf
carries its shape, dtype, init recipe and *logical* axis names, which
`repro_torch.distributed.sharding` maps to mesh axes. The same tree is:

* materialized into real tensors on a device (`materialize`), or
* turned into `TensorSpec` stand-ins (with DTensor placements attached
  when a `sharding_fn` is given) by `abstractify`: nothing is allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis names (len == rank)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"             # normal | zeros | ones | constant
    scale: Optional[float] = None    # None -> 1/sqrt(fan_in)
    const: float = 0.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor to be made (caches, SSM state), and the
    sharding it is to have (`distributed.sharding`'s DTensor placements;
    None when it is not sharded): the counterpart of the reference's
    `jax.ShapeDtypeStruct`."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: Any = None


def is_param(x) -> bool:
    return isinstance(x, Param)


def tree_map_params(fn: Callable[[Param], Any], tree):
    """`fn` over the Param leaves of a spec tree (nested dicts)."""
    return tree_map(fn, tree)


def tree_map(fn: Callable[..., Any], tree, *rest):
    """Map `fn` over the leaves of nested dicts (keys in sorted order, as
    JAX flattens a dict); `rest` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_items(tree, prefix: Tuple[str, ...] = ()) -> list:
    """(path, leaf) pairs, the path a tuple of dict keys, in the order
    `tree_map` visits the leaves (JAX's flatten order for dicts)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def subtree(tree, path: Tuple[str, ...]):
    """The part of `tree` at `path` (a path of `tree_items`)."""
    for k in path:
        tree = tree[k]
    return tree


def _fan_in(p: Param) -> int:
    # convention: last axis is the output dim for 2D+ weights
    if len(p.shape) <= 1:
        return max(int(np.prod(p.shape)), 1)
    return int(np.prod(p.shape[:-1]))


def materialize(tree, *, generator: torch.Generator,
                device: DeviceLike = None,
                dtype_override: Optional[torch.dtype] = None):
    """Instantiate real tensors on `device` (None means the card, and
    raises without one). Normal leaves are `randn * scale` drawn in float32
    from `generator`, which must live on that device, leaf by leaf in
    sorted key order; then cast to the leaf's dtype."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device} cannot fill "
                         f"tensors on {dev}")

    def _mk(p: Param):
        dt = dtype_override or p.dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=dev)
        if p.init == "constant":
            return torch.full(p.shape, p.const, dtype=dt, device=dev)
        scale = p.scale if p.scale is not None else 1.0 / np.sqrt(_fan_in(p))
        arr = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                          device=dev)
        return arr.mul_(float(scale)).to(dt)

    return tree_map(_mk, tree)


def stack_params(trees):
    """Stack a list of identically-structured Param trees along a new leading
    'layers' axis (the port loops over it in Python)."""

    def _stack(*ps: Param) -> Param:
        p0 = ps[0]
        if any(p.shape != p0.shape for p in ps):
            raise ValueError("stack_params: leaves differ in shape")
        return dataclasses.replace(
            p0, shape=(len(ps),) + p0.shape, axes=("layers",) + p0.axes)

    return tree_map(_stack, *trees)


def abstractify(tree, sharding_fn: Optional[Callable[[Param], Any]] = None):
    """TensorSpec tree of a Param-spec tree (with `sharding_fn(p)` as each
    leaf's sharding when given): zero allocation."""
    return tree_map_params(
        lambda p: TensorSpec(p.shape, p.dtype,
                             None if sharding_fn is None else sharding_fn(p)),
        tree)


def param_bytes(tree) -> int:
    """Bytes over the leaves of a spec tree, a TensorSpec tree or a tensor
    tree: elements times the dtype's item size."""
    return sum(int(np.prod(leaf.shape)) * leaf.dtype.itemsize
               for leaf in tree_leaves(tree))


def count_params(tree) -> int:
    """Elements over the leaves of a spec tree or a tensor tree."""
    return sum(int(np.prod(leaf.shape)) for leaf in tree_leaves(tree))
