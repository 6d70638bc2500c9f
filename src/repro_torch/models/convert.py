"""Carry model params and caches between the reference and the port, via
numpy.

A reference tree fetched to the host (`jax.device_get` of `repro.models`
params, or of a decode cache dict, SSM state included) is a nested dict
of numpy arrays; it becomes the port's nested dict of tensors with the
same keys, and back.
float32 and integer arrays carry as they are. A JAX bfloat16 array comes
to numpy as a 2-byte array of an extension dtype named "bfloat16"; its
bits are read through int16 and viewed as `torch.bfloat16`, so nothing
beyond numpy is needed. Going back, a bfloat16 tensor becomes a float32
array, which holds every bfloat16 value exactly
(`tensor_from_numpy(..., dtype=torch.bfloat16)` restores the bits).
Nothing here imports the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.params import tree_map


def tensor_from_numpy(arr, device, dtype: Optional[torch.dtype] = None):
    """One numpy array (float32, int, or JAX's bfloat16) -> a tensor on
    `device`; a floating-point array is cast to `dtype` if given."""
    arr = np.array(arr, order="C")          # a copy; keeps 0-d arrays 0-d
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy; bfloat16 widens to float32 exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def tree_from_numpy(tree, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None):
    """Reference params or caches (nested dicts of numpy arrays) -> the
    port's, on `device` (None means the card, and raises without one)."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev, dtype), tree)


def tree_to_numpy(tree):
    """The port's params or caches -> nested dicts of numpy arrays."""
    return tree_map(tensor_to_numpy, tree)
