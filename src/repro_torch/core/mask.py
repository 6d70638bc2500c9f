"""Static partitioning and the `design(name)` shim (port of `repro.core.mask`)."""
from __future__ import annotations

import torch

from repro_torch.core.design import Design, get_design


def static_partition_index(index, n_resources: int, n_apps: int, app):
    """Static resource partitioning (the `Static` design, §6): app `a` owns
    the contiguous slice (a*n)//n_apps .. ((a+1)*n)//n_apps of an index
    space (L2 sets, DRAM channels); at least one unit, clipped into range.

    index/app: int32 tensors (floor mod, as the reference); n_resources
    and n_apps: ints."""
    na = max(n_apps, 1)
    start = (app * n_resources) // na
    span = ((app + 1) * n_resources // na - start).clamp(min=1)
    return torch.clamp(start + index % span, max=n_resources - 1)


def design(name: str) -> Design:
    """The named design point, served by the registry."""
    return get_design(name)


# the paper's named designs
ALL_DESIGNS = ("ideal", "pwc", "gpu-mmu", "static", "mask",
               "mask-tlb", "mask-cache", "mask-dram")
