"""The float type of the simulator's float planes.

The simulator keeps its float planes (retired instructions, the summed
latencies of the stat planes, token arithmetic, the DRAM quota weights)
in float32. `FLOAT` is read at each use, so `lowered(dtype)` runs the
whole reference in a lower precision: the benchmark's control, which
`correct` must refuse.
"""
from __future__ import annotations

import contextlib

import torch

FLOAT = torch.float32


@contextlib.contextmanager
def lowered(dtype: torch.dtype):
    """Run the reference with its float planes in `dtype`."""
    global FLOAT
    saved, FLOAT = FLOAT, dtype
    try:
        yield
    finally:
        FLOAT = saved
