"""Split-TF32 arithmetic of the port's CUDA kernels, emulated in PyTorch.

The `mma.sync` TF32 products of `csrc/ssd_scan.cu` and
`csrc/flash_attention.cu` compute a.b as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
with a_hi = tf32(a) and a_lo = tf32(a - a_hi), rounded as
`cvt.rna.tf32.f32` rounds. The kernels' plain split references
(`ssd_scan/ref.py`, `flash_attention/ref.py`) build on these two
functions so that the CPU tests can hold that arithmetic to the
reference.
"""
from __future__ import annotations

import torch


def tf32_round(t):
    """float32 -> the nearest TF32 value (10 stored mantissa bits), ties
    away from zero, as a float32: `cvt.rna.tf32.f32` on the int32 view
    (add half of the dropped 13 bits' unit to the magnitude, clear them)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_einsum(eq, a, b):
    """einsum(eq, a, b) in split TF32: hi.hi + hi.lo + lo.hi, each partial
    product exact in float32 and summed in float32."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))
