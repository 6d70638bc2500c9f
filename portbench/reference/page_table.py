"""Multi-level (radix) page tables: functional, array-free address math.

uint32 values live in int64 tensors holding 0 .. 2**32-1, masked with
`MASK32` after every add and multiply; results go back to int32 through
`wrap_i32`, a two's-complement wrap.
"""
from __future__ import annotations

import dataclasses

import torch

MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class PageTableConfig:
    levels: int = 4
    bits_per_level: int = 9          # x86-64-style 9 bits/level
    page_bits: int = 12              # 4KB pages
    pte_bytes: int = 8
    line_bytes: int = 128            # GPU cache line

    @property
    def vpn_bits(self) -> int:
        return self.levels * self.bits_per_level


def u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 view of an integer tensor (as `astype(uint32)`), in int64."""
    if x.dtype != torch.int64:
        x = x.to(torch.int64)
    return x & MASK32


def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for uint32 `x` (int64) and a uint32 constant `c`.

    A constant of 2**31 or more is replaced by c - 2**32, which is equal
    mod 2**32: then |x * c| < 2**63 and the int64 product is exact (a
    plain product of two uint32 values can pass 2**63). The mask takes
    the low 32 bits of the two's-complement result."""
    return (x * (c - (1 << 32) if c >= 1 << 31 else c)) & MASK32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's-complement wrap)."""
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """Cheap deterministic 32-bit mixer (xorshift-multiply); uint32 in int64."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul_u32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def pte_line_addresses(cfg: PageTableConfig, asid, vpn) -> torch.Tensor:
    """Physical line addresses of the PTEs touched by a walk.

    asid/vpn: (...,) int32 -> (..., levels) int32 line ids. All levels are
    computed in one vectorized pass over a trailing level axis."""
    k = torch.arange(cfg.levels, device=vpn.device)
    shift = (cfg.levels - 1 - k) * cfg.bits_per_level
    prefix = u32(vpn)[..., None] >> shift          # entry index at level k
    line = prefix // (cfg.line_bytes // cfg.pte_bytes)
    region = (mul_u32(u32(asid), cfg.levels + 1)[..., None] + (k + 1)) & MASK32
    base = _mix(region) & 0x0FFFFFFF
    return wrap_i32(base + line)


def translate(cfg: PageTableConfig, asid, vpn) -> torch.Tensor:
    """VPN -> PFN (deterministic, disjoint across ASIDs), int32."""
    x = mul_u32(u32(asid), 0x9E3779B9) + u32(vpn)
    return wrap_i32(_mix(x) & 0x3FFFFFFF)


def walk_depth_tag(level: int) -> int:
    """3-bit page-walk-depth tag carried by memory requests (§5.3):
    0 = normal data, 1..6 = walk level, 7 = deeper."""
    return min(level + 1, 7)
