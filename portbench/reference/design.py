"""The paper's design points and their policy knobs, frozen.

A copy of the simulator's design layer as the benchmark holds it: one
policy spec per memory-system layer, the 8 built-in designs of §6, and
`design_params`, one design's knobs as host scalars (the float knobs as
`np.float32`). The reference runs one design a pass, so it has no
stacked per-row knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np

# translation organizations (paper Fig. 2a/2b + the ideal upper bound)
TRANSLATION_KINDS = ("ideal", "pwc", "shared_l2_tlb", "walk_only")
PARTITION_KINDS = ("shared", "static")
DRAM_KINDS = ("fr_fcfs", "mask")


@dataclasses.dataclass(frozen=True)
class TranslationSpec:
    """Translation-layer policy: organization + cache sizing (Table 1)."""

    kind: str = "shared_l2_tlb"
    l1_entries: int = 64             # fully associative, per core
    l2_entries: int = 512            # 16-way, ASID-tagged, shared
    l2_ways: int = 16
    walk_levels: int = 4             # radix page-table depth
    max_concurrent_walks: int = 64   # walker threads (Table 1)

    def __post_init__(self):
        if self.kind not in TRANSLATION_KINDS:
            raise ValueError(f"translation kind {self.kind!r} not in "
                             f"{TRANSLATION_KINDS}")


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """"shared" contends everything; "static" gives each app a contiguous
    ~1/n slice of L2 sets and DRAM channels (the `Static` baseline)."""

    kind: str = "shared"

    def __post_init__(self):
        if self.kind not in PARTITION_KINDS:
            raise ValueError(f"partition kind {self.kind!r} not in "
                             f"{PARTITION_KINDS}")


@dataclasses.dataclass(frozen=True)
class TokenSpec:
    """TLB-Fill Tokens (§5.2)."""

    enabled: bool = False
    initial_frac: float = 0.25
    step_frac: float = 0.5           # geometric hill-climb step
    bypass_cache_entries: int = 32   # fully associative


@dataclasses.dataclass(frozen=True)
class BypassSpec:
    """TLB-request-aware L2 data-cache bypass (§5.3)."""

    enabled: bool = False


@dataclasses.dataclass(frozen=True)
class DramSpec:
    """"fr_fcfs" is the baseline; "mask" adds the golden/silver/normal
    queues with Eq. (1) silver quotas (§5.4)."""

    kind: str = "fr_fcfs"
    thres_max: int = 500             # Eq. (1) quota ceiling

    def __post_init__(self):
        if self.kind not in DRAM_KINDS:
            raise ValueError(f"dram kind {self.kind!r} not in {DRAM_KINDS}")

    @property
    def enabled(self) -> bool:
        return self.kind == "mask"


@dataclasses.dataclass(frozen=True)
class Design:
    """A named, frozen, hashable design point: one policy spec per layer."""

    name: str
    translation: TranslationSpec = TranslationSpec()
    partition: PartitionSpec = PartitionSpec()
    tokens: TokenSpec = TokenSpec()
    bypass: BypassSpec = BypassSpec()
    dram: DramSpec = DramSpec()
    epoch_cycles: int = 8_000        # paper: 100K; scaled to sim length


class DesignParams(NamedTuple):
    """The policy plane of a Design, as host scalars."""

    use_l2_tlb: bool            # shared L2 TLB organization
    use_pwc: bool               # page-walk-cache organization
    tokens_on: bool             # TLB-Fill Tokens (§5.2)
    initial_frac: np.float32    # initial token fraction
    step_frac: np.float32       # hill-climb step
    bypass_on: bool             # L2 data-cache bypass (§5.3)
    dram_on: bool               # MASK DRAM scheduler (§5.4)
    thres_max: int              # Eq. (1) quota ceiling
    static_part: bool           # static L2$/DRAM partitioning


def design_params(d) -> DesignParams:
    """Pack a design's policy knobs into host scalars."""
    return DesignParams(
        use_l2_tlb=d.translation.kind == "shared_l2_tlb",
        use_pwc=d.translation.kind == "pwc",
        tokens_on=bool(d.tokens.enabled),
        initial_frac=np.float32(d.tokens.initial_frac),
        step_frac=np.float32(d.tokens.step_frac),
        bypass_on=bool(d.bypass.enabled),
        dram_on=d.dram.enabled,
        thres_max=int(d.dram.thres_max),
        static_part=d.partition.kind == "static",
    )


# the paper's named baselines and MASK±component ablations (§6)
_MECHS_OFF = dict(tokens=TokenSpec(enabled=False),
                  bypass=BypassSpec(enabled=False),
                  dram=DramSpec("fr_fcfs"))

BUILTIN_DESIGNS: Tuple[Design, ...] = (
    Design("ideal", translation=TranslationSpec(kind="ideal"), **_MECHS_OFF),
    Design("pwc", translation=TranslationSpec(kind="pwc"), **_MECHS_OFF),
    Design("gpu-mmu", **_MECHS_OFF),
    Design("static", partition=PartitionSpec("static"), **_MECHS_OFF),
    Design("mask", tokens=TokenSpec(enabled=True),
           bypass=BypassSpec(enabled=True), dram=DramSpec("mask")),
    Design("mask-tlb", tokens=TokenSpec(enabled=True)),
    Design("mask-cache", bypass=BypassSpec(enabled=True)),
    Design("mask-dram", dram=DramSpec("mask")),
)

DESIGNS: Dict[str, Design] = {d.name: d for d in BUILTIN_DESIGNS}


def get_design(name: str) -> Design:
    try:
        return DESIGNS[name]
    except KeyError:
        raise KeyError(f"unknown design {name!r}; known: "
                       f"{', '.join(DESIGNS)}") from None
