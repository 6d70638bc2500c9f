"""Composable design points: per-layer policy specs + a design registry.

Port of `repro.core.design`. A `Design` is a frozen, hashable composition
of one policy spec per memory-system layer (translation, partition,
tokens, bypass, dram). The paper's 8 designs are registered compositions.

A design splits into a static signature (shapes and program structure)
and `DesignParams`, the policy knobs. `design_params(d)` gives one
design's knobs as host scalars; the float knobs are `np.float32`, so the
arithmetic they enter matches the reference's float32 scalars. A pass
whose rows hold several designs of one signature group carries
`stack_params(...)`: each knob as its host value where every row agrees,
as an (R,) device tensor where the rows differ. The stages branch on
which of the two a knob is, never on a device value, so the cycle loop
needs no host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

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

    def with_(self, **overrides) -> "Design":
        """`dataclasses.replace` where a dict value merges into the
        corresponding spec instead of replacing it wholesale."""
        fields = {f.name for f in dataclasses.fields(self)}
        updates = {}
        for key, val in overrides.items():
            if key not in fields:
                raise TypeError(f"Design has no layer/field {key!r} "
                                f"(have: {', '.join(sorted(fields))})")
            cur = getattr(self, key)
            if isinstance(val, dict) and dataclasses.is_dataclass(cur):
                val = dataclasses.replace(cur, **val)
            updates[key] = val
        return dataclasses.replace(self, **updates)

    replace = with_


@dataclasses.dataclass(frozen=True)
class StaticSignature:
    """The shape/structure plane of a Design."""

    ideal: bool
    l1_entries: int
    l2_entries: int
    l2_ways: int
    walk_levels: int
    max_concurrent_walks: int
    bypass_cache_entries: int
    epoch_cycles: int


def static_signature(d) -> StaticSignature:
    d = as_design(d)
    tr = d.translation
    return StaticSignature(
        ideal=tr.kind == "ideal",
        l1_entries=tr.l1_entries,
        l2_entries=tr.l2_entries,
        l2_ways=tr.l2_ways,
        walk_levels=tr.walk_levels,
        max_concurrent_walks=tr.max_concurrent_walks,
        bypass_cache_entries=d.tokens.bypass_cache_entries,
        epoch_cycles=d.epoch_cycles,
    )


def canonical_design(sig: StaticSignature) -> Design:
    """The canonical representative `Design` of a signature group; its
    policy fields are placeholders that the stages never read."""
    kind = "ideal" if sig.ideal else "shared_l2_tlb"
    return Design(
        name=f"__sig:{'ideal' if sig.ideal else 'std'}__",
        translation=TranslationSpec(
            kind=kind, l1_entries=sig.l1_entries,
            l2_entries=sig.l2_entries, l2_ways=sig.l2_ways,
            walk_levels=sig.walk_levels,
            max_concurrent_walks=sig.max_concurrent_walks),
        tokens=TokenSpec(bypass_cache_entries=sig.bypass_cache_entries),
        epoch_cycles=sig.epoch_cycles,
    )


class DesignParams(NamedTuple):
    """The policy plane of a Design. From `design_params`, one design's
    knobs as host scalars. From `stack_params`, the knobs of a pass's
    rows: each knob is its host value where every row agrees and its (R,)
    tensor where the rows differ; the stages take the branch of a host
    value as it is and run a knob given as a tensor as a per-row masked
    path."""

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
    d = as_design(d)
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


# the reference's leaf types of a stacked DesignParams; the rest are bool
_ROW_DTYPES = {"initial_frac": torch.float32, "step_frac": torch.float32,
               "thres_max": torch.int32}


def stack_params(dps, repeat: int, device) -> DesignParams:
    """Stack one `DesignParams` per design, each repeated for `repeat`
    rows: design-major, row g * repeat + m is (design g, mix m), as the
    reference's `run_grid` stacks them (`src/repro/sim/runner.py:478`).
    A knob on which every row agrees stays its host value; one whose rows
    differ becomes an (R,) tensor on `device`, of the reference's stacked
    dtype: bool for the switches, float32 for the fractions, int32 for
    `thres_max`."""
    knobs = []
    for f, vals in zip(DesignParams._fields, zip(*dps)):
        if all(v == vals[0] for v in vals):
            knobs.append(vals[0])
        else:
            knobs.append(torch.tensor(
                np.repeat(np.asarray(vals), repeat),
                dtype=_ROW_DTYPES.get(f, torch.bool), device=device))
    return DesignParams(*knobs)


def from_legacy(dp) -> Design:
    """Convert a legacy `repro_torch.core.mask.DesignPoint` to a `Design`."""
    if isinstance(dp, Design):
        return dp
    m = dp.mask
    if dp.ideal_tlb:
        kind = "ideal"
    elif dp.use_pwc:
        if dp.use_l2_tlb:
            # the old pipeline would run BOTH the shared L2 TLB and the
            # PWC for this flag combo; no TranslationSpec kind expresses
            # that, so refuse rather than drop one of them
            raise ValueError(
                f"legacy DesignPoint {dp.name!r} sets both use_l2_tlb and "
                "use_pwc; that combination has no Design equivalent — "
                "pick one translation organization")
        kind = "pwc"
    elif dp.use_l2_tlb:
        kind = "shared_l2_tlb"
    else:
        kind = "walk_only"
    return Design(
        name=dp.name,
        translation=TranslationSpec(
            kind=kind, l1_entries=m.l1_tlb_entries,
            l2_entries=m.l2_tlb_entries, l2_ways=m.l2_tlb_ways,
            walk_levels=m.walk_levels,
            max_concurrent_walks=m.max_concurrent_walks),
        partition=PartitionSpec(
            "static" if dp.static_partition else "shared"),
        tokens=TokenSpec(enabled=m.tlb_tokens,
                         initial_frac=m.initial_token_frac,
                         step_frac=m.token_step_frac,
                         bypass_cache_entries=m.bypass_cache_entries),
        bypass=BypassSpec(enabled=m.l2_bypass),
        dram=DramSpec("mask" if m.dram_sched else "fr_fcfs",
                      thres_max=m.thres_max),
        epoch_cycles=m.epoch_cycles,
    )


def as_design(d) -> Design:
    """Normalize str | Design | legacy DesignPoint to a Design."""
    if isinstance(d, Design):
        return d
    if isinstance(d, str):
        return get_design(d)
    if hasattr(d, "mask") and hasattr(d, "name"):  # legacy DesignPoint
        return from_legacy(d)
    raise TypeError(f"not a design name/Design/DesignPoint: {d!r}")


_REGISTRY: Dict[str, Design] = {}


def register_design(d: Design, *, overwrite: bool = False) -> Design:
    """Register a design under its name; refuses to shadow a different
    design of the same name unless `overwrite=True`."""
    d = as_design(d)
    prev = _REGISTRY.get(d.name)
    if prev is not None and prev != d and not overwrite:
        raise ValueError(
            f"design {d.name!r} already registered with different specs; "
            "pass overwrite=True or pick another name")
    _REGISTRY[d.name] = d
    return d


def get_design(name: str) -> Design:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown design {name!r}; registered: "
                       f"{', '.join(sorted(_REGISTRY))}") from None


def list_designs() -> Tuple[str, ...]:
    """Registered design names, built-ins first (registration order)."""
    return tuple(_REGISTRY)


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

for _d in BUILTIN_DESIGNS:
    register_design(_d)
