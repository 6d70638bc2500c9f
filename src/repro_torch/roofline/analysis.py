"""Roofline analysis: three terms per (arch x shape x mesh).

Port of `repro.roofline.analysis`, with the constants of one NVIDIA H100
SXM (NVIDIA's H100 Tensor Core GPU datasheet, SXM5 column, dense rates):

    compute    = FLOPs      / (chips x 989e12 bf16 FLOP/s)
    memory     = HBM bytes  / (chips x 3.35e12 B/s HBM3)
    collective = coll_bytes / (chips x 18 links x 25e9 B/s NVLink 4)

`collective_bytes_from_hlo` is the reference's parser, kept here (stdlib
only) so the same HLO text gives the same numbers: it walks the HLO
computation graph, multiplies instructions inside ``while`` bodies by
their trip counts, and sums per-shard bytes of all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute ops. `model_flops` and
`roofline_terms` keep the reference's formulas. A torch step's FLOPs and
collective bytes come from `roofline/counter.py`.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

# ---- NVIDIA H100 SXM constants (NVIDIA's H100 datasheet, SXM5) ----
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12           # bytes/s of HBM3 per card
NVLINK_BW = 25e9           # bytes/s per NVLink 4 link, each direction
NVLINK_LINKS = 18          # NVLink 4 links per card (900 GB/s both ways)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    """'bf16[16,1024]{1,0}' -> bytes. Tuple shapes: sum of element shapes."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class Computation:
    name: str
    coll_bytes: Dict[str, int]
    whiles: List[Tuple[str, str]]          # (body_name, cond_name)
    calls: List[str]                        # called computations (call/cond branches)


def _parse_computations(hlo: str) -> Dict[str, Computation]:
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in hlo.splitlines():
        s = line.strip()
        header = re.match(r"(?:ENTRY\s+)?%?([\w\.\-]+)\s*\([^)]*\)\s*->.*{", s)
        if header and not s.startswith("ROOT") and "=" not in s.split("(")[0]:
            cur = Computation(header.group(1), {}, [], [])
            comps[cur.name] = cur
            continue
        if cur is None:
            continue
        if s.startswith("}"):
            cur = None
            continue
        # collective instruction?
        for op in _COLLECTIVES:
            # match ' = <shape> op-name(' including "-start" variants
            if re.search(rf"=\s*[^=]*\b{op}(-start)?\(", s):
                lhs_rhs = s.split("=", 1)
                if len(lhs_rhs) != 2:
                    continue
                # operand bytes: shapes of the operands inside the parens;
                # use the result shape (per-shard) as proxy for moved bytes
                bytes_ = _shape_bytes(lhs_rhs[1].split(f"{op}")[0])
                if bytes_ == 0:
                    bytes_ = _shape_bytes(lhs_rhs[1])
                cur.coll_bytes[op] = cur.coll_bytes.get(op, 0) + bytes_
                break
        m = re.search(r"while\(.*\),\s*condition=%?([\w\.\-]+),\s*body=%?([\w\.\-]+)", s)
        if m:
            cur.whiles.append((m.group(2), m.group(1)))
        for cm in re.finditer(r"(?:to_apply|branch_computations|called_computations)="
                              r"[{]?%?([\w\.\-,% ]+)[}]?", s):
            for name in re.split(r"[,\s]+", cm.group(1)):
                name = name.strip().lstrip("%")
                if name:
                    cur.calls.append(name)
    return comps


def _trip_count(cond_name: str, hlo_comps: Dict[str, str]) -> int:
    """Best-effort scan trip count: the comparison constant in the while cond."""
    body = hlo_comps.get(cond_name, "")
    consts = [int(x) for x in re.findall(r"s32\[\]\s+constant\((\d+)\)", body)]
    return max(consts) if consts else 1


def _raw_computation_texts(hlo: str) -> Dict[str, str]:
    texts: Dict[str, str] = {}
    cur_name, buf = None, []
    for line in hlo.splitlines():
        s = line.strip()
        header = re.match(r"(?:ENTRY\s+)?%?([\w\.\-]+)\s*\([^)]*\)\s*->.*{", s)
        if header:
            cur_name = header.group(1)
            buf = []
            continue
        if cur_name is not None:
            if s.startswith("}"):
                texts[cur_name] = "\n".join(buf)
                cur_name = None
            else:
                buf.append(s)
    return texts


def collective_bytes_from_hlo(hlo: str, entry_hint: Optional[str] = None
                              ) -> Dict[str, int]:
    """Total per-chip collective bytes by op kind, trip-count aware."""
    comps = _parse_computations(hlo)
    texts = _raw_computation_texts(hlo)

    entry = None
    em = re.search(r"ENTRY\s+%?([\w\.\-]+)", hlo)
    if em:
        entry = em.group(1)
    if entry is None or entry not in comps:
        entry = entry_hint or (next(iter(comps)) if comps else None)
    if entry is None:
        return {}

    totals: Dict[str, int] = {}
    seen_stack: List[str] = []

    def walk(name: str, mult: int):
        if name not in comps or name in seen_stack:
            return
        seen_stack.append(name)
        c = comps[name]
        for op, b in c.coll_bytes.items():
            totals[op] = totals.get(op, 0) + b * mult
        for body, cond in c.whiles:
            trips = _trip_count(cond, texts)
            walk(body, mult * max(trips, 1))
        for callee in c.calls:
            walk(callee, mult)
        seen_stack.pop()

    walk(entry, 1)
    return totals


# ---------------------------------------------------------------------------
# Roofline report
# ---------------------------------------------------------------------------

def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode: D = batch
    tokens per step. Train includes 3x (fwd+bwd)."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int) -> Dict[str, float]:
    compute_s = flops / (chips * PEAK_FLOPS)
    memory_s = hbm_bytes / (chips * HBM_BW)
    collective_s = coll_bytes / (chips * NVLINK_LINKS * NVLINK_BW)
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1])[0]
    total = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": total,
        "roofline_fraction": (compute_s / total) if total > 0 else 0.0,
    }
