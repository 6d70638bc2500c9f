"""Trip-count-aware HLO text analyzer.

Port of `repro.roofline.hlo_parse`: the port's own copy of the parser
(stdlib only), so the same HLO text gives the same numbers. The port's
steps run eagerly and have no HLO; `roofline/counter.py` counts the same
keys from a torch run.

``compiled.cost_analysis()`` on the CPU backend counts each while-loop body
ONCE, so scanned-layer models under-report FLOPs/bytes by the trip count.
This module parses ``compiled.as_text()`` structurally:

  * builds a per-computation instruction table (name -> result shape),
  * multiplies instructions inside while bodies by the loop trip count
    (extracted from the loop condition's comparison constant),
  * reports: dot/conv FLOPs, HBM bytes (operands+result of every top-level
    non-control instruction — the standard HLO cost-model assumption), and
    per-op collective bytes.

Fusion-internal computations are not double counted: a fusion instruction
contributes its own operands+result only.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1, "token": 0,
    "opaque": 0,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(.*\)\s*->\s*.+\{\s*$")
_INSTR_RE = re.compile(r"^(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(.+)$")
_OPNAME_RE = re.compile(r"\s*([\w\-]+)\(")


def _split_shape_op(rhs: str):
    """'(s32[], bf16[..] /*index=5*/ ...) while(...)' -> (shape_str, op, rest).

    Handles tuple result shapes containing /*index=N*/ comments."""
    rhs = rhs.strip()
    if rhs.startswith("("):
        depth = 0
        for i, ch in enumerate(rhs):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    shape_str = rhs[: i + 1]
                    m = _OPNAME_RE.match(rhs[i + 1:])
                    if not m:
                        return shape_str, None, ""
                    return (shape_str, m.group(1),
                            rhs[i + 1 + m.end() - 1:])
        return rhs, None, ""
    m = re.match(r"([\w\[\]\{\},]+)\s+([\w\-]+)\(", rhs)
    if not m:
        return rhs, None, ""
    return m.group(1), m.group(2), rhs[m.end() - 1:]

_CONTROL_OPS = {
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "after-all", "partition-id", "replica-id", "iota",
}
_COLLECTIVES = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "all-gather-start", "all-reduce-start",
                "collective-permute-start", "ragged-all-to-all"}


def shape_bytes(shape_str: str) -> int:
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


def _shape_dims(shape_str: str) -> Tuple[str, List[int]]:
    """First array shape in the string -> (dtype, dims)."""
    m = _SHAPE_RE.search(shape_str)
    if not m:
        return "", []
    dims = [int(d) for d in m.group(2).split(",")] if m.group(2) else []
    return m.group(1), dims


@dataclasses.dataclass
class Instr:
    name: str
    shape_str: str      # result shape (text before the op name)
    op: str
    operands: List[str]
    attrs: str          # raw text after the op's '(...)'
    raw: str


@dataclasses.dataclass
class Comp:
    name: str
    instrs: List[Instr] = dataclasses.field(default_factory=list)
    shapes: Dict[str, str] = dataclasses.field(default_factory=dict)


class HloModule:
    def __init__(self, hlo_text: str):
        self.comps: Dict[str, Comp] = {}
        self.entry: Optional[str] = None
        self._parse(hlo_text)

    # ------------------------------------------------------------- parse
    def _parse(self, text: str):
        cur: Optional[Comp] = None
        for line in text.splitlines():
            s = line.strip()
            if not s or s.startswith("//"):
                continue
            hm = _HDR_RE.match(s)
            if hm and " = " not in s.split("(")[0]:
                cur = Comp(hm.group(1))
                self.comps[cur.name] = cur
                if s.startswith("ENTRY"):
                    self.entry = cur.name
                # record parameter shapes (fusion-internal dots reference them)
                for pm in re.finditer(r"%?([\w\.\-]+):\s*("
                                      r"(?:\((?:[^()]|\([^()]*\))*\))|"
                                      r"[\w\[\],]+)", s):
                    cur.shapes[pm.group(1)] = pm.group(2)
                continue
            if cur is None:
                continue
            if s == "}" or s.startswith("} "):
                cur = None
                continue
            im = _INSTR_RE.match(s)
            if not im:
                continue
            name, rhs = im.group(1), im.group(2)
            shape_str, op, paren = _split_shape_op(rhs)
            if op is None:
                cur.shapes[name] = shape_str
                continue
            depth = 0
            end = 0
            for i, ch in enumerate(paren):
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                    if depth == 0:
                        end = i
                        break
            inner = paren[1:end]
            attrs = paren[end + 1:]
            operands = re.findall(r"%([\w\.\-]+)", inner)
            cur.instrs.append(Instr(name, shape_str, op, operands, attrs, s))
            cur.shapes[name] = shape_str

    # ---------------------------------------------------------- trip count
    def trip_count(self, cond_name: str) -> int:
        comp = self.comps.get(cond_name)
        if not comp:
            return 1
        consts: Dict[str, int] = {}
        for ins in comp.instrs:
            if ins.op == "constant":
                m = re.search(r"constant\((\d+)\)", ins.raw)
                if m and ins.shape_str.strip().startswith(("s32", "s64", "u32")):
                    consts[ins.name] = int(m.group(1))
        # precise path: ROOT compare(%gte, %constant), direction=LT/LE
        root = next((i for i in comp.instrs if i.raw.startswith("ROOT")), None)
        if root is not None and root.op == "compare":
            dm = re.search(r"direction=(\w+)", root.attrs)
            direction = dm.group(1) if dm else "LT"
            for o in root.operands:
                if o in consts:
                    c = consts[o]
                    return c + 1 if direction == "LE" else max(c, 1)
        return max(consts.values()) if consts else 1

    # ------------------------------------------------------------ analysis
    def _dot_flops(self, comp: Comp, ins: Instr) -> float:
        _, out_dims = _shape_dims(ins.shape_str)
        out_n = 1
        for d in out_dims:
            out_n *= d
        lhs = ins.operands[0] if ins.operands else None
        lhs_shape = comp.shapes.get(lhs, "")
        _, lhs_dims = _shape_dims(lhs_shape)
        cm = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ins.attrs)
        contract = 1
        if cm and cm.group(1):
            for ix in cm.group(1).split(","):
                i = int(ix)
                if i < len(lhs_dims):
                    contract *= lhs_dims[i]
        return 2.0 * out_n * contract

    def _conv_flops(self, comp: Comp, ins: Instr) -> float:
        _, out_dims = _shape_dims(ins.shape_str)
        out_n = 1
        for d in out_dims:
            out_n *= d
        rhs = ins.operands[1] if len(ins.operands) > 1 else None
        _, k_dims = _shape_dims(comp.shapes.get(rhs, ""))
        k_n = 1
        for d in k_dims:
            k_n *= d
        return 2.0 * out_n * max(k_n, 1)

    def _fusion_flops(self, name: str, depth: int = 0) -> float:
        comp = self.comps.get(name)
        if comp is None or depth > 3:
            return 0.0
        total = 0.0
        for ins in comp.instrs:
            if ins.op == "dot":
                total += self._dot_flops(comp, ins)
            elif ins.op == "convolution":
                total += self._conv_flops(comp, ins)
            elif ins.op == "fusion":
                fm = re.search(r"calls=%?([\w\.\-]+)", ins.attrs)
                if fm:
                    total += self._fusion_flops(fm.group(1), depth + 1)
        return total

    def analyze(self) -> Dict[str, float]:
        """Walk from ENTRY, trip-aware. Returns flops / hbm bytes /
        collective bytes (all per-device)."""
        totals = {"dot_flops": 0.0, "hbm_bytes": 0.0, "coll_bytes": 0.0,
                  "transcendental_elems": 0.0}
        coll_by_op: Dict[str, float] = {}
        stack: List[str] = []

        def walk(name: str, mult: float):
            comp = self.comps.get(name)
            if comp is None or name in stack:
                return
            stack.append(name)
            for ins in comp.instrs:
                if ins.op in _CONTROL_OPS:
                    continue
                if ins.op == "while":
                    bm = re.search(r"body=%?([\w\.\-]+)", ins.raw)
                    cm = re.search(r"condition=%?([\w\.\-]+)", ins.raw)
                    if bm and cm:
                        trips = self.trip_count(cm.group(1))
                        walk(bm.group(1), mult * max(trips, 1))
                    continue
                if ins.op == "conditional":
                    for b in re.findall(r"%([\w\.\-]+)", ins.attrs):
                        if b in self.comps:
                            walk(b, mult)
                    continue
                if ins.op == "call":
                    m = re.search(r"to_apply=%?([\w\.\-]+)", ins.attrs)
                    if m:
                        walk(m.group(1), mult)
                    continue
                # ---- cost-bearing instruction ----
                out_b = shape_bytes(ins.shape_str)
                in_b = sum(shape_bytes(comp.shapes.get(o, ""))
                           for o in ins.operands)
                totals["hbm_bytes"] += (out_b + in_b) * mult
                if ins.op == "fusion":
                    # count dot/conv FLOPs fused into the fusion body
                    # (bytes already accounted at the fusion boundary)
                    fm = re.search(r"calls=%?([\w\.\-]+)", ins.attrs)
                    if fm:
                        totals["dot_flops"] += (
                            self._fusion_flops(fm.group(1)) * mult)
                    continue
                if ins.op == "dot":
                    totals["dot_flops"] += self._dot_flops(comp, ins) * mult
                elif ins.op == "convolution":
                    totals["dot_flops"] += self._conv_flops(comp, ins) * mult
                elif ins.op in ("exponential", "tanh", "log", "rsqrt", "sqrt",
                                "power", "logistic"):
                    _, od = _shape_dims(ins.shape_str)
                    n = 1
                    for d in od:
                        n *= d
                    totals["transcendental_elems"] += n * mult
                if ins.op in _COLLECTIVES:
                    base = ins.op.replace("-start", "")
                    moved = max(out_b, in_b)
                    coll_by_op[base] = coll_by_op.get(base, 0.0) + moved * mult
                    totals["coll_bytes"] += moved * mult
            stack.pop()

        if self.entry:
            walk(self.entry, 1.0)
        totals["coll_by_op"] = coll_by_op
        return totals


def analyze_hlo(hlo_text: str) -> Dict[str, float]:
    return HloModule(hlo_text).analyze()
