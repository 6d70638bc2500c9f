"""One run of one cell: set-up, the measured window, the traced window,
the check, and the result line.

Everything that belongs to one cell is found by name: the workload's
entry in `BENCHMARK.json` names its configuration (a file of sizes) and
its traffic (`traffic/<name>.json`); the traffic names its entry type
(`entries/<entry>.py`), which holds the inputs, set-up, reference and
comparison of its kind of work; each metric the cell reports is read by
`metrics/<name>.py`, a `read(run)` that returns a number or None. The
harness itself only times, traces and reports.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from portbench import trace as trace_mod
from portbench.entries import Call, Entry

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    calls: List[Call]
    trace: Optional[trace_mod.Trace] = None


@dataclasses.dataclass
class Cell:
    config: dict
    traffic: dict


def load_bench(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `bench`, its files read from under `root`."""
    (wl,) = [w for w in bench["workloads"] if w["name"] == name]
    (cfg,) = [c for c in bench["configs"] if c["name"] == wl["config"]]
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{wl['traffic']}.json")
        .read_text())
    return Cell(config=config, traffic=traffic)


def entry_module(cell: Cell, root: Path = ROOT):
    """The module of the entry type the cell's traffic names: its `make`,
    `control` and `TESTS`."""
    kind = cell.traffic["entry"]
    return _load_file(root / "portbench" / "entries" / f"{kind}.py",
                      f"portbench_entry_{kind}")


def make_entry(cell: Cell, device, root: Path = ROOT,
               shrink: Optional[dict] = None) -> Entry:
    """The entry of the type the cell's traffic names."""
    return entry_module(cell, root).make(cell.config, cell.traffic, device,
                                         shrink=shrink)


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that `cell`
    reports: those that list it, or list no cells."""
    mine = [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return mine
    moved = {m["name"] for m in mine}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in moved]


def read_metrics(specs: List[dict], run: Run, root: Path = ROOT) -> dict:
    out = {}
    for i, m in enumerate(specs):
        mod = _load_file(root / "portbench" / "metrics" / f"{m['name']}.py",
                         f"portbench_metric_{i}")
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _window(entry: Entry, seed: int, seconds: float) -> List[Call]:
    """Whole calls from the window's start until one ends past `seconds`
    and there are `entry.min_calls`; a call that raises ends the window."""
    calls: List[Call] = []
    w0 = time.perf_counter()
    while True:
        c = Call(plan=entry.plan(seed, len(calls)), start=0.0,
                 work=entry.work)
        c.start = time.perf_counter()
        try:
            with torch.profiler.record_function(trace_mod.CALL):
                c.results = entry.call(c.plan)
        except Exception as e:  # noqa: BLE001 — a failing call is a result
            c.error = f"{type(e).__name__}: {e}"
        c.end = time.perf_counter()
        calls.append(c)
        if c.error or (c.end - w0 >= seconds
                       and len(calls) >= entry.min_calls):
            return calls


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device="cuda", bench: Optional[dict] = None,
             root: Path = ROOT, shrink: Optional[dict] = None,
             entry: Optional[Entry] = None, t_start: Optional[float] = None,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)
             ) -> Tuple[dict, dict]:
    """One run of cell `name`; returns (result line, checks).

    `shrink` is handed to the entry type, to cut the cell for the
    benchmark's own CPU tests; `entry` puts another entry (the control)
    in the program's place."""
    t0 = time.perf_counter() if t_start is None else t_start
    marks = [("start and imports", time.perf_counter())]
    bench = load_bench() if bench is None else bench
    if entry is None:
        entry = make_entry(resolve(bench, name, root), device, root, shrink)
    on_cuda = torch.device(device).type == "cuda"
    marks.append(("entry", time.perf_counter()))

    # ---- set-up: the seed's weights and inputs, libraries, every shape --
    if entry.prepare is not None:
        entry.prepare(seed)
        marks.append(("prepare", time.perf_counter()))
    entry.warm()
    _sync(device)
    marks.append(("warm", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    log(f"portbench: set-up {setup_s:.3f} s: " + ", ".join(
        f"{what} {t - t_prev:.3f} s" for (what, t), t_prev in
        zip(marks, [t0] + [t for _, t in marks])))
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()

    # ---- the window ------------------------------------------------------
    gc.collect()
    tr = None
    if not traced:
        calls = _window(entry, seed, seconds)
    else:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_cuda else [])
        counts: dict = {}
        with profile(activities=acts) as prof, \
                trace_mod.instrument(entry.spans, counts):
            calls = _window(entry, seed,
                            min(seconds, trace_mod.TRACE_SECONDS))
            _sync(device)
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    w = calls[-1].end - calls[0].start
    log(f"portbench: set-up {setup_s:.3f} s, {len(calls)} calls in "
        f"{w:.3f} s of window: "
        + " ".join(f"{c.end - c.start:.3f}" for c in calls))
    if traced and not calls[-1].error:
        tr = trace_mod.reduce(prof, entry.work, counts, on_cuda)
        del prof
        log(f"portbench: {len(tr.calls)} calls traced, "
            f"{len(tr.device_ops)} device operations, {tr.unlinked} "
            "without their launch")
        if entry.after_trace is not None:
            tr.extra = entry.after_trace(calls)

    # ---- the check, after the window and the memory reading ------------
    t_ref = time.perf_counter()
    checks, failed = entry.check(calls)
    log(f"portbench: check {time.perf_counter() - t_ref:.3f} s")
    for c in calls:
        if c.error:
            log(f"portbench: call failed: {c.error}")
    run = Run(setup_s=setup_s, calls=[c for c in calls if not c.error],
              trace=tr)
    kind = "per_layer" if traced else "end_to_end"
    result = {
        "correct": all(v["value"] <= v["limit"] for v in checks.values()),
        "attempted": len(calls) * entry.answers,
        "failed": failed,
        "metrics": read_metrics(metrics_of(bench, name, kind), run, root),
        "device": _device(device, peak, tr),
    }
    if tr is not None:
        result["breakdown"] = trace_mod.breakdown(tr)
    result["checks"] = checks
    return result, checks


def _device(device, peak: int, tr) -> dict:
    on_cuda = torch.device(device).type == "cuda"
    out = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name() if on_cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        out["busy_s"] = tr.busy_ns() / 1e9
        out["window_s"] = tr.window_ns / 1e9
    return out


def forbidden_modules(names=None) -> List[str]:
    """Top-level names among `names` (default: `sys.modules`) that the
    port must not load, compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
