"""What the simulator's entry types share: the rows of a sweep, set-up,
the spans of a traced run, the check of every row against the plain
reference, its control, and what the benchmark's CPU tests take from
them."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import mixes as mixes_mod
from portbench import reference
from portbench.entries import Entry, Fault, Tests

# cycles of set-up's one warm call, at the cell's own rows and designs
WARM_CYCLES = 2
STEP = "portbench.step"
ROUND = "portbench.fused_round"
# the program's functions wrapped in spans in a traced run
SPANS = (
    ("repro_torch.sim.runner", "step", STEP),
    ("repro_torch.sim.runner", "init_state", "portbench.init_state"),
    ("repro_torch.sim.runner", "state_to_numpy", "portbench.to_host"),
    ("repro_torch.sim.runner", "_stats", "portbench.stats"),
    ("repro_torch.kernels.fused_tlb.ops", "fused_tlb_round", ROUND),
    ("repro_torch.kernels.fused_tlb.ops", "fused_tlb_access_ref", ROUND),
)

# (mixes, cycles) -> each design's per-row stats dicts, in the order of mixes
Run = Callable[[list, int], Dict[str, List[dict]]]


def check_sizes(config: dict) -> None:
    """Raise ValueError where a size of the program's `SimConfig` differs
    from the configuration file's (the cycle count is the entry's
    argument): the program's entries take its default sizes."""
    from repro_torch.sim.config import SimConfig
    prog = SimConfig(n_apps=config["n_apps"], device="cpu")
    for f in dataclasses.fields(prog):
        if f.name in config and f.name != "sim_cycles" \
                and getattr(prog, f.name) != config[f.name]:
            raise ValueError(
                f"the program's SimConfig.{f.name} is "
                f"{getattr(prog, f.name)!r}, the configuration's "
                f"{config[f.name]!r}")


def sim_entry(config: dict, traffic: dict, device, designs, run: Run,
              shrink: Optional[dict] = None) -> Entry:
    """The entry that times `run` over the traffic's rows for the
    configuration's cycles. `shrink` ({"rows": k, "cycles": c,
    "warm_cycles": w}) cuts it for the benchmark's own CPU tests."""
    designs = list(designs)
    mixes = mixes_mod.rows(config["n_apps"], traffic)
    cycles, warm_cycles = config["sim_cycles"], WARM_CYCLES
    if shrink:
        mixes, cycles = mixes[:shrink["rows"]], shrink["cycles"]
        warm_cycles = shrink.get("warm_cycles", warm_cycles)
    on_cuda = torch.device(device).type == "cuda"

    def warm():
        if on_cuda:
            from repro_torch.kernels import _build
            _build.load("fused_tlb")
        run(mixes, warm_cycles)

    def check(calls):
        if on_cuda:
            torch.cuda.empty_cache()
        truth = {d: dict(zip(mixes, reference.run_rows(d, mixes, cycles,
                                                       device, config)))
                 for d in designs}
        return compare(calls, designs, truth)

    def after_trace(calls):
        """Each fused round's work in a replay of the first profiled
        call, whose rounds get the same inputs."""
        work: list = []
        with round_work_recorder(work):
            run(calls[0].plan, cycles)
        return {"round_work": work}

    return Entry(answers=len(designs) * len(mixes),
                 work=len(designs) * len(mixes) * cycles,
                 plan=lambda seed, k: mixes_mod.order(mixes, seed, k),
                 call=lambda plan: run(plan, cycles), warm=warm,
                 check=check, spans=SPANS, after_trace=after_trace)


def same(a: dict, b: dict) -> bool:
    """Two stats dicts float-hex equal: the same keys, and every value
    the same float64 bits in the same shape."""
    if not isinstance(a, dict) or set(a) != set(b):
        return False
    for k in a:
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            return False
    return True


def compare(calls, designs, truth: Dict[str, dict]):
    """Every row of every call against the reference: rows whose stats
    differ in any bit, and rows the program gave no stats for (a call
    that raised gave none)."""
    mismatched = missing = 0
    for c in calls:
        for d in designs:
            got = (c.results or {}).get(d)
            for i, mix in enumerate(c.plan):
                if got is None or i >= len(got) or not isinstance(got[i],
                                                                  dict):
                    missing += 1
                elif not same(got[i], truth[d][mix]):
                    mismatched += 1
    return ({"rows_mismatched": {"value": mismatched, "limit": 0},
             "rows_missing": {"value": missing, "limit": 0}}, missing)


@contextlib.contextmanager
def round_work_recorder(out: list):
    """Record (bytes, operations) of every fused round run inside, in
    order (`work.round_work_rows`), by wrapping the round."""
    from portbench import work
    from repro_torch.kernels.fused_tlb import ops
    saved = (ops.fused_tlb_round, ops.fused_tlb_access_ref)

    def wrap(fn):
        def wrapped(tags, asids, lru, vpn, asid, active, may_fill, time,
                    *, n_waves=1, track_asids=True):
            before = (tags.clone(), asids.clone(), lru.clone())
            res = fn(tags, asids, lru, vpn, asid, active, may_fill, time,
                     n_waves=n_waves, track_asids=track_asids)
            out.append(work.round_work_rows(before, vpn, active, res,
                                            n_waves, track_asids))
            return res
        return wrapped

    ops.fused_tlb_round, ops.fused_tlb_access_ref = map(wrap, saved)
    try:
        yield
    finally:
        ops.fused_tlb_round, ops.fused_tlb_access_ref = saved


def control(config: dict, traffic: dict, device, shrink=None,
            dtype=None) -> Entry:
    """The control: the plain reference with its float planes in `dtype`
    (bfloat16, the nearest precision below the configuration's float32),
    put in the program's place."""
    from portbench.reference import precision
    designs = list(traffic["designs"])
    dtype = torch.bfloat16 if dtype is None else dtype

    def run(mixes, cycles):
        with precision.lowered(dtype):
            return {d: reference.run_rows(d, mixes, cycles, device, config)
                    for d in designs}

    return sim_entry(config, traffic, device, designs, run, shrink)


# ---- what the benchmark's CPU tests plant under a run ---------------------

def _timed(cfg, shrink) -> bool:
    """Whether a config is the timed calls' (set-up's warm call is not)."""
    return cfg.sim_cycles == shrink["cycles"]


def _unchanged_step(monkeypatch, shrink):
    """A step that returns its state unchanged."""
    from repro_torch.sim import runner
    real = runner.step
    monkeypatch.setattr(runner, "step", lambda cfg, dp, pm, st, c: st
                        if _timed(cfg, shrink) else real(cfg, dp, pm, st, c))


def _half_the_rows(monkeypatch, shrink):
    """Half of the rows left out, the other half's answers in their
    place."""
    from repro_torch.sim import runner
    real = runner._run_rows

    def half(cfg, dp, mixes):
        if not _timed(cfg, shrink):
            return real(cfg, dp, mixes)
        keep = (len(mixes) + 1) // 2
        if not isinstance(dp.use_pwc, torch.Tensor):
            final = real(cfg, dp, mixes[:keep])
        else:   # per-row knobs: cut them with the rows
            dp = type(dp)(*(k[:keep] if isinstance(k, torch.Tensor) else k
                            for k in dp))
            final = real(cfg, dp, mixes[:keep])
        idx = np.arange(len(mixes)) % keep
        return type(final)(*_take(final, idx))
    monkeypatch.setattr(runner, "_run_rows", half)


def _take(tree, idx):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [type(x)(*_take(x, idx)) if isinstance(x, tuple) else
                x[idx] for x in tree]
    return tree[idx]


def _altered_answer(monkeypatch, shrink):
    """One row's answer one ulp off, where it is produced."""
    from repro_torch.sim import runner
    real = runner._stats
    seen = []

    def stats(cfg, st, audit=None):
        out = real(cfg, st, audit)
        seen.append(_timed(cfg, shrink))
        if sum(seen) == 2 and seen[-1]:   # one row's answer, one ulp off
            out["ipc"] = np.nextafter(out["ipc"], np.inf)
        return out
    monkeypatch.setattr(runner, "_stats", stats)


# cycle counts no other test file runs the port at
TESTS = Tests(
    dry_run={"rows": 4, "cycles": 11, "warm_cycles": 13},
    faults_shrink={"rows": 5, "cycles": 19, "warm_cycles": 17},
    faults=tuple(Fault(f, ("rows_mismatched", "rows_missing")) for f in
                 (_unchanged_step, _half_the_rows, _altered_answer)),
    control_checks=("rows_mismatched",))
