"""Where a traced run's step goes, stage by stage.

    python3 portbench/stages.py --workload <name> --seed <n> [--seconds s]

Runs one cell traced, as `run.py --trace 1` does, then joins the
program's spans (`repro_torch.spans`, on the profiler's host clock) with
the profiler's device operations by the time the host launched each
one. Prints, for each stage span of the cycle step, the host self time,
the device operations launched and their device time, each a
pass-cycle (a stage's self time leaves out the fused round's span inside
it); and the join's own check: the share of the operations
launched inside the benchmark's `portbench.step` wrapper whose launch
lies inside a program `sim.step` span, and the operations launched inside
the stage spans against `kernels_per_cycle` x steps; and, a call, the
count, time and self time of the program's other spans (the pass, its
cold start, the fused round, the transfer, the stats). The result line of
the run is printed first; the table is the last line, as JSON.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGES = ("sched", "probe", "front", "memory", "commit", "retire", "stats",
          "epoch")


def join(tr, records) -> dict:
    """The stage table and the join's check for a `Trace` and the
    program's records (`spans.log()`)."""
    child_ns = [0] * len(records)
    for n, s, e, p, _ in records:
        if p >= 0:
            child_ns[p] += e - s
    inside = [i for i, r in enumerate(records)
              if any(cs <= r[1] < ce for cs, ce in tr.calls)]
    steps = [records[i] for i in inside if records[i][0] == "sim.step"]
    n_steps = len(steps)
    stage_spans = sorted((records[i][1], records[i][2],
                          records[i][0].rsplit(".", 1)[1])
                         for i in inside
                         if records[i][0].startswith("sim.step."))
    starts = [s for s, _, _ in stage_spans]
    table = {st: {"host_ns": 0, "host_self_ns": 0, "ops": 0, "device_ns": 0}
             for st in STAGES}
    for i in inside:
        n, s, e = records[i][:3]
        if n.startswith("sim.step."):
            row = table[n.rsplit(".", 1)[1]]
            row["host_ns"] += e - s
            row["host_self_ns"] += e - s - child_ns[i]
    for _, s, e, launch in tr.device_ops:
        k = bisect.bisect_right(starts, launch) - 1
        if k >= 0 and launch < stage_spans[k][1]:
            row = table[stage_spans[k][2]]
            row["ops"] += 1
            row["device_ns"] += e - s
    step_starts = [s for _, s, _, _, _ in steps]

    def in_step(t):
        k = bisect.bisect_right(step_starts, t) - 1
        return k >= 0 and t < steps[k][2]

    runner: dict = {}
    for i in inside:
        n, s, e = records[i][:3]
        if not n.startswith("sim.step"):
            row = runner.setdefault(n, {"count": 0, "ms": 0.0, "self_ms": 0.0})
            row["count"] += 1
            row["ms"] += (e - s) / 1e6
            row["self_ms"] += (e - s - child_ns[i]) / 1e6
    wrapped = tr.launched_in("portbench.step")
    per = max(n_steps, 1)
    return {
        "per_call": {n: {k: v / len(tr.calls) for k, v in row.items()}
                     for n, row in runner.items()},
        "pass_cycles": n_steps,
        "stages": {st: {"host_ms": r["host_ns"] / per / 1e6,
                        "host_self_ms": r["host_self_ns"] / per / 1e6,
                        "ops": r["ops"] / per,
                        "device_ms": r["device_ns"] / per / 1e6}
                   for st, r in table.items()},
        "step_host_ms": sum(e - s for _, s, e, _, _ in steps) / per / 1e6,
        "wrapped_ops": len(wrapped),
        "wrapped_ops_in_sim_step": sum(in_step(o[3]) for o in wrapped),
        "stage_ops": sum(r["ops"] for r in table.values()),
        "wrapped_steps": tr.counts.get("portbench.step", 0),
    }


def traced_run(workload: str, seed: int, seconds: float, **kwargs):
    """One traced run of `workload` through the harness (`run_cell`'s
    keyword arguments pass on): (result line, its `Trace`, or None where
    the run's last call failed)."""
    from portbench import harness
    from portbench import trace as trace_mod
    kept = []
    reduce = trace_mod.reduce

    def keep(*a, **k):
        kept.append(reduce(*a, **k))
        return kept[-1]

    trace_mod.reduce = keep
    try:
        result, _ = harness.run_cell(workload, seed, seconds, True, **kwargs)
    finally:
        trace_mod.reduce = reduce
    return result, (kept[0] if kept else None)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from repro_torch import spans
    if not torch.cuda.is_available():
        sys.exit("stages: no CUDA device; the table is the card's")
    result, tr = traced_run(args.workload, args.seed, args.seconds,
                            device="cuda", root=ROOT)
    print(json.dumps(result), flush=True)
    if tr is None:
        sys.exit("no trace: the run's last call failed")
    out = dict(join(tr, spans.log()), workload=args.workload,
               seed=args.seed, device=result["device"]["kind"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
