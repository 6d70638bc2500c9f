#!/usr/bin/env python3
"""Wall time of the paper's design sweeps on one GPU: grouped by static
signature (`sweep`, as the figures run it) against one `sweep` per
design, for the PyTorch port.

    python3 scripts/torch_grid_time.py [--pairs 20,2] [--cycles 100]

The sweeps are those of `benchmarks/paper_repro.py` (fig3, fig16-fig19,
tab3-tab5; tab4 sweeps tab3's designs), plus all 8 built-in designs, at
its traffic: the first `--pairs` of `pair_workloads()` (the paper's
N_PAIRS is 20; a comma list runs each count in turn), solo baselines
included, under `run_grid`'s default `max_rows` of 64. Only the cycle
count is cut (60,000 in the paper). A sweep's solo baselines run as
2-app rows with an idle partner, so at 20 pairs a design's grid is 42
rows (20 pairs, 22 solos) and `max_rows` 64 holds one design a pass.

One sweep per design is timed once per design per turn; a list's
per-design time is the sum over its designs. Turns run grouped, per
design, per design, grouped, in one process, and every grouped result
must equal its per-design result bit for bit. The passes each way are
counted at `runner._grid_pass`.

Prints one JSON line per design list, then the card's name and power
limit.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

DESIGNS = ("ideal", "pwc", "gpu-mmu", "static", "mask", "mask-tlb",
           "mask-cache", "mask-dram")
# the design lists `benchmarks/paper_repro.py` sweeps, copied: this script
# imports nothing of the JAX package
SWEEPS = {
    "fig3": ("gpu-mmu", "pwc", "ideal"),
    "fig16": ("gpu-mmu", "mask", "static", "ideal"),
    "fig17": ("gpu-mmu", "mask-tlb", "mask-cache", "mask-dram", "mask"),
    "fig18": ("gpu-mmu", "mask", "static"),
    "tab3": ("gpu-mmu", "mask-tlb"),
    "tab5": ("gpu-mmu", "mask-cache"),
    "fig19": ("gpu-mmu", "mask-dram"),
    "all 8": DESIGNS,
}


def same(a, b):
    """Two `ExperimentResult`s equal bit for bit."""
    import numpy as np
    return (a.solo_ipc == b.solo_ipc and len(a) == len(b) and all(
        x.benches == y.benches and all(
            np.array_equal(np.asarray(x.raw[k]), np.asarray(y.raw[k]))
            for k in x.raw) for x, y in zip(a, b)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", default="20")
    ap.add_argument("--cycles", type=int, default=100)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_grid_time: no CUDA device is visible")
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.sim import runner
    from repro_torch.sim.workloads import pair_workloads

    card = cs.card_line()
    passes = []
    grid_pass = runner._grid_pass

    def counted(ccfg, designs, mixes):
        passes.append(len(designs) * len(mixes))
        return grid_pass(ccfg, designs, mixes)

    runner._grid_pass = counted
    for n_pairs in args.pairs.split(","):
        run_pairs(torch, runner, pair_workloads()[:int(n_pairs)],
                  args.cycles, passes, card)
    print(card, flush=True)


def run_pairs(torch, runner, pairs, cycles, passes, card):
    """The turns at one pair count; prints a line per design list."""
    def timed(designs):
        passes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = runner.sweep(list(designs), pairs, cycles=cycles,
                           device="cuda")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, list(passes)

    grouped = {k: [] for k in SWEEPS}
    single = {d: [] for d in DESIGNS}
    rows = {}
    ref = {}
    for how in ("grouped", "per_design", "per_design", "grouped"):
        if how == "per_design":
            for d in DESIGNS:
                res, dt, p = timed([d])
                single[d].append(dt)
                rows[d] = p
                if d in ref and not same(res[d], ref[d]):
                    raise AssertionError(f"sweep([{d}]) changed between "
                                         f"turns")
                ref[d] = res[d]
            continue
        for key, designs in SWEEPS.items():
            res, dt, p = timed(designs)
            grouped[key].append(dt)
            rows[key] = p
            for d in designs:
                if d in ref and not same(res[d], ref[d]):
                    raise AssertionError(f"{key}: the grouped sweep's {d} "
                                         f"!= its one-design sweep")
                ref.setdefault(d, res[d])
    for key, designs in SWEEPS.items():
        per = [sum(single[d][t] for d in designs) for t in range(2)]
        print(json.dumps({
            "sweep": key, "designs": list(designs), "pairs": len(pairs),
            "cycles": cycles, "max_rows": 64,
            "grouped_passes": rows[key],
            "per_design_passes": [r for d in designs for r in rows[d]],
            "grouped_s": grouped[key], "per_design_s": per,
            "per_design_over_grouped": sum(per) / sum(grouped[key]),
            "card": card}), flush=True)


if __name__ == "__main__":
    main()
