"""The control of `correct`: what the cell's entry type puts in the
program's place at the nearest precision below the configuration's
(`entries/<entry>.py`'s `control`). The check must refuse it. The
simulator's is the plain reference with its float planes in bfloat16.

    python3 portbench/control.py --workload <name> --seed <n> [<n> ...]

Runs, in one process on the card, the shortest window of the cell's own
calls (the entry's fewest: one call of the simulator's rows and cycles,
every input of a prefill cell) through the control for each seed, and
prints each seed's checks as one JSON line. The benchmark's runs never
run it.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(name: str, seed: int, device, bench=None, root: Path = ROOT,
        shrink=None):
    """One control run of cell `name`: (result line, checks)."""
    from portbench import harness
    bench = harness.load_bench(root / "BENCHMARK.json") if bench is None \
        else bench
    cell = harness.resolve(bench, name, root)
    mod = harness.entry_module(cell, root)
    entry = mod.control(cell.config, cell.traffic, device, shrink=shrink)
    return harness.run_cell(name, seed, 0.0, False, device=device,
                            bench=bench, root=root, entry=entry)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        sys.exit("portbench: the control runs on the card")
    for seed in args.seed:
        result, checks = run(args.workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"], "checks": checks}),
              flush=True)


if __name__ == "__main__":
    main()
