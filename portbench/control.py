"""The control of `correct`: the plain reference with its float planes in
bfloat16, the nearest precision below the configuration's float32, put in
the program's place. The check must refuse it.

    python3 portbench/control.py --workload <name> --seed <n> [<n> ...]

Runs, in one process on the card, one call of the cell's own rows and
cycles through the lowered reference for each seed, and prints each
seed's checks as one JSON line. The benchmark's runs never run it.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def lowered_run(designs, config: dict, device, dtype):
    """The reference run in `dtype`, in the form of an entry's run."""
    from portbench import reference
    from portbench.reference import precision

    def run(mixes, cycles):
        with precision.lowered(dtype):
            return {d: reference.run_rows(d, mixes, cycles, device, config)
                    for d in designs}

    return run


def run(name: str, seed: int, device, bench=None, root: Path = ROOT,
        shrink=None, dtype=None):
    """One control run of cell `name`: (result line, checks)."""
    import torch

    from portbench import harness
    from portbench.entries import _sim
    bench = harness.load_bench(root / "BENCHMARK.json") if bench is None \
        else bench
    cell = harness.resolve(bench, name, root)
    designs = cell.traffic["designs"]
    entry = _sim.sim_entry(
        cell.config, cell.traffic, device, designs,
        lowered_run(designs, cell.config, device, dtype or torch.bfloat16),
        shrink)
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
