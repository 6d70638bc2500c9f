"""Run one cell of the benchmark once, on the card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program under `src/`. Prints
the result as one JSON line, the last of standard output; the numbers
checked against their limits are the last lines of standard error. Exits
non-zero, with no result, where there is no card, fewer cards than the
cell asks for, no program beside the benchmark, or where the process has
loaded JAX or the JAX package once the window has closed.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Python's bytecode of every module imported from here on, the installed
# libraries' too, kept at a fixed path inside the checkout and written even
# where the environment asks for none (PYTHONDONTWRITEBYTECODE): without
# it every run compiles torch's modules from source again, some 8 s of its
# set-up on an 8-core host; with it only a checkout's first run does
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False


def fail(msg: str, code: int) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no program under {ROOT / 'src'}: nothing to measure", 2)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench import harness
    bench = harness.load_bench(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        fail(f"no workload {args.workload!r} in BENCHMARK.json", 2)
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count()} visible", 3)
    result, checks = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", bench=bench, root=ROOT, t_start=T0)
    bad = harness.forbidden_modules()
    if bad:
        fail(f"loaded {', '.join(bad)}: the benchmark runs without JAX", 4)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
