#!/usr/bin/env python3
"""Simulated cycles per second of a churn trace beside the same cycles as
one run, for the PyTorch port on one GPU.

    python3 scripts/torch_trace_rate.py [--rounds 3] [--cycles 1200]

On the 2-app golden mix (mask, 3DS+BLK, Table 1 widths), in alternating
rounds (run_mix, trace, trace, run_mix) so host drift hits both alike:

  * `run_mix(..., cycles)`: one pass;
  * `run_trace(..., [mix] * 4, seg_cycles=cycles // 4)`: the same cycles
    as 4 segments (constant membership: the same result, plus 4
    boundaries and 4 snapshots).

Each run ends in a host transfer of its stats, so the host clock covers
the device's work. Prints one line per run, a JSON line with the
medians, then the card's name and power limit.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

MIX = ("3DS", "BLK")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cycles", type=int, default=1200)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_trace_rate: no CUDA device is visible")
    from repro_torch.sim import runner

    cycles, seg = args.cycles, args.cycles // 4
    runs = {
        "run_mix": lambda: runner.run_mix("mask", list(MIX), cycles=cycles,
                                          device="cuda"),
        "run_trace": lambda: runner.run_trace(
            "mask", [MIX] * 4, seg_cycles=seg, device="cuda"),
    }
    runner.run_mix("mask", list(MIX), cycles=20, device="cuda")   # warm up
    runner.run_trace("mask", [MIX] * 4, seg_cycles=5, device="cuda")
    rates = {name: [] for name in runs}
    for r in range(args.rounds):
        for name in ("run_mix", "run_trace", "run_trace", "run_mix"):
            t0 = time.perf_counter()
            runs[name]()
            dt = time.perf_counter() - t0
            rates[name].append(cycles / dt)
            print(f"round {r} {name}: {dt:.2f} s, {cycles / dt:.1f} "
                  f"simulated cycles/s", flush=True)
    print(json.dumps({name: {"median_cycles_per_s": statistics.median(v),
                             "cycles_per_s": v}
                      for name, v in rates.items()}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
