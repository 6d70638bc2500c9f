#!/usr/bin/env python3
"""Where a simulated cycle's time goes, for the PyTorch port on one GPU.

    python3 scripts/torch_step_profile.py [--cycles 100] [--designs mask,pwc]

For each design, on the 2-app golden mix (3DS+BLK, Table 1 widths):

  * host-sync check: a few steps under
    `torch.cuda.set_sync_debug_mode("error")`, which raises on a
    synchronizing CUDA call (a prototype that may miss some);
  * wall ms per step over `--cycles` steps, ended by a synchronize;
  * a `torch.profiler` trace of the same number of steps: device
    (kernel) time per step, kernel launches per step, and the
    `fused_tlb` kernel's mean device time and launches per step.

Prints one JSON line per design, then the card's name and power limit.
"""
import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

DESIGNS = ("ideal", "pwc", "gpu-mmu", "static", "mask", "mask-tlb",
           "mask-cache", "mask-dram")


def profile_design(torch, name, cycles):
    from repro_torch.core.design import design_params, get_design
    from repro_torch.sim import memsys, runner
    from repro_torch.sim.config import SimConfig
    from repro_torch.sim.workloads import app_matrix

    cfg = SimConfig(design=get_design(name), sim_cycles=20)
    dp = design_params(cfg.design)
    pm = torch.tensor(app_matrix(["3DS", "BLK"]), device="cuda")
    st = runner.simulate(cfg, dp, pm)
    cycle = 20
    out = {"design": name}

    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with torch.inference_mode():
            for _ in range(5):
                st = memsys.step(cfg, dp, pm, st, cycle)
                cycle += 1
        out["host_syncs_found"] = False
    except RuntimeError:
        traceback.print_exc()
        out["host_syncs_found"] = True
    finally:
        torch.cuda.set_sync_debug_mode(0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(cycles):
            st = memsys.step(cfg, dp, pm, st, cycle)
            cycle += 1
    torch.cuda.synchronize()
    out["wall_ms_per_step"] = (time.perf_counter() - t0) / cycles * 1e3

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.inference_mode():
                for _ in range(cycles):
                    st = memsys.step(cfg, dp, pm, st, cycle)
                    cycle += 1
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        fused = [e for e in kernels if "fused_tlb" in e.name]
        out["device_ms_per_step"] = sum(
            e.self_device_time_total for e in kernels) / cycles / 1e3
        out["kernels_per_step"] = len(kernels) / cycles
        out["fused_tlb_launches_per_step"] = len(fused) / cycles
        out["fused_tlb_device_us"] = (
            sum(e.self_device_time_total for e in fused) / len(fused)
            if fused else None)
        out["device_busy_share"] = (out["device_ms_per_step"]
                                    / out["wall_ms_per_step"])
    except RuntimeError:
        traceback.print_exc()
        out["device_ms_per_step"] = "not measured"
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=100)
    ap.add_argument("--designs", default=",".join(DESIGNS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_step_profile: no CUDA device is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    for name in args.designs.split(","):
        row = profile_design(torch, name, args.cycles)
        row["card"] = card
        print(json.dumps(row), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
