#!/usr/bin/env python3
"""Where a simulated cycle's time goes, for the PyTorch port on one GPU.

    python3 scripts/torch_step_profile.py [--cycles 100]
        [--designs mask,pwc] [--src SRC]

`--src` (default: this checkout's `src`) is the directory whose
`repro_torch` package is measured, so two trees can be compared in one
call (unpack the other with `git archive` into a directory `.gitignore`
lists). For each design, on the 2-app golden mix (3DS+BLK, Table 1
widths), one row, the design's knobs as host scalars (as `run_mix` runs
it); then, where the package has per-row knobs (`stack_params`), the
mixed group of the 7 non-ideal designs x 3 mixes (R = 21):

  * dispatcher operations of one step at an epoch and of one between
    epochs, the fused round counted as one call (`chip_smoke.step_ops`);
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
import importlib
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

DESIGNS = ("ideal", "pwc", "gpu-mmu", "static", "mask", "mask-tlb",
           "mask-cache", "mask-dram")
GROUP_MIXES = [("3DS", "BLK"), ("3DS", None), ("BLK", None)]


def profile_step(torch, cs, label, cfg, dp, pm, cycles):
    from repro_torch.sim import memsys, runner

    out = {"design": label, "rows": int(pm.shape[0])}
    st = runner.simulate(cfg, dp, pm)
    e = cfg.design.epoch_cycles
    ops = []
    for cycle in (e - 1, e):                # t = epoch_cycles: an epoch
        n, st = cs.step_ops(torch, cfg, dp, pm, st, cycle)
        ops.append(n)
    out["ops_epoch_step"], out["ops_step"] = ops
    cycle = e + 1

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
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_step_profile: no CUDA device is visible")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    # the module: `repro_torch.core.design` is the `design` function
    pd = importlib.import_module("repro_torch.core.design")
    from repro_torch.sim.config import SimConfig
    from repro_torch.sim.workloads import app_matrix

    card = cs.card_line()
    pm = torch.tensor(app_matrix(["3DS", "BLK"]), device="cuda")[None]
    for name in args.designs.split(","):
        d = pd.get_design(name)
        cfg = SimConfig(design=d, sim_cycles=20, device="cuda")
        row = profile_step(torch, cs, name, cfg, pd.design_params(d), pm,
                           args.cycles)
        print(json.dumps(dict(row, src=args.src, card=card)), flush=True)
    if hasattr(pd, "stack_params"):
        group = [n for n in DESIGNS if n != "ideal"]
        dp = pd.stack_params([pd.design_params(n) for n in group],
                             len(GROUP_MIXES), "cuda")
        cfg = SimConfig(design=pd.get_design("gpu-mmu"), sim_cycles=20,
                        device="cuda")
        gpm = torch.tensor(np.stack([app_matrix(m) for _ in group
                                     for m in GROUP_MIXES]), device="cuda")
        row = profile_step(torch, cs, "group of 7", cfg, dp, gpm,
                           args.cycles)
        print(json.dumps(dict(row, src=args.src, card=card)), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
