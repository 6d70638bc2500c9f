#!/usr/bin/env python3
"""Where the model's serving path spends its time, for the PyTorch port on
one GPU.

    python3 scripts/torch_serve_profile.py \
        [--arch qwen3-4b|mamba2-1.3b|olmoe-1b-7b]

The serving shape of `chip_smoke.py` phase 6 (qwen3-4b, the default),
phase 9 (mamba2-1.3b) or phase 15 (olmoe-1b-7b), from its own setup: the model at full width in
bf16, random weights from a seeded generator on the card,
`attention_impl="pallas_flash"`, 4 prompts of 2048 tokens, caches of
2048 + 64 positions. After a warm-up prefill and decode step, for the
prefill and for 8 greedy decode steps:

  * wall ms, ended by a synchronize (prefill: one call; decode: per step);
  * a `torch.profiler` trace of the same work: device ms (the sum of
    kernel times; one stream, so kernels do not overlap), kernel
    launches, the device busy share (device ms over the traced wall ms),
    the path kernel's launches, device ms and share of the device time
    (the tensor-core flash attention kernel for qwen3-4b and
    olmoe-1b-7b, the SSD intra-chunk kernel for mamba2-1.3b), and the
    kernels with the most device time.

Prints one JSON line per phase, then the card's name and power limit.
"""
import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402

STEPS = 8                          # decode steps timed, then traced
# the hand-written kernel on each arch's bf16 serving path, by its CUDA
# name: the tensor-core flash kernel, the SSD intra-chunk kernel
PATH_KERNEL = {"qwen3-4b": "flash_wgmma_kernel",
               "mamba2-1.3b": "ssd_intra_kernel",
               "olmoe-1b-7b": "flash_wgmma_kernel"}


def trace(torch, fn, n):
    """Run `fn` n times under the profiler; return (wall ms, kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def summary(phase, wall_ms, traced_ms, kernels, n, path_kernel):
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name[:90]] += e.self_device_time_total / 1e3
    device = sum(by_name.values())
    mine = [e for e in kernels if path_kernel in e.name]
    mine_ms = sum(e.self_device_time_total for e in mine) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "phase": phase, "calls": n, "wall_ms_per_call": wall_ms / n,
        "traced_wall_ms_per_call": traced_ms / n,
        "device_ms_per_call": device / n,
        "device_busy_share": device / traced_ms,
        "kernels_per_call": len(kernels) / n,
        "path_kernel": path_kernel,
        "path_kernel_launches_per_call": len(mine) / n,
        "path_kernel_device_ms_per_call": mine_ms / n,
        "path_kernel_device_share": mine_ms / device if device else 0.0,
        "top_kernels_ms_per_call": [[k, v / n] for k, v in top]}


def main():
    parser = argparse.ArgumentParser(
        description="Profile the port's serving path on one GPU.")
    parser.add_argument("--arch", default=chip_smoke.SERVE_ARCH,
                        choices=sorted(PATH_KERNEL))
    arch = parser.parse_args().arch
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_serve_profile: no CUDA device is visible")
    card = chip_smoke.card_line()
    model, cfg, run, params = chip_smoke.model_setup(torch, None, arch)
    tokens = chip_smoke.serve_tokens(torch, np, cfg)
    max_len = chip_smoke.SERVE_S + chip_smoke.SERVE_NEW   # > 2 * STEPS + 1
    state = {}

    def prefill():
        state["logits"], state["caches"] = model.forward_prefill(
            cfg, run, params, {"tokens": tokens}, max_len=max_len)

    def decode():
        tok = state["logits"][:, -1].argmax(dim=-1, keepdim=True).int()
        state["logits"], state["caches"] = model.forward_decode(
            cfg, run, params, {"tokens": tok}, state["caches"])

    with torch.inference_mode():
        prefill()
        decode()                                        # warm-up
        for phase, fn, n in (("prefill", prefill, 1),
                             ("decode", decode, STEPS)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            traced, kernels = trace(torch, fn, n)
            row = summary(phase, wall, traced, kernels, n, PATH_KERNEL[arch])
            row.update(arch=cfg.name, batch=chip_smoke.SERVE_B,
                       prompt=chip_smoke.SERVE_S, card=card)
            print(json.dumps(row), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
