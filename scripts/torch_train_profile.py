#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time, on one GPU.

    python3 scripts/torch_train_profile.py

The training setup of `chip_smoke.py` phase 17 (c): mamba2-1.3b at full
width and depth, bf16 params from a seeded generator on the card, AdamW
with fp32 moments, remat, one microbatch of 2 x 4096 seeded random tokens
and labels. After a warm-up, for one microbatch's loss and gradient
(`train.step.value_and_grad`: the forward, the remat recomputes and the
backward) and for one optimizer update over the whole model:

  * wall ms, ended by a synchronize;
  * a `torch.profiler` trace of the same work: device ms, kernel launches,
    the device busy share, the ssd kernel's launches and device ms
    (`ssd_intra_kernel`), and the kernels with the most device time (as
    `scripts/torch_serve_profile.py` reports them);
  * for the microbatch, the calls and the summed device span of the ssd
    Function's plain backward (a `record_function` range this script puts
    around `SsdIntraChunk.backward`; the profiler shows the range on the
    device's track, which the kernel sums leave out).

Prints one JSON line per phase, then the card's name and power limit.
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import chip_smoke  # noqa: E402
import torch_serve_profile as serve_profile  # noqa: E402

BACKWARD_RANGE = "ssd_plain_backward"


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_train_profile: no CUDA device is visible")
    from torch.profiler import record_function

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models import model
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step

    card = chip_smoke.card_line()
    plain_backward = ops.SsdIntraChunk.backward

    def ranged_backward(ctx, *grads):
        with record_function(BACKWARD_RANGE):
            return plain_backward(ctx, *grads)
    ops.SsdIntraChunk.backward = staticmethod(ranged_backward)

    full = chip_smoke.train_run_config()
    cfg, seq = full.model, full.shape.seq_len
    micro_b = full.shape.global_batch // full.microbatches
    run = dataclasses.replace(full, microbatches=1, shape=dataclasses.replace(
        full.shape, global_batch=micro_b))
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, device="cuda")
    opt_cfg = opt_mod.OptConfig()
    state = opt_mod.init(params, opt_cfg)
    rng = np.random.RandomState(17)
    batch = {k: torch.tensor(rng.randint(0, cfg.vocab_size, (
        micro_b, seq)), dtype=torch.int32, device="cuda")
        for k in ("tokens", "labels")}
    grad_fn = step.value_and_grad(step.build_loss_fn(cfg, run))
    out = {}

    def microbatch():
        out["grads"] = grad_fn(params, batch)[1]

    def update():
        opt_mod.update(params, out["grads"], state, opt_cfg)

    microbatch()
    update()                                            # warm-up
    for phase, fn in (("microbatch", microbatch), ("optimizer", update)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        traced, events = serve_profile.trace(torch, fn, 1)
        # the range shows on the device's track too: a span, not a kernel
        spans = [e for e in events if e.name == BACKWARD_RANGE]
        kernels = [e for e in events if e.name != BACKWARD_RANGE]
        row = serve_profile.summary(phase, wall, traced, kernels, 1,
                                    "ssd_intra_kernel")
        if phase == "microbatch":
            row["ssd_plain_backward_calls"] = len(spans)
            row["ssd_plain_backward_device_span_ms"] = sum(
                e.self_device_time_total for e in spans) / 1e3
        row.update(arch=cfg.name, batch=micro_b, seq=seq,
                   peak_bytes=torch.cuda.max_memory_allocated(), card=card)
        print(json.dumps(row), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
