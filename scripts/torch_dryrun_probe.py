"""Trace every applicable cell of the dry run at its minimal depth, to find
the cells whose step does not trace on a route, fast.

    python3 scripts/torch_dryrun_probe.py [--device cpu] [--multi-pod both]

Each cell of `configs.all_cells()` that applies runs through
`launch.dryrun.lower_cell` with its run config cut to one layer (one
period of a hybrid or MoE-every-k stack, one encoder layer), 1024 tokens
for train and prefill (decode keeps its cache length) and at most 2
microbatches: the widths, the mesh and the sharding are the cell's. One
line per (cell, mesh): ok with the seconds, rank 0's `hbm_per_device` and
collective bytes, or FAIL with the error and the port's frames. Exits 1
if any cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import all_cells, get_run_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def cut(arch, shape_name):
    run = get_run_config(arch, shape_name)
    cfg = run.model
    period = max(cfg.attn_every or 1, cfg.moe_every or 1)
    cfg = dataclasses.replace(cfg, n_layers=period,
                              n_enc_layers=min(cfg.n_enc_layers, 1))
    sh = run.shape
    seq = sh.seq_len if sh.kind == "decode" else 1024
    return dataclasses.replace(
        run, model=cfg, shape=ShapeConfig(sh.name, seq, sh.global_batch,
                                          sh.kind),
        microbatches=min(run.microbatches, 2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="both")
    args = ap.parse_args()
    pods = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]
    torch.set_num_threads(1)
    failed = 0
    for arch, shape_name, ok in all_cells():
        if not ok:
            continue
        for mp in pods:
            t0 = time.perf_counter()
            mesh = "2x16x16" if mp else "16x16"
            try:
                rep = dryrun.lower_cell(arch, shape_name, mp,
                                        run_override=cut(arch, shape_name),
                                        device=args.device)
                print(f"ok {arch} {shape_name} {mesh} "
                      f"{time.perf_counter() - t0:.1f} s "
                      f"hbm_per_device {rep['hbm_per_device_bytes']} "
                      f"{rep['collective_bytes_by_op']}", flush=True)
            except Exception as e:      # a cell's failure is its report
                failed += 1
                frames = [f"{Path(f.filename).name}:{f.lineno}"
                          for f in traceback.extract_tb(e.__traceback__)
                          if "repro_torch" in f.filename][-5:]
                print(f"FAIL {arch} {shape_name} {mesh} "
                      f"{time.perf_counter() - t0:.1f} s {e!r:.400} "
                      f"{frames}", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
