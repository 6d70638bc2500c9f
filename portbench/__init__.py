"""The benchmark of the PyTorch and CUDA port: the MASK simulator's sweeps
and the model stack's prefill.

`run.py` runs one cell of `BENCHMARK.json` once; everything that belongs
to one configuration, traffic mix, entry type or metric is a file of its
own under `configs/`, `traffic/`, `entries/` and `metrics/`, found by its
name. `reference/` holds the plain simulator and the plain MoE language
model (`reference/moe_lm.py`) that decide `correct`; `flops.py` counts a
prefill's FLOPs and bytes.
"""
