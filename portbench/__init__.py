"""The benchmark of the PyTorch and CUDA port of the MASK simulator.

`run.py` runs one cell of `BENCHMARK.json` once; everything that belongs
to one configuration, traffic mix, entry type or metric is a file of its
own under `configs/`, `traffic/`, `entries/` and `metrics/`, found by its
name. `reference/` is the plain simulator that decides `correct`.
"""
