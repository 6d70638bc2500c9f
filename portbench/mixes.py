"""The one generator of the benchmark's traffic: the rows of a sweep.

A traffic file names its rows by parameters: `bundles` is "all" (every
bundle of the configuration's `n_apps` distinct benchmarks outside the
(low, low) class, in sorted order) or a list of bundles, each a list of
bench names; `solo_rows` adds one row per benchmark of the bundles with
idle partners (the §6 IPC_alone baseline). A run's `--seed` only orders
the rows: every seed gives the same set.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

import numpy as np

from portbench.reference.workloads import ELIGIBLE

Mix = Tuple[Optional[str], ...]


def rows(n_apps: int, spec: dict) -> List[Mix]:
    pick = spec.get("bundles", "all")
    if pick == "all":
        out: List[Mix] = list(itertools.combinations(ELIGIBLE, n_apps))
    else:
        out = [tuple(b) for b in pick]
        bad = [b for b in out if len(b) != n_apps
               or not set(b) <= set(ELIGIBLE) or len(set(b)) != n_apps]
        if bad:
            raise ValueError(f"bundles that are not {n_apps} distinct "
                             f"eligible benchmarks: {bad}")
    if spec.get("solo_rows", False):
        used = {b for m in out for b in m}
        out += [(b,) + (None,) * (n_apps - 1) for b in ELIGIBLE if b in used]
    return out


def order(mixes: List[Mix], seed: int, call: int) -> List[Mix]:
    """The rows of call `call` of a run with `--seed seed`: a permutation
    drawn from both (any integer seed, negative ones included)."""
    rng = np.random.default_rng([seed & (2**64 - 1), call])
    return [mixes[i] for i in rng.permutation(len(mixes))]
