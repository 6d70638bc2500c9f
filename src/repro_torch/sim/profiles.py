"""Tenant app-profile -> simulator-benchmark mapping (oracle-facing); a
copy of `repro.sim.profiles`, which imports no JAX.

The serving layer talks about *tenants* with declared workload profiles
("interactive", "heavy", ...); the simulator talks about Table 2
benchmarks with calibrated (L1 TLB, L2 TLB) locality classes. This thin
mapping is the contract between them: the contention oracle
(`repro_torch.serving.oracle`) maps each tenant's profile to a representative
bench here and asks the simulator how a candidate co-placement would
contend. A profile name may also BE a bench name (power users pin the
exact Table 2 stream they calibrated against).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.sim.workloads import BENCHES, CATEGORY

# serving-level profiles -> a representative Table 2 bench per
# (L1 TLB, L2 TLB) locality class. Chosen deterministically from the
# class members so profile-mapped predictions are stable across PRs.
PROFILES: Dict[str, str] = {
    # tiny working set, fits the per-core L1 TLB: cheap co-runner
    "interactive": "NN",      # (low, low)
    "light": "LUD",           # (low, low)
    # page-streaming with reach far beyond the shared L2 TLB
    "streaming": "SAD",       # (low, high)
    "rag": "BFS2",            # (low, high)
    # scattered accesses in a modest set: misses L1, fits shared L2 solo
    "scattered": "GUP",       # (high, low)
    # the aggressor class: thrashes both TLB levels, DRAM-bound walks
    "batch": "MUM",           # (high, high)
    "heavy": "3DS",           # (high, high)
}

DEFAULT_PROFILE = "batch"


def bench_for_profile(profile: str) -> str:
    """Resolve a tenant profile (or a literal bench name) to a bench."""
    if profile in PROFILES:
        return PROFILES[profile]
    if profile in CATEGORY:
        return profile
    raise KeyError(
        f"unknown app profile {profile!r}: expected one of "
        f"{sorted(PROFILES)} or a Table 2 bench name from {BENCHES}")


def profile_category(profile: str) -> Tuple[str, str]:
    """(L1 TLB, L2 TLB) miss-rate class of a profile's mapped bench."""
    return CATEGORY[bench_for_profile(profile)]
