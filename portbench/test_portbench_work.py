"""`work.py`, the benchmark's copy of the fused round's work count,
gives `chip_smoke.py`'s numbers, and its row-axis form the sum of its
rows."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import work

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("portbench_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(case):
    """The plain round on a case: its outputs as numpy arrays."""
    from portbench.reference.fused_round import fused_tlb_access_ref
    keys = ("tags", "asids", "lru", "vpn", "asid", "active", "may_fill")
    args = [torch.tensor(case[k]) for k in keys]
    out = fused_tlb_access_ref(*args, case["time"],
                               n_waves=case["n_waves"],
                               track_asids=case["track_asids"])
    return [o.numpy() for o in out]


@pytest.mark.parametrize("shape,masks,seed", [
    ((1024, 16, 240, 8), "half", 3), ((1024, 16, 120, 4), "all", 5),
    ((64, 16, 120, 4), "half", 7), ((64, 16, 120, 4), "nofill", 9)])
def test_round_work_is_chip_smokes(smoke, shape, masks, seed):
    case = smoke.path_case(np, *shape, masks, seed)
    out = _run(case)
    assert work.round_work(case, out) == smoke.round_work(np, case, out)
    nb, ops = work.round_work(case, out)
    assert work.least_time(nb, ops) == smoke.least_time(nb, ops)
    assert (work.HBM_BYTES_PER_S, work.CUDA_CORE_OPS_PER_S) == \
        (smoke.HBM_BYTES_PER_S, smoke.CUDA_CORE_OPS_PER_S)


@pytest.mark.parametrize("track", [False, True])
def test_round_work_rows_is_the_sum_of_its_rows(smoke, track):
    cases = [smoke.kernel_test_case(np, 32, 16, 30, 3, track)
             if track else smoke.path_case(np, 64, 16, 120, 4, "half", s)
             for s in range(3)]
    if track:   # three different rows of the tracked case
        rng = np.random.RandomState(0)
        for c in cases[1:]:
            c["vpn"] = rng.permutation(c["vpn"])
    per_row = [work.round_work(c, _run(c)) for c in cases]
    keys = ("tags", "asids", "lru", "vpn", "asid", "active", "may_fill")
    stacked = {k: torch.tensor(np.stack([c[k] for c in cases]))
               for k in keys}
    before = tuple(stacked[k].clone() for k in ("tags", "asids", "lru"))
    from portbench.reference.fused_round import fused_tlb_access_ref
    c0 = cases[0]
    out = fused_tlb_access_ref(*(stacked[k] for k in keys), c0["time"],
                               n_waves=c0["n_waves"],
                               track_asids=c0["track_asids"])
    got = work.round_work_rows(before, stacked["vpn"], stacked["active"],
                               out, c0["n_waves"], c0["track_asids"])
    assert got == tuple(map(sum, zip(*per_row)))
