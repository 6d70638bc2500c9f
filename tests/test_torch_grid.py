"""The port's row axis and grid building blocks against the reference (CPU).

* The plain fused round with a leading row axis equals `jax.vmap` of the
  reference's `access_fused` (XLA path) and the per-row loop, at both
  main-path shapes and on the write-collision case.
* Every core mechanism with rows (TLB probe/fill, banks, DRAM, tokens,
  bypass) equals the same calls made row by row without the axis.
* `memsys.step` over R rows equals R single runs, across epoch
  boundaries, and issues the same operations whatever R is (counted at
  the dispatcher), so no Python loop over rows hides in it.
* `run_grid` reproduces the 8 1200-cycle float-hex goldens of
  `tests/test_memsys_stages.py` in 2 passes, one per signature group;
  `convert` carries one row of a 3-row
  state to a reference tree and back; `devices=2` raises.
* The JAX-free helpers copied from the reference (`mix_workloads`,
  `pair_workloads`, `hmr_class`, `from_legacy`, `MaskConfig`,
  `DesignPoint`) give what the reference's give.
"""
import dataclasses
import importlib
import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core import mask as ref_mask  # noqa: E402
from repro.core import tlb as ref_tlb  # noqa: E402
from repro.sim import memsys as ref_ms  # noqa: E402
from repro.sim import workloads as ref_wl  # noqa: E402
from repro.sim.config import SimConfig as RefConfig  # noqa: E402
from repro_torch.core import bypass as pt_bp  # noqa: E402
# `repro_torch.core.design` the module: the package binds the name to
# the `design` function, as `repro.core` does
pt_design = importlib.import_module("repro_torch.core.design")
from repro_torch.core import dram_sched as pt_dram  # noqa: E402
from repro_torch.core import mask as pt_mask  # noqa: E402
from repro_torch.core import tlb as pt_tlb  # noqa: E402
from repro_torch.core import tokens as pt_tok  # noqa: E402
from repro_torch.kernels.fused_tlb import kernel as kernel_mod  # noqa: E402
from repro_torch.kernels.fused_tlb import ops as fused_ops  # noqa: E402
from repro_torch.kernels.fused_tlb.ref import fused_tlb_access_ref  # noqa: E402
from repro_torch.sim import convert, memsys, runner  # noqa: E402
from repro_torch.sim import workloads as pt_wl  # noqa: E402
from repro_torch.sim.config import SimConfig  # noqa: E402

# `repro.core` re-exports a function named `design`, shadowing the module
ref_design = importlib.import_module("repro.core.design")

R = 3
PLANES = ("tags", "asids", "lru")
LANES = ("vpn", "asid", "active", "may_fill")


def _load_golden():
    path = Path(__file__).with_name("test_memsys_stages.py")
    spec = importlib.util.spec_from_file_location("_memsys_stage_pins", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GOLDEN


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ fused round

def _path_case(sets, ways, N, W, seed):
    """A main-path-like tag-only round (as `test_torch_tlb.py`'s): tags are
    int32-wrapped line ids in their sets; half the lanes re-touch resident
    lines, some repeat their own earlier-wave line."""
    rng = np.random.RandomState(seed)
    hi = rng.randint(-2**21, 2**21, (sets, ways)).astype(np.int64)
    tags = (hi * sets + np.arange(sets)[:, None]).astype(np.int32)
    tags[rng.rand(sets, ways) < 0.1] = -1
    vpn = (rng.randint(-2**21, 2**21, N) * sets
           + rng.randint(0, sets, N)).astype(np.int32)
    pick = tags.reshape(-1)[rng.randint(0, sets * ways, N)]
    vpn = np.where((rng.rand(N) < 0.5) & (pick != -1), pick, vpn)
    C = N // W
    rep = rng.rand(N) < 0.15
    rep[:C] = False
    vpn[rep] = vpn[np.flatnonzero(rep) - C]
    return dict(tags=tags, asids=np.zeros((sets, ways), np.int32),
                lru=rng.randint(0, 3000, (sets, ways)).astype(np.int32),
                vpn=vpn.astype(np.int32), asid=np.zeros(N, np.int32),
                active=rng.rand(N) < 0.6, may_fill=rng.rand(N) < 0.8)


def _collision_case(order):
    return dict(tags=np.asarray([[8, 12, 16, 20]], np.int32),
                asids=np.zeros((1, 4), np.int32),
                lru=np.asarray([[1, 5, 6, 7]], np.int32),
                vpn=np.asarray(order, np.int32), asid=np.zeros(2, np.int32),
                active=np.ones(2, bool), may_fill=np.ones(2, bool))


def _stack(cases):
    return {k: np.stack([c[k] for c in cases]) for k in cases[0]}


def _idle_rows(rows):
    """Every row but the middle one with all its lanes masked off, as the
    rows of a mixed group's PWC round that hold no `pwc` design."""
    rows["active"][[r for r in range(R) if r != R // 2]] = False
    return rows


def _ref_vmapped(rows, time, W):
    def one(tags, asids, lru, vpn, asid, active, may_fill):
        st = ref_tlb.TLBState(tags, asids, lru, jnp.int32(0), jnp.int32(0))
        st, hit, filled = ref_tlb.access_fused(
            st, vpn, asid, active, may_fill, time, n_waves=W,
            track_asids=False, backend="xla")
        return st.tags, st.asids, st.lru, hit, filled
    out = jax.vmap(one)(*(jnp.asarray(rows[k]) for k in PLANES + LANES))
    return [np.asarray(x).astype(np.int32) for x in out]


ROUND_CASES = {
    "l2": (lambda: _stack([_path_case(1024, 16, 240, 8, s)
                           for s in range(R)]), 8),
    "pwc": (lambda: _stack([_path_case(64, 16, 120, 4, 10 + s)
                            for s in range(R)]), 4),
    "l2-idle-rows": (lambda: _idle_rows(_stack(
        [_path_case(1024, 16, 240, 8, 20 + s) for s in range(R)])), 8),
    "pwc-idle-rows": (lambda: _idle_rows(_stack(
        [_path_case(64, 16, 120, 4, 30 + s) for s in range(R)])), 4),
    "collision": (lambda: _stack([_collision_case([8, 100]),
                                  _collision_case([100, 8]),
                                  _collision_case([8, 8])]), 1),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_fused_round_rows_match_vmapped_reference_and_loop(case):
    make, W = ROUND_CASES[case]
    rows = make()
    want = _ref_vmapped(rows, 3001, W)
    t = {k: torch.tensor(v) for k, v in rows.items()}
    before = kernel_mod.fused_tlb_round.launches
    got = fused_ops.fused_tlb_access(*(t[k] for k in PLANES + LANES), 3001,
                                     n_waves=W, track_asids=False)
    assert kernel_mod.fused_tlb_round.launches == before
    assert got[0] is t["tags"] and got[2] is t["lru"]   # in place
    for a, b, name in zip(got, want, PLANES + ("hit", "filled")):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    for r in range(R):          # the same round, one row at a time
        one = {k: torch.tensor(v[r]) for k, v in rows.items()}
        out = fused_tlb_access_ref(*(one[k] for k in PLANES + LANES), 3001,
                                   n_waves=W, track_asids=False)
        for a, b, name in zip(out, got, PLANES + ("hit", "filled")):
            np.testing.assert_array_equal(a.numpy(), b[r].numpy(),
                                          err_msg=f"row {r} {name}")
    if case == "collision":     # the higher lane owns the shared slot
        assert [int(x) for x in got[0][:, 0, 0]] == [100, 8, 8]
    # a row whose lanes are all masked off is left as it was
    idle = [r for r in range(R) if not rows["active"][r].any()]
    assert len(idle) == (R - 1 if case.endswith("idle-rows") else 0)
    for r in idle:
        for k, a in zip(PLANES, got):
            np.testing.assert_array_equal(a[r].numpy(), rows[k][r],
                                          err_msg=f"idle row {r} {k}")
        assert not got[3][r].any() and not got[4][r].any()


def _no_build(*_):
    raise AssertionError("the wrapper built the kernel before checking")


@pytest.mark.parametrize("shape,match", [
    ((2, 1, 2), "current CUDA device"),           # 8-byte row stride
    ((2, 3, 1), "current CUDA device"),
])
def test_kernel_wrapper_refuses_misaligned_rows(monkeypatch, shape, match):
    """Row r's planes start r * sets * ways * 4 bytes in: a stride off 16
    bytes is no longer refused but runs the instance that reads words
    (`instance` 0). What still raises ValueError before any build or
    launch: planes off the card (the CPU tensors here) and lanes whose
    rows do not match the planes'."""
    monkeypatch.setattr(kernel_mod._build, "load", _no_build)
    kernel_mod._entry.cache_clear()
    z = torch.zeros(shape, dtype=torch.int32)
    v = torch.zeros((shape[0], 4), dtype=torch.int32)
    b = torch.zeros((shape[0], 4), dtype=torch.bool)
    assert not kernel_mod.rows_aligned((z, z, z), shape[0])
    assert kernel_mod.instance(shape[-1], False) == 0
    before = kernel_mod.fused_tlb_round.launches
    with pytest.raises(ValueError, match=match):
        kernel_mod.fused_tlb_round(z, z, z, v, v, b, b, 0)
    with pytest.raises(ValueError, match=r"shape \(2, 4\)"):   # lanes/rows
        kernel_mod.fused_tlb_round(z, z, z, v[:1], v, b, b, 0)
    assert kernel_mod.fused_tlb_round.launches == before


# ------------------------------------------------------- core with rows

def _tlb_rows(rng, shape, tag_hi):
    return pt_tlb.TLBState(
        tags=torch.tensor(rng.randint(-1, tag_hi, shape), dtype=torch.int32),
        asids=torch.tensor(rng.randint(-1, 3, shape), dtype=torch.int32),
        lru=torch.tensor(rng.randint(0, 50, shape), dtype=torch.int32),
        hits=torch.tensor(rng.randint(0, 9, shape[:-2]), dtype=torch.int32),
        misses=torch.tensor(rng.randint(0, 9, shape[:-2]),
                            dtype=torch.int32))


def _row(tree, r):
    return type(tree)(*(x[r] for x in tree))


def _assert_rows(batched, rows, msg):
    for r, one in enumerate(rows):
        for f, a, b in zip(batched._fields, batched, one):
            np.testing.assert_array_equal(a[r].numpy(), b.numpy(),
                                          err_msg=f"{msg} row {r} {f}")


@pytest.mark.parametrize("shape,N", [((R, 32, 16), 30), ((R, 1, 32), 30),
                                     ((R, 30, 1, 64), None)])
def test_tlb_rows_match_row_loop(shape, N):
    """probe/fill (and the bank forms, N=None) with a leading row axis ==
    the same calls row by row: a row's lanes touch only its own planes."""
    rng = np.random.RandomState(len(shape) * 7 + shape[1])
    st = _tlb_rows(rng, shape, 40)
    singles = [_row(st, r) for r in range(R)]
    lanes = (R,) + ((shape[1],) if N is None else (N,))
    probe, fill = ((pt_tlb.probe_bank, pt_tlb.fill_bank) if N is None
                   else (pt_tlb.probe, pt_tlb.fill))
    for t in range(1, 12):
        vpn = torch.tensor(rng.randint(0, 80, lanes), dtype=torch.int32)
        asid = torch.tensor(rng.randint(0, 3, lanes), dtype=torch.int32)
        act = torch.tensor(rng.rand(*lanes) > 0.2)
        st, hit = probe(st, vpn, asid, act, t)
        st = fill(st, vpn, asid, act & ~hit, t)
        for r in range(R):
            singles[r], h = probe(singles[r], vpn[r], asid[r], act[r], t)
            np.testing.assert_array_equal(hit[r].numpy(), h.numpy())
            singles[r] = fill(singles[r], vpn[r], asid[r], act[r] & ~h, t)
        _assert_rows(st, singles, f"t={t}")
    occ = pt_tlb.occupancy_by_asid(st, 3, rows=True)
    for r in range(R):
        np.testing.assert_array_equal(
            occ[r].numpy(), pt_tlb.occupancy_by_asid(singles[r], 3).numpy())


@pytest.mark.parametrize("mask_on", [True, False])
def test_dram_rows_match_row_loop(mask_on):
    """`dram_sched.access` over rows == row by row; every per-lane scatter
    (counts, backlog, open rows) is offset by the row."""
    rng = np.random.RandomState(int(mask_on))
    n_apps, W, C = 3, 8, 30
    N = W * C
    st = pt_dram.DramState(
        open_row=torch.tensor(rng.randint(-1, 6, (R, 8, 8)),
                              dtype=torch.int32),
        silver_app=torch.tensor(rng.randint(0, n_apps, R), dtype=torch.int32),
        silver_left=torch.tensor(rng.randint(1, 4, R), dtype=torch.int32),
        conc_walks=torch.tensor(rng.randint(0, 30, (R, n_apps)),
                                dtype=torch.int32),
        warps_stalled=torch.tensor(rng.randint(0, 60, (R, n_apps)),
                                   dtype=torch.int32),
        queue_len=torch.tensor(rng.randint(0, 9, (R, 8, 3)),
                               dtype=torch.int32))
    singles = [_row(st, r) for r in range(R)]
    app = torch.tensor(rng.randint(0, n_apps, N), dtype=torch.int32)
    is_tlb = torch.tensor(rng.rand(N) < 0.3)
    for cycle in range(4):
        ch, bank, row = (torch.tensor(rng.randint(0, hi, (R, N)),
                                      dtype=torch.int32) for hi in (8, 3, 6))
        act = torch.tensor(rng.rand(R, N) < 0.7)
        st, lat = pt_dram.access(st, ch, bank, row, app, is_tlb, act,
                                 mask_enabled=mask_on, waves=W)
        for r in range(R):
            singles[r], one = pt_dram.access(
                singles[r], ch[r], bank[r], row[r], app, is_tlb, act[r],
                mask_enabled=mask_on, waves=W)
            np.testing.assert_array_equal(lat[r].numpy(), one.numpy())
        _assert_rows(st, singles, f"cycle {cycle}")


def test_tokens_and_bypass_rows_match_row_loop():
    rng = np.random.RandomState(5)
    wpa = torch.tensor([480, 480], dtype=torch.int32)
    tok = pt_tok.init(2, wpa, np.float32(0.25))
    tok = type(tok)(*(x.repeat(R, *(1,) * x.dim()) for x in tok))
    bp = pt_bp.init("cpu")
    bp = type(bp)(*(x.repeat(R, *(1,) * x.dim()) for x in bp))
    tok1 = [_row(tok, r) for r in range(R)]
    bp1 = [_row(bp, r) for r in range(R)]
    app = torch.tensor(rng.randint(0, 2, 30), dtype=torch.int32)
    depth = torch.tensor(rng.randint(0, 8, 240), dtype=torch.int32)
    for epoch in range(5):
        for _ in range(3):
            hit = torch.tensor(rng.rand(R, 30) < 0.4)
            act = torch.tensor(rng.rand(R, 30) < 0.8)
            tok = pt_tok.record(tok, app, hit, act)
            h2 = torch.tensor(rng.rand(R, 240) < 0.5)
            a2 = torch.tensor(rng.rand(R, 240) < 0.7)
            fill = pt_bp.should_fill(bp, depth)
            bp = pt_bp.record(bp, depth, h2, a2)
            for r in range(R):
                tok1[r] = pt_tok.record(tok1[r], app, hit[r], act[r])
                np.testing.assert_array_equal(
                    fill[r].numpy(), pt_bp.should_fill(bp1[r], depth).numpy())
                bp1[r] = pt_bp.record(bp1[r], depth, h2[r], a2[r])
        tok = pt_tok.epoch_update(tok, wpa)
        bp = pt_bp.epoch_update(bp)
        tok1 = [pt_tok.epoch_update(x, wpa) for x in tok1]
        bp1 = [pt_bp.epoch_update(x) for x in bp1]
        _assert_rows(tok, tok1, f"tokens epoch {epoch}")
        _assert_rows(bp, bp1, f"bypass epoch {epoch}")


# ------------------------------------------------------------ the step

def _leaves(tree, path="state"):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}.{f}")
    else:
        yield path, tree


MIX_ROWS = [["3DS", "BLK"], ["MUM", None], ["BLK", "3DS"]]


@pytest.mark.parametrize("name", ["mask", "pwc", "static"])
def test_rows_equal_single_runs_across_epochs(name):
    """R rows stepped together == R single runs, every leaf, over cycles
    that cross three epoch boundaries (tokens, bypass latch, DRAM
    pressure) under a short epoch."""
    d = pt_design.get_design(name).with_(epoch_cycles=40)
    cfg = SimConfig(design=d, sim_cycles=130, device="cpu")
    dp = pt_design.design_params(d)
    pms = torch.tensor(np.stack([pt_wl.app_matrix(m) for m in MIX_ROWS]))
    st = runner.simulate(cfg, dp, pms)
    assert st.stall_until.shape == (R, cfg.total_warps)
    for r in range(R):
        one = runner.simulate(cfg, dp, pms[r])
        got = dict(_leaves(convert.state_to_numpy(st, row=r)))
        for path, want in _leaves(convert.state_to_numpy(one)):
            np.testing.assert_array_equal(got[path], want,
                                          err_msg=f"row {r} {path}")


class _OpCount(TorchDispatchMode):
    """Counts dispatched operations by name; none while `inside` > 0 (a
    caller that counts a whole call as one raises it around the call)."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()
        self.inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.inside:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


# the 7 built-in designs of the non-ideal signature group, as one pass
GROUP = [n for n in ref_mask.ALL_DESIGNS if n != "ideal"]


@pytest.mark.parametrize("name", ["pwc", "mask", "ideal", "group"])
def test_step_work_does_not_grow_with_rows(monkeypatch, name):
    """One step at R = 1 and R = 8 rows per design dispatches the same
    operations, the same number of times, and the same number of fused
    rounds (2 under `pwc` and in the mixed `group` of 7 designs, whose
    PWC round masks the other rows' lanes; else 1): the rows share every
    launch."""
    rounds = []
    plain = fused_ops.fused_tlb_access_ref
    monkeypatch.setattr(fused_ops, "fused_tlb_access_ref",
                        lambda *a, **k: rounds.append(a[0].shape[0])
                        or plain(*a, **k))
    names = GROUP if name == "group" else [name]
    cfg = SimConfig(design=names[0], sim_cycles=2, device="cpu")
    counts = {}
    for rows in (1, 8):
        dp = pt_design.stack_params(
            [pt_design.design_params(n) for n in names], rows, "cpu") \
            if name == "group" else pt_design.design_params(cfg.design)
        R = rows * len(names)
        pm = torch.tensor(pt_wl.app_matrix(["3DS", "BLK"]))[None] \
            .repeat(R, 1, 1)
        st = runner.simulate(cfg, dp, pm)        # warms the shape caches
        rounds.clear()
        with torch.inference_mode(), _OpCount() as mode:
            memsys.step(cfg, dp, pm, st, 2)
        counts[rows] = mode.ops
        assert rounds == [R] * (2 if name in ("pwc", "group") else 1)
    assert counts[1] == counts[8]
    assert sum(counts[8].values()) > 100


# ------------------------------------------------------------ runner

def test_grid_reproduces_goldens_float_hex(monkeypatch):
    """run_grid over the 8 designs, one mix, 1200 cycles: 2 passes (ideal
    alone, then the other 7 as the rows of one pass), and every cell
    equals its `GOLDEN` pin float-hex."""
    golden = _load_golden()
    names = list(ref_mask.ALL_DESIGNS)
    passes = []
    grid_pass = runner._grid_pass
    monkeypatch.setattr(runner, "_grid_pass",
                        lambda ccfg, ds, mixes: passes.append(
                            tuple(d.name for d in ds))
                        or grid_pass(ccfg, ds, mixes))
    grid = runner.run_grid(names, [("3DS", "BLK")], cycles=1200,
                           device="cpu")
    assert passes == [("ideal",), tuple(GROUP)]
    for i, name in enumerate(names):
        for key, want in golden[name].items():
            got = [x.hex() for x in
                   np.asarray(grid[i][0][key], np.float64).ravel().tolist()]
            assert got == want, f"{name}:{key} drifted: {got} != {want}"


def test_convert_round_trips_one_row():
    """Row 1 of a 3-row state -> a reference tree (jax leaves) -> numpy ->
    the port's single state, unchanged; the rows stacked back from
    reference trees give the 3-row state again."""
    cfg = SimConfig(design="gpu-mmu", sim_cycles=25, device="cpu")
    dp = pt_design.design_params(cfg.design)
    pms = torch.tensor(np.stack([pt_wl.app_matrix(m) for m in MIX_ROWS]))
    st = runner.simulate(cfg, dp, pms)
    ref_cfg = RefConfig(design=ref_design.get_design("gpu-mmu"))
    treedef = jax.tree_util.tree_structure(ref_ms.init_state(
        ref_cfg, ref_design.design_params(ref_cfg.design)))
    trees = []
    for r in range(R):
        leaves = [jnp.asarray(x) for _, x in
                  _leaves(convert.state_to_numpy(st, row=r))]
        trees.append(jax.device_get(jax.tree_util.tree_unflatten(treedef,
                                                                 leaves)))
    one = convert.state_from_numpy(trees[1], "cpu")
    want = dict(_leaves(convert.state_to_numpy(st, row=1)))
    for path, x in _leaves(convert.state_to_numpy(one)):
        np.testing.assert_array_equal(x, want[path], err_msg=path)
        assert x.dtype == want[path].dtype, path
    back = convert.state_from_numpy(trees, "cpu")
    full = dict(_leaves(convert.state_to_numpy(st)))
    for path, x in _leaves(convert.state_to_numpy(back)):
        np.testing.assert_array_equal(x, full[path], err_msg=path)


def test_more_than_one_device_raises():
    # the CPU shows one device to shard over (tests/test_torch_sharded_grid
    # patches the count): asking for more raises, naming the count, as the
    # reference raises past its visible devices
    with pytest.raises(ValueError, match="devices=2"):
        runner.run_grid(["mask"], [("3DS", "BLK")], cycles=5, devices=2,
                        device="cpu")
    with pytest.raises(ValueError, match="devices=2"):
        runner.sweep(["mask"], [("3DS", "BLK")], cycles=5, devices=2,
                     device="cpu")
    with pytest.raises(ValueError, match="grid path"):
        runner.sweep(["mask"], [("3DS", "BLK")], cycles=5, devices=2,
                     grid=False, device="cpu")


# ------------------------------------------------ copied JAX-free helpers

@pytest.mark.parametrize("seed,n_mixes,n_apps", [(7, 35, 2), (3, 12, 3),
                                                 (0, 5, 4)])
def test_mix_workloads_match_reference(seed, n_mixes, n_apps):
    got = pt_wl.mix_workloads(seed, n_mixes, n_apps)
    assert got == ref_wl.mix_workloads(seed, n_mixes, n_apps)
    assert [pt_wl.hmr_class(m) for m in got] == \
        [ref_wl.hmr_class(m) for m in got]
    assert pt_wl.pair_workloads(seed, 20) == ref_wl.pair_workloads(seed, 20)
    with pytest.raises(ValueError):
        pt_wl.mix_workloads(0, 10_000, 2)
    with pytest.raises(ValueError):
        pt_wl.mix_workloads(0, 1, 99)


LEGACY = [
    dict(name="lg-default"),
    dict(name="lg-pwc", use_l2_tlb=False, use_pwc=True),
    dict(name="lg-ideal", ideal_tlb=True),
    dict(name="lg-walk", use_l2_tlb=False),
    dict(name="lg-static", static_partition=True,
         mask=dict(tlb_tokens=True, l2_bypass=False, dram_sched=True,
                   l2_tlb_entries=1024, epoch_cycles=4000, thres_max=77,
                   initial_token_frac=0.5, walk_levels=3)),
]


@pytest.mark.parametrize("spec", LEGACY, ids=[s["name"] for s in LEGACY])
def test_legacy_design_points_match_reference(spec):
    spec = dict(spec)
    mask_kw = spec.pop("mask", None)
    ref_kw, pt_kw = dict(spec), dict(spec)
    if mask_kw is not None:
        ref_kw["mask"] = ref_mask.MaskConfig(**mask_kw)
        pt_kw["mask"] = pt_mask.MaskConfig(**mask_kw)
    ref_dp, pt_dp = ref_mask.DesignPoint(**ref_kw), \
        pt_mask.DesignPoint(**pt_kw)
    assert dataclasses.asdict(pt_dp) == dataclasses.asdict(ref_dp)
    want = dataclasses.asdict(ref_design.from_legacy(ref_dp))
    assert dataclasses.asdict(pt_design.from_legacy(pt_dp)) == want
    assert dataclasses.asdict(pt_design.as_design(pt_dp)) == want
    assert pt_design.design_params(pt_dp) == \
        convert.design_params_from_numpy(ref_design.design_params(ref_dp))


def test_legacy_both_translation_flags_refused():
    dp = pt_mask.DesignPoint("both", use_l2_tlb=True, use_pwc=True)
    with pytest.raises(ValueError, match="use_l2_tlb and use_pwc"):
        pt_design.as_design(dp)
    with pytest.raises(TypeError):
        pt_design.as_design(42)
    assert dataclasses.asdict(pt_mask.MaskConfig()) == \
        dataclasses.asdict(ref_mask.MaskConfig())
