"""Per-row design knobs: a signature group's designs as the rows of one
pass, against the reference's grid semantics (CPU).

* `stack_params` gives the reference's stacked `DesignParams` (the
  `jax.tree_util` stack of `repro.sim.runner.run_grid`), design-major,
  with a knob's host value where every row agrees.
* `dram_sched.access` / `silver_quota` (per-row `mask_enabled`,
  `thres_max`), the token state (per-row `initial_frac`, `step_frac`,
  init, epochs and a membership change) and the shared L2$ stage
  (per-row bypass, static partition and DRAM knobs) equal the same calls
  made row by row with each row's host knobs; the DRAM and token calls
  also equal `jax.vmap` of the reference's on the same stacked knobs.
* A group of variants that differ only in dynamic knobs, crossing
  epochs, runs as one pass whose every cell equals that variant's
  `run_mix`, float-hex.
* The 8 built-in designs run as 2 passes, rows design-major.
* `run_grid`'s chunk plans (which designs share a pass, the stacked
  knobs and workload rows of each) and `FailureRecord`s equal the
  reference's for the same (designs, mixes, `max_rows`, `fail_soft`);
  the reference is stubbed at `_compiled_grid_run`, so nothing of it is
  compiled or simulated here.
* A one-design step issues the parent's operations: the dispatcher
  counts of every built-in design are pinned.
"""
import functools
import importlib
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import dram_sched as ref_dram  # noqa: E402
from repro.core import mask as ref_mask  # noqa: E402
from repro.core import tokens as ref_tok  # noqa: E402
from repro.sim import runner as ref_runner  # noqa: E402
# `repro_torch.core.design` the module: the package binds the name to
# the `design` function, as `repro.core` does
pt_design = importlib.import_module("repro_torch.core.design")
from repro_torch.core import dram_sched as pt_dram  # noqa: E402
from repro_torch.core import tokens as pt_tok  # noqa: E402
from repro_torch.kernels.fused_tlb import ops as fused_ops  # noqa: E402
from repro_torch.sim import memsys, runner  # noqa: E402
from repro_torch.sim import workloads as pt_wl  # noqa: E402
from repro_torch.sim.config import SimConfig  # noqa: E402
from tests.test_torch_grid import _OpCount  # noqa: E402

# `repro.core` re-exports a function named `design`, shadowing the module
ref_design = importlib.import_module("repro.core.design")

NAMES = list(ref_mask.ALL_DESIGNS)
GROUP = [n for n in NAMES if n != "ideal"]
MIXES = [("3DS", "BLK"), ("MUM", None)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hexed(s):
    return {k: [x.hex() for x in np.asarray(v, np.float64).ravel().tolist()]
            for k, v in s.items()}


def _variants():
    """One signature group at a 40-cycle epoch: the 7 non-ideal built-ins
    (each mechanism on and off, the pwc organization) and variants of
    `mask` with the other value of every numeric knob and the walk-only
    organization."""
    m = pt_design.get_design("mask").with_(epoch_cycles=40)
    return [pt_design.get_design(n).with_(epoch_cycles=40)
            for n in GROUP] + [
        m.with_(name="mask-if50", tokens=dict(initial_frac=0.5)),
        m.with_(name="mask-sf25", tokens=dict(step_frac=0.25)),
        m.with_(name="mask-tm100", dram=dict(thres_max=100)),
        m.with_(name="mask-walk", translation=dict(kind="walk_only")),
    ]


# ------------------------------------------------------------ knobs

# the reference's dtype of each stacked knob; the rest are bool
_PLANE_DTYPES = {"initial_frac": np.float32, "step_frac": np.float32,
                 "thres_max": np.int32}


def _plane(dp, R):
    """Every knob of `dp` as an (R,) array: a tensor knob as it is, a host
    knob broadcast to the reference's stacked dtype."""
    return pt_design.DesignParams(*(
        x.numpy() if isinstance(x, torch.Tensor)
        else np.full(R, x, _PLANE_DTYPES.get(f, np.bool_))
        for f, x in zip(pt_design.DesignParams._fields, dp)))


@pytest.mark.parametrize("names, M", [
    (GROUP, 3), (["mask", "mask-tlb"], 2), (["gpu-mmu"], 4),
    (["mask", "mask"], 1)])
def test_stacked_params_match_reference_stack(names, M):
    """`stack_params` == the reference's stacked plane, leaf by leaf
    (values and dtypes), with a knob's host value where all rows agree
    and an (R,) tensor where they differ."""
    got = pt_design.stack_params([pt_design.design_params(n) for n in names],
                                 M, "cpu")
    want = jax.device_get(jax.tree_util.tree_map(
        lambda *leaves: jnp.repeat(jnp.stack(leaves), M, axis=0),
        *[ref_design.design_params(n) for n in names]))
    plane = _plane(got, len(names) * M)
    for f in ref_design.DesignParams._fields:
        row = getattr(plane, f)
        ref = np.asarray(getattr(want, f))
        assert row.dtype == ref.dtype and row.shape == (len(names) * M,), f
        np.testing.assert_array_equal(row, ref, err_msg=f)
        knob = getattr(got, f)
        host = [getattr(pt_design.design_params(n), f) for n in names]
        if len(set(host)) == 1:
            assert not isinstance(knob, torch.Tensor) and knob == host[0], f
        else:
            assert isinstance(knob, torch.Tensor), f


def _rows_of(tree, r):
    return type(tree)(*(x[r] for x in tree))


def _assert_rows(tree, singles, what):
    for f, x in zip(tree._fields, tree):
        for r, one in enumerate(singles):
            np.testing.assert_array_equal(
                x[r].numpy(), getattr(one, f).numpy(),
                err_msg=f"{what}: row {r} {f}")


def _assert_ref(tree, ref, what):
    """A tree of tensors == the reference's tree of arrays, leaf by leaf,
    values and dtypes."""
    for f, x in zip(tree._fields, tree):
        a, b = x.numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f}")


def _to_ref(cls, tree):
    return cls(*(jnp.asarray(x.numpy()) for x in tree))


def test_dram_per_row_knobs_match_row_loop():
    """`dram_sched.access` with (R,) `mask_enabled` / `thres_max` == each
    row called with its own host knobs, and == `jax.vmap` of the
    reference's on the same stacked knobs, over cycles that rotate the
    silver app (small quotas); `silver_quota` likewise."""
    rng = np.random.RandomState(11)
    mask_on = [True, False, True, True]
    thres = [500, 500, 3, 40]
    R, n_apps, W, C = len(mask_on), 3, 8, 30
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
    singles = [_rows_of(st, r) for r in range(R)]
    app = torch.tensor(rng.randint(0, n_apps, N), dtype=torch.int32)
    is_tlb = torch.tensor(rng.rand(N) < 0.3)
    on_t = torch.tensor(mask_on)
    tm_t = torch.tensor(thres, dtype=torch.int32)
    ref = _to_ref(ref_dram.DramState, st)
    ref_access = jax.jit(jax.vmap(
        functools.partial(ref_dram.access, waves=W),
        in_axes=(0, 0, 0, 0, None, None, 0, 0, 0)))
    rotations = 0
    for cycle in range(6):
        ch, bank, row = (torch.tensor(rng.randint(0, hi, (R, N)),
                                      dtype=torch.int32) for hi in (8, 3, 6))
        act = torch.tensor(rng.rand(R, N) < 0.7)
        before = st.silver_app.clone()
        st, lat = pt_dram.access(st, ch, bank, row, app, is_tlb, act,
                                 mask_enabled=on_t, thres_max=tm_t, waves=W)
        rotations += int((st.silver_app != before).sum())
        ref, ref_lat = ref_access(
            ref, *(jnp.asarray(x.numpy()) for x in (ch, bank, row, app,
                                                    is_tlb, act, on_t,
                                                    tm_t)))
        _assert_ref(st, ref, f"vmap cycle {cycle}")
        np.testing.assert_array_equal(lat.numpy(), np.asarray(ref_lat))
        for r in range(R):
            singles[r], one = pt_dram.access(
                singles[r], ch[r], bank[r], row[r], app, is_tlb, act[r],
                mask_enabled=mask_on[r], thres_max=thres[r], waves=W)
            np.testing.assert_array_equal(lat[r].numpy(), one.numpy())
        _assert_rows(st, singles, f"cycle {cycle}")
    assert rotations > 0
    quota = pt_dram.silver_quota(st, tm_t)
    np.testing.assert_array_equal(
        quota.numpy(), np.asarray(jax.vmap(ref_dram.silver_quota)(
            ref, jnp.asarray(thres, jnp.int32))))
    for r in range(R):
        np.testing.assert_array_equal(
            quota[r].numpy(), pt_dram.silver_quota(singles[r],
                                                   thres[r]).numpy())


def test_tokens_per_row_fracs_match_row_loop():
    """Token init with (R,) `initial_frac`, epochs with (R,) `step_frac`,
    and `init_state` / `apply_membership_change` under stacked knobs ==
    each row with its own design's host knobs; init, record and epochs
    also == `jax.vmap` of the reference's on the same stacked knobs."""
    rng = np.random.RandomState(5)
    fracs = [np.float32(0.25), np.float32(0.5), np.float32(0.8)]
    steps = [np.float32(0.5), np.float32(0.25), np.float32(0.125)]
    R = len(fracs)
    wpa = torch.tensor([480, 420], dtype=torch.int32)
    tok = pt_tok.init(2, wpa, torch.tensor(fracs))
    assert tok.tokens.shape == (R, 2)
    tok = tok._replace(**{f: getattr(tok, f).repeat(R, *(1,) * getattr(
        tok, f).dim()) for f in tok._fields if f != "tokens"})
    singles = [pt_tok.init(2, wpa, f) for f in fracs]
    _assert_rows(tok, singles, "init")
    ref_wpa = jnp.asarray(wpa.numpy())
    ref = jax.vmap(lambda f: ref_tok.init(2, ref_wpa, f))(
        jnp.asarray(fracs, jnp.float32))
    _assert_ref(tok, ref, "vmap init")
    ref_record = jax.vmap(ref_tok.record, in_axes=(0, None, 0, 0))
    ref_epoch = jax.vmap(lambda x, s: ref_tok.epoch_update(x, ref_wpa,
                                                           step_frac=s))
    ref_steps = jnp.asarray(steps, jnp.float32)
    app = torch.tensor(rng.randint(0, 2, 30), dtype=torch.int32)
    for epoch in range(5):
        hit = torch.tensor(rng.rand(R, 30) < 0.4)
        act = torch.tensor(rng.rand(R, 30) < 0.8)
        tok = pt_tok.record(tok, app, hit, act)
        singles = [pt_tok.record(x, app, hit[r], act[r])
                   for r, x in enumerate(singles)]
        tok = pt_tok.epoch_update(tok, wpa, step_frac=torch.tensor(steps))
        singles = [pt_tok.epoch_update(x, wpa, step_frac=s)
                   for x, s in zip(singles, steps)]
        _assert_rows(tok, singles, f"epoch {epoch}")
        ref = ref_epoch(ref_record(ref, *(jnp.asarray(x.numpy())
                                          for x in (app, hit, act))),
                        ref_steps)
        _assert_ref(tok, ref, f"vmap epoch {epoch}")

    # the state of a grouped pass, and a membership change over it
    ds = [pt_design.get_design("mask").with_(
        name=f"m{i}", tokens=dict(initial_frac=float(f), step_frac=float(s)))
        for i, (f, s) in enumerate(zip(fracs, steps))]
    cfg = SimConfig(design=ds[0], sim_cycles=1, device="cpu")
    dps = [pt_design.design_params(d) for d in ds]
    rp = pt_design.stack_params(dps, 1, "cpu")
    assert isinstance(rp.initial_frac, torch.Tensor)
    st = memsys.init_state(cfg, rp, rows=R)
    change = torch.tensor([[True, False], [False, True], [True, True]])
    st = st._replace(tokens=st.tokens._replace(tokens=st.tokens.tokens + 7))
    out = memsys.apply_membership_change(cfg, rp, st, change)
    for r, dp in enumerate(dps):
        one = memsys.init_state(cfg, dp, rows=1)
        np.testing.assert_array_equal(st.tokens.tokens[r].numpy() - 7,
                                      one.tokens.tokens[0].numpy())
        single = memsys.apply_membership_change(
            cfg, dp, memsys.map_state(lambda x, r=r: x[r:r + 1], st),
            change[r:r + 1])
        for f in out.tokens._fields:
            np.testing.assert_array_equal(
                getattr(out.tokens, f)[r].numpy(),
                getattr(single.tokens, f)[0].numpy(),
                err_msg=f"change: row {r} {f}")
    with pytest.raises(ValueError, match="rows"):
        memsys.init_state(cfg, rp)


def test_shared_round_per_row_knobs_match_row_loop():
    """`shared_memory_access` under stacked knobs whose bypass, static
    partition, DRAM scheduler and quota ceiling differ by row == each row
    under its own design's host knobs, over epochs that latch bypass
    rates (so `should_fill` bites)."""
    names = ["mask", "static", "mask-cache", "gpu-mmu", "mask-dram"]
    ds = [pt_design.get_design(n) for n in names]
    ds[-1] = ds[-1].with_(dram=dict(thres_max=7))
    R = len(ds)
    cfg = SimConfig(design=ds[0], sim_cycles=1, device="cpu")
    dps = [pt_design.design_params(d) for d in ds]
    rp = pt_design.stack_params(dps, 1, "cpu")
    assert all(isinstance(getattr(rp, f), torch.Tensor)
               for f in ("bypass_on", "static_part", "dram_on", "thres_max"))
    rng = np.random.RandomState(3)
    C, L, K = cfg.n_cores, 4, memsys.DATA_WIDTH
    data = memsys.map_state(lambda x: x.repeat(R, *(1,) * x.dim()),
                            memsys.init_data(cfg))
    singles = [memsys.map_state(lambda x: x[None], memsys.init_data(cfg))
               for _ in range(R)]
    app = torch.tensor(cfg.app_of_core, dtype=torch.int32)
    tags = memsys._consts(cfg).walk_tags
    for t in range(1, 25):
        wl = torch.tensor(rng.randint(0, 4000, (R, L * C)), dtype=torch.int32)
        wg = torch.tensor(rng.rand(R, L * C) < 0.5)
        dl = torch.tensor(rng.randint(0, 4000, (R, K * C)), dtype=torch.int32)
        go = torch.tensor(rng.rand(R, C) < 0.6)
        data, mem = memsys.shared_memory_access(
            cfg, rp, data, app, wl, wg, tags, dl, go, t)
        for r, dp in enumerate(dps):
            singles[r], one = memsys.shared_memory_access(
                cfg, dp, singles[r], app, wl[r:r + 1], wg[r:r + 1], tags,
                dl[r:r + 1], go[r:r + 1], t)
            for f, x in zip(mem._fields, mem):
                np.testing.assert_array_equal(
                    x[r].numpy(), getattr(one, f)[0].numpy(),
                    err_msg=f"t={t} row {r} {f}")
        if t % 6 == 0:           # latch per-depth rates: bypass decides
            bp = memsys.bp_mod.epoch_update(data.bypass)
            data = data._replace(bypass=bp)
            singles = [s._replace(bypass=memsys.bp_mod.epoch_update(s.bypass))
                       for s in singles]
    for r in range(R):
        for path, x in _leaves(data):
            np.testing.assert_array_equal(
                x[r].numpy(), dict(_leaves(singles[r]))[path][0].numpy(),
                err_msg=f"row {r} {path}")
    assert bool(data.bypass.have_rates.any())


def _leaves(tree, path="data"):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}.{f}")
    else:
        yield path, tree


# ------------------------------------------------------------ the grid

def _record_passes(monkeypatch):
    passes = []
    grid_pass = runner._grid_pass

    def counted(ccfg, designs, mixes):
        passes.append(tuple(d.name for d in designs))
        return grid_pass(ccfg, designs, mixes)

    monkeypatch.setattr(runner, "_grid_pass", counted)
    return passes


def test_dynamic_knob_group_equals_run_mix(monkeypatch):
    """11 variants of one signature group (every mechanism on and off,
    two initial_frac, step_frac and thres_max values, 3 organizations) x 2
    mixes at a 40-cycle epoch: ONE pass of 22 rows, one new plan, and
    every cell == that variant's `run_mix` float-hex across 2 epochs."""
    cycles = 97                         # unique: no other test's plan
    ds = _variants()
    passes = _record_passes(monkeypatch)
    before = runner.TRACE_COUNT
    grid = runner.run_grid(ds, MIXES, cycles=cycles, device="cpu")
    assert passes == [tuple(d.name for d in ds)]
    assert runner.TRACE_COUNT - before == 1
    cells = {}
    for i, d in enumerate(ds):
        for m, mix in enumerate(MIXES):
            want = _hexed(runner.run_mix(d, list(mix), cycles, device="cpu"))
            assert _hexed(grid[i][m]) == want, f"{d.name} {mix} drifted"
            cells[(d.name, m)] = want
    # the knobs matter: every variant differs from `mask` in some cell
    for d in (d for d in ds if d.name != "mask"):
        assert any(cells[(d.name, m)] != cells[("mask", m)]
                   for m in range(len(MIXES))), d.name


def test_builtin_designs_run_as_two_passes(monkeypatch):
    """The 8 built-in designs x 3 mixes: 2 passes, `ideal`'s 3 rows and
    the other 7 designs' 21 rows, design-major (row g * 3 + m is design g,
    mix m), the fused round launched once per pass per round (2 under the
    group's PWC rows)."""
    mixes = [("3DS", "BLK"), ("MUM", None), ("BLK", "RED")]
    passes = _record_passes(monkeypatch)
    rows = []
    run_rows = runner._run_rows
    monkeypatch.setattr(runner, "_run_rows", lambda cfg, dp, ms: rows.append(
        list(ms)) or run_rows(cfg, dp, ms))
    rounds = []
    plain = fused_ops.fused_tlb_access_ref
    monkeypatch.setattr(fused_ops, "fused_tlb_access_ref",
                        lambda *a, **k: rounds.append(a[0].shape[0])
                        or plain(*a, **k))
    grid = runner.run_grid(NAMES, mixes, cycles=4, device="cpu")
    assert passes == [("ideal",), tuple(GROUP)]
    assert rows == [mixes, mixes * len(GROUP)]
    assert Counter(rounds) == {3: 4, 21: 8}
    assert all(len(r) == len(mixes) for r in grid)
    assert all(c["cycles"] == 4.0 for r in grid for c in r)


class _Stop(RuntimeError):
    pass


def _ref_stub(calls):
    def compiled(ccfg):
        def run(dp_stack, pm_stack):
            calls.append((jax.device_get(dp_stack), np.asarray(pm_stack)))
            raise _Stop("stubbed pass")
        return run
    return compiled


def _port_stub(calls):
    def run_rows(cfg, dp, mixes):
        calls.append((_plane(dp, len(mixes)),
                      np.stack([pt_wl.app_matrix(list(m)) for m in mixes])))
        raise _Stop("stubbed pass")
    return run_rows


def _extra(mod):
    """Designs of two more signature groups, built in `mod`."""
    m = mod.get_design("mask")
    return [m.with_(name="mask-w8", translation=dict(l2_ways=8)),
            mod.get_design("gpu-mmu").with_(
                name="mmu-w8", translation=dict(l2_ways=8)),
            mod.get_design("ideal").with_(name="ideal-tm9",
                                          dram=dict(kind="mask",
                                                    thres_max=9))]


PLAN_CASES = [
    # (design names or "+extra", number of mixes, max_rows)
    (GROUP[:6], 5, 20),          # 6 designs x 5 mixes: 2 passes of 15 rows
    (NAMES, 3, 64),              # 2 passes: 3 rows and 21 rows
    (NAMES, 10, 64),             # 6 designs a call: 7 passes of one
    (NAMES, 67, 64),             # past the cap: one design a pass
    (GROUP[:4], 5, 10),          # 2 designs a call: 2 passes of 10 rows
    (GROUP[:6], 2, 8),           # 4 a call: 2 passes of 3 designs
    (NAMES + ["+extra"], 4, 16),  # 4 groups in order of first appearance
]


@pytest.mark.parametrize("names, M, max_rows", PLAN_CASES)
def test_chunk_plans_and_failure_records_match_reference(monkeypatch, names,
                                                         M, max_rows):
    """Which designs share each pass, in which row order (the stacked
    knobs and workload rows of every pass), and the `FailureRecord` of a
    failing chunk in every cell it covered: == the reference's, with both
    runners stubbed where a pass would run."""
    extra = "+extra" in names
    names = [n for n in names if n != "+extra"]
    pt_ds = [pt_design.get_design(n) for n in names] + (
        _extra(pt_design) if extra else [])
    ref_ds = [ref_design.get_design(n) for n in names] + (
        _extra(ref_design) if extra else [])
    mixes = pt_wl.pair_workloads(n_pairs=M)
    got_calls, want_calls = [], []
    monkeypatch.setattr(runner, "_run_rows", _port_stub(got_calls))
    monkeypatch.setattr(ref_runner, "_compiled_grid_run",
                        _ref_stub(want_calls))
    got = runner.run_grid(pt_ds, mixes, cycles=5, max_rows=max_rows,
                          fail_soft=True, device="cpu")
    want = ref_runner.run_grid(ref_ds, mixes, cycles=5, max_rows=max_rows,
                               fail_soft=True)
    assert len(got_calls) == len(want_calls)
    for (dp, pm), (ref_dp, ref_pm) in zip(got_calls, want_calls):
        for f in ref_design.DesignParams._fields:
            a, b = getattr(dp, f), np.asarray(getattr(ref_dp, f))
            np.testing.assert_array_equal(a, b, err_msg=f)
            assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(pm, ref_pm)
    recs = {}
    for d, (a_row, b_row) in enumerate(zip(got, want)):
        assert len(a_row) == len(b_row) == M
        for a, b in zip(a_row, b_row):
            assert isinstance(a, runner.FailureRecord)
            assert (a.designs, a.n_apps, a.cycles, a.error_type, a.message,
                    a.stage) == (b.designs, b.n_apps, b.cycles,
                                 b.error_type, b.message, b.stage)
            assert a is a_row[0]
            recs[a.designs] = a
    assert len(recs) == len(got_calls)


# ------------------------------------------------------------ launches

# dispatcher operations of one step of a one-design pass at R = 1 (the
# fused round counted as one call): (the epoch step, a step between
# epochs), measured with `_step_ops` below. They are the parent's counts
# from before per-row knobs, plus what reading the cycle from the device
# scalar `state.t` adds: its view `t_next[0]`, the floor division of the
# sequential stream in `gen_vpn`, the add of the walk deadline (under a
# walk design) and one expand of the stamp per LRU scatter (the L1 probe
# and fill, the L2 TLB's and the bypass cache's where the design has them)
PARENT_STEP_OPS = {
    "ideal": (437, 437), "pwc": (615, 615), "gpu-mmu": (674, 674),
    "static": (692, 692), "mask": (906, 854), "mask-tlb": (811, 759),
    "mask-cache": (741, 689), "mask-dram": (806, 754),
}


def _step_ops(monkeypatch, cfg, dp, pm, st, cycle):
    mode = _OpCount()
    plain = fused_ops.fused_tlb_access_ref

    def round_as_one(*a, **k):
        mode.ops["fused round"] += 1
        mode.inside += 1
        try:
            return plain(*a, **k)
        finally:
            mode.inside -= 1

    monkeypatch.setattr(fused_ops, "fused_tlb_access_ref", round_as_one)
    with torch.inference_mode(), mode:
        st = memsys.step(cfg, dp, pm, st, cycle)
    monkeypatch.setattr(fused_ops, "fused_tlb_access_ref", plain)
    return sum(mode.ops.values()), st


@pytest.mark.parametrize("name", NAMES)
def test_one_design_step_issues_the_parents_operations(monkeypatch, name):
    """A one-design pass (host knobs, as `run_mix` runs it) and a
    `stack_params` pass of that one design (every knob agrees) each issue the
    parent's operations per step, at an epoch and between epochs."""
    d = pt_design.get_design(name).with_(epoch_cycles=40)
    cfg = SimConfig(design=d, sim_cycles=39, device="cpu")
    pm = torch.tensor(pt_wl.app_matrix(["3DS", "BLK"]))[None]
    for dp in (pt_design.design_params(d),
               pt_design.stack_params([pt_design.design_params(d)], 1,
                                      "cpu")):
        st = runner.simulate(cfg, dp, pm)
        got = []
        for cycle in (39, 40):           # t = 40 is an epoch
            n, st = _step_ops(monkeypatch, cfg, dp, pm, st, cycle)
            got.append(n)
        assert tuple(got) == PARENT_STEP_OPS[name]
