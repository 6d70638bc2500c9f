"""Parity of the port's TLB machinery and plain fused round (CPU).

`probe`/`fill`/`probe_bank`/`fill_bank` are stepped in lockstep with the
reference over seeded request streams. The plain fused round
(`access_fused` on CPU tensors) is held against the reference's XLA path
and its Pallas kernel in interpret mode, at the kernel-test shapes, at
both main-path shapes with negative (int32-wrapped) tags, on the
write-collision case, at more lanes than a thread block has threads
(1056: 132 cores' lanes; 2048) and on rows of (3, 5) planes at R = 2.
Everything is exact. The CUDA wrapper's plan (the instance by way count
and row alignment, lanes per thread) and its refusals are checked too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import tlb as ref_tlb  # noqa: E402
from repro.kernels.fused_tlb.ops import fused_tlb_access  # noqa: E402
from repro_torch.core import tlb as pt_tlb  # noqa: E402
from repro_torch.kernels.fused_tlb import kernel as kernel_mod  # noqa: E402
from repro_torch.kernels.fused_tlb import ops as pt_ops  # noqa: E402
from repro_torch.kernels.fused_tlb.kernel import fused_tlb_round  # noqa: E402
from repro_torch.sim.convert import tlb_from_numpy, tlb_to_numpy  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_np(state):
    return ref_tlb.TLBState(*(np.asarray(x) for x in state))


def _assert_state(got, want, msg=""):
    got = tlb_to_numpy(got)
    for f in ref_tlb.TLBState._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{msg} {f}")


def _to_jax(state_np):
    return ref_tlb.TLBState(*(jnp.asarray(x) for x in state_np))


def _random_state(rng, shape, tag_hi=40, asid_hi=3, lru_hi=50):
    return ref_tlb.TLBState(
        tags=rng.randint(-1, tag_hi, shape).astype(np.int32),
        asids=rng.randint(-1, asid_hi, shape).astype(np.int32),
        lru=rng.randint(0, lru_hi, shape).astype(np.int32),
        hits=np.asarray(rng.randint(0, 9, shape[:-2]), np.int32),
        misses=np.asarray(rng.randint(0, 9, shape[:-2]), np.int32))


@pytest.mark.parametrize("entries,ways,N", [(512, 16, 30), (32, 32, 30),
                                            (64, 4, 12), (8, 8, 3)])
def test_probe_fill_lockstep(entries, ways, N):
    rng = np.random.RandomState(entries + ways + N)
    ref = _ref_np(ref_tlb.init(entries, ways))
    got = pt_tlb.init(entries, ways, "cpu")
    for t in range(1, 40):
        vpn = rng.randint(0, 3 * entries, N).astype(np.int32)
        asid = rng.randint(0, 3, N).astype(np.int32)
        act = rng.rand(N) > 0.2
        fil = rng.rand(N) > 0.3
        r_state, r_hit = ref_tlb.probe(_to_jax(ref), jnp.asarray(vpn),
                                       jnp.asarray(asid), jnp.asarray(act), t)
        got, hit = pt_tlb.probe(got, torch.tensor(vpn), torch.tensor(asid),
                                torch.tensor(act), t)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(r_hit))
        ref = _ref_np(ref_tlb.fill(r_state, jnp.asarray(vpn),
                                   jnp.asarray(asid),
                                   jnp.asarray(fil & ~np.asarray(r_hit)), t))
        got = pt_tlb.fill(got, torch.tensor(vpn), torch.tensor(asid),
                          torch.tensor(fil) & ~hit, t)
        _assert_state(got, ref, f"t={t}")


@pytest.mark.parametrize("B,entries,ways", [(30, 64, 64), (5, 16, 4),
                                            (3, 8, 8)])
def test_bank_lockstep(B, entries, ways):
    rng = np.random.RandomState(B * entries)
    ref = _ref_np(ref_tlb.init_bank(B, entries, ways))
    got = pt_tlb.init_bank(B, entries, ways, "cpu")
    _assert_state(got, ref, "init")
    for t in range(1, 50):
        vpn = rng.randint(0, 2 * entries, B).astype(np.int32)
        asid = rng.randint(0, 2, B).astype(np.int32)
        act = rng.rand(B) > 0.2
        r_state, r_hit = ref_tlb.probe_bank(
            _to_jax(ref), jnp.asarray(vpn), jnp.asarray(asid),
            jnp.asarray(act), t)
        got, hit = pt_tlb.probe_bank(got, torch.tensor(vpn),
                                     torch.tensor(asid), torch.tensor(act), t)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(r_hit))
        miss = act & ~np.asarray(r_hit)
        ref = _ref_np(ref_tlb.fill_bank(r_state, jnp.asarray(vpn),
                                        jnp.asarray(asid), jnp.asarray(miss),
                                        t))
        got = pt_tlb.fill_bank(got, torch.tensor(vpn), torch.tensor(asid),
                               torch.tensor(miss), t)
        _assert_state(got, ref, f"t={t}")


def test_flush_and_occupancy():
    rng = np.random.RandomState(3)
    for shape in ((4, 8), (3, 1, 16)):
        st = _random_state(rng, shape, asid_hi=5)
        got = tlb_from_numpy(st, "cpu")
        for a in (0, 2, -1):
            _assert_state(pt_tlb.flush_asid(got, a),
                          _ref_np(ref_tlb.flush_asid(_to_jax(st), a)))
        for n in (2, 5):
            np.testing.assert_array_equal(
                pt_tlb.occupancy_by_asid(got, n).numpy(),
                np.asarray(ref_tlb.occupancy_by_asid(_to_jax(st), n)))


# ------------------------------------------------------------ fused round

def _kernel_test_case(sets, ways, N, W):
    """The inputs of the reference's kernel test (`test_kernels.py`)."""
    rng = np.random.RandomState(sets * ways + W)
    return dict(
        tags=rng.randint(-1, 500, (sets, ways)).astype(np.int32),
        asids=rng.randint(0, 3, (sets, ways)).astype(np.int32),
        lru=rng.randint(0, 100, (sets, ways)).astype(np.int32),
        vpn=rng.randint(0, 600, (N,)).astype(np.int32),
        asid=rng.randint(0, 3, (N,)).astype(np.int32),
        active=rng.rand(N) > 0.25, may_fill=rng.rand(N) > 0.2, time=77)


def _path_case(sets, ways, N, W, masks, seed):
    """A main-path-like tag-only round: tags are line ids wrapped to int32
    (mostly negative), each in the set it maps to; about half the lanes
    re-touch resident lines, some repeat their own earlier-wave line."""
    rng = np.random.RandomState(seed)
    hi = rng.randint(-2**21, 2**21, (sets, ways)).astype(np.int64)
    tags = (hi * sets + np.arange(sets)[:, None]).astype(np.int32)
    tags[rng.rand(sets, ways) < 0.1] = -1
    lru = rng.randint(0, 3000, (sets, ways)).astype(np.int32)
    vpn = (rng.randint(-2**21, 2**21, N) * sets
           + rng.randint(0, sets, N)).astype(np.int32)
    resident = rng.rand(N) < 0.5
    pick = tags.reshape(-1)[rng.randint(0, sets * ways, N)]
    vpn = np.where(resident & (pick != -1), pick, vpn).astype(np.int32)
    C = N // W
    rep = rng.rand(N) < 0.15
    rep[:C] = False
    vpn[rep] = vpn[np.flatnonzero(rep) - C]
    active = {"all": np.ones(N, bool), "half": rng.rand(N) < 0.5,
              "nofill": np.ones(N, bool)}[masks]
    may_fill = np.zeros(N, bool) if masks == "nofill" else rng.rand(N) < 0.8
    return dict(tags=tags, asids=np.zeros((sets, ways), np.int32), lru=lru,
                vpn=vpn, asid=np.zeros(N, np.int32), active=active,
                may_fill=may_fill, time=3001)


def _collision_case(order):
    """One set: way 0 holds line 8 with the oldest LRU, so a same-cycle
    fill of the set takes way 0 while another lane pre-hits it."""
    return dict(tags=np.asarray([[8, 12, 16, 20]], np.int32),
                asids=np.zeros((1, 4), np.int32),
                lru=np.asarray([[1, 5, 6, 7]], np.int32),
                vpn=np.asarray(order, np.int32), asid=np.zeros(2, np.int32),
                active=np.ones(2, bool), may_fill=np.ones(2, bool), time=50)


def _run_ref(case, W, track, interpret):
    args = [jnp.asarray(case[k]) for k in ("tags", "asids", "lru", "vpn",
                                           "asid", "active", "may_fill")]
    if interpret:
        out = fused_tlb_access(*args, case["time"], n_waves=W,
                               track_asids=track, interpret=True)
    else:
        st = ref_tlb.TLBState(args[0], args[1], args[2], jnp.int32(0),
                              jnp.int32(0))
        st, hit, filled = ref_tlb.access_fused(
            st, *args[3:], case["time"], n_waves=W, track_asids=track)
        out = (st.tags, st.asids, st.lru, hit, filled)
    return [np.asarray(x).astype(np.int32) for x in out]


def _run_port(case, W, track):
    t = {k: torch.tensor(case[k]) for k in ("tags", "asids", "lru", "vpn",
                                            "asid", "active", "may_fill")}
    before = fused_tlb_round.launches
    out = pt_ops.fused_tlb_access(
        t["tags"], t["asids"], t["lru"], t["vpn"], t["asid"], t["active"],
        t["may_fill"], case["time"], n_waves=W, track_asids=track)
    assert fused_tlb_round.launches == before       # CPU: the plain round
    assert out[0] is t["tags"] and out[2] is t["lru"]   # updated in place
    return [x.numpy() for x in out]


def _check(case, W, track, interpret):
    want = _run_ref(case, W, track, interpret)
    got = _run_port(case, W, track)
    for a, b, name in zip(got, want, ("tags", "asids", "lru", "hit",
                                      "filled")):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("sets,ways,N,W", [(1, 64, 30, 1), (32, 16, 30, 3),
                                           (64, 8, 64, 4), (4, 2, 24, 6)])
@pytest.mark.parametrize("track_asids", [True, False])
@pytest.mark.parametrize("interpret", [False, True])
def test_fused_round_kernel_test_shapes(sets, ways, N, W, track_asids,
                                        interpret):
    _check(_kernel_test_case(sets, ways, N, W), W, track_asids, interpret)


PATH_SHAPES = [(1024, 16, 240, 8), (1024, 16, 120, 4), (64, 16, 120, 4)]


@pytest.mark.parametrize("sets,ways,N,W", PATH_SHAPES)
@pytest.mark.parametrize("masks", ["all", "half", "nofill"])
def test_fused_round_path_shapes(sets, ways, N, W, masks):
    case = _path_case(sets, ways, N, W, masks, seed=sets + N)
    assert (case["vpn"] < 0).mean() > 0.3          # negative tags occur
    _check(case, W, False, interpret=False)


@pytest.mark.parametrize("sets,ways,N,W", PATH_SHAPES[::2])
def test_fused_round_path_shapes_interpret(sets, ways, N, W):
    _check(_path_case(sets, ways, N, W, "half", seed=7), W, False,
           interpret=True)


@pytest.mark.parametrize("sets,ways,N,W", PATH_SHAPES)
def test_fused_round_chained_rounds(sets, ways, N, W):
    """Twenty rounds in a row on one evolving table, port vs reference."""
    case = _path_case(sets, ways, N, W, "half", seed=11)
    planes = {k: case[k] for k in ("tags", "asids", "lru")}
    rng = np.random.RandomState(5)
    for r in range(20):
        nxt = _path_case(sets, ways, N, W, "half", seed=100 + r)
        pick = planes["tags"].reshape(-1)[rng.randint(0, sets * ways, N)]
        nxt["vpn"] = np.where(rng.rand(N) < 0.4, pick, nxt["vpn"]) \
            .astype(np.int32)
        nxt.update(planes, time=4000 + r)
        want = _run_ref(nxt, W, False, interpret=False)
        got = _run_port(nxt, W, False)
        for a, b, name in zip(got, want, ("tags", "asids", "lru", "hit",
                                          "filled")):
            np.testing.assert_array_equal(a, b, err_msg=f"round {r} {name}")
        planes = dict(zip(("tags", "asids", "lru"), got[:3]))


# more lanes than threads: the kernel's wide instances (lanes t, t + 1024)
WIDE_SHAPES = [(1024, 16, 2048, 8), (64, 16, 1056, 4)]


@pytest.mark.parametrize("sets,ways,N,W", WIDE_SHAPES)
@pytest.mark.parametrize("interpret", [False, True])
def test_fused_round_wide_lanes(sets, ways, N, W, interpret):
    """2048 and 1056 lanes: the plain round equals the reference's XLA
    path and its Pallas kernel (interpret mode) bit for bit."""
    _check(_path_case(sets, ways, N, W, "half", seed=N + W), W, False,
           interpret)


@pytest.mark.parametrize("track_asids", [True, False])
def test_fused_round_rows_of_unaligned_planes(track_asids):
    """Two rows of (3, 5) planes (60-byte rows, off 16-byte alignment from
    row 1 on, where the card's word-reading instance runs): the port's
    row-axis round equals the reference's kernel (interpret mode) run on
    each row alone."""
    rows = [_kernel_test_case(3, 5, 24, 6)]
    rng = np.random.RandomState(35)
    rows.append({k: (rng.permutation(v.reshape(-1)).reshape(v.shape)
                     if isinstance(v, np.ndarray) else v)
                 for k, v in rows[0].items()})
    keys = ("tags", "asids", "lru", "vpn", "asid", "active", "may_fill")
    t = {k: torch.tensor(np.stack([r[k] for r in rows])) for k in keys}
    got = pt_ops.fused_tlb_access(*(t[k] for k in keys), 77, n_waves=6,
                                  track_asids=track_asids)
    assert got[0].shape == (2, 3, 5) and got[3].shape == (2, 24)
    for r, case in enumerate(rows):
        want = _run_ref(case, 6, track_asids, interpret=True)
        for a, b, name in zip(got, want, ("tags", "asids", "lru", "hit",
                                          "filled")):
            np.testing.assert_array_equal(a[r].numpy(), b,
                                          err_msg=f"row {r} {name}")


@pytest.mark.parametrize("order,tag0,hit,filled", [
    ([8, 100], 100, [1, 0], [0, 1]),    # the winner (lane 1) owns way 0
    ([100, 8], 8, [0, 1], [1, 0]),      # the pre-hit (lane 1) owns way 0
])
@pytest.mark.parametrize("interpret", [False, True])
def test_fused_round_write_collision(order, tag0, hit, filled, interpret):
    """A pre-hit lane and a same-cycle winner name one slot: the higher
    lane index wins it, as the reference's serial scatter gives."""
    case = _collision_case(order)
    want = _run_ref(case, 1, False, interpret)
    got = _run_port(case, 1, False)
    assert want[0][0, 0] == tag0 and got[0][0, 0] == tag0
    assert want[3].tolist() == hit and want[4].tolist() == filled
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_access_fused_counters_and_backend_check():
    case = _kernel_test_case(32, 16, 30, 3)
    st = pt_tlb.TLBState(*(torch.tensor(case[k]) for k in
                           ("tags", "asids", "lru")),
                         torch.tensor(5, dtype=torch.int32),
                         torch.tensor(7, dtype=torch.int32))
    args = [torch.tensor(case[k]) for k in ("vpn", "asid", "active",
                                            "may_fill")]
    rst = ref_tlb.TLBState(*(jnp.asarray(case[k]) for k in
                             ("tags", "asids", "lru")), jnp.int32(5),
                           jnp.int32(7))
    rst, rhit, rfilled = ref_tlb.access_fused(
        rst, *(jnp.asarray(case[k]) for k in ("vpn", "asid", "active",
                                              "may_fill")), 77, n_waves=3)
    got, hit, filled = pt_tlb.access_fused(st, *args, 77, n_waves=3,
                                           backend="torch")
    _assert_state(got, _ref_np(rst))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(rhit))
    np.testing.assert_array_equal(filled.numpy(), np.asarray(rfilled))
    with pytest.raises(ValueError, match="backend"):
        pt_tlb.access_fused(st, *args, 78, n_waves=3, backend="cuda")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never runs the plain round."""
    z = torch.zeros((4, 2), dtype=torch.int32)
    v = torch.zeros(8, dtype=torch.int32)
    b = torch.zeros(8, dtype=torch.bool)
    before = fused_tlb_round.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_tlb_round(z, z, z, v, v, b, b, 0)
    assert fused_tlb_round.launches == before


@pytest.mark.parametrize("n_ways,want", [(16, 16), (2, 0), (8, 0), (64, 0),
                                         (1, 0), (4, 0), (32, 0), (3, 0)])
def test_kernel_instance_by_way_count(n_ways, want):
    """The wrapper launches the instance compiled for the main path's 16
    ways, else the one that reads the count at run time (the kernel
    test's 2, 8 and 64 ways among them)."""
    assert kernel_mod.instance(n_ways) == want


@pytest.mark.parametrize("shape,offset,want", [
    ((1024, 16), 0, 16),          # the L2 planes: 16-byte rows
    ((2, 1024, 16), 0, 16),
    ((1024, 16), 1, 0),           # a plane 4 bytes off: word by word
    ((3, 5), 0, 0),               # 5 ways: always the run-time instance
    ((2, 3, 5), 0, 0),
])
def test_kernel_instance_by_alignment(shape, offset, want):
    """The 16-way instance reads rows by 16-byte loads, so it runs only on
    planes whose every row is 16-byte aligned; any other layout runs the
    instance that reads words."""
    n = int(np.prod(shape))
    planes = [torch.zeros(n + offset, dtype=torch.int32)[offset:]
              .view(shape) for _ in range(3)]
    R = shape[0] if len(shape) == 3 else 1
    aligned = kernel_mod.rows_aligned(planes, R)
    assert aligned == (offset == 0 and (R == 1 or shape[-1] * shape[-2] % 4
                                        == 0))
    assert kernel_mod.instance(shape[-1], aligned) == want


@pytest.mark.parametrize("N,want", [(1, 1), (240, 1), (1024, 1), (1025, 8),
                                    (1056, 8), (2048, 8), (8192, 8)])
def test_kernel_lanes_per_thread(N, want):
    """Up to 1024 lanes a thread each; more run the wide instance, 1024
    threads taking lanes t, t + 1024, ... (up to MAX_LANES = 8192)."""
    assert kernel_mod.lanes_per_thread(N) == want
    assert N <= kernel_mod.MAX_LANES


@pytest.mark.parametrize("sets,ways,N,W", [(1024, 16, 1056, 8),
                                           (1024, 16, 2048, 8),
                                           (64, 16, 8192, 8)])
def test_kernel_shared_memory_admits_wide_lanes(sets, ways, N, W):
    """The wide rounds' tables (owner hash of at least 2 entries a lane)
    fit a block's shared memory."""
    assert 2 ** kernel_mod.hash_bits(N) >= 2 * N
    assert kernel_mod.shared_bytes(sets, W, N) <= kernel_mod.MAX_SMEM


# every round the repo runs: the main path's L2 (and under `ideal`) and
# PWC rounds, the reference kernel test's shapes, the collision case
REPO_SHAPES = PATH_SHAPES + [(1, 64, 30, 1), (32, 16, 30, 3), (64, 8, 64, 4),
                             (4, 2, 24, 6), (1, 4, 2, 1)]


@pytest.mark.parametrize("sets,ways,N,W", REPO_SHAPES)
def test_kernel_shared_memory_admits_repo_shapes(sets, ways, N, W):
    """The wrapper's shared-memory reckoning admits every shape the repo
    runs, each within the 48 KB a launch takes without raising the
    kernel's limit; the owner hash table has at least 2 entries a lane."""
    assert 2 ** kernel_mod.hash_bits(N) >= 2 * N
    smem = kernel_mod.shared_bytes(sets, W, N)
    assert smem <= 48 * 1024 <= kernel_mod.MAX_SMEM
    assert smem == 4 * (sets * W + 2 * N + 2 ** (kernel_mod.hash_bits(N) + 1))


def _no_build(*_):
    raise AssertionError("the wrapper built the kernel before checking")


@pytest.mark.parametrize("plane", ["tags", "asids", "lru"])
def test_kernel_wrapper_refuses_misaligned_planes(monkeypatch, plane):
    """A plane off 16-byte alignment is no longer refused: it runs the
    instance that reads words (`instance` gives 0 for its 16 ways). What
    still raises, before any build or launch, is a plane that does not
    lie on the card: the CPU tensors here."""
    monkeypatch.setattr(kernel_mod._build, "load", _no_build)
    kernel_mod._entry.cache_clear()
    planes = {k: torch.zeros((4, 16), dtype=torch.int32)
              for k in ("tags", "asids", "lru")}
    planes[plane] = torch.zeros(4 * 16 + 1, dtype=torch.int32)[1:] \
        .view(4, 16)
    v = torch.zeros(8, dtype=torch.int32)
    b = torch.zeros(8, dtype=torch.bool)
    assert not kernel_mod.rows_aligned(list(planes.values()), 1)
    assert kernel_mod.instance(16, False) == 0
    before = fused_tlb_round.launches
    with pytest.raises(ValueError, match="current CUDA device"):
        fused_tlb_round(planes["tags"], planes["asids"], planes["lru"], v, v,
                        b, b, 0)
    assert fused_tlb_round.launches == before
