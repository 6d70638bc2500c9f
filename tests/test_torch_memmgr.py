"""Parity of the port's paged KV pool (`repro_torch.memmgr`,
`repro_torch.core.asid`) with the reference on the CPU.

* Seeded sequences of admit, append, write, lookup, release and occupy
  run through both pools; after every operation the int planes (block
  tables, translation cache, tokens, lengths, ASIDs, clock) are exactly
  equal, the k/v bits are equal, the returned ok/fault/phys/hit agree and
  `pool_pressure` is equal. The sequences include unadmitted and repeated
  slots, so faulted lanes and cell collisions in `write_kv` occur.
* `append_token_alloc`: the port allocates `need_page` pages where the
  reference branches with `lax.cond`; equal tables and ok on and off a
  page boundary, with the pool exhausted, and for an unadmitted slot.
* The whole-fail law: an allocation past `pages_per_seq` or past the free
  pages takes nothing.
* `write_kv`'s collision: a faulted lane and a live lane on one cell; the
  higher lane wins in both packages.
* `AsidAllocator` and `AddressSpace` behave alike.
* `paged_attention` reads the same values through a pool that both
  packages built.
* The carrier `pool_from_numpy` / `pool_to_numpy` is bit exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import asid as jasid  # noqa: E402
from repro.kernels.paged_attention.ops import \
    paged_attention as jax_paged  # noqa: E402
from repro.memmgr import block_table as jbt  # noqa: E402
from repro.memmgr import kv_cache as jkvc  # noqa: E402
from repro_torch.core import asid as pasid  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pt_paged  # noqa: E402
from repro_torch.memmgr import block_table as pbt  # noqa: E402
from repro_torch.memmgr import kv_cache as pkvc  # noqa: E402
from repro_torch.models.convert import tensor_to_numpy  # noqa: E402

CFG = dict(n_pages=24, page_size=4, n_kv=2, head_dim=8, n_layers=2,
           max_seqs=6, pages_per_seq=4, max_tenants=4, seqs_per_tenant=2,
           tcache_entries=16, tcache_ways=4)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pools(**kw):
    cfg = dict(CFG, **kw)
    jcfg, pcfg = jkvc.PoolConfig(**cfg), pkvc.PoolConfig(**cfg)
    return jcfg, jkvc.init(jcfg), pcfg, pkvc.init(pcfg, "cpu")


def _ref_numpy(pool):
    host = jax.device_get(pool)
    out = {}
    for f in jkvc.KVPool._fields:
        val = getattr(host, f)
        if hasattr(val, "_fields"):
            out[f] = {g: np.asarray(getattr(val, g)) for g in val._fields}
        else:
            out[f] = np.asarray(val)
    return out


def _bits(a):
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "float32"):
        return a.astype(np.float32).view(np.uint32)
    return a


def _same_pool(jpool, ppool):
    want, got = _ref_numpy(jpool), pkvc.pool_to_numpy(ppool)
    assert list(want) == list(got)
    for f, w in want.items():
        g = got[f]
        if isinstance(w, dict):
            assert list(w) == list(g), f
            for k in w:
                assert np.array_equal(_bits(g[k]), _bits(w[k])), f"{f}.{k}"
        else:
            assert np.array_equal(_bits(g), _bits(w)), f


def _same(p, j):
    assert np.array_equal(tensor_to_numpy(p), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_operations_match_reference(seed):
    jcfg, jpool, pcfg, ppool = _pools()
    rng = np.random.RandomState(seed)
    free_j = list(range(CFG["max_seqs"]))
    free_p = list(free_j)
    for step in range(36):
        op = rng.choice(["admit", "append", "write", "write", "lookup",
                         "release", "occupy"])
        if op == "admit":
            slot, asid = int(rng.randint(6)), int(rng.randint(-1, 6))
            plen = int(rng.randint(0, 20))
            jpool, jok = jkvc.admit_seq(jcfg, jpool, jnp.int32(slot),
                                        jnp.int32(asid), jnp.int32(plen))
            ppool, pok = pkvc.admit_seq(pcfg, ppool, slot, asid, plen)
            assert bool(pok) == bool(jok)
        elif op == "append":
            slot = int(rng.randint(6))
            jpool, jok = jkvc.append_token_alloc(jcfg, jpool, jnp.int32(slot))
            ppool, pok = pkvc.append_token_alloc(pcfg, ppool, slot)
            assert bool(pok) == bool(jok)
        elif op == "write":
            slots = rng.randint(0, 6, int(rng.randint(1, 6))).astype(np.int32)
            layer = int(rng.randint(2))
            kv = rng.randn(2, len(slots), 2, 8).astype(np.float32)
            jpool, jf = jkvc.write_kv(jcfg, jpool, layer, jnp.asarray(slots),
                                      jnp.asarray(kv[0]), jnp.asarray(kv[1]))
            ppool, pf = pkvc.write_kv(pcfg, ppool, layer,
                                      torch.from_numpy(slots),
                                      torch.from_numpy(kv[0]),
                                      torch.from_numpy(kv[1]))
            _same(pf, jf)
        elif op == "lookup":
            slots = rng.randint(0, 6, 5).astype(np.int32)
            pages = rng.randint(0, 4, 5).astype(np.int32)
            jpool, jphys, jf, jhit = jkvc.lookup(
                jcfg, jpool, jnp.asarray(slots), jnp.asarray(pages))
            ppool, pphys, pf, phit = pkvc.lookup(
                pcfg, ppool, torch.from_numpy(slots), torch.from_numpy(pages))
            for p, j in ((pphys, jphys), (pf, jf), (phit, jhit)):
                _same(p, j)
        elif op == "release":
            slot = int(rng.randint(6))
            jpool = jkvc.release_seq(jcfg, jpool, jnp.int32(slot))
            ppool = pkvc.release_seq(pcfg, ppool, slot)
            for free in (free_j, free_p):
                if slot not in free:
                    free.append(slot)
        else:
            pages = int(rng.randint(1, 9))
            jpool, jused = jkvc.occupy_pages(jcfg, jpool, free_j, pages)
            ppool, pused = pkvc.occupy_pages(pcfg, ppool, free_p, pages)
            assert pused == jused and free_p == free_j
        _same_pool(jpool, ppool)
        assert pkvc.pool_pressure(pcfg, ppool) == \
            jkvc.pool_pressure(jcfg, jpool), (step, op)
        bt_j = jkvc.gather_block_table(jcfg, jpool, jnp.arange(6))
        _same(pkvc.gather_block_table(pcfg, ppool, torch.arange(6)), bt_j)


@pytest.mark.parametrize("plen,n_pages", [(4, 24), (5, 24), (8, 2), (0, 24),
                                          (16, 24)])
def test_append_without_branch_matches_lax_cond(plen, n_pages):
    """On a page boundary (4, 8, 0), off it (5), with the pool exhausted
    (8 tokens in 2 pages), at the sequence's capacity (16), and for the
    unadmitted slot 3: the same tables, lengths and ok."""
    jcfg, jpool, pcfg, ppool = _pools(n_pages=n_pages)
    jpool, _ = jkvc.admit_seq(jcfg, jpool, jnp.int32(0), jnp.int32(1),
                              jnp.int32(plen))
    ppool, _ = pkvc.admit_seq(pcfg, ppool, 0, 1, plen)
    for slot in (0, 0, 3):
        jpool, jok = jkvc.append_token_alloc(jcfg, jpool, jnp.int32(slot))
        ppool, pok = pkvc.append_token_alloc(pcfg, ppool, slot)
        assert bool(pok) == bool(jok)
        _same_pool(jpool, ppool)


def test_allocation_fails_whole():
    jcfg, jpool, pcfg, ppool = _pools(n_pages=6)
    # 5 pages > pages_per_seq = 4: nothing is taken
    jpool, jok = jkvc.admit_seq(jcfg, jpool, jnp.int32(0), jnp.int32(1),
                                jnp.int32(17))
    ppool, pok = pkvc.admit_seq(pcfg, ppool, 0, 1, 17)
    assert not bool(pok) and not bool(jok)
    assert int(pbt.n_free(ppool.tables)) == 6
    assert bool((ppool.tables.owner == -1).all())
    assert bool((ppool.tables.leaf == -1).all())
    # a run past the sequence's last logical page: nothing is taken
    tables, ok = pbt.alloc_pages(ppool.tables, 1, 3, 2, 2)
    jtables, jok = jbt.alloc_pages(jpool.tables, jnp.int32(1), jnp.int32(3),
                                   jnp.int32(2), jnp.int32(2))
    assert not bool(ok) and not bool(jok)
    for f in pbt.BlockTables._fields:
        _same(getattr(tables, f), getattr(jtables, f))
        assert torch.equal(getattr(tables, f), getattr(ppool.tables, f))
    # more pages than are free: nothing is taken
    ppool, _ = pkvc.admit_seq(pcfg, ppool, 0, 1, 12)     # 3 of 6
    ppool, ok = pkvc.admit_seq(pcfg, ppool, 1, 1, 16)    # 4 > 3 free
    assert not bool(ok) and int(pbt.n_free(ppool.tables)) == 3
    assert int(ppool.seq_lens[1]) == 0 and int(ppool.seq_asid[1]) == -1


@pytest.mark.parametrize("order,kept", [([0, 1], False), ([1, 0], True)])
def test_write_kv_collision_higher_lane_wins(order, kept):
    """Slot 0 holds 4 tokens in page 0, so its token 3 goes to (page 0,
    offset 3). Unadmitted slot 1 faults (length 0: position -1, offset 3)
    and is sent to page 0: the same cell. The higher lane wins: a faulted
    lane after the live one writes back the old 0."""
    jcfg, jpool, pcfg, ppool = _pools()
    jpool, _ = jkvc.admit_seq(jcfg, jpool, jnp.int32(0), jnp.int32(0),
                              jnp.int32(4))
    ppool, _ = pkvc.admit_seq(pcfg, ppool, 0, 0, 4)
    vals = np.stack([np.full((2, 8), 5.0 if s == 0 else 7.0, np.float32)
                     for s in order])
    slots = np.asarray(order, np.int32)
    jpool, jf = jkvc.write_kv(jcfg, jpool, 0, jnp.asarray(slots),
                              jnp.asarray(vals), jnp.asarray(vals))
    ppool, pf = pkvc.write_kv(pcfg, ppool, 0, torch.from_numpy(slots),
                              torch.from_numpy(vals), torch.from_numpy(vals))
    _same(pf, jf)
    want = 5.0 if kept else 0.0
    assert float(jpool.k[0, 0, 3, 0, 0]) == want
    assert float(ppool.k[0, 0, 3, 0, 0]) == want
    assert float(ppool.v[0, 0, 3, 0, 0]) == want
    _same_pool(jpool, ppool)


def test_asid_allocator_matches_reference():
    ja, pa = jasid.AsidAllocator(max_live=3), pasid.AsidAllocator(max_live=3)
    got = [pa.allocate(n) for n in ("x", "y", "z")]
    want = [ja.allocate(n) for n in ("x", "y", "z")]
    assert [(s.asid, s.name, s.root_frame) for s in got] == \
        [(s.asid, s.name, s.root_frame) for s in want]
    for alloc in (ja, pa):
        with pytest.raises(RuntimeError, match="too many"):
            alloc.allocate("w")
        alloc.release(1)
        alloc.release(7)                     # absent: ignored
    assert pa.allocate("v").asid == ja.allocate("v").asid == 3
    assert sorted(pa.live) == sorted(ja.live) == [0, 2, 3]
    assert pa.get(1) is None and ja.get(1) is None
    assert pa.get(2).name == ja.get(2).name == "z"
    # an ASID past 8 bits: the reference asserts, the port raises
    with pytest.raises(ValueError, match="8-bit"):
        pasid.AddressSpace(asid=256, name="n", root_frame=0)
    with pytest.raises(AssertionError):
        jasid.AddressSpace(asid=256, name="n", root_frame=0)


def test_paged_attention_over_pools_built_by_both():
    jcfg, jpool, pcfg, ppool = _pools(n_layers=1)
    rng = np.random.RandomState(5)
    lens = [7, 12, 1, 4]
    for slot, ln in enumerate(lens):
        jpool, _ = jkvc.admit_seq(jcfg, jpool, jnp.int32(slot),
                                  jnp.int32(slot % 2), jnp.int32(0))
        ppool, _ = pkvc.admit_seq(pcfg, ppool, slot, slot % 2, 0)
        for _ in range(ln):
            jpool, _ = jkvc.append_token_alloc(jcfg, jpool, jnp.int32(slot))
            ppool, _ = pkvc.append_token_alloc(pcfg, ppool, slot)
            kv = rng.randn(2, 1, 2, 8).astype(np.float32)
            one = np.asarray([slot], np.int32)
            jpool, _ = jkvc.write_kv(jcfg, jpool, 0, jnp.asarray(one),
                                     jnp.asarray(kv[0]), jnp.asarray(kv[1]))
            ppool, _ = pkvc.write_kv(pcfg, ppool, 0, torch.from_numpy(one),
                                     torch.from_numpy(kv[0]),
                                     torch.from_numpy(kv[1]))
    _same_pool(jpool, ppool)
    slots = np.arange(4, dtype=np.int32)
    q = rng.randn(4, 4, 8).astype(np.float32)
    jq = jnp.asarray(q, jnp.bfloat16)
    want = jax_paged(jq, jpool.k[0], jpool.v[0],
                     jkvc.gather_block_table(jcfg, jpool, jnp.asarray(slots)),
                     jpool.seq_lens[slots], interpret=True)
    pslots = torch.from_numpy(slots)
    got = pt_paged.paged_attention(
        torch.from_numpy(q).to(torch.bfloat16), ppool.k[0], ppool.v[0],
        pkvc.gather_block_table(pcfg, ppool, pslots),
        ppool.seq_lens[pslots.long()])
    assert ppool.seq_lens.tolist()[:4] == lens
    np.testing.assert_allclose(tensor_to_numpy(got),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


def test_carrier_round_trip_bit_exact():
    jcfg, jpool, pcfg, _ = _pools()
    jpool, _ = jkvc.admit_seq(jcfg, jpool, jnp.int32(2), jnp.int32(1),
                              jnp.int32(9))
    kv = np.random.RandomState(0).randn(1, 2, 8).astype(np.float32)
    jpool, _ = jkvc.write_kv(jcfg, jpool, 1, jnp.asarray([2], jnp.int32),
                             jnp.asarray(kv), jnp.asarray(kv))
    ppool = pkvc.pool_from_numpy(jax.device_get(jpool), "cpu")
    assert ppool.k.dtype == torch.bfloat16 and isinstance(ppool.clock, int)
    _same_pool(jpool, ppool)


def test_pool_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pkvc.init(pkvc.PoolConfig(**CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pbt.init(4, 2, 2, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pkvc.pool_from_numpy(None)
