"""Parity of the port's integer primitives with the JAX reference (CPU).

Hashes, address streams, page-table math, workload tables, static
partitioning, design knobs and config properties: every value must be
equal, over seeded sweeps that include uint32 values above 2**31.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import mask as ref_mask  # noqa: E402
from repro.core import page_table as ref_pt  # noqa: E402
from repro.sim import config as ref_config  # noqa: E402
from repro.sim import workloads as ref_wl  # noqa: E402
# `repro_torch.core.design` the module: the package binds the name to
# the `design` function, as `repro.core` does
pt_design = importlib.import_module("repro_torch.core.design")
from repro_torch.core import mask as pt_mask  # noqa: E402
from repro_torch.core import page_table as pt_pt  # noqa: E402
from repro_torch.sim import config as pt_config  # noqa: E402
from repro_torch.sim import convert  # noqa: E402
from repro_torch.sim import workloads as pt_wl  # noqa: E402

# `repro.core` re-exports a function named `design`, shadowing the module
ref_design = importlib.import_module("repro.core.design")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _i32(rng, n, lo=0, hi=2**31 - 1):
    return rng.randint(lo, hi, n, dtype=np.int64).astype(np.int32)


def test_mix_uint32_sweep():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 2**32, 4096, dtype=np.uint64)
    x[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    ref = np.asarray(ref_pt._mix(jnp.asarray(x.astype(np.uint32))))
    got = pt_pt._mix(torch.tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("c", [0x7FEB352D, 0x846CA68B, 2654435761, 40503,
                               0x9E3779B9, 2**32 - 1])
def test_mul_u32_matches_uint32_product(c):
    rng = np.random.RandomState(c % 1000)
    x = rng.randint(0, 2**32, 2048, dtype=np.uint64)
    x[:2] = [2**32 - 1, 2**31]
    want = (x.astype(np.uint32) * np.uint32(c)).astype(np.int64)
    got = pt_pt.mul_u32(torch.tensor(x.astype(np.int64)), c).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrap_i32_is_twos_complement():
    x = np.array([0, 2**31 - 1, 2**31, 2**32 - 1, -1, -2**31, 2**35 + 5,
                  -2**35 - 7], np.int64)
    got = pt_pt.wrap_i32(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, x.astype(np.int32))


@pytest.mark.parametrize("levels", [4, 3])
def test_pte_line_addresses_and_translate_sweep(levels):
    rng = np.random.RandomState(levels)
    asid = _i32(rng, 2048, 0, 64)
    vpn = _i32(rng, 2048)
    vpn[:3] = [0, 2**31 - 1, 2**30]
    cfg_r = ref_pt.PageTableConfig(levels=levels)
    cfg_p = pt_pt.PageTableConfig(levels=levels)
    np.testing.assert_array_equal(
        pt_pt.pte_line_addresses(cfg_p, torch.tensor(asid),
                                 torch.tensor(vpn)).numpy(),
        np.asarray(ref_pt.pte_line_addresses(cfg_r, jnp.asarray(asid),
                                             jnp.asarray(vpn))))
    np.testing.assert_array_equal(
        pt_pt.translate(cfg_p, torch.tensor(asid), torch.tensor(vpn)).numpy(),
        np.asarray(ref_pt.translate(cfg_r, jnp.asarray(asid),
                                    jnp.asarray(vpn))))
    assert [pt_pt.walk_depth_tag(k) for k in range(9)] == \
        [ref_pt.walk_depth_tag(k) for k in range(9)]


def test_app_matrix_all_benches():
    names = list(ref_wl.BENCHES) + [None]
    np.testing.assert_array_equal(pt_wl.app_matrix(names),
                                  ref_wl.app_matrix(names))
    assert pt_wl.FIELD == ref_wl.FIELD
    assert pt_wl.CATEGORY == ref_wl.CATEGORY
    np.testing.assert_array_equal(pt_wl.IDLE_ROW, ref_wl.IDLE_ROW)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gen_vpn_sweep(seed):
    rng = np.random.RandomState(seed)
    n = 4096
    pm = ref_wl.app_matrix(list(ref_wl.BENCHES) + [None])
    app = _i32(rng, n, 0, pm.shape[0])
    warp = _i32(rng, n, 0, 960)
    pos = _i32(rng, n)
    pos[:2] = [0, 2**31 - 1]
    for t in (1, 63, 64, 8000, 59_999, 2**24 + 3):
        ref = ref_wl.gen_vpn(jnp.asarray(pm)[jnp.asarray(app)],
                             jnp.asarray(app), jnp.asarray(warp),
                             jnp.asarray(pos), jnp.int32(t))
        got = pt_wl.gen_vpn(torch.tensor(pm)[torch.tensor(app)],
                            torch.tensor(app), torch.tensor(warp),
                            torch.tensor(pos), t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=f"t={t}")


@pytest.mark.parametrize("n_res,n_apps", [(1024, 2), (8, 3), (64, 4), (2, 3)])
def test_static_partition_index(n_res, n_apps):
    rng = np.random.RandomState(n_res + n_apps)
    idx = _i32(rng, 512, -2**31, 2**31 - 1)
    app = _i32(rng, 512, 0, n_apps)
    ref = ref_mask.static_partition_index(jnp.asarray(idx), n_res, n_apps,
                                          jnp.asarray(app))
    got = pt_mask.static_partition_index(torch.tensor(idx), n_res, n_apps,
                                         torch.tensor(app))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", ref_mask.ALL_DESIGNS)
def test_design_params_and_signature(name):
    ref = jax.device_get(ref_design.design_params(name))
    got = convert.design_params_to_numpy(pt_design.design_params(name))
    for f in ref_design.DesignParams._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(got, f)
        assert a.dtype == b.dtype and a == b, f
    assert convert.design_params_from_numpy(ref) == \
        pt_design.design_params(name)
    assert dataclasses.asdict(pt_design.static_signature(name)) == \
        dataclasses.asdict(ref_design.static_signature(name))
    assert pt_mask.design(name).name == name


def test_design_with_and_registry():
    mine = pt_design.get_design("mask").with_(
        name="mask-small", tokens=dict(initial_frac=0.1))
    assert mine.tokens.initial_frac == 0.1 and mine.tokens.enabled
    assert pt_design.design_params(mine).initial_frac == np.float32(0.1)
    with pytest.raises(TypeError):
        mine.with_(nope=1)
    with pytest.raises(ValueError):
        pt_design.register_design(mine.with_(name="mask"))
    assert pt_design.list_designs()[:8] == ref_mask.ALL_DESIGNS
    sig = pt_design.static_signature("pwc")
    assert pt_design.canonical_design(sig).translation.kind == \
        ref_design.canonical_design(ref_design.static_signature("pwc")) \
        .translation.kind


@pytest.mark.parametrize("n_apps", [1, 2, 3, 4, 7])
def test_config_properties(n_apps):
    a = ref_config.SimConfig(n_apps=n_apps)
    b = pt_config.SimConfig(n_apps=n_apps, device="cpu")
    assert (b.app_of_core, b.cores_per_app, b.warps_per_app, b.total_warps) \
        == (a.app_of_core, a.cores_per_app, a.warps_per_app, a.total_warps)
    assert b.device == "cpu" and not hasattr(b, "tlb_backend")
    with pytest.raises(ValueError):
        pt_config.SimConfig(n_apps=31, device="cpu")
