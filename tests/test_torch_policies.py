"""Parity of the port's policy mechanisms with the JAX reference (CPU).

TLB-Fill Tokens, the L2 bypass latch and the MASK DRAM scheduler are
driven from seeded random states and inputs; every output leaf must be
equal, including float32 miss rates and the open rows written by
duplicate (channel, bank) lanes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bypass as ref_bp  # noqa: E402
from repro.core import dram_sched as ref_dram  # noqa: E402
from repro.core import tokens as ref_tok  # noqa: E402
from repro_torch.core import bypass as pt_bp  # noqa: E402
from repro_torch.core import dram_sched as pt_dram  # noqa: E402
from repro_torch.core import tokens as pt_tok  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _eq(got, want, msg=""):
    """NamedTuple of tensors == NamedTuple of jax arrays, leaf by leaf."""
    if hasattr(got, "_fields"):
        for f in got._fields:
            _eq(getattr(got, f), getattr(want, f), f"{msg}.{f}")
        return
    a, b = got.numpy(), np.asarray(want)
    assert a.dtype == b.dtype, (msg, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _pair(cls_ref, cls_pt, **leaves):
    return (cls_ref(**{k: jnp.asarray(v) for k, v in leaves.items()}),
            cls_pt(**{k: torch.tensor(v) for k, v in leaves.items()}))


# ---------------------------------------------------------------- tokens

@pytest.mark.parametrize("frac", [0.25, 0.8, 0.1])
def test_tokens_init(frac):
    wpa = np.asarray([480, 448, 32], np.int32)
    _eq(pt_tok.init(3, torch.tensor(wpa), np.float32(frac)),
        ref_tok.init(3, jnp.asarray(wpa), jnp.float32(frac)))


@pytest.mark.parametrize("seed", range(6))
def test_tokens_record_and_epoch_update(seed):
    rng = np.random.RandomState(seed)
    na = 3
    wpa = np.asarray([320, 320, 320], np.int32)
    ref, got = _pair(
        ref_tok.TokenState, pt_tok.TokenState,
        tokens=rng.randint(1, 330, na).astype(np.int32),
        direction=rng.choice([-1, 1], na).astype(np.int32),
        prev_miss_rate=rng.rand(na).astype(np.float32),
        epoch_hits=rng.randint(0, 5000, na).astype(np.int32),
        epoch_misses=rng.randint(0, 5000, na).astype(np.int32),
        first_epoch=np.asarray(seed % 2 == 0))
    app = rng.randint(0, na, 30).astype(np.int32)
    hit, act = rng.rand(30) < 0.5, rng.rand(30) < 0.7
    ref = ref_tok.record(ref, jnp.asarray(app), jnp.asarray(hit),
                         jnp.asarray(act))
    got = pt_tok.record(got, torch.tensor(app), torch.tensor(hit),
                        torch.tensor(act))
    _eq(got, ref, "record")
    for step in (0.5, 0.3):
        ref = ref_tok.epoch_update(ref, jnp.asarray(wpa),
                                   step_frac=jnp.float32(step))
        got = pt_tok.epoch_update(got, torch.tensor(wpa),
                                  step_frac=np.float32(step))
        _eq(got, ref, f"epoch step={step}")
        assert got.prev_miss_rate.dtype == torch.float32


# ---------------------------------------------------------------- bypass

@pytest.mark.parametrize("seed", range(4))
def test_bypass_record_should_fill_epoch(seed):
    rng = np.random.RandomState(seed)
    ref, got = _pair(
        ref_bp.BypassState, pt_bp.BypassState,
        hits=rng.randint(0, 50, 8).astype(np.int32),
        accesses=rng.randint(0, 80, 8).astype(np.int32),
        rate_q10=rng.randint(0, 1024, 8).astype(np.int32),
        have_rates=np.asarray(seed > 0),
        epoch_idx=np.asarray(seed, np.int32))
    depth = rng.randint(0, 8, 240).astype(np.int32)
    hit, act = rng.rand(240) < 0.4, rng.rand(240) < 0.6
    for _ in range(3):
        _eq(pt_bp.should_fill(got, torch.tensor(depth)),
            ref_bp.should_fill(ref, jnp.asarray(depth)), "should_fill")
        ref = ref_bp.record(ref, jnp.asarray(depth), jnp.asarray(hit),
                            jnp.asarray(act))
        got = pt_bp.record(got, torch.tensor(depth), torch.tensor(hit),
                           torch.tensor(act))
        _eq(got, ref, "record")
        ref, got = ref_bp.epoch_update(ref), pt_bp.epoch_update(got)
        _eq(got, ref, "epoch_update")


# ------------------------------------------------------------------ DRAM

def _dram_pair(rng, n_apps, n_channels=8, n_banks=8):
    return _pair(
        ref_dram.DramState, pt_dram.DramState,
        open_row=rng.randint(-1, 6, (n_channels, n_banks)).astype(np.int32),
        silver_app=np.asarray(rng.randint(0, n_apps), np.int32),
        silver_left=np.asarray(rng.randint(1, 4), np.int32),
        conc_walks=rng.randint(0, 30, n_apps).astype(np.int32),
        warps_stalled=rng.randint(0, 60, n_apps).astype(np.int32),
        queue_len=rng.randint(0, 9, (n_channels, 3)).astype(np.int32))


@pytest.mark.parametrize("waves,C", [(1, 30), (8, 30), (4, 6)])
@pytest.mark.parametrize("mask_on", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_dram_access(waves, C, mask_on, seed):
    """Few channels/banks/rows so duplicate (channel, bank) lanes and row
    hits are common: the open-row update must keep the LAST active lane."""
    rng = np.random.RandomState(seed * 10 + waves)
    n_apps, N = 3, waves * C
    ref, got = _dram_pair(rng, n_apps)
    for cycle in range(4):
        lanes = dict(
            channel=rng.randint(0, 8, N).astype(np.int32),
            bank=rng.randint(0, 3, N).astype(np.int32),
            row=rng.randint(0, 6, N).astype(np.int32),
            app=rng.randint(0, n_apps, N).astype(np.int32),
            is_tlb=rng.rand(N) < 0.3, active=rng.rand(N) < 0.7)
        ref, r_lat = ref_dram.access(
            ref, *(jnp.asarray(v) for v in lanes.values()),
            mask_enabled=jnp.asarray(mask_on), thres_max=jnp.int32(500),
            waves=waves)
        got, lat = pt_dram.access(
            got, *(torch.tensor(v) for v in lanes.values()),
            mask_enabled=mask_on, thres_max=500, waves=waves)
        _eq(lat, r_lat, f"latency cycle {cycle}")
        _eq(got, ref, f"state cycle {cycle}")


@pytest.mark.parametrize("seed", range(4))
def test_dram_quota_classify_pressure(seed):
    rng = np.random.RandomState(seed)
    ref, got = _dram_pair(rng, 4)
    for thres in (500, 37):
        _eq(pt_dram.silver_quota(got, thres),
            ref_dram.silver_quota(ref, jnp.int32(thres)), "quota")
    app = rng.randint(0, 4, 50).astype(np.int32)
    tlb = rng.rand(50) < 0.3
    for on in (True, False):
        _eq(pt_dram.classify(got, torch.tensor(app), torch.tensor(tlb), on),
            ref_dram.classify(ref, jnp.asarray(app), jnp.asarray(tlb),
                              jnp.asarray(on)), "classify")
    conc = rng.randint(0, 9, 4).astype(np.int32)
    stalled = rng.randint(0, 9, 4).astype(np.int32)
    _eq(pt_dram.update_pressure(got, torch.tensor(conc),
                                torch.tensor(stalled)),
        ref_dram.update_pressure(ref, jnp.asarray(conc),
                                 jnp.asarray(stalled)), "pressure")
