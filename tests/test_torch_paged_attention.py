"""Parity of the port's paged decode attention op against the reference
(CPU).

On the CPU, `repro_torch.kernels.paged_attention.ops.paged_attention`
runs the kernel's plain version (`ref.py`). It is held against the
reference's Pallas kernel in interpret mode and its `paged_attention_ref`
on the reference kernel test's 6-case sweep, with the reference's
tolerances (atol = rtol = 3e-2 in bf16, 2e-5 in fp32). The bf16 inputs
are the reference's own bf16 arrays, carried bit for bit.

A sequence of length 0 is where the reference's two versions part: its
Pallas kernel skips every page and returns 0, its plain version
softmaxes a row of equal masked scores and returns the mean of the
gathered v. The port follows the kernel on both of its routes; the test
pins all three values. The CUDA kernel runs only on the card
(`chip_smoke.py` phase 11).

`ref.paged_attention_split_ref` computes the function as the CUDA kernel
splits it (`kernel.split_plan`'s spans, each span's own max, the ordered
merge of the partials); it is held to the same two references at the
same tolerances, on the sweep and on cases that stress the split (page
sizes 5 and 1, 1 and 40 pages per sequence, lengths at a split boundary
and one past it, a length 0 among live sequences, G 12 and 16, dh 96),
and on the inputs the card once refused (G 32 and 71 over one KV head,
dh 80, 100 and 256). The kernel's wrapper is checked here for its plan
(instance, head groups, staging) and its refusals; staging is shown to
keep the function (the plain version on zero-padded copies at the true
head's scale, sliced to dh, equals it on the originals).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.ops import \
    paged_attention as jax_paged  # noqa: E402
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as jax_ref  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels.flash_attention import \
    kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import \
    kernel as pt_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pt_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref, paged_attention_split_ref)
from repro_torch.models.convert import (  # noqa: E402
    tensor_from_numpy, tensor_to_numpy)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(B, H, KV, dh, page, npp, dtype):
    """The reference test's inputs (tests/test_kernels.py)."""
    rng = np.random.RandomState(B * H)
    P = npp * B + 4
    q = jnp.asarray(rng.randn(B, H, dh), dtype)
    kp = jnp.asarray(rng.randn(P, page, KV, dh), dtype)
    vp = jnp.asarray(rng.randn(P, page, KV, dh), dtype)
    bt = jnp.asarray(rng.choice(P, (B, npp), replace=False), jnp.int32)
    sl = jnp.asarray(rng.randint(1, npp * page + 1, B), jnp.int32)
    return q, kp, vp, bt, sl


def _port(*arrays):
    return [tensor_from_numpy(np.asarray(a), "cpu") for a in arrays]


SWEEP = [
    (4, 8, 4, 64, 16, 6),
    (2, 4, 4, 128, 32, 4),        # MHA-ish
    (3, 16, 2, 64, 8, 10),        # GQA 8:1
    (2, 32, 2, 128, 16, 4),       # GQA 16:1 (glm4-9b)
    (2, 24, 2, 128, 16, 4),       # GQA 12:1 (mistral-large-123b)
    (2, 8, 8, 96, 16, 4),         # dh 96 (phi3-vision)
]

# (B, H, KV, dh, page, pages per sequence, seq_lens): split_plan gives
# spans of 25 pages (125 tokens) at page 5, 128 pages at page 1, 16 pages
# at page 8 and 8 pages at page 16 (128 tokens)
SPLIT_CASES = [
    (3, 8, 2, 64, 5, 60, (300, 125, 126)),     # page 5; at / one past
    (2, 4, 4, 32, 1, 300, (256, 129)),         # page 1; two spans / one past
    (4, 8, 4, 64, 16, 1, (16, 1, 7, 0)),       # one page per sequence
    (3, 16, 2, 128, 8, 40, (320, 128, 129)),   # 40 pages per sequence
    (3, 24, 2, 128, 16, 12, (128, 0, 190)),    # G 12; length 0 among live
    (2, 32, 2, 128, 16, 10, (160, 129)),       # G 16
    (3, 8, 8, 96, 16, 20, (320, 129, 0)),      # dh 96
]


# the inputs the card once refused, as chip_smoke.py's CONTRACT_PAGED at
# CPU sizes: G 32 and 71 (Falcon-7B) over one KV head, 142 heads over 2,
# dh 256 (gemma-2 9b), 80, and 100 (bf16: staged to 104)
WIDE = [(2, 32, 1, 64, 8, 3), (2, 71, 1, 32, 8, 3), (2, 142, 2, 32, 4, 4),
        (2, 8, 2, 256, 8, 3), (2, 8, 2, 80, 8, 3), (2, 8, 2, 100, 8, 3)]


@pytest.mark.parametrize("B,H,KV,dh,page,npp", SWEEP)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_attention_sweep(B, H, KV, dh, page, npp, dtype):
    _hold_to_reference(_inputs(B, H, KV, dh, page, npp, dtype), dtype)


@pytest.mark.parametrize("B,H,KV,dh,page,npp", WIDE)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_attention_wide_groups_and_heads(B, H, KV, dh, page, npp,
                                               dtype):
    """The groups and heads the card once refused: the port's op equals
    the reference's Pallas kernel (interpret mode) and its plain version
    at the sweep's tolerances."""
    _hold_to_reference(_inputs(B, H, KV, dh, page, npp, dtype), dtype)


def _hold_to_reference(arrays, dtype):
    B, H, _ = arrays[0].shape
    dh = arrays[0].shape[2]
    got = pt_ops.paged_attention(*_port(*arrays))
    assert tuple(got.shape) == (B, H, dh)
    assert got.dtype == (torch.float32 if dtype == jnp.float32
                         else torch.bfloat16)
    got = tensor_to_numpy(got)
    tol = 3e-2 if dtype == jnp.bfloat16 else 2e-5
    for want in (jax_paged(*arrays, interpret=True), jax_ref(*arrays)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_empty_sequence_follows_the_kernel():
    q, kp, vp, bt, sl = _inputs(4, 8, 4, 64, 16, 6, jnp.float32)
    sl = sl.at[1].set(0)
    kernel_out = np.asarray(jax_paged(q, kp, vp, bt, sl, interpret=True))
    ref_out = np.asarray(jax_ref(q, kp, vp, bt, sl))
    got = tensor_to_numpy(pt_ops.paged_attention(*_port(q, kp, vp, bt, sl)))
    # the reference's kernel: 0; its plain version: the mean of the v rows
    # its block table gathers (GQA: query head h reads KV head h // 2)
    assert np.all(kernel_out[1] == 0)
    gathered = np.asarray(vp)[np.asarray(bt)[1]].reshape(-1, 4, 64)
    np.testing.assert_allclose(
        ref_out[1], np.repeat(gathered.mean(0), 2, axis=0), atol=1e-5)
    assert np.all(got[1] == 0)
    others = [0, 2, 3]
    np.testing.assert_allclose(got[others], kernel_out[others], atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got[others], ref_out[others], atol=2e-5,
                               rtol=2e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, kp, vp, bt, sl = _port(*_inputs(2, 4, 4, 128, 32, 4, jnp.float32))
    with pytest.raises(ValueError, match="current CUDA device"):
        pt_kernel.paged_attention(q, kp, vp, bt, sl)
    assert pt_kernel.paged_attention.launches == 0


@pytest.mark.parametrize("arch", sorted(
    name for name, cfg in ARCHS.items() if not cfg.is_attention_free))
def test_attention_kernels_take_every_config(arch):
    """Every model config with attention runs in place on both flash
    kernels and the paged kernel, in both dtypes: its head dim plans onto
    a compiled instance with no staging, and its GQA group (H / KV) onto
    head groups of at most G_MAX that cover it."""
    cfg = ARCHS[arch]
    assert cfg.n_heads % cfg.n_kv_heads == 0
    G = cfg.n_heads // cfg.n_kv_heads
    for dtype in (torch.bfloat16, torch.float32):
        fp = flash_kernel.plan(dtype, cfg.head_dim)
        assert not fp.staged and fp.dh == cfg.head_dim <= fp.instance
        pp = pt_kernel.plan(dtype, cfg.head_dim, G)
        assert not pp.staged and pp.dh == cfg.head_dim <= pp.instance
        assert pp.heads <= pt_kernel.G_MAX
        assert (pp.groups - 1) * pp.heads < G <= pp.groups * pp.heads


@pytest.mark.parametrize("dtype,dh,G,in_place,want", [
    (torch.bfloat16, 128, 4, True, (128, 128, 4, 1, False)),   # the pool
    (torch.bfloat16, 96, 16, True, (96, 96, 16, 1, False)),
    (torch.bfloat16, 128, 12, True, (128, 128, 12, 1, False)),
    (torch.bfloat16, 128, 32, True, (128, 128, 16, 2, False)),
    (torch.bfloat16, 64, 71, True, (64, 128, 15, 5, False)),   # falcon-7b
    (torch.bfloat16, 256, 2, True, (256, 256, 2, 1, False)),   # gemma-2 9b
    (torch.bfloat16, 80, 4, True, (80, 128, 4, 1, False)),
    (torch.bfloat16, 100, 4, True, (104, 128, 4, 1, True)),
    (torch.bfloat16, 136, 17, True, (136, 192, 9, 2, False)),
    (torch.bfloat16, 128, 4, False, (128, 128, 4, 1, True)),
    (torch.float32, 100, 4, True, (100, 128, 4, 1, False)),
    (torch.float32, 98, 1, True, (100, 128, 1, 1, True)),
    (torch.float32, 8, 1, True, (8, 128, 1, 1, False)),
    (torch.float32, 32, 1, False, (32, 32, 1, 1, True)),
])
def test_plan_picks_instance_groups_and_staging(dtype, dh, G, in_place,
                                                want):
    """The plan of a call: the head rounded up to whole 16-byte pieces,
    the exact instance of that width where there is one and G is one
    group, else the narrowest padded width at or above it; G cut into
    ceil(G / 16) groups of equal size (the last may be short); staged
    where the rounding moves dh or the tensors are not contiguous and
    aligned."""
    assert tuple(pt_kernel.plan(dtype, dh, G, in_place)) == want
    assert want[1] in (pt_kernel.PADDED_WIDTHS if want[3] > 1 or
                       want[0] not in pt_kernel.EXACT_WIDTHS
                       else pt_kernel.EXACT_WIDTHS)


@pytest.mark.parametrize("dh,match", [(264, "head dim 264"),
                                      (0, "head dim 0")])
def test_plan_refuses_past_the_widest_instance(dh, match):
    with pytest.raises(ValueError, match=match):
        pt_kernel.plan(torch.bfloat16, dh, 4)
    with pytest.raises(ValueError, match="float16"):
        pt_kernel.plan(torch.float16, 64, 4)


@pytest.mark.parametrize("dtype,dh", [(jnp.bfloat16, 100), (jnp.float32, 98),
                                      (jnp.bfloat16, 36)])
def test_staging_keeps_the_function(dtype, dh):
    """A staged call's copies: the plain version on the zero-padded q and
    pages, at the true head's scale, sliced to dh, equals the plain
    version on the originals; the padded columns come out 0."""
    q, kp, vp, bt, sl = _port(*_inputs(3, 8, 2, dh, 8, 4, dtype))
    how = pt_kernel.plan(q.dtype, dh, 4)
    assert how.staged and how.dh > dh
    padded = [pt_kernel.stage(t, how.dh) for t in (q, kp, vp)]
    for t, p in zip((q, kp, vp), padded):
        assert p.is_contiguous() and torch.equal(p[..., :dh], t)
        assert not p[..., dh:].any()
    want = pt_ops.paged_attention(q, kp, vp, bt, sl)
    got = paged_attention_ref(*padded, bt, sl, scale=1.0 / dh ** 0.5)
    assert not got[..., dh:].any()
    tol = 1e-6 if dtype == jnp.float32 else 2.0 ** -8
    torch.testing.assert_close(got[..., :dh], want, atol=tol, rtol=tol)


def test_in_place_needs_contiguous_aligned_tensors():
    """The kernel reads q and the pages as they lie only when contiguous
    and 16-byte aligned, and the table and lengths when contiguous."""
    q, kp, vp, bt, sl = _port(*_inputs(3, 8, 2, 64, 8, 4, jnp.float32))
    assert pt_kernel.in_place(q, kp, vp, bt, sl)
    odd = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    wide = torch.zeros(3, 8, 72)[..., :64]
    for args in ((odd, kp, vp, bt, sl), (wide, kp, vp, bt, sl),
                 (q, kp, vp, bt.t().contiguous().t(), sl),
                 (q, kp.transpose(0, 1), vp, bt, sl)):
        assert not pt_kernel.in_place(*args)


def _split_inputs(B, H, KV, dh, page, npp, lens, dtype):
    """Inputs of a split case, from a seed, with the given lengths."""
    rng = np.random.RandomState(B * H + page * npp)
    P = npp * B + 4
    q = jnp.asarray(rng.randn(B, H, dh), dtype)
    kp = jnp.asarray(rng.randn(P, page, KV, dh), dtype)
    vp = jnp.asarray(rng.randn(P, page, KV, dh), dtype)
    bt = jnp.asarray(rng.choice(P, (B, npp), replace=False), jnp.int32)
    return q, kp, vp, bt, jnp.asarray(lens, jnp.int32)


def _hold_split_ref(arrays, dtype):
    """The split version against the Pallas kernel (interpret mode) on
    every row and the reference's plain version on the rows of length >
    0 (a length 0 gives 0, as the kernel does)."""
    got = paged_attention_split_ref(*_port(*arrays))
    B, H, dh = arrays[0].shape
    assert tuple(got.shape) == (B, H, dh)
    assert got.dtype == (torch.float32 if dtype == jnp.float32
                         else torch.bfloat16)
    got = tensor_to_numpy(got)
    tol = 3e-2 if dtype == jnp.bfloat16 else 2e-5
    live = np.asarray(arrays[4]) > 0
    np.testing.assert_allclose(
        got, np.asarray(jax_paged(*arrays, interpret=True), np.float32),
        atol=tol, rtol=tol)
    np.testing.assert_allclose(
        got[live], np.asarray(jax_ref(*arrays), np.float32)[live],
        atol=tol, rtol=tol)
    assert np.all(got[~live] == 0)


@pytest.mark.parametrize("B,H,KV,dh,page,npp", SWEEP + WIDE)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_split_ref_sweep(B, H, KV, dh, page, npp, dtype):
    _hold_split_ref(_inputs(B, H, KV, dh, page, npp, dtype), dtype)


@pytest.mark.parametrize("B,H,KV,dh,page,npp,lens", SPLIT_CASES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_split_ref_split_cases(B, H, KV, dh, page, npp, lens, dtype):
    _hold_split_ref(_split_inputs(B, H, KV, dh, page, npp, lens, dtype),
                    dtype)


def test_split_plan_covers_every_page_once():
    """For pages of 1-256 tokens and 1-64 pages per sequence, the spans
    cover every logical page exactly once, each holds at least one page,
    and no span is empty."""
    for page in range(1, 257):
        for n in range(1, 65):
            pps, n_splits = pt_kernel.split_plan(page, n)
            assert pps >= 1 and n_splits >= 1
            covered = [p for i in range(n_splits)
                       for p in range(i * pps, min((i + 1) * pps, n))]
            assert covered == list(range(n)), (page, n)
            assert (n_splits - 1) * pps < n, (page, n)
