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
and one past it, a length 0 among live sequences, G 12 and 16, dh 96).
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
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_split_ref  # noqa: E402
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


@pytest.mark.parametrize("B,H,KV,dh,page,npp", SWEEP)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_paged_attention_sweep(B, H, KV, dh, page, npp, dtype):
    arrays = _inputs(B, H, KV, dh, page, npp, dtype)
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
    """Every model config with attention has a head dim that both flash
    kernels and the paged kernel take, and a GQA group (H / KV) within
    the paged kernel's G_MAX: the card refuses no shape the reference
    computes for the repo's configs."""
    cfg = ARCHS[arch]
    assert cfg.head_dim in flash_kernel.HEAD_DIMS
    assert cfg.head_dim in pt_kernel.HEAD_DIMS
    assert cfg.n_heads % cfg.n_kv_heads == 0
    assert cfg.n_heads // cfg.n_kv_heads <= pt_kernel.G_MAX


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


@pytest.mark.parametrize("B,H,KV,dh,page,npp", SWEEP)
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
