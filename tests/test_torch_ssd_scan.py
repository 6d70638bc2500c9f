"""Parity of the port's SSD ops against the reference (CPU).

On the CPU, `repro_torch.kernels.ssd_scan.ops` runs the kernel's plain
version (`ref.py`). It is held against the reference's Pallas kernel in
interpret mode (`ssd_intra_chunk` and the public `ssd_scan`) and against
the O(S) recurrence `ssd_recurrence_ref` of both packages, on the
reference kernel test's 3 sweep cases and two ragged chunks (Q = 10 and
Q = 248, not multiples of the CUDA kernel's 64-row tiles), at the
reference's atol = rtol = 1e-4 (float32; measured errors ~1e-6). The CUDA
kernel runs only on the card (`chip_smoke.py` phase 8 holds it against
the same plain version). Its arithmetic, split-TF32 products
(`ref.ssd_intra_chunk_split_ref`), is held here to the reference at the
same 1e-4, and at a reduced serving shape to `ref.ssd_limits`, the
limit `chip_smoke.py` holds the kernel to at the serving shape. The
widths the card once refused (hd 128 and 100, ds 256 and 200, past the
kernel's 64 x 128 tiles; `WIDE`) are held to the reference the same way,
and the wrapper's plan (tile slices, instance, staging) and refusals are
checked.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan.kernel import \
    ssd_intra_chunk as jax_intra  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as jax_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import \
    ssd_recurrence_ref as jax_recurrence  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as pt_kernel  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as pt_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as pt_ref  # noqa: E402

TOL = 1e-4
CASES = [(64, 4, 16, 16, 16), (128, 8, 32, 16, 32), (96, 2, 64, 32, 32),
         (40, 2, 16, 16, 10),      # ragged: Q = 10
         (496, 2, 16, 16, 248)]    # ragged: Q = 248, four 64-row tiles
# past the tiles: hd in slices of 64, ds in slices of 128
WIDE = [(128, 2, 128, 256, 64), (96, 3, 100, 200, 48), (64, 2, 256, 16, 32),
        (64, 2, 16, 256, 64)]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(S, nh, hd, ds):
    """The reference test's inputs (tests/test_kernels.py)."""
    rng = np.random.RandomState(S + nh)
    x = (rng.randn(2, S, nh, hd) * .5).astype(np.float32)
    dt = (np.abs(rng.randn(2, S, nh)) * .1 + .02).astype(np.float32)
    A = (-np.abs(rng.randn(nh)) * .5 - .1).astype(np.float32)
    B = (rng.randn(2, S, ds) * .5).astype(np.float32)
    C = (rng.randn(2, S, ds) * .5).astype(np.float32)
    return x, dt, A, B, C


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S,nh,hd,ds,chunk", CASES)
def test_ssd_scan_matches_reference(S, nh, hd, ds, chunk):
    arrays = _inputs(S, nh, hd, ds)
    y, h = pt_ops.ssd_scan(*map(torch.from_numpy, arrays), chunk=chunk)
    assert y.shape == (2, S, nh, hd) and h.shape == (2, nh, hd, ds)
    jy, jh = jax_scan(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    ry, rh = jax_recurrence(*map(jnp.asarray, arrays))
    for want_y, want_h in ((jy, jh), (ry, rh)):
        _close(y, want_y)
        _close(h, want_h)


@pytest.mark.parametrize("S,nh,hd,ds,chunk", CASES + WIDE)
def test_ssd_intra_chunk_matches_reference_kernel(S, nh, hd, ds, chunk):
    x, dt, A, B, C = _inputs(S, nh, hd, ds)
    nc = S // chunk
    xc = (x * dt[..., None]).reshape(2, nc, chunk, nh, hd)
    dAc = (dt * A).reshape(2, nc, chunk, nh)
    Bc, Cc = (a.reshape(2, nc, chunk, ds) for a in (B, C))
    got = pt_ops.ssd_intra_chunk(*map(torch.from_numpy, (xc, dAc, Bc, Cc)))
    want = jax_intra(*map(jnp.asarray, (xc, dAc, Bc, Cc)),
                     head_tile=min(8, nh), interpret=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("S,nh,hd,ds,chunk", CASES[:3])
def test_recurrence_ref_matches_reference(S, nh, hd, ds, chunk):
    arrays = _inputs(S, nh, hd, ds)
    y, h = pt_ref.ssd_recurrence_ref(*map(torch.from_numpy, arrays))
    jy, jh = jax_recurrence(*map(jnp.asarray, arrays))
    _close(y, jy)
    _close(h, jh)


def test_shape_contract():
    """S must be a multiple of the chunk, as the reference asserts; the
    kernel's wrapper refuses CPU tensors (no fallback), and its plan
    widths past 256 and a chunk past Q_MAX, before any launch."""
    x, dt, A, B, C = map(torch.from_numpy, _inputs(64, 4, 16, 16))
    with pytest.raises(ValueError, match="not a multiple"):
        pt_ops.ssd_scan(x, dt, A, B, C, chunk=24)
    xc = torch.zeros(1, 1, 8, 2, 16)
    dAc = torch.zeros(1, 1, 8, 2)
    Bc = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="current CUDA device"):
        pt_kernel.ssd_intra_chunk(xc, dAc, Bc, Bc)
    assert pt_kernel.ssd_intra_chunk.launches == 0
    for hd, ds, Q, match in ((264, 16, 8, "head dim 264"),
                             (16, 257, 8, "state dim 257"),
                             (16, 16, pt_kernel.Q_MAX + 1, "chunk 30657")):
        with pytest.raises(ValueError, match=match):
            pt_kernel.plan(hd, ds, Q)


@pytest.mark.parametrize("hd,ds,Q,contiguous,want", [
    (64, 128, 256, True, (1, 1, False, False, False)),   # mamba2 serving
    (18, 10, 20, True, (1, 1, False, False, False)),
    (64, 128, 1040, True, (1, 1, False, True, False)),
    (128, 256, 256, True, (2, 2, True, False, False)),
    (100, 200, 300, True, (2, 2, True, False, False)),
    (256, 256, 1040, True, (4, 2, True, True, False)),
    (64, 129, 64, True, (1, 2, True, False, False)),
    (64, 128, 256, False, (1, 1, False, False, True)),
])
def test_plan_slices_and_staging(hd, ds, Q, contiguous, want):
    """The plan of a call: one block per 64 columns of hd, a loop over
    128 columns of ds, the WIDE instance where either slices, the cs
    windows past 768 rows, a copy of non-contiguous inputs."""
    assert tuple(pt_kernel.plan(hd, ds, Q, contiguous)) == want


@pytest.mark.parametrize("S,nh,hd,ds,chunk", CASES + WIDE)
def test_split_tf32_matches_reference_kernel(S, nh, hd, ds, chunk):
    """The CUDA kernel's arithmetic (each product in split TF32, emulated
    on the CPU) meets the reference's 1e-4 on the sweep."""
    x, dt, A, B, C = _inputs(S, nh, hd, ds)
    nc = S // chunk
    args = ((x * dt[..., None]).reshape(2, nc, chunk, nh, hd),
            (dt * A).reshape(2, nc, chunk, nh),
            B.reshape(2, nc, chunk, ds), C.reshape(2, nc, chunk, ds))
    got = pt_ref.ssd_intra_chunk_split_ref(*map(torch.from_numpy, args))
    want = jax_intra(*map(jnp.asarray, args), head_tile=min(8, nh),
                     interpret=True)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        _close(g, w)


def test_tf32_round_is_cvt_rna():
    """Round to nearest with ties away from zero, 10 stored mantissa
    bits, the low 13 bits of the float32 cleared."""
    one = 1.0
    vals = torch.tensor([one + 2 ** -11, one + 2 ** -12, one + 3 * 2 ** -12,
                         -(one + 2 ** -11), 3.0, 0.0, 2 ** -130],
                        dtype=torch.float32)
    want = [one + 2 ** -10, one, one + 2 ** -10, -(one + 2 ** -10), 3.0,
            0.0, 2 ** -130]
    got = pt_ref.tf32_round(vals)
    assert got.tolist() == want
    rng = np.random.RandomState(0)
    t = torch.from_numpy(rng.randn(4096).astype(np.float32))
    r = pt_ref.tf32_round(t)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((r - t).abs() <= 2.0 ** -11 * t.abs()).all())


def test_split_tf32_within_smoke_limit():
    """At a reduced serving shape (B=1, S=512 in chunks of 256, 4 heads of
    64, d_state 128), the split-TF32 arithmetic stays within
    `ref.ssd_limits` of the float32 plain version, and the limit
    still rejects a wrong head or q tile."""
    rng = np.random.RandomState(8)
    b, S, nh, hd, ds, Q = 1, 512, 4, 64, 128, 256
    x = torch.from_numpy((rng.randn(b, S, nh, hd) * .5).astype(np.float32))
    B, C = (torch.from_numpy((rng.randn(b, S, ds) * .5).astype(np.float32))
            for _ in range(2))
    dt = torch.from_numpy((rng.rand(b, S, nh) * .1 + .02).astype(np.float32))
    A = torch.from_numpy(-(rng.rand(nh) * .5 + .1).astype(np.float32))
    args = pt_ops.chunk_inputs(x, dt, A, B, C, Q)
    got = pt_ref.ssd_intra_chunk_split_ref(*args)
    want = pt_ref.ssd_intra_chunk_ref(*args)
    limits = pt_ref.ssd_limits(*args)
    for g, w, lim in zip(got, want, limits):
        assert bool(((g - w).abs() <= lim).all())
    for wrong in (want[0].roll(1, dims=3), want[0].roll(64, dims=2)):
        assert bool(((got[0] - wrong).abs() > limits[0]).any())
