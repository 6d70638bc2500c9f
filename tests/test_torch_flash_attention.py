"""Parity of the port's flash attention op against the reference (CPU).

On the CPU, `repro_torch.kernels.flash_attention.ops.flash_attention`
runs the kernel's plain version (`ref.py`). It is held against the
reference's Pallas kernel in interpret mode and against its
`attention_ref`, on the reference kernel test's 18-case sweep with the
reference's tolerances (atol = rtol = 2e-2 in bf16, 2e-5 in fp32), and
on the edge shapes of the tensor-core kernel. The bf16 inputs are the
reference's own bf16 arrays, carried bit for bit. The CUDA kernels
themselves run only on the card (`chip_smoke.py` holds them against the
same plain version on the same 18 cases and the edges at full length);
here the wrapper's routing by dtype, its plan (the compiled instance a
head dim runs and whether a call is staged through zero-padded copies)
and its refusals, which come before any build or launch, are checked.
The heads the card once refused (dh 80, 100, 192, 256; H = 8 over one KV
head) are held to the reference's Pallas kernel like the sweep, and the
staging is shown to keep the function: the plain version on the
zero-padded copies, with the true head's scale, sliced to dh, equals it
on the originals. The fp32 kernel's split-TF32 arithmetic is emulated on
the CPU (`ref.attention_split_ref`) and held to the reference within
2e-5 on the sweep, a ragged 496-token shape, the edges and the wide
heads; plain TF32 misses that tolerance.
"""
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import \
    kernel as kernel_mod  # noqa: E402
from repro_torch.kernels.flash_attention import ops as pt_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as ref_mod  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bhsd)
from repro_torch.kernels._tf32 import tf32_round  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    tensor_from_numpy, tensor_to_numpy)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(S, H, KV, dh, dtype, seed):
    rng = np.random.RandomState(seed)
    return [jnp.asarray(rng.randn(2, S, n, dh), dtype) for n in (H, KV, KV)]


def _port(*arrays):
    return [tensor_from_numpy(np.asarray(a), "cpu") for a in arrays]


@functools.lru_cache(maxsize=None)
def _jax_wants(S, H, KV, dh, causal, window, bq, bk, seed):
    """The reference's fp32 outputs, (B, S, H, dh) numpy: its Pallas kernel
    in interpret mode, then its `attention_ref`."""
    q, k, v = _inputs(S, H, KV, dh, jnp.float32, seed)
    kernel = jax_flash(q, k, v, causal=causal, window=window, block_q=bq,
                       block_k=bk, interpret=True)
    plain = jnp.swapaxes(jax_ref(
        jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
        causal=causal, window=window), 1, 2)
    return np.asarray(kernel, np.float32), np.asarray(plain, np.float32)


@pytest.mark.parametrize("S,H,KV,dh,bq,bk", [
    (128, 4, 4, 64, 64, 64),      # MHA
    (256, 8, 2, 64, 64, 128),     # GQA 4:1; window=96 case: row 255 sees
    (128, 4, 1, 128, 32, 64),     # MQA      nothing in the first k tile
])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 96)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_sweep(S, H, KV, dh, bq, bk, causal, window, dtype):
    q, k, v = _inputs(S, H, KV, dh, dtype, S + H)
    want_kernel = jax_flash(q, k, v, causal=causal, window=window,
                            block_q=bq, block_k=bk, interpret=True)
    want_ref = jnp.swapaxes(jax_ref(
        jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
        causal=causal, window=window), 1, 2)
    tq, tk, tv = _port(q, k, v)
    got = pt_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                 block_q=bq, block_k=bk)
    assert got.shape == (2, S, H, dh) and got.dtype == tq.dtype
    got = tensor_to_numpy(got)
    assert np.all(np.isfinite(got))
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("S,bq,ok", [(96, 512, True), (96, 32, True),
                                     (96, 64, False), (100, 48, False)])
def test_tiling_contract(S, bq, ok):
    """The port accepts and rejects the reference kernel's shapes: each
    length a multiple of its block cut to the length."""
    q, k, v = _port(*_inputs(S, 2, 1, 32, jnp.float32, 0))
    if ok:
        out = pt_ops.flash_attention(q, k, v, block_q=bq, block_k=bq)
        assert out.shape == q.shape
    else:
        with pytest.raises(ValueError, match="multiples"):
            pt_ops.flash_attention(q, k, v, block_q=bq, block_k=bq)


def test_cpu_route_never_launches_and_kernel_refuses_cpu():
    """A CPU tensor goes to the plain version; the kernel's wrapper takes
    only tensors on the card and raises on anything else."""
    q, k, v = _port(*_inputs(64, 4, 2, 64, jnp.float32, 1))
    before = flash_attention_bhsd.launches
    pt_ops.flash_attention(q, k, v)
    assert flash_attention_bhsd.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2))
    assert flash_attention_bhsd.launches == before


# The tensor-core kernel's edges, as chip_smoke.py's FLASH_EDGES at CPU
# sizes: (S, H, KV, dh, causal, window). Lengths off its 128-row tiles,
# windows across them, non-causal rows (one with a window), G = H / KV of
# 1, 4 and 8, every head dim (96: phi3-vision's), one token.
EDGES = [(200, 4, 4, 128, True, None), (200, 8, 2, 64, True, 60),
         (200, 8, 1, 32, False, None), (200, 16, 2, 128, False, 60),
         (77, 4, 2, 128, True, 50), (129, 2, 2, 64, False, None),
         (1, 2, 1, 64, True, None), (200, 8, 2, 96, True, None),
         (129, 4, 4, 96, False, 60)]


# The heads the card once refused, as chip_smoke.py's CONTRACT_FLASH at CPU
# sizes: dh 80 and 100 (read through the 128-wide instances; bf16 100 is
# staged to 104), 192 and 256 (the wide instances), H = 8 over one KV head
WIDE = [(64, 4, 2, 80, True, None), (64, 4, 2, 100, True, 24),
        (64, 2, 1, 192, False, None), (64, 2, 1, 256, True, None),
        (64, 8, 1, 64, True, None), (40, 8, 1, 256, False, 24)]


@pytest.mark.parametrize("S,H,KV,dh,causal,window", EDGES)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_edges(S, H, KV, dh, causal, window, dtype):
    """On the CPU, `ops.flash_attention` equals the reference's kernel (in
    interpret mode) and its `attention_ref` at the edge shapes the card's
    kernels are held to, with the sweep's tolerances."""
    _hold_to_reference(S, H, KV, dh, causal, window, dtype)


@pytest.mark.parametrize("S,H,KV,dh,causal,window", WIDE)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_flash_attention_wide_heads(S, H, KV, dh, causal, window, dtype):
    """The heads the card once refused: `ops.flash_attention` equals the
    reference's kernel (interpret mode) and its `attention_ref`, with the
    sweep's tolerances."""
    _hold_to_reference(S, H, KV, dh, causal, window, dtype)


def _hold_to_reference(S, H, KV, dh, causal, window, dtype):
    q, k, v = _inputs(S, H, KV, dh, dtype, S + dh)
    want_kernel = jax_flash(q, k, v, causal=causal, window=window,
                            block_q=S, block_k=S, interpret=True)
    want_ref = jnp.swapaxes(jax_ref(
        jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2), jnp.swapaxes(v, 1, 2),
        causal=causal, window=window), 1, 2)
    tq, tk, tv = _port(q, k, v)
    got = pt_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                 block_q=S, block_k=S)
    assert got.shape == (2, S, H, dh) and got.dtype == tq.dtype
    got = tensor_to_numpy(got)
    assert np.all(np.isfinite(got))
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_route_by_dtype():
    """The dtype alone picks the kernel: bf16 the wgmma kernel, fp32 the
    split-TF32 kernel, each with its own source; any other dtype raises."""
    assert kernel_mod.route(torch.bfloat16) == "wgmma"
    assert kernel_mod.route(torch.float32) == "split_tf32"
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="not one of"):
            kernel_mod.route(dtype)
    csrc = Path(kernel_mod.__file__).resolve().parents[2] / "csrc"
    assert set(kernel_mod.SOURCES) == set(kernel_mod.ROUTES.values())
    for name in kernel_mod.SOURCES.values():
        assert (csrc / f"{name}.cu").is_file()
    assert set(flash_attention_bhsd.route_launches) == set(kernel_mod.SOURCES)


def _bhsd_views(B, S, H, KV, dh, dtype, offset=0, s_pad=0):
    """(B, heads, S, dh) views of (B, S, heads, dh + s_pad) storage, as the
    model passes them; q starts `offset` elements into its buffer."""
    def view(n, off):
        buf = torch.zeros(off + B * S * n * (dh + s_pad), dtype=dtype)
        t = buf[off:].view(B, S, n, dh + s_pad)[..., :dh]
        return t.transpose(1, 2)
    return view(H, offset), view(KV, 0), view(KV, 0)


def _no_build(*_):
    raise AssertionError("the wrapper built a kernel before checking")


@pytest.mark.parametrize("case,dtype,match", [
    ("cpu", torch.bfloat16, "current CUDA device"),
    ("cpu", torch.float32, "current CUDA device"),
    ("address", torch.bfloat16, "current CUDA device"),
    ("address", torch.float32, "current CUDA device"),
    ("stride", torch.bfloat16, "current CUDA device"),
    ("stride", torch.float32, "current CUDA device"),
    ("head_dim", torch.bfloat16, "head dim 264"),
    ("head_dim", torch.float32, "head dim 264"),
    ("dtype", torch.float16, "must share one of"),
])
def test_wrapper_refuses_before_build(monkeypatch, case, dtype, match):
    """`flash_attention_bhsd` raises ValueError on CPU tensors, on a head
    dim past the widest instance (256) and on float16, before it builds
    or launches anything. An address or a stride off 16 bytes (TMA in
    bf16, 16-byte copies in fp32) is no longer refused: the plan stages
    such a call through aligned copies, and on the CPU it is the device
    that refuses it."""
    monkeypatch.setattr(kernel_mod._build, "load", _no_build)
    kernel_mod._entry.cache_clear()
    dh = 264 if case == "head_dim" else 64
    pad = 4 if dtype == torch.bfloat16 else 2
    q, k, v = _bhsd_views(2, 40, 4, 2, dh, dtype,
                          offset=1 if case == "address" else 0,
                          s_pad=pad if case == "stride" else 0)
    if case == "stride":     # q aligned, k's rows 136 B (bf16), 264 B apart
        q = _bhsd_views(2, 40, 4, 2, dh, dtype)[0]
    if case in ("address", "stride"):
        faults = [kernel_mod._stride_fault(t, n)
                  for t, n in ((q, "q"), (k, "k"), (v, "v"))]
        assert any(faults)
        assert kernel_mod.plan(dtype, dh, aligned=False).staged
    before = (flash_attention_bhsd.launches,
              dict(flash_attention_bhsd.route_launches),
              flash_attention_bhsd.staged)
    with pytest.raises(ValueError, match=match):
        flash_attention_bhsd(q, k, v, causal=True)
    assert (flash_attention_bhsd.launches,
            flash_attention_bhsd.route_launches,
            flash_attention_bhsd.staged) == before


@pytest.mark.parametrize("dtype,dh,aligned,want", [
    (torch.bfloat16, 128, True, (128, 128, False)),   # qwen3-4b: in place
    (torch.bfloat16, 96, True, (96, 128, False)),     # phi3-vision
    (torch.bfloat16, 32, True, (32, 64, False)),
    (torch.bfloat16, 80, True, (80, 128, False)),
    (torch.bfloat16, 100, True, (104, 128, True)),    # 200 B rows: staged
    (torch.bfloat16, 136, True, (136, 192, False)),
    (torch.bfloat16, 192, True, (192, 192, False)),
    (torch.bfloat16, 200, True, (200, 256, False)),
    (torch.bfloat16, 256, True, (256, 256, False)),   # gemma-2 9b's head
    (torch.bfloat16, 128, False, (128, 128, True)),   # strides off 16 B
    (torch.float32, 128, True, (128, 128, False)),
    (torch.float32, 100, True, (100, 128, False)),
    (torch.float32, 98, True, (100, 128, True)),
    (torch.float32, 8, True, (8, 32, False)),
    (torch.float32, 160, True, (160, 160, False)),
    (torch.float32, 256, True, (256, 256, False)),
    (torch.float32, 64, False, (64, 64, True)),
])
def test_plan_picks_instance_and_staging(dtype, dh, aligned, want):
    """The plan of a call: the head rounded up to whole 16-byte pieces,
    read through the narrowest instance at or above it (bf16: 64, 128,
    192, 256; fp32: every multiple of 32), staged where the rounding
    moves dh or the layout is off 16 bytes."""
    assert tuple(kernel_mod.plan(dtype, dh, aligned)) == want
    assert want[1] in kernel_mod.INSTANCES[kernel_mod.route(dtype)]


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 100),
                                      (torch.bfloat16, 36),
                                      (torch.float32, 98),
                                      (torch.float32, 30)])
def test_staging_keeps_the_function(dtype, dh):
    """A staged call's copies: the plain version on the zero-padded
    tensors, at the true head's scale, sliced to dh, equals the plain
    version on the originals; the padded columns come out 0."""
    how = kernel_mod.plan(dtype, dh)
    assert how.staged and how.dh > dh
    q, k, v = (t.transpose(1, 2).to(dtype) for t in
               _port(*_inputs(48, 4, 2, dh, jnp.float32, dh)))
    padded = [kernel_mod.stage(t, how.dh) for t in (q, k, v)]
    for t, p in zip((q, k, v), padded):
        assert p.is_contiguous() and p.shape[-1] == how.dh
        assert torch.equal(p[..., :dh], t) and not p[..., dh:].any()
    want = ref_mod.attention_ref(q, k, v, causal=True, window=20)
    got = ref_mod.attention_ref(*padded, causal=True, window=20,
                                scale=1.0 / dh ** 0.5)
    assert not got[..., dh:].any()
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got[..., :dh], want, atol=tol, rtol=tol)


def test_tma_strides_of_the_model_layout():
    """The model's (B, S, H, dh) tensors, passed as (B, H, S, dh) views,
    give TMA their own strides; a dim of length 1 gets a harmless one."""
    q, k, _ = _bhsd_views(2, 40, 4, 2, 128, torch.bfloat16)
    assert kernel_mod.tma_strides(q, "q") == [40 * 4 * 128, 128, 4 * 128]
    one = _bhsd_views(1, 40, 1, 1, 64, torch.bfloat16)[0][:, :, :1]
    assert kernel_mod.tma_strides(one, "q") == [64, 64, 64]
    odd = torch.zeros(2, 3, 5, 68, dtype=torch.bfloat16)[:, :, :, :64]
    with pytest.raises(ValueError, match="stride"):
        kernel_mod.tma_strides(odd, "v")


# the fp32 kernel's arithmetic: (S, H, KV, dh, causal, window, bq, bk,
# seed), the reference's sweep, the ragged 496-token prefill of the fp32
# match at a small width, and the edges
SPLIT_CASES = (
    [(S, H, KV, dh, causal, window, bq, bk, S + H)
     for S, H, KV, dh, bq, bk in [(128, 4, 4, 64, 64, 64),
                                  (256, 8, 2, 64, 64, 128),
                                  (128, 4, 1, 128, 32, 64)]
     for causal, window in [(True, None), (False, None), (True, 96)]]
    + [(496, 4, 2, 128, True, None, 512, 512, 1)]
    + [(S, H, KV, dh, causal, window, S, S, S + dh)
       for S, H, KV, dh, causal, window in EDGES + WIDE])


def _split_port(case):
    S, H, KV, dh, causal, window, _, _, seed = case
    tq, tk, tv = (t.transpose(1, 2) for t in
                  _port(*_inputs(S, H, KV, dh, jnp.float32, seed)))
    out = ref_mod.attention_split_ref(tq, tk, tv, causal=causal,
                                      window=window)
    return out.transpose(1, 2).numpy()


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_tf32_arithmetic_within_fp32_tolerance(case):
    """Both products in split TF32 (the fp32 kernel's arithmetic) stay
    within the reference's fp32 atol = rtol = 2e-5 of its Pallas kernel
    (interpret mode) and of its `attention_ref`."""
    got = _split_port(case)
    assert np.all(np.isfinite(got))
    for want in _jax_wants(*case):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_plain_tf32_misses_fp32_tolerance(monkeypatch):
    """The negative control: one TF32 pass (hi.hi) per product misses 2e-5
    where the split stays inside it, so the split is needed."""
    def share(case):
        want = _jax_wants(*case)[1]
        err = np.abs(_split_port(case) - want)
        return float((err / (2e-5 + 2e-5 * np.abs(want))).max())

    cases = SPLIT_CASES[:3]
    split = max(share(case) for case in cases)
    monkeypatch.setattr(ref_mod, "split_einsum", lambda eq, a, b: (
        torch.einsum(eq, tf32_round(a), tf32_round(b))))
    plain = max(share(case) for case in cases)
    assert split < 1 < plain
