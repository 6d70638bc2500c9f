"""Parity of the port's flash attention op against the reference (CPU).

On the CPU, `repro_torch.kernels.flash_attention.ops.flash_attention`
runs the kernel's plain version (`ref.py`). It is held against the
reference's Pallas kernel in interpret mode and against its
`attention_ref`, on the reference kernel test's 18-case sweep with the
reference's tolerances (atol = rtol = 2e-2 in bf16, 2e-5 in fp32). The
bf16 inputs are the reference's own bf16 arrays, carried bit for bit.
The CUDA kernel itself runs only on the card (`chip_smoke.py` holds it
against the same plain version on the same 18 cases).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as pt_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bhsd)
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
