"""Parity of the port's Mamba2 serving path with the reference on the CPU.

Reduced mamba2-1.3b (4 layers, d_model 128, 16 heads of 16, d_state 16,
chunk 16), the reference's params carried across by `models/convert.py`.
On the CPU the port's `ssd_chunked` runs the SSD kernel's plain version.

* The block: `_causal_conv`, `_segsum`, `ssd_chunked` (with a carried-in
  state, ragged chunks), `mamba2_forward` and `mamba2_decode` against the
  reference in fp32, atol = rtol = 1e-5 (the same float32 arithmetic in
  another order; measured errors ~1e-6).
* The slice: `forward_prefill` and 8 `forward_decode` steps against the
  reference's at prompt lengths 8, 12 and 40 (chunks of 8, 12 and 10
  rows); caches (SSM state and conv ring) likewise. The reduced model's
  tied embedding makes logits of up to ~90, so the limits are relative to
  the largest |value| (`_close_scaled`): fp32 1e-5 of it (measured max
  |err| ~4e-5 at ~90, 4e-7 of it), bf16 2^-7 of it, about one bf16 step
  (measured ~0.1-0.25 against ~0.7).
* Decode == chunked scan as a law of the port alone (the reference test's
  atol 1e-4, rtol 1e-3), and prefill + decode == `forward_train`.
* Param specs, cache shapes and the bf16 bits of params and caches carry
  across; jamba's hybrid period has the reference's specs and caches
  (its forwards: `tests/test_torch_model_families.py`).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced_model  # noqa: E402
from repro.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.params import materialize as jmaterialize  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.configs.base import RunConfig as PRunConfig  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShapeConfig  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.models import mamba2 as pm2  # noqa: E402
from repro_torch.models import model as pM  # noqa: E402

ARCH = "mamba2-1.3b"
TOL32 = 1e-5
TOL16_SCALED = 2.0 ** -7      # about one bf16 step at the largest logit


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.tensor_to_numpy(x)
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _close_scaled(got, want, tol):
    """Within tol of the largest |want|, and rtol: the reduced model's
    tied embedding (scale 1) makes logits of up to ~90, where one float32
    rounding is ~8e-6 and one bf16 step is 0.5, so an absolute limit
    stated for values of order 1 cannot hold near zero."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _cfgs(**kw):
    return (dataclasses.replace(reduced_model(ARCHS[ARCH]), **kw),
            dataclasses.replace(pconfigs.reduced_model(pconfigs.ARCHS[ARCH]),
                                **kw))


def _block_params(cfg):
    params = jax.device_get(jmaterialize(
        jax.random.PRNGKey(0), jm2.mamba2_params(cfg),
        dtype_override=jnp.float32))
    return params, convert.tree_from_numpy(params, "cpu")


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

def test_conv_and_segsum_match_reference():
    rng = np.random.RandomState(0)
    xbc = rng.randn(2, 5, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    prev = rng.randn(2, 3, 12).astype(np.float32)
    for p in (None, prev):
        got = pm2._causal_conv(_t(xbc), _t(w), _t(b),
                               None if p is None else _t(p))
        want = jm2._causal_conv(xbc, w, b, p)
        for g, wt in zip(got, want):
            _close(g, wt, TOL32)
    x = rng.randn(3, 7).astype(np.float32)
    got, want = _np(pm2._segsum(_t(x))), np.asarray(jm2._segsum(x))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=TOL32, rtol=TOL32)


@pytest.mark.parametrize("S,chunk,with_h0", [(32, 16, False), (40, 16, True),
                                             (12, 16, True)])
def test_ssd_chunked_matches_reference(S, chunk, with_h0):
    rng = np.random.RandomState(S)
    x = (rng.randn(2, S, 4, 8) * .5).astype(np.float32)
    dt = (np.abs(rng.randn(2, S, 4)) * .1 + .02).astype(np.float32)
    A = (-np.abs(rng.randn(4)) * .5 - .1).astype(np.float32)
    B, C = ((rng.randn(2, S, 16) * .5).astype(np.float32) for _ in range(2))
    h0 = rng.randn(2, 4, 8, 16).astype(np.float32) if with_h0 else None
    got = pm2.ssd_chunked(_t(x), _t(dt), _t(A), _t(B), _t(C), chunk,
                          None if h0 is None else _t(h0))
    want = jm2.ssd_chunked(x, dt, A, B, C, chunk, h0)
    for g, w in zip(got, want):
        _close(g, w, TOL32)


def test_block_forward_and_decode_match_reference():
    cfg, pcfg = _cfgs()
    params, pparams = _block_params(cfg)
    x = (np.random.RandomState(1).randn(2, 12, cfg.d_model) * .3
         ).astype(np.float32)
    jy, jst = jm2.mamba2_forward(params, cfg, x[:, :8])
    py, pst = pm2.mamba2_forward(pparams, pcfg, _t(x[:, :8]))
    _close(py, jy, TOL32)
    _close(pst.h, jst.h, TOL32)
    _close(pst.conv, jst.conv, TOL32)
    # a second segment from the carried state, then single-token decode
    jy, jst = jm2.mamba2_forward(params, cfg, x[:, 8:10], jst)
    py, pst = pm2.mamba2_forward(pparams, pcfg, _t(x[:, 8:10]), pst)
    _close(py, jy, TOL32)
    for i in (10, 11):
        jy, jst = jm2.mamba2_decode(params, cfg, x[:, i:i + 1], jst)
        py, pst = pm2.mamba2_decode(pparams, pcfg, _t(x[:, i:i + 1]), pst)
        _close(py, jy, TOL32)
        _close(pst.h, jst.h, TOL32)
        _close(pst.conv, jst.conv, TOL32)


def test_decode_matches_chunked():
    """Stepwise O(1) decode == chunked scan on the same sequence, in the
    port alone (the reference's law, tests/test_moe_mamba.py)."""
    _, pcfg = _cfgs(dtype="float32")
    _, pparams = _block_params(_cfgs(dtype="float32")[0])
    x = torch.from_numpy((np.random.RandomState(1).randn(2, 12, pcfg.d_model)
                          * .3).astype(np.float32))
    y_full, st_full = pm2.mamba2_forward(pparams, pcfg, x)
    spec = pm2.ssm_state_specs(pcfg, 2)
    st = pm2.SSMState(h=torch.zeros(spec.h.shape),
                      conv=torch.zeros(spec.conv.shape))
    ys = []
    for i in range(12):
        y, st = pm2.mamba2_decode(pparams, pcfg, x[:, i:i + 1], st)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.cat(ys, dim=1)), _np(y_full),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(_np(st.h), _np(st_full.h), atol=1e-4,
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# The model: specs, caches, conversion
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_param_specs_and_cache_shapes_match_reference():
    cfg, pcfg = _cfgs()
    jspecs = _flat(jlm.build_param_specs(cfg))
    pspecs = _flat(plm.build_param_specs(pcfg))
    assert jspecs.keys() == pspecs.keys()
    for key, p in jspecs.items():
        q = pspecs[key]
        assert (q.shape, q.axes, q.init, q.scale, q.const) == \
            (p.shape, p.axes, p.init, p.scale, p.const), key
        assert str(q.dtype).split(".")[-1] == jnp.dtype(p.dtype).name, key
    jc = jlm.cache_shapes(cfg, 3, 40)
    pc = pM.cache_shapes(pcfg, 3, 40)
    assert {k: (s.shape, jnp.dtype(s.dtype).name) for k, s in jc.items()} \
        == {k: (s.shape, str(s.dtype).split(".")[-1]) for k, s in pc.items()}
    assert set(pc) == {"cache_len", "ssm_h", "ssm_conv"}
    cache = pM.init_cache(pcfg, 3, 40, device="cpu")
    assert all(int(t.abs().sum()) == 0 for t in cache.values())


def test_jamba_param_specs_and_cache_shapes_match_reference():
    """The hybrid: one period of 8 layers (Mamba2 and one attention layer,
    MoE FFNs every 2nd layer) in the reference's specs and caches."""
    cfg = reduced_model(ARCHS["jamba-1.5-large-398b"])
    pcfg = pconfigs.reduced_model(pconfigs.ARCHS["jamba-1.5-large-398b"])
    jspecs = _flat(jlm.build_param_specs(cfg))
    pspecs = _flat(plm.build_param_specs(pcfg))
    assert jspecs.keys() == pspecs.keys()
    for key, p in jspecs.items():
        q = pspecs[key]
        assert (q.shape, q.axes, q.init, q.scale, q.const) == \
            (p.shape, p.axes, p.init, p.scale, p.const), key
        assert str(q.dtype).split(".")[-1] == jnp.dtype(p.dtype).name, key
    assert sum("/moe/router" in k for k in pspecs) == 4
    assert sum("/ssm/" in k and k.endswith("A_log") for k in pspecs) == 7
    jc = jlm.cache_shapes(cfg, 3, 40)
    pc = pM.cache_shapes(pcfg, 3, 40)
    assert {k: (s.shape, jnp.dtype(s.dtype).name) for k, s in jc.items()} \
        == {k: (s.shape, str(s.dtype).split(".")[-1]) for k, s in pc.items()}
    assert set(pc) == {"cache_len", "k", "v", "ssm_h", "ssm_conv"}


# ---------------------------------------------------------------------------
# The slice: forward_prefill + forward_decode (and forward_train)
# ---------------------------------------------------------------------------

def _setup(dtype, seq):
    cfg, pcfg = _cfgs()
    run = RunConfig(model=cfg, shape=ShapeConfig("t", seq, 2, "train"),
                    remat=False)
    prun = PRunConfig(model=pcfg, shape=PShapeConfig("t", seq, 2, "train"),
                      remat=False)
    override = jnp.float32 if dtype == "float32" else None
    params = jmaterialize(jax.random.PRNGKey(0), jlm.build_param_specs(cfg),
                          dtype_override=override)
    pparams = convert.tree_from_numpy(jax.device_get(params), "cpu")
    tokens = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, seq)).astype(np.int32)
    return cfg, run, params, pcfg, prun, pparams, tokens


def _check_caches(pc, jc, tol):
    assert pc.keys() == set(jc.keys())
    assert np.array_equal(_np(pc["cache_len"]), np.asarray(jc["cache_len"]))
    for key in ("ssm_h", "ssm_conv"):
        assert tuple(pc[key].shape) == jc[key].shape
        assert str(pc[key].dtype).split(".")[-1] == jc[key].dtype.name
        _close_scaled(pc[key], jc[key], tol)


@pytest.mark.parametrize("prompt", [8, 12, 40])
@pytest.mark.parametrize("dtype,tol", [("float32", TOL32),
                                       ("bfloat16", TOL16_SCALED)])
def test_prefill_decode_matches_reference(prompt, dtype, tol):
    cfg, run, params, pcfg, prun, pparams, toks = _setup(dtype, prompt + 8)
    jl, jc = jM.forward_prefill(cfg, run, params,
                                {"tokens": jnp.asarray(toks[:, :prompt])},
                                max_len=64)
    pl, pc = pM.forward_prefill(pcfg, prun, pparams,
                                {"tokens": torch.tensor(toks[:, :prompt])},
                                max_len=64)
    assert tuple(pl.shape) == jl.shape == (2, 1, cfg.padded_vocab)
    _close_scaled(pl, jl, tol)
    _check_caches(pc, jc, tol)
    for i in range(prompt, prompt + 8):
        tok = toks[:, i:i + 1]
        jl, jc = jM.forward_decode(cfg, run, params,
                                   {"tokens": jnp.asarray(tok)}, jc)
        pl, pc = pM.forward_decode(pcfg, prun, pparams,
                                   {"tokens": torch.tensor(tok)}, pc)
        _close_scaled(pl, jl, tol)
    _check_caches(pc, jc, tol)


def test_caches_carry_across_bit_exact():
    """The reference's bf16 prefill caches carry to the port and back bit
    for bit, and decode in the port as they do in the reference."""
    cfg, run, params, pcfg, prun, pparams, toks = _setup("bfloat16", 12)
    _, jc = jM.forward_prefill(cfg, run, params,
                               {"tokens": jnp.asarray(toks[:, :8])},
                               max_len=16)
    host = jax.device_get(jc)
    pc = convert.tree_from_numpy(host, "cpu")
    assert pc["ssm_conv"].dtype == torch.bfloat16
    assert pc["ssm_h"].dtype == torch.float32
    back = convert.tree_to_numpy(pc)

    def bits(a):
        a = np.asarray(a)
        if a.dtype.name in ("bfloat16", "float32"):
            return a.astype(np.float32).view(np.uint32)
        return a
    for key in host:
        assert np.array_equal(bits(back[key]), bits(host[key])), key
    for i in range(8, 12):
        tok = toks[:, i:i + 1]
        jl, jc = jM.forward_decode(cfg, run, params,
                                   {"tokens": jnp.asarray(tok)}, jc)
        pl, pc = pM.forward_decode(pcfg, prun, pparams,
                                   {"tokens": torch.tensor(tok)}, pc)
        _close_scaled(pl, jl, TOL16_SCALED)


def test_forward_train_and_teacher_forcing():
    """forward_train matches the reference; the port's own prefill +
    decode reproduce its forward_train (the reference test's 2e-3 and
    5e-3)."""
    cfg, run, params, pcfg, prun, pparams, toks = _setup("float32", 16)
    jl, _ = jM.forward_train(cfg, run, params, {"tokens": jnp.asarray(toks)})
    full, aux = pM.forward_train(pcfg, prun, pparams,
                                 {"tokens": torch.tensor(toks)})
    _close_scaled(full, jl, TOL32)
    assert float(aux) == 0.0
    logits, caches = pM.forward_prefill(
        pcfg, prun, pparams, {"tokens": torch.tensor(toks[:, :8])},
        max_len=64)
    np.testing.assert_allclose(_np(logits[:, -1]), _np(full[:, 7]),
                               atol=2e-3, rtol=2e-3)
    for i in range(8, 16):
        logits, caches = pM.forward_decode(
            pcfg, prun, pparams, {"tokens": torch.tensor(toks[:, i:i + 1])},
            caches)
        assert float((logits[:, 0] - full[:, i]).abs().max()) < 5e-3
