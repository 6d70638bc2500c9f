"""Parity of the port's model stack (dense serving path) with the reference
on the CPU.

* Layers (`rmsnorm`, `apply_rope`, `_head_norm`, `mlp`) and the attention
  functions (`naive_attention`, `blocked_attention`,
  `decode_attention_dense`) against the reference in fp32, atol = rtol =
  1e-5 (the same float32 arithmetic summed in another order; measured
  errors are ~1e-6).
* `models/convert.py` carries the reference's param trees (reduced
  qwen3-4b and llama3-8b, fp32 and bf16) bit for bit.
* The slice: the reference's params, carried across, through
  `forward_prefill` (logits and caches) and 8 `forward_decode` steps with
  `attention_impl="pallas_flash"` on both sides (the reference runs its
  Pallas kernel in interpret mode; the port the kernel's plain version).
  fp32: atol = rtol = 1e-5 (measured max |err| ~1e-6 on logits of
  magnitude ~2). bf16: atol = rtol = 3e-2, about four bf16 steps at that
  magnitude (measured: one step, 7.8e-3).
* The port's own prefill + decode against its own `forward_train`
  (teacher forcing), with the reference test's tolerances (2e-3 prefill,
  5e-3 decode).
* Entry points default to the card and raise without one.
* The (arch, run option) pairs the port refused before the MoE,
  encoder-decoder, patch and int8 paths were ported (mixtral, whisper,
  phi-3-vision, jamba; int8 mamba2 and qwen3): prefill + decode against
  the reference (`tests/test_torch_model_families.py` has these families
  in full).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced_model  # noqa: E402
from repro.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models import quant as jquant  # noqa: E402
from repro.models.params import materialize as jmaterialize  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.configs.base import RunConfig as PRunConfig  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShapeConfig  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as pL  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.models import model as pM  # noqa: E402
from repro_torch.models.params import materialize, tree_leaves  # noqa: E402
from tests import test_torch_model_families as families  # noqa: E402

TOL32 = 1e-5
TOL16 = 3e-2
ARCHS_PORTED = ["qwen3-4b", "llama3-8b"]


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


# ---------------------------------------------------------------------------
# Layers and attention functions
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 4, 32).astype(np.float32)
    scale = {"scale": (1 + 0.1 * rng.randn(32)).astype(np.float32)}
    pscale = {"scale": _t(scale["scale"])}
    _close(pL.rmsnorm(pscale, _t(x), 1e-6), jL.rmsnorm(scale, x, 1e-6), TOL32)
    _close(pattn._head_norm(pscale, _t(x)), jattn._head_norm(scale, x),
           TOL32)
    for pos in (np.arange(8)[None, :], np.full((2, 1), 5000)):
        xs = x[:, :pos.shape[1]]
        _close(pL.apply_rope(_t(xs), _t(pos), 1e6),
               jL.apply_rope(xs, pos, 1e6), TOL32)
    w = {k: (rng.randn(*s) / 8).astype(np.float32) for k, s in
         (("w_gate", (32, 64)), ("w_up", (32, 64)), ("w_down", (64, 32)))}
    h = rng.randn(2, 8, 32).astype(np.float32)
    _close(pL.mlp({k: _t(v) for k, v in w.items()}, _t(h)), jL.mlp(w, h),
           TOL32)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (False, None, 0), (True, 5, 0), (True, None, 3)])
def test_naive_attention_matches_reference(causal, window, q_offset):
    rng = np.random.RandomState(1)
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, 16, 2, 16).astype(np.float32) for _ in range(2))
    q = q[:, :16 - q_offset] if q_offset else q
    got = pattn.naive_attention(_t(q), _t(k[:, :q.shape[1] + q_offset]),
                                _t(v[:, :q.shape[1] + q_offset]),
                                causal=causal, window=window,
                                q_offset=q_offset)
    want = jattn.naive_attention(q, k[:, :q.shape[1] + q_offset],
                                 v[:, :q.shape[1] + q_offset], causal=causal,
                                 window=window, q_offset=q_offset)
    _close(got, want, TOL32)


@pytest.mark.parametrize("S,bq,bk,causal,window", [
    (32, 8, 16, True, None), (32, 16, 8, False, None),
    (32, 8, 8, True, 12),
    (64, 16, 32, True, 20),   # k tile start clamped; differs from naive
    (24, 512, 1024, True, None)])
def test_blocked_attention_matches_reference(S, bq, bk, causal, window):
    rng = np.random.RandomState(S + bq)
    q = rng.randn(2, S, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, S, 2, 16).astype(np.float32) for _ in range(2))
    got = pattn.blocked_attention(_t(q), _t(k), _t(v), causal=causal,
                                  window=window, block_q=bq, block_k=bk)
    want = jattn.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, block_q=bq, block_k=bk)
    _close(got, want, TOL32)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_dense_matches_reference(window):
    rng = np.random.RandomState(2)
    q = rng.randn(3, 1, 4, 16).astype(np.float32)
    kc, vc = (rng.randn(3, 10, 2, 16).astype(np.float32) for _ in range(2))
    cl = np.asarray([1, 6, 10], np.int32)
    got = pattn.decode_attention_dense(_t(q), _t(kc), _t(vc), _t(cl),
                                       window=window)
    want = jattn.decode_attention_dense(q, kc, vc, cl, window=window)
    _close(got, want, TOL32)


def test_attention_dispatch():
    rng = np.random.RandomState(3)
    q = _t(rng.randn(1, 16, 4, 32).astype(np.float32))
    k, v = (_t(rng.randn(1, 16, 2, 32).astype(np.float32)) for _ in range(2))
    outs = [pattn.attention(q, k, v, impl=i, block_q=8, block_k=8)
            for i in ("naive", "xla_blocked", "pallas_flash")]
    for o in outs[1:]:
        _close(o, outs[0], TOL32)
    with pytest.raises(ValueError, match="unknown attention impl"):
        pattn.attention(q, k, v, impl="sdpa")


# ---------------------------------------------------------------------------
# Params, caches, conversion
# ---------------------------------------------------------------------------

def _jax_params(cfg, dtype):
    override = jnp.float32 if dtype == "float32" else None
    return jax.device_get(jmaterialize(
        jax.random.PRNGKey(0), jlm.build_param_specs(cfg),
        dtype_override=override))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS_PORTED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_bit_exact(arch, dtype):
    ref = _jax_params(reduced_model(ARCHS[arch]), dtype)
    port = convert.tree_from_numpy(ref, "cpu")
    flat_ref, flat_port = _flat(ref), _flat(port)
    flat_back = _flat(convert.tree_to_numpy(port))
    assert flat_ref.keys() == flat_port.keys() == flat_back.keys()
    for key, a in flat_ref.items():
        t, back = flat_port[key], flat_back[key]
        assert t.shape == a.shape, key
        want_dt = torch.bfloat16 if a.dtype.name == "bfloat16" \
            else torch.float32
        assert t.dtype == want_dt, key
        assert np.array_equal(back.view(np.uint32),
                              a.astype(np.float32).view(np.uint32)), key
        again = convert.tensor_from_numpy(back, "cpu", dtype=t.dtype)
        assert torch.equal(again.view(torch.int16 if t.dtype ==
                                      torch.bfloat16 else torch.int32),
                           t.view(torch.int16 if t.dtype == torch.bfloat16
                                  else torch.int32)), key


@pytest.mark.parametrize("arch", ARCHS_PORTED)
def test_param_specs_and_cache_shapes_match_reference(arch):
    cfg = reduced_model(ARCHS[arch])
    pcfg = pconfigs.reduced_model(pconfigs.ARCHS[arch])
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    jspecs = _flat(jlm.build_param_specs(cfg))
    pspecs = _flat(plm.build_param_specs(pcfg))
    assert jspecs.keys() == pspecs.keys()
    for key, p in jspecs.items():
        q = pspecs[key]
        assert (q.shape, q.axes, q.init, q.scale, q.const) == \
            (p.shape, p.axes, p.init, p.scale, p.const), key
        assert str(q.dtype).split(".")[-1] == jnp.dtype(p.dtype).name, key
    params = pM.init_params(torch.Generator().manual_seed(0), pcfg,
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in _flat(params).items()} == \
        {k: p.shape for k, p in jspecs.items()}
    jc = jlm.cache_shapes(cfg, 3, 40)
    pc = pM.cache_shapes(pcfg, 3, 40)
    assert {k: (s.shape, jnp.dtype(s.dtype).name) for k, s in jc.items()} \
        == {k: (s.shape, str(s.dtype).split(".")[-1]) for k, s in pc.items()}
    cache = pM.init_cache(pcfg, 3, 40, device="cpu")
    assert all(int(t.abs().sum()) == 0 for t in cache.values())


def test_materialize_recipe_and_determinism():
    cfg = pconfigs.reduced_model(pconfigs.ARCHS["qwen3-4b"])
    specs = plm.build_param_specs(cfg)
    a = materialize(specs, generator=torch.Generator().manual_seed(7),
                    device="cpu")
    b = materialize(specs, generator=torch.Generator().manual_seed(7),
                    device="cpu", dtype_override=torch.float32)
    for x, y, p in zip(tree_leaves(a), tree_leaves(b), tree_leaves(specs)):
        assert x.dtype == p.dtype and y.dtype == torch.float32
        assert torch.equal(x, y.to(x.dtype))
        if p.init == "ones":
            assert bool((y == 1).all())
    w = b["blocks"]["layer0"]["mlp"]["w_gate"]          # (R, d, d_ff)
    fan_in = w.shape[0] * w.shape[1]
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.05


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    cfg = pconfigs.reduced_model(pconfigs.ARCHS["qwen3-4b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pM.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        materialize(plm.build_param_specs(cfg), generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pM.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tree_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="generator on cpu"):
        materialize(plm.build_param_specs(cfg), generator=torch.Generator(),
                    device="meta")


@pytest.mark.parametrize("arch,run_kw", [
    ("mixtral-8x22b", {}),
    ("mamba2-1.3b", {"quantize_weights": True}),
    ("whisper-base", {}),
    ("phi-3-vision-4.2b", {}), ("jamba-1.5-large-398b", {}),
    ("qwen3-4b", {"quantize_weights": True})])
def test_formerly_unported_kinds_match_reference(arch, run_kw):
    """The (arch, run option) pairs the port refused before its MoE,
    encoder-decoder, patch-input and int8 paths: prefill + 2 decode steps
    against the reference. int8 in bf16 (the reference's quantized blocks
    carried across; 3e-2 of the largest |logit|), the rest in fp32 with the
    reference jitted (1e-5 of it). int8 mamba2 is refused by both with a
    ValueError: its stacked 1-D conv_b is quantized as a 2-D weight with
    scales over the layer axis, which the reference's scan rejects
    (ROADMAP Queue 3)."""
    quant = run_kw.get("quantize_weights", False)
    dtype = "bfloat16" if quant else "float32"
    cfg, run, params, pcfg, prun, pparams, _ = _setup(arch, dtype)
    run = dataclasses.replace(run, **run_kw)
    prun = dataclasses.replace(prun, **run_kw)
    if quant:
        params = dict(params, blocks=jquant.quantize_arrays(params["blocks"]))
        pparams = convert.tree_from_numpy(jax.device_get(params), "cpu")
        assert any(t.dtype == torch.int8 for t in tree_leaves(pparams))
    jb, pb = families._batch(cfg, dtype, 8)
    if arch == "mamba2-1.3b":
        with pytest.raises(ValueError, match="leading axis sizes"):
            jM.forward_prefill(cfg, run, params,
                               dict(jb, tokens=jb["tokens"][:, :8]),
                               max_len=16)
        with pytest.raises(ValueError, match="not the 4 stacked repeats"):
            pM.forward_prefill(pcfg, prun, pparams,
                               dict(pb, tokens=pb["tokens"][:, :8]),
                               max_len=16)
        assert tuple(pparams["blocks"]["layer0"]["ssm"]["conv_b"][
            "scale"].shape) == (pcfg.ssm_expand * pcfg.d_model
                                + 2 * pcfg.ssm_state,)
        return
    wrap = (lambda f: f) if quant else jax.jit
    jl, jc = wrap(functools.partial(jM.forward_prefill, cfg, run,
                                    max_len=16))(
        params, dict(jb, tokens=jb["tokens"][:, :8]))
    pl, pc = pM.forward_prefill(pcfg, prun, pparams,
                                dict(pb, tokens=pb["tokens"][:, :8]),
                                max_len=16)
    tol = TOL16 if quant else TOL32
    families._close(pl, jl, tol)
    decode = wrap(functools.partial(jM.forward_decode, cfg, run))
    for i in (8, 9):
        jl, jc = decode(params, {"tokens": jb["tokens"][:, i:i + 1]}, jc)
        pl, pc = pM.forward_decode(pcfg, prun, pparams,
                                   {"tokens": pb["tokens"][:, i:i + 1]}, pc)
        families._close(pl, jl, tol)


# ---------------------------------------------------------------------------
# The slice: forward_prefill + forward_decode (and forward_train)
# ---------------------------------------------------------------------------

def _setup(arch, dtype, *, seq=16, **cfg_kw):
    cfg = dataclasses.replace(reduced_model(ARCHS[arch]), **cfg_kw)
    pcfg = dataclasses.replace(pconfigs.reduced_model(pconfigs.ARCHS[arch]),
                               **cfg_kw)
    shape = ShapeConfig("t", seq, 2, "train")
    run = RunConfig(model=cfg, shape=shape, remat=False,
                    attention_impl="pallas_flash")
    prun = PRunConfig(model=pcfg, shape=PShapeConfig("t", seq, 2, "train"),
                      remat=False, attention_impl="pallas_flash")
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
    for key in ("k", "v"):
        assert tuple(pc[key].shape) == jc[key].shape
        _close(pc[key], jc[key], tol)


@pytest.mark.parametrize("arch", ARCHS_PORTED)
@pytest.mark.parametrize("dtype,tol", [("float32", TOL32),
                                       ("bfloat16", TOL16)])
def test_prefill_decode_matches_reference(arch, dtype, tol):
    cfg, run, params, pcfg, prun, pparams, toks = _setup(arch, dtype)
    prompt, max_len = 8, 24
    jl, jc = jM.forward_prefill(cfg, run, params,
                                {"tokens": jnp.asarray(toks[:, :prompt])},
                                max_len=max_len)
    pl, pc = pM.forward_prefill(pcfg, prun, pparams,
                                {"tokens": torch.tensor(toks[:, :prompt])},
                                max_len=max_len)
    assert tuple(pl.shape) == jl.shape == (2, 1, cfg.padded_vocab)
    _close(pl, jl, tol)
    _check_caches(pc, jc, tol)
    for i in range(prompt, prompt + 8):
        tok = toks[:, i:i + 1]
        jl, jc = jM.forward_decode(cfg, run, params,
                                   {"tokens": jnp.asarray(tok)}, jc)
        pl, pc = pM.forward_decode(pcfg, prun, pparams,
                                   {"tokens": torch.tensor(tok)}, pc)
        _close(pl, jl, tol)
    _check_caches(pc, jc, tol)


@pytest.mark.parametrize("cfg_kw,max_len", [
    ({}, 8),                       # cache full: the last slot is rewritten
    ({"sliding_window": 6}, 24)])  # ring buffer of 6, windowed flash
def test_decode_cache_edges_match_reference(cfg_kw, max_len):
    cfg, run, params, pcfg, prun, pparams, toks = _setup(
        "llama3-8b", "float32", **cfg_kw)
    jl, jc = jM.forward_prefill(cfg, run, params,
                                {"tokens": jnp.asarray(toks[:, :8])},
                                max_len=max_len)
    pl, pc = pM.forward_prefill(pcfg, prun, pparams,
                                {"tokens": torch.tensor(toks[:, :8])},
                                max_len=max_len)
    _close(pl, jl, TOL32)
    for i in range(8, 12):
        tok = toks[:, i:i + 1]
        jl, jc = jM.forward_decode(cfg, run, params,
                                   {"tokens": jnp.asarray(tok)}, jc)
        pl, pc = pM.forward_decode(pcfg, prun, pparams,
                                   {"tokens": torch.tensor(tok)}, pc)
        _close(pl, jl, TOL32)
    _check_caches(pc, jc, TOL32)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL32),
                                       ("bfloat16", TOL16)])
def test_reference_caches_carry_across(dtype, tol):
    """The reference's prefill caches, carried to the port through numpy,
    decode in the port as they do in the reference."""
    cfg, run, params, pcfg, prun, pparams, toks = _setup("qwen3-4b", dtype)
    jl, jc = jM.forward_prefill(cfg, run, params,
                                {"tokens": jnp.asarray(toks[:, :8])},
                                max_len=16)
    pc = convert.tree_from_numpy(jax.device_get(jc), "cpu")
    assert pc["cache_len"].dtype == torch.int32
    assert pc["k"].dtype == (torch.float32 if dtype == "float32"
                             else torch.bfloat16)
    for i in range(8, 12):
        tok = toks[:, i:i + 1]
        jl, jc = jM.forward_decode(cfg, run, params,
                                   {"tokens": jnp.asarray(tok)}, jc)
        pl, pc = pM.forward_decode(pcfg, prun, pparams,
                                   {"tokens": torch.tensor(tok)}, pc)
        _close(pl, jl, tol)
    _check_caches(pc, jc, tol)


@pytest.mark.parametrize("arch", ARCHS_PORTED)
def test_forward_train_matches_reference(arch):
    cfg, run, params, pcfg, prun, pparams, toks = _setup(arch, "float32")
    jl, jaux = jM.forward_train(cfg, run, params,
                                {"tokens": jnp.asarray(toks)})
    pl, paux = pM.forward_train(pcfg, prun, pparams,
                                {"tokens": torch.tensor(toks)})
    assert tuple(pl.shape) == jl.shape == (2, 16, cfg.padded_vocab)
    _close(pl, jl, TOL32)
    assert float(paux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ARCHS_PORTED)
def test_decode_matches_teacher_forcing(arch):
    """The port's prefill + stepwise decode reproduce its own full-forward
    logits (fp32; the reference test's tolerances)."""
    pcfg = pconfigs.reduced_model(pconfigs.ARCHS[arch])
    prun = PRunConfig(model=pcfg, shape=PShapeConfig("t", 16, 2, "train"),
                      remat=False, attention_impl="pallas_flash")
    params = pM.init_params(torch.Generator().manual_seed(0), pcfg,
                            device="cpu", dtype_override=torch.float32)
    toks = torch.tensor(np.random.RandomState(0).randint(
        0, pcfg.vocab_size, (2, 16)), dtype=torch.int32)
    full, _ = pM.forward_train(pcfg, prun, params, {"tokens": toks})
    prompt = 8
    logits, caches = pM.forward_prefill(
        pcfg, prun, params, {"tokens": toks[:, :prompt]}, max_len=64)
    _close(logits[:, -1], full[:, prompt - 1], 2e-3)
    errs = []
    for i in range(prompt, 16):
        logits, caches = pM.forward_decode(
            pcfg, prun, params, {"tokens": toks[:, i:i + 1]}, caches)
        errs.append(float((logits[:, 0] - full[:, i]).abs().max()))
    assert max(errs) < 5e-3, errs
    assert caches["cache_len"].tolist() == [16, 16]


@pytest.mark.parametrize("prompt,departs", [(4, False), (8, True)])
def test_window_decode_after_long_prompt_departs_equally(prompt, departs):
    """A reference fault the port keeps (ROADMAP Queue 3): after a prompt
    longer than the sliding window, `_pad_prefill_caches` keeps the last
    `window` keys at ring slots 0..window-1, and decode then writes
    position p at slot p % window, over a key still in the window. Reduced
    llama3-8b, window 6, fp32, 6 decode steps against each package's own
    `forward_train`: a 4-token prompt decodes exactly, an 8-token one
    departs (errors of ~0.05-0.3), and the port's errors equal the
    reference's."""
    cfg, run, params, pcfg, prun, pparams, toks = _setup(
        "llama3-8b", "float32", sliding_window=6)
    n = prompt + 6
    jfull, _ = jM.forward_train(cfg, run, params,
                                {"tokens": jnp.asarray(toks[:, :n])})
    pfull, _ = pM.forward_train(pcfg, prun, pparams,
                                {"tokens": torch.tensor(toks[:, :n])})
    _close(pfull, jfull, TOL32)
    _, jc = jM.forward_prefill(cfg, run, params,
                               {"tokens": jnp.asarray(toks[:, :prompt])},
                               max_len=24)
    _, pc = pM.forward_prefill(pcfg, prun, pparams,
                               {"tokens": torch.tensor(toks[:, :prompt])},
                               max_len=24)
    jerr, perr = [], []
    for i in range(prompt, n):
        tok = toks[:, i:i + 1]
        jl, jc = jM.forward_decode(cfg, run, params,
                                   {"tokens": jnp.asarray(tok)}, jc)
        pl, pc = pM.forward_decode(pcfg, prun, pparams,
                                   {"tokens": torch.tensor(tok)}, pc)
        jerr.append(float(np.abs(_np(jl[:, 0]) - _np(jfull[:, i])).max()))
        perr.append(float(np.abs(_np(pl[:, 0]) - _np(pfull[:, i])).max()))
    np.testing.assert_allclose(perr, jerr, atol=TOL32, rtol=0)
    if departs:
        assert max(jerr) > 0.05 and max(perr) > 0.05, (jerr, perr)
    else:
        assert max(jerr) < 1e-4 and max(perr) < 1e-4, (jerr, perr)
