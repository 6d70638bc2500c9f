"""Parity of the port's model families past the dense and Mamba2 ones with
the reference on the CPU: MoE (olmoe-1b-7b, mixtral-8x22b with its
sliding window), the hybrid (jamba-1.5-large-398b: Mamba2 and attention
layers, MoE FFNs every 2nd layer), the encoder-decoder (whisper-base) and
patch inputs (phi-3-vision-4.2b), each reduced (`reduced_model`).

* Param specs, cache shapes (cross k/v included) and input specs equal
  the reference's; the reference's bf16 params carry across and back bit
  for bit (`models/convert.py`).
* The reference's params (fp32 and bf16) carried across, the same seeded
  tokens, frames and patch embeddings: `forward_train` (logits and the
  MoE aux loss), `forward_prefill` (logits and caches) and 4
  `forward_decode` steps against the reference, `attention_impl=
  "xla_blocked"` with 8-row blocks on both sides (the reference's fp32
  calls under `jax.jit`, its bf16 calls op by op). Limits relative to the
  largest |value| as `tests/test_torch_mamba2.py` has them (whisper's tied
  embedding makes logits of ~140): fp32 1e-5 of it (measured ~2e-7 of
  it), bf16 3e-2 of it (measured: one bf16 step, 2^-8 to 2^-6 of it).
* The port's prefill + decode reproduce its own `forward_train` (fp32,
  the reference test's 2e-3 / 5e-3), with `capacity_factor = n_experts`
  so that no token is dropped: capacity is per group, and a 16-token
  forward and 1-token decode groups would drop different tokens.
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
from repro.models import lm as jlm  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models.params import materialize as jmaterialize  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.configs.base import RunConfig as PRunConfig  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShapeConfig  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.models import model as pM  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
FAMILIES = ["olmoe-1b-7b", "mixtral-8x22b", "jamba-1.5-large-398b",
            "whisper-base", "phi-3-vision-4.2b"]
PROMPT, STEPS, BLOCK = 8, 4, 8


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.tensor_to_numpy(x)
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _cfgs(arch, **kw):
    return (dataclasses.replace(reduced_model(ARCHS[arch]), **kw),
            dataclasses.replace(pconfigs.reduced_model(pconfigs.ARCHS[arch]),
                                **kw))


def _name(dt):
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) \
        else jnp.dtype(dt).name


@pytest.mark.parametrize("arch", FAMILIES)
def test_specs_and_cache_shapes_match_reference(arch):
    cfg, pcfg = _cfgs(arch)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    jspecs = _flat(jlm.build_param_specs(cfg))
    pspecs = _flat(plm.build_param_specs(pcfg))
    assert jspecs.keys() == pspecs.keys()
    for key, p in jspecs.items():
        q = pspecs[key]
        assert (q.shape, q.axes, q.init, q.scale, q.const) == \
            (p.shape, p.axes, p.init, p.scale, p.const), key
        assert _name(q.dtype) == _name(p.dtype), key
    jc, pc = jlm.cache_shapes(cfg, 3, 40), pM.cache_shapes(pcfg, 3, 40)
    assert {k: (s.shape, _name(s.dtype)) for k, s in jc.items()} == \
        {k: (s.shape, _name(s.dtype)) for k, s in pc.items()}
    assert ("cross_k" in pc) == cfg.is_enc_dec
    for kind, seq in (("train", 32), ("prefill", 32), ("decode", 32)):
        shape = ShapeConfig("t", seq, 2, kind)
        js = jM.input_specs(cfg, shape)
        ps = pM.input_specs(pcfg, PShapeConfig("t", seq, 2, kind))
        assert {k: (s.shape, _name(s.dtype)) for k, s in js.items()} == \
            {k: (s.shape, _name(s.dtype)) for k, s in ps.items()}
    params = pM.init_params(torch.Generator().manual_seed(0), pcfg,
                            device="cpu")
    assert {k: tuple(v.shape) for k, v in _flat(params).items()} == \
        {k: p.shape for k, p in jspecs.items()}


@pytest.mark.parametrize("arch", FAMILIES)
def test_convert_round_trip_bit_exact(arch):
    cfg, _ = _cfgs(arch)
    ref = jax.device_get(jmaterialize(jax.random.PRNGKey(0),
                                      jlm.build_param_specs(cfg)))
    port = convert.tree_from_numpy(ref, "cpu")
    flat_ref, flat_port = _flat(ref), _flat(port)
    flat_back = _flat(convert.tree_to_numpy(port))
    assert flat_ref.keys() == flat_port.keys() == flat_back.keys()
    for key, a in flat_ref.items():
        t = flat_port[key]
        assert t.shape == a.shape and _name(t.dtype) == a.dtype.name, key
        assert np.array_equal(flat_back[key].view(np.uint32),
                              a.astype(np.float32).view(np.uint32)), key


def _batch(cfg, dtype, n_text, seed=0):
    """Seeded tokens (2, n_text + STEPS) and, as the config needs them,
    patch embeddings and frames in `dtype` (numpy float32 values)."""
    rng = np.random.RandomState(seed)
    out = {"tokens": rng.randint(0, cfg.vocab_size,
                                 (2, n_text + STEPS)).astype(np.int32)}
    if cfg.n_patches:
        out["patch_embeds"] = rng.randn(2, cfg.n_patches, cfg.d_model) * .5
    if cfg.is_enc_dec:
        out["frames"] = rng.randn(2, cfg.enc_len, cfg.d_model) * .5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    pdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jb = {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, jdt)
          for k, v in out.items()}
    pb = {k: torch.tensor(v) if k == "tokens"
          else torch.tensor(v, dtype=torch.float32).to(pdt)
          for k, v in out.items()}
    return jb, pb


def _runs(cfg, pcfg, seq):
    kw = dict(remat=False, attention_impl="xla_blocked", attn_block_q=BLOCK,
              attn_block_k=BLOCK)
    return (RunConfig(model=cfg, shape=ShapeConfig("t", seq, 2, "train"),
                      **kw),
            PRunConfig(model=pcfg, shape=PShapeConfig("t", seq, 2, "train"),
                       **kw))


def _check_caches(pc, jc, tol):
    assert pc.keys() == set(jc.keys())
    assert np.array_equal(_np(pc["cache_len"]), np.asarray(jc["cache_len"]))
    for key in pc:
        assert tuple(pc[key].shape) == jc[key].shape, key
        _close(pc[key], jc[key], tol)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_reference(arch, dtype):
    cfg, pcfg = _cfgs(arch)
    tol = TOL[dtype]
    n_text = 2 * PROMPT
    run, prun = _runs(cfg, pcfg, cfg.n_patches + n_text)
    params = jmaterialize(jax.random.PRNGKey(0), jlm.build_param_specs(cfg),
                          dtype_override=jnp.float32 if dtype == "float32"
                          else None)
    pparams = convert.tree_from_numpy(jax.device_get(params), "cpu")
    jb, pb = _batch(cfg, dtype, n_text)
    toks = jb["tokens"]

    def first(b, n):
        return dict(b, tokens=b["tokens"][:, :n])

    # the reference's fp32 calls jitted (4x quicker than op by op for
    # jamba's Mamba layers; float32 either way), its bf16 calls op by op
    # (fusion under jit moves bf16 roundings)
    wrap = jax.jit if dtype == "float32" else (lambda f: f)
    train = wrap(functools.partial(jM.forward_train, cfg, run))
    prefill = wrap(functools.partial(jM.forward_prefill, cfg, run,
                                     max_len=32))
    decode = wrap(functools.partial(jM.forward_decode, cfg, run))
    jl, jaux = train(params, first(jb, n_text))
    pl, paux = pM.forward_train(pcfg, prun, pparams, first(pb, n_text))
    assert tuple(pl.shape) == jl.shape == (2, cfg.n_patches + n_text,
                                           cfg.padded_vocab)
    _close(pl, jl, tol)
    if cfg.is_moe:
        assert float(jaux) > 0
    np.testing.assert_allclose(float(paux), float(jaux), rtol=tol, atol=tol)

    n_prompt = n_text - PROMPT
    jl, jc = prefill(params, first(jb, n_prompt))
    pl, pc = pM.forward_prefill(pcfg, prun, pparams, first(pb, n_prompt),
                                max_len=32)
    assert tuple(pl.shape) == jl.shape == (2, 1, cfg.padded_vocab)
    _close(pl, jl, tol)
    _check_caches(pc, jc, tol)
    for i in range(n_prompt, n_prompt + STEPS):
        tok = np.asarray(toks[:, i:i + 1])
        jl, jc = decode(params, {"tokens": jnp.asarray(tok)}, jc)
        pl, pc = pM.forward_decode(pcfg, prun, pparams,
                                   {"tokens": torch.tensor(tok)}, pc)
        _close(pl, jl, tol)
    _check_caches(pc, jc, tol)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_teacher_forcing(arch):
    """The port alone: prefill + stepwise decode == its `forward_train`."""
    _, pcfg = _cfgs(arch)
    if pcfg.is_moe:
        pcfg = dataclasses.replace(pcfg,
                                   capacity_factor=float(pcfg.n_experts))
    n_text = 2 * PROMPT
    _, prun = _runs(pcfg, pcfg, pcfg.n_patches + n_text)
    prun = dataclasses.replace(prun, attention_impl="pallas_flash")
    params = pM.init_params(torch.Generator().manual_seed(0), pcfg,
                            device="cpu", dtype_override=torch.float32)
    _, pb = _batch(pcfg, "float32", n_text, seed=1)
    batch = dict(pb, tokens=pb["tokens"][:, :n_text])
    full, _ = pM.forward_train(pcfg, prun, params, batch)
    off = pcfg.n_patches
    n_prompt = n_text - PROMPT
    logits, caches = pM.forward_prefill(
        pcfg, prun, params, dict(batch, tokens=batch["tokens"][:, :n_prompt]),
        max_len=32)
    _close(logits[:, -1], full[:, off + n_prompt - 1], 2e-3)
    for i in range(n_prompt, n_text):
        logits, caches = pM.forward_decode(
            pcfg, prun, params, {"tokens": batch["tokens"][:, i:i + 1]},
            caches)
        _close(logits[:, 0], full[:, off + i], 5e-3)
    assert caches["cache_len"].tolist() == [off + n_text] * 2


@pytest.mark.parametrize("S,enc_len", [(16, 24), (1024, 1025)])
def test_cross_attention_matches_reference(S, enc_len):
    """Whisper's cross attention, both of the reference's forms: naive at
    S * enc_len <= 2**20, q-blocked with the whole k/v past it (1024 x
    1025 rows; 8-row q blocks), fp32, from projected frames and from the
    cached k/v."""
    cfg, pcfg = _cfgs("whisper-base")
    run, prun = _runs(cfg, pcfg, S)
    params = jax.device_get(jmaterialize(
        jax.random.PRNGKey(0), jlm.build_param_specs(cfg),
        dtype_override=jnp.float32))
    lp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])["layer0"]
    plp = convert.tree_from_numpy(lp, "cpu")
    rng = np.random.RandomState(S)
    x = (rng.randn(1, S, cfg.d_model) * .5).astype(np.float32)
    enc = (rng.randn(1, enc_len, cfg.d_model) * .5).astype(np.float32)
    jo, (jk, jv) = jlm._cross_attention(cfg, run, lp, x, enc_out=enc)
    po, (pk, pv) = plm._cross_attention(pcfg, prun, plp, torch.tensor(x),
                                        enc_out=torch.tensor(enc))
    _close(po, jo, TOL["float32"])
    _close(pk, jk, TOL["float32"])
    jo1, _ = jlm._cross_attention(cfg, run, lp, x[:, :1], cross_kv=(jk, jv))
    po1, _ = plm._cross_attention(pcfg, prun, plp, torch.tensor(x[:, :1]),
                                  cross_kv=(pk, pv))
    _close(po1, jo1, TOL["float32"])
