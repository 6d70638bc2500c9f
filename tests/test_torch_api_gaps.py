"""The reference names the port once lacked, and its encoder-decoder
trained on float32 frames, against the reference on the CPU.

* Whisper with float32 frames over bf16 weights: the encoder and the
  decoder from its first cross attention compute in float32 (layers.dot
  casts each weight at its use), as the reference's promotion does.
  `build_loss_fn`'s loss within 1e-5 (relative) of the reference's and
  every gradient leaf in its param's dtype, within 2^-7 of its largest
  |g_ref|: the gradients of bf16 weights are bf16 (8 significant bits,
  2^-8 relative), and the decoder's first self attention runs in bf16 in
  both packages. The decoder has one layer: at more than one the
  reference's `lax.scan` over the decoder blocks refuses its own promoted
  carry (bf16 in, float32 out), so its whisper smoke raises TypeError
  (ROADMAP Queue 3), where the port trains: `launch/train.py --arch
  whisper-base --smoke` runs on the CPU.
* `layers.unembed` == the reference's einsum on a reduced table.
* `OptConfig(sequential_updates=False)` gives the same step as True.
* `abstract_params` / `abstractify` / `param_bytes` /
  `optimizer.abstract_state(..., sharding_fn=)`: the reference's shapes,
  dtypes, byte counts and (through a `Sharder`) the specs, for every
  config, with no tensor made.
* Every `forward_*` with an explicit no-op `constrain` is bit-equal to
  the call without it.
* `repro_torch.core` re-exports the names `repro.core` does (the design
  registry, the specs, the legacy design points), each the port
  module's own object, and the registry lists the reference's designs.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_run_config as j_run_config  # noqa: E402
from repro.configs import reduced_model as j_reduced  # noqa: E402
from repro.configs.base import RunConfig as JRun  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.distributed.sharding import Sharder as JSharder  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.models import params as jparams  # noqa: E402
from repro.models.params import materialize as jmaterialize  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import ARCHS as P_ARCHS  # noqa: E402
from repro_torch.configs import get_run_config as p_run_config  # noqa: E402
from repro_torch.configs import reduced_model as p_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig as PRun  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.distributed.sharding import Sharder  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as pL  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.models import model as pM  # noqa: E402
from repro_torch.models import params as pparams_mod  # noqa: E402
from repro_torch.models.params import (TensorSpec, subtree,  # noqa: E402
                                       tree_items)
from repro_torch.train import optimizer as popt  # noqa: E402
from repro_torch.train import step as pstep  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dtype(t):
    return str(t).replace("torch.", "")


# ---------------------------------------------------------- whisper, fp32

def test_whisper_float32_frames_match_reference():
    B, S = 2, 40
    cfg, pcfg = (dataclasses.replace(r(a["whisper-base"]), n_layers=1)
                 for r, a in ((j_reduced, J_ARCHS), (p_reduced, P_ARCHS)))
    kw = dict(attn_block_q=8, attn_block_k=8, remat=False)
    run = JRun(model=cfg, shape=JShape("t", S, B, "train"), **kw)
    prun = PRun(model=pcfg, shape=PShape("t", S, B, "train"), **kw)
    params = jmaterialize(jax.random.PRNGKey(0), jlm.build_param_specs(cfg))
    pparams = convert.tree_from_numpy(jax.device_get(params), "cpu")
    rng = np.random.RandomState(5)
    b = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "frames": rng.randn(B, cfg.enc_len, cfg.d_model).astype(np.float32)}
    # the reference op by op: jit's fusion moves bf16 roundings
    (jl, _), jg = jax.value_and_grad(jstep.build_loss_fn(cfg, run),
                                     has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    (pl, _), pg = pstep.value_and_grad(pstep.build_loss_fn(pcfg, prun))(
        pparams, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(pl) - float(jl)) <= 1e-5 * abs(float(jl))
    jg = convert.tree_from_numpy(jax.device_get(jg), "cpu")
    for path, g in tree_items(pg):
        w = subtree(jg, path)
        assert g.dtype == w.dtype == subtree(pparams, path).dtype, path
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 2 ** -7 * scale, \
            path


def test_whisper_encoder_runs_in_the_frames_dtype():
    pcfg = p_reduced(P_ARCHS["whisper-base"])
    run = PRun(model=pcfg, shape=PShape("t", 16, 2, "train"),
               attn_block_q=8, attn_block_k=8)
    params = pM.init_params(torch.Generator().manual_seed(0), pcfg,
                            device="cpu")
    frames = torch.randn(2, pcfg.enc_len, pcfg.d_model)
    assert plm.encode(pcfg, run, params, frames).dtype == torch.float32
    assert plm.encode(pcfg, run, params,
                      frames.bfloat16()).dtype == torch.bfloat16
    logits, _ = plm.forward_train(pcfg, run, params, {
        "tokens": torch.zeros(2, 16, dtype=torch.int32), "frames": frames})
    assert logits.dtype == torch.float32


def test_whisper_smoke_launcher_trains_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import train as launcher
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "whisper-base", "--smoke", "--steps", "2",
        "--seq-len", "16", "--batch", "2", "--device", "cpu"])
    launcher.main()
    assert "first loss" in capsys.readouterr().out


# ------------------------------------------------------------ API names

def test_unembed_matches_reference():
    rng = np.random.RandomState(0)
    table = rng.randn(96, 32).astype(np.float32)
    x = rng.randn(2, 5, 32).astype(np.float32)
    want = np.asarray(jL.unembed({"table": jnp.asarray(table)},
                                 jnp.asarray(x)))
    got = pL.unembed({"table": torch.from_numpy(table)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # bf16 activations over a float32 table compute in float32, as JAX
    got16 = pL.unembed({"table": torch.from_numpy(table)},
                       torch.from_numpy(x).bfloat16())
    assert got16.dtype == torch.float32


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_sequential_updates_give_the_same_step(name):
    cfg = p_reduced(P_ARCHS["qwen3-4b"])
    run = PRun(model=cfg, shape=PShape("t", 16, 2, "train"),
               attn_block_q=8, attn_block_k=8)
    rng = np.random.RandomState(3)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 16))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    out = {}
    for seq in (True, False):
        ocfg = popt.OptConfig(name=name, lr=1e-3, warmup_steps=2,
                              sequential_updates=seq)
        params = pM.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu", dtype_override=torch.float32)
        out[seq] = pstep.build_train_step(cfg, run, ocfg)(
            params, popt.init(params, ocfg), batch)
    for path, p in tree_items(out[True][0]):
        assert torch.equal(p, subtree(out[False][0], path)), path
    assert jopt.OptConfig().sequential_updates == \
        popt.OptConfig().sequential_updates


def _stub_mesh(names, shape):
    return (types.SimpleNamespace(shape=dict(zip(names, shape)),
                                  axis_names=names),
            types.SimpleNamespace(shape=shape, mesh_dim_names=names))


@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_abstract_params_match_reference(arch, monkeypatch):
    made = []
    for fn in ("empty", "zeros", "randn", "full", "ones", "tensor"):
        real = getattr(torch, fn)

        def spy(*a, _real=real, **k):
            made.append(a)
            return _real(*a, **k)
        monkeypatch.setattr(torch, fn, spy)
    shape_name = "train_4k"
    jrun, prun = j_run_config(arch, shape_name), p_run_config(arch,
                                                              shape_name)
    jmesh, pmesh = _stub_mesh(("data", "model"), (16, 16))
    jsh, psh = JSharder(jmesh, jrun), Sharder(pmesh, prun)
    for quantize in (False, True):
        want = jM.abstract_params(jrun.model, quantize=quantize)
        got = pM.abstract_params(prun.model, quantize=quantize)
        spec_got = pM.abstract_params(prun.model, psh.param_spec, quantize)
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        items = tree_items(got)
        assert len(items) == len(flat)
        for (path, g), (jpath, w) in zip(items, flat):
            assert "/".join(path) == "/".join(k.key for k in jpath)
            assert isinstance(g, TensorSpec) and g.sharding is None
            assert tuple(g.shape) == tuple(w.shape)
            assert _dtype(g.dtype) == str(w.dtype)
        assert pparams_mod.param_bytes(got) == jparams.param_bytes(want)
        assert pparams_mod.param_bytes(pM.param_specs(prun.model, quantize)) \
            == jparams.param_bytes(want)
        specs = dict(jlm.build_param_specs(jrun.model))
        if quantize:
            from repro.models.quant import quantize_spec_tree
            specs["blocks"] = quantize_spec_tree(specs["blocks"])
        jleaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, jparams.Param))
        for (path, g), jp in zip(tree_items(spec_got), jleaves):
            assert g.sharding == tuple(jsh.param_spec(jp)), path
    assert made == []


@pytest.mark.parametrize("opt", [dict(name="adamw"),
                                 dict(name="adamw", bf16_moments=True),
                                 dict(name="adafactor")])
def test_abstract_state_sharding_matches_reference(opt):
    jrun = j_run_config("jamba-1.5-large-398b", "train_4k")
    prun = p_run_config("jamba-1.5-large-398b", "train_4k")
    jmesh, pmesh = _stub_mesh(("pod", "data", "model"), (2, 16, 16))
    jsh, psh = JSharder(jmesh, jrun), Sharder(pmesh, prun)
    jspecs = jlm.build_param_specs(jrun.model)
    # the reference's `abstract_state` wraps each sharding in a
    # ShapeDtypeStruct, which needs a mesh of devices: read its specs
    # through a stand-in that records them
    recorded = []

    def record(p):
        recorded.append(repr((tuple(p.shape), tuple(jsh.param_spec(p)))))
        return None

    jopt.abstract_state(jspecs, jopt.OptConfig(**opt), record)
    got = popt.abstract_state(plm.build_param_specs(prun.model),
                              popt.OptConfig(**opt), psh.param_spec)
    specs = [repr((tuple(s.shape), s.sharding)) for _, s in tree_items(got)
             if s.shape != ()]
    # the same moments with the same specs (the reference visits vr before
    # vc, sorted keys put vc first)
    assert sorted(specs) == sorted(recorded)
    want = jopt.abstract_state(jspecs, jopt.OptConfig(**opt))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, g), (_, w) in zip(tree_items(got), flat):
        assert tuple(g.shape) == tuple(w.shape)
        assert _dtype(g.dtype) == str(w.dtype)


# ------------------------------------------------------ the no-op hooks

@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-1.3b", "olmoe-1b-7b",
                                  "whisper-base", "phi-3-vision-4.2b"])
def test_noop_constrain_is_bit_equal(arch):
    cfg = p_reduced(P_ARCHS[arch])
    run = PRun(model=cfg, shape=PShape("t", 16, 2, "train"),
               attn_block_q=8, attn_block_k=8, remat=False)
    params = pM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu", dtype_override=torch.float32)
    g = torch.Generator().manual_seed(1)
    n_text = 16 - (cfg.n_patches or 0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, n_text),
                                     generator=g, dtype=torch.int32)}
    if cfg.n_patches:
        batch["patch_embeds"] = torch.randn(2, cfg.n_patches, cfg.d_model,
                                            generator=g)
    if cfg.is_enc_dec:
        batch["frames"] = torch.randn(2, cfg.enc_len, cfg.d_model,
                                      generator=g)
    seen = []

    def noop(x, axes):
        seen.append(axes)
        return x

    a, _ = plm.forward_train(cfg, run, params, batch)
    b, _ = plm.forward_train(cfg, run, params, batch, noop)
    assert torch.equal(a, b) and seen
    la, ca = plm.forward_prefill(cfg, run, params, batch, 24)
    lb, cb = plm.forward_prefill(cfg, run, params, batch, 24, noop)
    assert torch.equal(la, lb)
    tok = {"tokens": torch.ones(2, 1, dtype=torch.int32)}
    da, _ = plm.forward_decode(cfg, run, params, tok, ca)
    n = len(seen)
    db, _ = plm.forward_decode(cfg, run, params, tok, cb, constrain=noop)
    assert torch.equal(da, db) and len(seen) > n
    for key in ca:
        assert torch.equal(ca[key], cb[key]), key


def test_core_reexports_the_reference_names():
    """`repro_torch.core` exports every public name of `repro.core` that
    is not a submodule, each the object of the port's `design` or `mask`
    module, and the two registries list the same designs."""
    import importlib
    import types as _types

    import repro.core as j_core
    import repro_torch.core as p_core
    from repro_torch.core import mask as p_mask
    # the module, which the package's `design` (the function) shadows
    p_design = importlib.import_module("repro_torch.core.design")

    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not isinstance(getattr(mod, n), _types.ModuleType)}
    want = names(j_core)
    assert want == {"ALL_DESIGNS", "BypassSpec", "Design", "DesignPoint",
                    "DramSpec", "MaskConfig", "PartitionSpec", "TokenSpec",
                    "TranslationSpec", "design", "get_design", "list_designs",
                    "register_design"}
    assert names(p_core) == want
    for n in want:
        home = p_mask if n in ("ALL_DESIGNS", "DesignPoint", "MaskConfig",
                               "design") else p_design
        assert getattr(p_core, n) is getattr(home, n), n
    assert p_core.list_designs() == j_core.list_designs()
    assert p_core.ALL_DESIGNS == j_core.ALL_DESIGNS
    assert p_core.design("mask").name == j_core.design("mask").name
