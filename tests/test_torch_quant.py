"""Parity of the port's int8 weight-only path (`repro_torch.models.quant`)
with the reference's `repro.models.quant` on the CPU.

* `quantize_arrays` on the same bf16 weights gives bit-equal int8 and
  float32 scales: a 2-D weight (per out-channel), a stacked 3-D block
  weight and a stacked 4-D expert stack (per leading slice and
  out-channel), an unstacked 3-D expert stack; float32 and 1-D leaves
  pass through.
* `dequant_tree` of the carried {"q", "scale"} leaves is bit-equal to the
  reference's, and within the reference's round-trip law (|err| <= 1.01
  scale) of the bf16 weight.
* `model.param_specs(cfg, quantize=True)` has the leaves, shapes and
  dtypes of the reference's `abstract_params(cfg, quantize=True)` (dense,
  MoE with stacked experts, the hybrid's unstacked period).
* Decode with int8 weights (`quantize_weights=True`): the port's bf16
  prefill caches carried to both packages, one decode step each on the
  reference's {"q", "scale"} (carried across for the port): the logits
  within the bf16 parity tolerance (3e-2 of the largest |logit|, as
  `tests/test_torch_model_families.py` holds bf16). For dense llama3-8b
  and MoE olmoe-1b-7b also the reference's own int8-vs-bf16 law
  (`tests/test_quant.py`: max |diff| / std(bf16 logits) < 0.1) against the
  port's bf16 decode; reduced jamba misses that law in the reference
  itself (0.150), so it is held to the reference's int8 logits only.
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
from repro.models import model as jM  # noqa: E402
from repro.models import quant as jq  # noqa: E402
from repro.models.params import materialize as jmaterialize  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.configs.base import RunConfig as PRunConfig  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShapeConfig  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as pM  # noqa: E402
from repro_torch.models import quant as pq  # noqa: E402

TOL16 = 3e-2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _bits(x):
    a = convert.tensor_to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                        else x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("shape", [(16, 24), (3, 16, 24), (2, 4, 16, 24),
                                   (4, 16, 24)])
def test_quantize_and_dequant_bit_equal(shape):
    w = (np.random.RandomState(len(shape)).randn(*shape) * 0.3).astype(
        np.float32)
    w[..., 0] = 0.0                    # an all-zero channel: the 1e-8 floor
    jw = jnp.asarray(w, jnp.bfloat16)
    tree = {"w": jw, "norm": jnp.ones((24,), jnp.bfloat16),
            "f32": jnp.asarray(w, jnp.float32)}
    ref = jax.device_get(jq.quantize_arrays(tree))
    got = pq.quantize_arrays(convert.tree_from_numpy(jax.device_get(tree),
                                                     "cpu"))
    assert pq.is_qleaf(got["w"]) and jq.is_qleaf(ref["w"])
    assert got["w"]["q"].dtype == torch.int8
    assert got["w"]["scale"].dtype == torch.float32
    want_scale = (shape[0], shape[-1]) if len(shape) >= 3 else (shape[-1],)
    assert tuple(got["w"]["scale"].shape) == ref["w"]["scale"].shape \
        == want_scale
    assert np.array_equal(got["w"]["q"].numpy(), ref["w"]["q"])
    assert np.array_equal(_bits(got["w"]["scale"]), _bits(ref["w"]["scale"]))
    for key in ("norm", "f32"):
        assert not isinstance(got[key], dict)
    # dequant: the carried leaves, both packages
    carried = convert.tree_from_numpy(ref, "cpu")
    assert carried["w"]["q"].dtype == torch.int8
    back = pq.dequant_tree(carried)
    jback = jq.dequant_tree(ref)
    assert back["w"].dtype == torch.bfloat16
    assert np.array_equal(_bits(back["w"]), _bits(jback["w"]))
    err = np.abs(convert.tensor_to_numpy(back["w"])
                 - np.asarray(jw.astype(jnp.float32)))
    scale = convert.tensor_to_numpy(got["w"]["scale"])
    if len(shape) >= 3:
        scale = scale.reshape((shape[0],) + (1,) * (len(shape) - 2)
                              + (shape[-1],))
    assert np.all(err <= scale * 1.01 + 1e-4)


@pytest.mark.parametrize("arch", ["mistral-large-123b", "olmoe-1b-7b",
                                  "jamba-1.5-large-398b"])
def test_quantized_specs_match_reference(arch):
    cfg = reduced_model(ARCHS[arch])
    pcfg = pconfigs.reduced_model(pconfigs.ARCHS[arch])
    want = _flat(jM.abstract_params(cfg, quantize=True))
    got = _flat(pM.param_specs(pcfg, quantize=True))
    assert want.keys() == got.keys()
    n_int8 = 0
    for key, s in want.items():
        p = got[key]
        assert tuple(p.shape) == s.shape, key
        assert str(p.dtype).split(".")[-1] == jnp.dtype(s.dtype).name, key
        n_int8 += p.dtype == torch.int8
        if key.endswith("/scale"):
            assert p.init == "ones"
    assert n_int8 > 0


def _quant_setup(arch):
    cfg = reduced_model(ARCHS[arch])
    pcfg = pconfigs.reduced_model(pconfigs.ARCHS[arch])
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 16, 2, "decode"),
                    remat=False, attn_block_q=16, attn_block_k=16)
    prun = PRunConfig(model=pcfg, shape=PShapeConfig("t", 16, 2, "decode"),
                      remat=False, attn_block_q=16, attn_block_k=16)
    params = jmaterialize(jax.random.PRNGKey(0), jlm.build_param_specs(cfg))
    return cfg, run, params, pcfg, prun


def _to_reference(caches):
    """The port's caches as the reference's arrays (bf16 stays bf16)."""
    return {k: jnp.asarray(convert.tensor_to_numpy(v),
                           jnp.bfloat16 if v.dtype == torch.bfloat16
                           else None) for k, v in caches.items()}


@pytest.mark.parametrize("arch,law", [("llama3-8b", True),
                                      ("olmoe-1b-7b", True),
                                      ("jamba-1.5-large-398b", False)])
def test_int8_decode_matches_reference(arch, law):
    """The port's bf16 prefill caches go to both packages; one decode step
    with int8 weights in each. Reduced jamba misses the int8-vs-bf16 law in
    the reference itself (0.150 there: its MoE routing moves with the
    quantized weights), so it is held to the reference's int8 logits only."""
    cfg, run, params, pcfg, prun = _quant_setup(arch)
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 8))
    pparams = convert.tree_from_numpy(jax.device_get(params), "cpu")
    lg, pcaches = pM.forward_prefill(
        pcfg, prun, pparams, {"tokens": torch.tensor(toks, dtype=torch.int32)},
        max_len=32)
    tok = lg[:, -1].argmax(-1, keepdim=True).int()
    jcaches = _to_reference(pcaches)
    pbf16, _ = pM.forward_decode(pcfg, prun, pparams, {"tokens": tok},
                                 {k: v.clone() for k, v in pcaches.items()})
    runq = dataclasses.replace(run, quantize_weights=True)
    qparams = dict(params, blocks=jq.quantize_arrays(params["blocks"]))
    jout, _ = jM.forward_decode(cfg, runq, qparams,
                                {"tokens": jnp.asarray(tok.numpy())}, jcaches)
    pparams_q = convert.tree_from_numpy(jax.device_get(qparams), "cpu")
    assert any(t.dtype == torch.int8 for t in _flat(pparams_q).values())
    pout, _ = pM.forward_decode(
        pcfg, dataclasses.replace(prun, quantize_weights=True), pparams_q,
        {"tokens": tok}, pcaches)
    want = np.asarray(jout.astype(jnp.float32))
    got = convert.tensor_to_numpy(pout)
    np.testing.assert_allclose(got, want, rtol=TOL16,
                               atol=TOL16 * max(1.0, np.abs(want).max()))
    if law:
        ref = convert.tensor_to_numpy(pbf16)
        rel = np.abs(got - ref).max() / max(float(ref.std()), 1e-6)
        assert rel < 0.1, rel


def test_quantize_arrays_on_port_params_equals_carried():
    """The port's own quantization of the carried bf16 blocks equals the
    reference's, leaf for leaf (olmoe's stacked blocks: 3-D block weights
    and 4-D expert stacks)."""
    cfg, run, params, pcfg, prun = _quant_setup("olmoe-1b-7b")
    ref = _flat(jax.device_get(jq.quantize_arrays(params["blocks"])))
    got = _flat(pq.quantize_arrays(convert.tree_from_numpy(
        jax.device_get(params["blocks"]), "cpu")))
    assert ref.keys() == got.keys()
    for key, a in ref.items():
        assert np.array_equal(_bits(got[key]), _bits(a)), key
