"""DeepSeek-V2-Lite on the port, on the CPU: latent attention (MLA) with YaRN
RoPE, a leading dense layer and routed plus shared experts, held to the
benchmark's plain reference (`portbench/reference/mla_lm.py`, float32),
which imports nothing of the program, on seeded random weights at a small
size (`prefill_mla.TINY`: 3 layers, d_model 64, 4 heads with q/k of 16 +
16 and v of 16, a 32-wide latent, 8 experts top 3 and 2 shared).

* `forward_prefill`'s last-token logits and latent caches, in float32, on
  each attention route, equal the reference's to float32 rounding, at a
  length where experts drop assignments past their capacity; the same
  program in bf16 misses those tolerances.
* Prefill, then decode through the latent cache, equals the reference's
  full forward at every position (no drops: a decode step routes the
  batch as one group, so only a capacity that drops nothing makes the
  two routings the same).
* YaRN at the published numbers: pairs 0-10 unscaled, 23-31 divided by
  40, mscale 1.2608, softmax scale 0.114721.
* The MoE: unnormalised top-k gates and the shared experts equal the
  reference's; olmoe's routing (normalised, no shared experts) is as it
  was.
* The registry: the published widths and 15.71 B parameters, and the
  reference-parity lists (`ARCHS`, `all_cells()`) without the new arch.
* The flash op with v narrower than q and k and a given scale, on the CPU
  route and the kernel's fake branch: outputs, the split plan, the work
  count and the refusals.
* The program's spans `model.mla` (with the latent's bytes) and
  `model.moe.shared`, recorded only under a profiler.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.entries import prefill as prefill_entry  # noqa: E402
from portbench.entries import prefill_mla  # noqa: E402
from portbench.reference import mla_lm  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.configs import (ARCHS, PORT_ARCHS, all_cells,  # noqa: E402
                                 get_model)
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import attention, layers, lm, model, moe  # noqa: E402

ARCH = "deepseek-v2-lite"
CONFIG = json.loads((ROOT / "portbench" / "configs" / f"{ARCH}.json")
                    .read_text())
# float32 against float32: the products run in other orders (blocked or
# whole softmax, batched or looped experts), each rounding ~6e-8 relative;
# through 3 layers that stays below 1e-6. 1e-5 leaves ten times that, and
# lies 400x under bf16's rounding step (2^-8), which the bf16 test misses.
TOL32 = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny(**kw):
    """(the program's ModelConfig, the reference's config dict)."""
    over = dict(prefill_mla.TINY["config"], **kw)
    return (dataclasses.replace(get_model(ARCH), **over),
            dict(CONFIG, **over))


def weights(prog, seed, dtype=torch.float32):
    params = prefill_entry.make_weights(prog, seed, "cpu")
    return _tree_to(params, dtype) if dtype != torch.bfloat16 else params


def _tree_to(tree, dtype):
    return {k: _tree_to(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def ref_weights(params, prog):
    return prefill_mla.reference_weights(params, prog.n_layers,
                                         prog.first_dense_layers)


def tokens(B, S, seed, vocab=512):
    return torch.randint(0, vocab, (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))


def run_cfg(prog, impl, B=2, S=128):
    return RunConfig(model=prog, shape=ShapeConfig("p", S, B, "prefill"),
                     remat=False, attention_impl=impl, attn_block_q=32,
                     attn_block_k=64)


def rel(got, want, dims):
    return prefill_entry.rel_err(got, want, dims)


# ---------------------------------------------------------------- prefill

def _prefill_errors(prog, cfg, params, tok, impl):
    dropped = []
    real = moe.moe_apply

    def probe(*a, **kw):
        out, aux = real(*a, **kw)
        dropped.append(float(aux["dropped_frac"]))
        return out, aux
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "moe_apply", probe)
        logits, caches = model.forward_prefill(
            prog, run_cfg(prog, impl), params, {"tokens": tok},
            max_len=tok.shape[1] + 16)
    latents = []
    want = mla_lm.prefill(cfg, ref_weights(params, prog), [tok],
                          lambda r, i, lat: latents.append(lat))[0]
    S = tok.shape[1]
    cache_errs = [float(rel(caches["latent"][0, r, :, :S], lat,
                            (1, 2)).max()) for r, lat in enumerate(latents)]
    assert not caches["latent"][:, :, :, S:].any()
    assert caches["cache_len"].tolist() == [S] * tok.shape[0]
    return (float(rel(logits[:, -1], want, 1).max()), cache_errs,
            max(dropped))


@pytest.mark.parametrize("impl", ["pallas_flash", "xla_blocked", "naive"])
def test_prefill_equals_reference_in_float32(impl):
    prog, cfg = tiny()
    params = weights(prog, 11)
    logit_err, cache_errs, dropped = _prefill_errors(
        prog, cfg, params, tokens(2, 128, 3), impl)
    assert dropped > 0                 # capacity drops some assignments
    assert logit_err < TOL32
    assert max(cache_errs) < TOL32 and len(cache_errs) == prog.n_layers


def test_bf16_misses_the_float32_tolerances():
    """The program in bf16, the precision the cell runs, is no float32
    computation: it misses both the logits' and layer 0's tolerance."""
    prog, cfg = tiny()
    params = weights(prog, 11, torch.bfloat16)
    logit_err, cache_errs, _ = _prefill_errors(
        prog, cfg, params, tokens(2, 128, 3), "pallas_flash")
    assert logit_err > TOL32 and cache_errs[0] > TOL32


def test_decode_through_the_latent_cache_equals_the_full_forward():
    """Prefill 24 tokens, then decode 8 through the latent cache (k and v
    expanded from it each step): each step's logits and the latent it
    writes equal the reference's full forward over the prefix. The
    capacity takes every assignment (factor = experts), so the grouped
    routing of a decode step drops nothing, as the full forward's."""
    prog, cfg = tiny(capacity_factor=8.0)
    params = weights(prog, 5)
    tok = tokens(2, 32, 7)
    run = run_cfg(prog, "pallas_flash")
    _, caches = model.forward_prefill(prog, run, params,
                                      {"tokens": tok[:, :24]}, max_len=40)
    rw = ref_weights(params, prog)
    latents = []
    mla_lm.prefill(cfg, rw, [tok], lambda r, i, lat: latents.append(lat))
    for t in range(24, 32):
        logits, caches = model.forward_decode(
            prog, run, params, {"tokens": tok[:, t:t + 1]}, caches)
        want = mla_lm.prefill(cfg, rw, [tok[:, :t + 1]])[0]
        assert float(rel(logits[:, 0], want, 1).max()) < TOL32
        assert caches["cache_len"].tolist() == [t + 1] * 2
    for r, lat in enumerate(latents):
        assert float(rel(caches["latent"][0, r, :, :32], lat,
                         (1, 2)).max()) < TOL32


def test_cache_shapes_hold_the_latent():
    prog = get_model(ARCH)
    shapes = lm.cache_shapes(prog, 2, 1000)
    assert set(shapes) == {"cache_len", "latent"}
    assert shapes["latent"].shape == (1, 27, 2, 1000, 576)
    assert shapes["latent"].dtype == torch.bfloat16
    # 1,152 B a token a layer in bf16, against olmoe's k and v: 8,192 B
    assert 576 * 2 == 1152
    o = get_model("olmoe-1b-7b")
    assert set(lm.cache_shapes(o, 1, 8)) == {"cache_len", "k", "v"}


# ------------------------------------------------------------------ YaRN

def test_yarn_at_the_published_numbers():
    prog = get_model(ARCH)
    f = layers.yarn_freqs(64, 1e4, 40.0, 4096, 32.0, 1.0)
    plain = layers.rope_freqs(64, 1e4)
    ratio = plain / f
    assert torch.allclose(ratio[:11], torch.ones(11))        # pairs 0-10
    assert bool((ratio[11:23] > 1).all() and (ratio[11:23] < 40).all())
    assert torch.allclose(ratio[23:], torch.full((9,), 40.0))  # 23-31
    assert layers.yarn_mscale(40.0, 0.707) == pytest.approx(1.2608, abs=1e-4)
    assert attention.mla_scale(prog) == pytest.approx(0.114721, abs=1e-6)
    assert mla_lm.softmax_scale(CONFIG) == attention.mla_scale(prog)
    # written apart, the two differ in float32 rounding only
    assert torch.allclose(mla_lm.yarn_inv_freq(CONFIG, "cpu"), f,
                          rtol=1e-6, atol=0)
    # factor 1: plain RoPE
    assert torch.equal(layers.yarn_freqs(64, 1e4, 1.0, 4096, 32.0, 1.0),
                       plain)


def test_rope_turns_the_interleaved_pairs():
    x = torch.randn(1, 5, 2, 8, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(5)[None]
    inv = layers.rope_freqs(8, 100.0)
    got = layers.apply_rope_pairs(x, pos, inv)
    z = torch.view_as_complex(x.unflatten(-1, (4, 2)).contiguous())
    turn = torch.polar(torch.ones(5, 4), pos[0, :, None] * inv)
    want = torch.view_as_real(z * turn[:, None]).flatten(-2)
    assert torch.allclose(got, want, atol=1e-6)
    cfg = dict(CONFIG, qk_rope_head_dim=8, rope_theta=100.0, yarn_factor=1.0)
    assert torch.allclose(mla_lm.rope_pairs(x, cfg), want, atol=1e-6)


# ------------------------------------------------------------------- MoE

def _moe_inputs(seed, n_shared=2):
    prog, cfg = tiny(capacity_factor=8.0)
    p = prefill_entry.make_weights(prog, seed, "cpu")["blocks"]["layer1"]
    p = _tree_to(p, torch.float32)
    if not n_shared:
        p["moe"].pop("shared")
    x = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(seed))
    return prog, cfg, p, x


def test_unnormalised_top_k_and_shared_experts_equal_the_reference():
    prog, cfg, p, x = _moe_inputs(3)
    got, _ = moe.moe_apply(p["moe"], x, top_k=3, capacity_factor=8.0,
                           norm_topk_prob=False)
    lw = prefill_mla.reference_weights(
        {"blocks": {"layer0": {**p, "mlp": {}}}, "embed": {"table": None},
         "lm_head": {"table": None}, "final_norm": {"scale": None}},
        1, 0)["layers"][0]
    with mla_lm.exact_float32():
        want = mla_lm.moe(x, lw, dict(cfg, capacity_factor=8.0))
    assert float(rel(got, want, (1, 2)).max()) < TOL32
    # the gates as the softmax gives them, not renormalised
    normed, _ = moe.moe_apply(p["moe"], x, top_k=3, capacity_factor=8.0)
    assert float(rel(normed, want, (1, 2)).max()) > 1e-2
    # the shared experts are one SwiGLU over every token, added
    routed, _ = moe.moe_apply({k: v for k, v in p["moe"].items()
                               if k != "shared"}, x, top_k=3,
                              capacity_factor=8.0, norm_topk_prob=False)
    assert torch.allclose(got, routed + layers.mlp(p["moe"]["shared"], x),
                          atol=1e-6)


def test_olmoe_routing_is_unchanged():
    """olmoe's config keeps the renormalised gates, no shared experts and
    no leading dense layer; its MoE call is the same bits with the new
    options at their defaults, and its gates sum to 1."""
    o = get_model("olmoe-1b-7b")
    assert (o.norm_topk_prob, o.n_shared_experts, o.first_dense_layers,
            o.kv_lora_rank) == (True, 0, 0, 0)
    assert set(o.ffn_kinds()) == {"moe"} and set(o.layer_kinds()) == {"attn"}
    assert "shared" not in moe.moe_params(64, 32, 8)
    _, _, p, x = _moe_inputs(9, n_shared=0)
    a, aux_a = moe.moe_apply(p["moe"], x, top_k=3)
    b, aux_b = moe.moe_apply(p["moe"], x, top_k=3, norm_topk_prob=True)
    assert torch.equal(a, b)
    assert all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)
    _, _, gates, _ = moe.route(p["moe"], x, 3)
    assert torch.allclose(gates.sum(-1), torch.ones(2, 40))


# -------------------------------------------------------------- registry

def test_registry_has_the_published_widths():
    c = get_model(ARCH)
    assert (c.n_layers, c.d_model, c.n_heads, c.vocab_size) == (
        27, 2048, 16, 102400)
    assert (c.kv_lora_rank, c.qk_nope_head_dim, c.qk_rope_head_dim,
            c.v_head_dim, c.qk_head_dim, c.latent_dim) == (
        512, 128, 64, 128, 192, 576)
    assert (c.n_experts, c.top_k, c.expert_d_ff, c.d_ff,
            c.n_shared_experts, c.first_dense_layers) == (
        64, 6, 1408, 10944, 2, 1)
    assert (c.yarn_factor, c.yarn_original_max_pos, c.yarn_mscale,
            c.yarn_mscale_all_dim, c.rope_theta, c.norm_eps) == (
        40.0, 4096, 0.707, 0.707, 10000.0, 1e-6)
    assert not c.norm_topk_prob
    assert CONFIG["routed_scaling_factor"] == 1
    assert c.ffn_kinds() == ("dense",) + ("moe",) * 26
    assert c.layer_kinds() == ("mla",) * 27
    assert c.param_count() == 15_706_484_224                # 15.71 B
    assert round(c.param_count() / 1e9, 2) == 15.71
    # the file the benchmark runs states the program's sizes
    prefill_entry.check_sizes(c, CONFIG)
    assert lm.block_pattern(c)[0] == 27     # layer 0 breaks any period


def test_a_routed_scaling_factor_other_than_one_is_refused():
    """The program scales no routed expert's output: a configuration whose
    published routed_scaling_factor is not 1 is refused before anything
    is made; the published 1 is taken."""
    traffic = json.loads((ROOT / "portbench" / "traffic"
                          / "prefill-dsv2lite-long.json").read_text())
    scaled = dict(CONFIG, routed_scaling_factor=2.5)
    with pytest.raises(ValueError, match="routed_scaling_factor"):
        prefill_mla.make(scaled, traffic, "cpu", prefill_mla.TINY)
    prefill_mla.make(CONFIG, traffic, "cpu", prefill_mla.TINY)


def test_the_reference_lists_stay_the_references():
    assert ARCH in PORT_ARCHS and ARCH not in ARCHS
    cells = list(all_cells())
    assert len(cells) == 40 and all(a != ARCH for a, _, _ in cells)
    with pytest.raises(KeyError, match="unknown arch"):
        get_model("deepseek-v2")


def test_param_specs_count_what_param_count_counts():
    from repro_torch.models.params import count_params
    prog, _ = tiny()
    assert count_params(model.param_specs(prog)) == prog.param_count() + (
        (prog.padded_vocab - prog.vocab_size) * prog.d_model * 2)


# ----------------------------------------------------------------- flash

def _qkv(B, S, H, KV, dqk, dv, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, S, H, dqk, generator=g).to(dtype),
            torch.randn(B, S, KV, dqk, generator=g).to(dtype),
            torch.randn(B, S, KV, dv, generator=g).to(dtype))


def _plain(q, k, v, scale, causal=True):
    G = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(G, dim=2).float() for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * scale
    S = q.shape[1]
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)


@pytest.mark.parametrize("H,KV,dqk,dv", [(4, 4, 24, 16), (4, 2, 48, 16),
                                         (2, 1, 16, 40)])
def test_flash_cpu_route_takes_two_widths_and_a_scale(H, KV, dqk, dv):
    q, k, v = _qkv(2, 64, H, KV, dqk, dv, dqk + dv)
    got = ops.flash_attention(q, k, v, causal=True, scale=0.3)
    assert got.shape == (2, 64, H, dv)
    assert torch.allclose(got, _plain(q, k, v, 0.3), atol=1e-5)
    # no scale: 1/sqrt of q's and k's width
    got = ops.flash_attention(q, k, v, causal=False)
    assert torch.allclose(got, _plain(q, k, v, dqk ** -0.5, False),
                          atol=1e-5)


@pytest.mark.parametrize("dtype,dh,dv,aligned,taken", [
    (torch.bfloat16, 192, 128, True, True),
    (torch.bfloat16, 192, 128, False, True),
    (torch.bfloat16, 160, 128, True, False),
    (torch.bfloat16, 192, 64, True, False),
    (torch.bfloat16, 192, 100, True, False),
    (torch.bfloat16, 128, 64, True, False),
    (torch.bfloat16, 64, 128, True, False),
    (torch.bfloat16, 256, 128, True, False),
    (torch.float32, 192, 128, True, False),
])
def test_split_plan(dtype, dh, dv, aligned, taken):
    """v narrower than q and k: the <192, 128> instance takes its own pair
    (an unaligned layout staged at the same widths); every other pair of
    unequal widths is refused."""
    B, H, S = 2, 4, 64
    mode, (q, k, v) = _fake_cuda((B, H, S, dh), (B, H, S, dh),
                                 (B, H, S, dv), dtype=dtype)
    with mode:
        if not aligned:             # rows of dh + 1: strides off 16 bytes
            w = dh + 1
            q = torch.empty_strided((B, H, S, dh), (H * S * w, S * w, w, 1),
                                    dtype=dtype, device="cuda")
        if not taken:
            with pytest.raises(ValueError, match="no .* instance takes"):
                K.flash_attention_bhsd(q, k, v, scale=0.1)
            return
        assert (K._stride_fault(q, "q") is None) == aligned
        o = K.flash_attention_bhsd(q, k, v, scale=0.1)
    assert tuple(o.shape) == (B, H, S, dv)


def test_staging_to_one_width_keeps_the_function(monkeypatch):
    """No pair is staged to one width: a pair no instance takes is refused
    before any build, on any device, where the CPU route takes it."""
    def no_build(*_):
        raise AssertionError("the wrapper built a kernel before checking")
    monkeypatch.setattr(K._build, "load", no_build)
    q, k, v = (t.transpose(1, 2) for t in _qkv(2, 48, 4, 2, 40, 24, 1))
    with pytest.raises(ValueError, match="no split_tf32 instance takes"):
        K.flash_attention_bhsd(q, k, v, causal=True, scale=0.2)
    got = ops.flash_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                              causal=True, scale=0.2)
    want = attention_ref(q, k, v, causal=True, scale=0.2)
    assert torch.equal(got, want.transpose(1, 2))


def _fake_cuda(*shapes, dtype=torch.bfloat16):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    with mode:
        return mode, [torch.empty(s, dtype=dtype, device="cuda")
                      for s in shapes]


def test_flash_fake_branch_with_two_widths():
    from repro_torch.roofline.counter import StepCounter
    B, H, S = 2, 4, 64
    launches, fakes = (K.flash_attention_bhsd.launches,
                       K.flash_attention_bhsd.fake_calls)
    mode, (q, k, v) = _fake_cuda((B, H, S, 192), (B, H, S, 192),
                                 (B, H, S, 128))
    with mode, StepCounter() as c:
        o = K.flash_attention_bhsd(q, k, v, causal=True, scale=0.1147)
    assert tuple(o.shape) == (B, H, S, 128) and o.dtype == torch.bfloat16
    assert o.stride() == (S * H * 128, 128, H * 128, 1)
    assert K.flash_attention_bhsd.launches == launches
    assert K.flash_attention_bhsd.fake_calls == fakes + 1
    flops, nbytes = K.work(q, k, True, None, v)
    assert flops == 2 * (192 + 128) * B * H * (S * (S + 1) // 2)
    assert nbytes == 2 * B * H * S * (192 + 192 + 128 + 128)
    assert c.totals()["kernels"]["flash_attention"] == {
        "calls": 1, "flops": flops, "bytes": nbytes}


def test_work_of_equal_widths_is_four_dh_a_pair():
    q = torch.empty(2, 4, 64, 128)
    k = torch.empty(2, 2, 64, 128)
    assert K.work(q, k) == K.work(q, k, v=k)
    assert K.work(q, k)[0] == 4 * 128 * 2 * 4 * (64 * 65 // 2)


@pytest.mark.parametrize("which", ["batch", "heads", "length"])
def test_a_v_that_does_not_match_k_is_refused(which, monkeypatch):
    def no_build(*_):
        raise AssertionError("the wrapper built a kernel before checking")
    monkeypatch.setattr(K._build, "load", no_build)
    shape = {"batch": (1, 2, 64, 128), "heads": (2, 1, 64, 128),
             "length": (2, 2, 32, 128)}[which]
    q, k = torch.empty(2, 4, 64, 192), torch.empty(2, 2, 64, 192)
    with pytest.raises(ValueError, match=r"\(B, KV, Sk, dv\)"):
        K.flash_attention_bhsd(q, k, torch.empty(shape))
    mode, (fq, fk, fv) = _fake_cuda((2, 4, 64, 192), (2, 2, 64, 192), shape)
    with mode, pytest.raises(ValueError, match=r"\(B, KV, Sk, dv\)"):
        K.flash_attention_bhsd(fq, fk, fv)


# ----------------------------------------------------------------- spans

def test_spans_record_the_latent_and_the_shared_experts():
    from torch.profiler import ProfilerActivity, profile
    prog, _ = tiny()
    params = weights(prog, 2, torch.bfloat16)
    tok = tokens(2, 64, 1)
    run = run_cfg(prog, "pallas_flash")
    before = len(spans.log())
    model.forward_prefill(prog, run, params, {"tokens": tok}, max_len=80)
    assert len(spans.log()) == before      # no profiler: nothing kept
    with profile(activities=[ProfilerActivity.CPU]):
        model.forward_prefill(prog, run, params, {"tokens": tok},
                              max_len=80)
    recs = spans.log()[before:]
    mla = [r for r in recs if r[0] == "model.mla"]
    shared = [r for r in recs if r[0] == "model.moe.shared"]
    assert len(mla) == prog.n_layers and len(shared) == prog.n_layers - 1
    assert all(a["bytes"] == 2 * 64 * prog.latent_dim * 2
               for *_, a in mla)
    assert all(e >= s for _, s, e, _, _ in mla + shared)


def test_the_full_cell_writes_a_gigabyte_of_latent_a_call():
    prog = get_model(ARCH)
    per_call = prog.n_layers * 32768 * prog.latent_dim * 2
    assert math.isclose(per_call / 1e6, 1019.2, rel_tol=1e-3)
