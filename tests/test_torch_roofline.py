"""The port's roofline package (`repro_torch.roofline`) against the
reference's `repro.roofline`, on the CPU.

* `analyze_hlo` and `collective_bytes_from_hlo` give the reference's
  numbers exactly on `tests/test_data_sharding_hlo.py`'s fixtures (a
  scan of 7 trips, an all-reduce of 256 bytes), on hand-written modules
  with collectives inside while loops, and on the compiled HLO text of
  small reference jits made here (a scanned matmul, nested scans, a
  convolution, a fori_loop).
* `model_flops` == the reference's on every applicable ARCHS x
  SHAPES_BY_NAME cell; `roofline_terms` == the reference's with the
  port's H100 constants patched to the reference's TPU values.
* The torch counter (`roofline.counter`) gives 2.n.m.k.trips for a
  looped matmul and 0 for what is no product; the sharded step's
  collective bytes are checked in `tests/test_torch_sharding.py`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import SHAPES_BY_NAME as J_SHAPES  # noqa: E402
from repro.configs.registry import all_cells  # noqa: E402
from repro.roofline import analysis as j_analysis  # noqa: E402
from repro.roofline import hlo_parse as j_hlo  # noqa: E402
from repro_torch.configs import ARCHS as P_ARCHS  # noqa: E402
from repro_torch.configs import SHAPES_BY_NAME as P_SHAPES  # noqa: E402
from repro_torch.roofline import analysis as p_analysis  # noqa: E402
from repro_torch.roofline import hlo_parse as p_hlo  # noqa: E402
from repro_torch.roofline.counter import StepCounter, count_step  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


ALL_REDUCE = """
HloModule test

ENTRY %main (a: f32[64]) -> f32[64] {
  %a = f32[64]{0} parameter(0)
  ROOT %ar = f32[64]{0} all-reduce(%a), replica_groups={}, to_apply=%add
}
"""

LOOPED_COLLECTIVES = """
HloModule looped

%add (x: f32[], y: f32[]) -> f32[] {
  %x = f32[] parameter(0)
  %y = f32[] parameter(1)
  ROOT %s = f32[] add(%x, %y)
}

%cond (p: (s32[], bf16[8,128])) -> pred[] {
  %p = (s32[], bf16[8,128]{1,0}) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %n = s32[] constant(5)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

%body (p: (s32[], bf16[8,128])) -> (s32[], bf16[8,128]) {
  %p = (s32[], bf16[8,128]{1,0}) parameter(0)
  %i = s32[] get-tuple-element(%p), index=0
  %x = bf16[8,128]{1,0} get-tuple-element(%p), index=1
  %ag = bf16[32,128]{1,0} all-gather(%x), dimensions={0}
  %rs = bf16[8,128]{1,0} reduce-scatter(%ag), dimensions={0}, to_apply=%add
  %one = s32[] constant(1)
  %j = s32[] add(%i, %one)
  ROOT %t = (s32[], bf16[8,128]{1,0}) tuple(%j, %rs)
}

ENTRY %main (a: bf16[8,128]) -> bf16[8,128] {
  %a = bf16[8,128]{1,0} parameter(0)
  %z = s32[] constant(0)
  %t0 = (s32[], bf16[8,128]{1,0}) tuple(%z, %a)
  %w = (s32[], bf16[8,128]{1,0}) while(%t0), condition=%cond, body=%body
  %o = bf16[8,128]{1,0} get-tuple-element(%w), index=1
  ROOT %ar = bf16[8,128]{1,0} all-reduce(%o), replica_groups={}, to_apply=%add
}
"""


def _scan_matmul():
    def f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=7)[0]
    return jax.jit(f).lower(jnp.zeros((64, 64)), jnp.zeros((64, 64)))


def _nested_scans():
    def f(x, w):
        def inner(c, _):
            return jnp.sin(c @ w), None

        def outer(c, _):
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, None, length=4)[0]
    return jax.jit(f).lower(jnp.zeros((16, 32)), jnp.zeros((32, 32)))


def _conv():
    def f(x, k):
        return jax.lax.conv_general_dilated(x, k, (1, 1), "SAME")
    return jax.jit(f).lower(jnp.zeros((2, 3, 16, 16)),
                            jnp.zeros((8, 3, 3, 3)))


def _fori():
    def f(x, w):
        return jax.lax.fori_loop(0, 6, lambda i, c: jnp.exp(c @ w) * 1e-3,
                                 x)
    return jax.jit(f).lower(jnp.zeros((8, 24)), jnp.zeros((24, 24)))


def _texts():
    out = {"all_reduce": ALL_REDUCE, "looped": LOOPED_COLLECTIVES}
    for name, make in (("scan", _scan_matmul), ("nested", _nested_scans),
                       ("conv", _conv), ("fori", _fori)):
        lowered = make()
        out[name] = lowered.compile().as_text()
        out[name + "_stablehlo"] = lowered.as_text()
    return out


@pytest.fixture(scope="module")
def texts():
    return _texts()


@pytest.mark.parametrize("name", ["all_reduce", "looped", "scan", "nested",
                                  "conv", "fori", "scan_stablehlo"])
def test_parsers_match_reference(texts, name):
    hlo = texts[name]
    assert p_hlo.analyze_hlo(hlo) == j_hlo.analyze_hlo(hlo)
    assert p_analysis.collective_bytes_from_hlo(hlo) == \
        j_analysis.collective_bytes_from_hlo(hlo)
    assert p_analysis.collective_bytes_from_hlo(hlo, entry_hint="main") \
        == j_analysis.collective_bytes_from_hlo(hlo, entry_hint="main")
    assert p_hlo.HloModule(hlo).entry == j_hlo.HloModule(hlo).entry


def test_parsers_read_the_fixtures(texts):
    """The fixtures' own laws hold for the port's copy: the scan counted
    7 times, the all-reduce 256 bytes, the looped collectives 5 times."""
    t = p_hlo.analyze_hlo(texts["scan"])
    expect = 2 * 64 * 64 * 64 * 7
    assert abs(t["dot_flops"] - expect) / expect < 0.05
    assert p_hlo.analyze_hlo(texts["all_reduce"])["coll_by_op"] == {
        "all-reduce": 256}
    looped = p_hlo.analyze_hlo(texts["looped"])["coll_by_op"]
    assert looped == {"all-gather": 5 * 32 * 128 * 2,
                      "reduce-scatter": 5 * 32 * 128 * 2,
                      "all-reduce": 8 * 128 * 2}
    # the reference's older walk (`analysis._parse_computations`) reads a
    # computation header only when its parameter list has no nested
    # parentheses, so it never enters a while body whose carry is a
    # tuple; the port keeps that parser as it is
    assert p_analysis.collective_bytes_from_hlo(texts["looped"]) == {
        "all-reduce": 8 * 128 * 2}


CELLS = [(a, s) for a, s, ok in all_cells() if ok]


def test_model_flops_match_reference():
    for arch, shape in CELLS:
        got = p_analysis.model_flops(P_ARCHS[arch], P_SHAPES[shape])
        want = j_analysis.model_flops(J_ARCHS[arch], J_SHAPES[shape])
        assert got == want, (arch, shape)
    assert len(CELLS) > 30


def test_roofline_terms_match_reference_with_its_constants(monkeypatch):
    cases = [(1e15, 2e12, 3e10, 256), (5e12, 8e11, 0.0, 1),
             (1e9, 1e13, 4e9, 512), (0.0, 0.0, 0.0, 4)]
    for flops, hbm, coll, chips in cases:
        got = p_analysis.roofline_terms(flops, hbm, coll, chips)
        assert set(got) == set(j_analysis.roofline_terms(flops, hbm, coll,
                                                         chips))
    monkeypatch.setattr(p_analysis, "PEAK_FLOPS", j_analysis.PEAK_FLOPS)
    monkeypatch.setattr(p_analysis, "HBM_BW", j_analysis.HBM_BW)
    monkeypatch.setattr(p_analysis, "NVLINK_BW", j_analysis.ICI_BW)
    monkeypatch.setattr(p_analysis, "NVLINK_LINKS", j_analysis.ICI_LINKS)
    for flops, hbm, coll, chips in cases:
        assert p_analysis.roofline_terms(flops, hbm, coll, chips) == \
            j_analysis.roofline_terms(flops, hbm, coll, chips)


def test_h100_constants():
    assert p_analysis.PEAK_FLOPS == 989e12
    assert p_analysis.HBM_BW == 3.35e12
    assert p_analysis.NVLINK_LINKS * p_analysis.NVLINK_BW == 450e9
    t = p_analysis.roofline_terms(989e12, 3.35e12 / 2, 0.0, 1)
    assert t["dominant"] == "compute" and t["bound_s"] == 1.0
    assert t["roofline_fraction"] == 1.0


@pytest.mark.parametrize("n, m, k, trips", [(64, 48, 32, 7), (5, 3, 9, 1),
                                            (16, 16, 16, 0)])
def test_counter_counts_looped_matmul(n, m, k, trips):
    x, w = torch.zeros(n, k), torch.zeros(k, m)

    def f():
        c = torch.zeros(n, m)
        for _ in range(trips):
            c = torch.tanh(c + x @ w)
        return c

    _, t = count_step(f)
    assert t["dot_flops"] == 2 * n * m * k * trips
    assert t["coll_bytes"] == 0 and t["coll_by_op"] == {}


def test_counter_counts_batched_products_and_no_elementwise():
    a, b = torch.ones(3, 4, 5), torch.ones(3, 5, 6)
    with StepCounter() as c:
        torch.einsum("bij,bjk->bik", a, b)
        torch.exp(a).sum()
    assert c.totals()["dot_flops"] == 2 * 3 * 4 * 5 * 6
    with StepCounter() as c:
        (a * 2).softmax(-1)
    assert c.totals()["dot_flops"] == 0


def test_counter_sees_the_model_step():
    """A reduced prefill's products: every attention and MLP matmul."""
    from repro_torch.configs import reduced_model
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import model as M
    cfg = dataclasses.replace(reduced_model(P_ARCHS["qwen3-4b"]), n_layers=1)
    run = RunConfig(model=cfg, shape=ShapeConfig("p", 16, 2, "prefill"),
                    attention_impl="naive")
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu", dtype_override=torch.float32)
    tokens = torch.from_numpy(np.zeros((2, 16), np.int32))
    _, t = count_step(M.forward_prefill, cfg, run, params,
                      {"tokens": tokens}, 16)
    B, S, d, H, KV, dh = 2, 16, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.head_dim
    proj = 2 * B * S * d * (H + 2 * KV) * dh + 2 * B * S * H * dh * d
    attn = 2 * 2 * B * H * S * S * dh
    mlp = 3 * 2 * B * S * d * cfg.d_ff
    logits = 2 * B * 1 * d * cfg.padded_vocab
    assert t["dot_flops"] == proj + attn + mlp + logits
