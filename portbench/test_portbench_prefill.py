"""The prefill entry type on the CPU, on an olmoe-shaped model a test run
holds (`prefill.TINY`: 2 layers, d_model 64, 4 heads, 8 experts with top
2, a 512-token vocab, a 256-token budget in two shapes): the program
equals the plain reference, which follows the program's routing law to
float32 rounding; the control rounds every bf16 matrix through fp8; the
FLOP count equals a hand count; the readers give their values on a
synthetic trace; and a program whose sizes differ from the configuration
file is refused. The control and the planted faults are refused in
`test_portbench_faults.py`, as every cell's are."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import flops, harness, trace
from portbench.entries import Call, prefill
from portbench.reference import moe_lm

HERE = Path(__file__).resolve().parent
CELL = "prefill-olmoe"
BENCH = harness.load_bench()
CONFIG = json.loads((HERE / "configs" / "olmoe-1b-7b.json").read_text())
TRAFFIC = json.loads((HERE / "traffic" / "prefill-olmoe.json").read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run(seed, entry=None):
    return harness.run_cell(CELL, seed, 0.0, False, device="cpu",
                            shrink=prefill.TINY, entry=entry,
                            log=lambda m: None)


def past(checks):
    return {n for n, c in checks.items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("seed", [0, 2**31 + 21, 7919])
def test_the_entry_equals_the_reference(seed):
    result, checks = run(seed)
    assert result["correct"] is True and not past(checks)
    assert result["attempted"] == 4 and result["failed"] == 0
    assert checks["rows_missing"]["value"] == 0


def test_the_reference_follows_the_programs_routing_law():
    """In float32 on both sides (weights, activations, attention), the
    program's prefill and the reference agree to float32 rounding, at a
    length where experts drop assignments past their capacity."""
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import model
    config, prog, _ = prefill.sizes(CONFIG, TRAFFIC, prefill.TINY)
    params = prefill.make_weights(prog, 11, "cpu")
    params = _tree_to(params, torch.float32)
    tokens = torch.randint(0, prog.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    run_cfg = RunConfig(model=prog, shape=ShapeConfig("p", 128, 2,
                                                      "prefill"),
                        remat=False, attention_impl="naive")
    dropped = []
    from repro_torch.models import moe
    real = moe.moe_apply

    def probe(*a, **kw):
        out, aux = real(*a, **kw)
        dropped.append(float(aux["dropped_frac"]))
        return out, aux
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "moe_apply", probe)
        logits, caches = model.forward_prefill(
            prog, run_cfg, params, {"tokens": tokens}, max_len=160)
    assert max(dropped) > 0          # capacity drops some assignments
    keys = []
    truth = moe_lm.prefill(config, prefill.reference_weights(
        params, prog.n_layers), [tokens],
        lambda r, i, k, v: keys.append((r, k, v)))
    assert prefill.rel_err(logits[:, -1], truth[0], 1).max() < 1e-5
    for r, k, v in keys:
        assert prefill.rel_err(caches["k"][r, 0, :, :128], k,
                               (1, 2, 3)).max() < 1e-5
        assert prefill.rel_err(caches["v"][r, 0, :, :128], v,
                               (1, 2, 3)).max() < 1e-5
        assert not caches["k"][r, 0, :, 128:].any()


def _tree_to(tree, dtype):
    return {k: _tree_to(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def test_the_control_rounds_every_bf16_matrix_through_fp8():
    _, prog, _ = prefill.sizes(CONFIG, TRAFFIC, prefill.TINY)
    params = prefill.make_weights(prog, 5, "cpu")
    low = prefill.round_through(params, torch.float8_e4m3fn)
    wq, wq8 = params["blocks"]["layer0"]["attn"]["wq"], \
        low["blocks"]["layer0"]["attn"]["wq"]
    assert not torch.equal(wq, wq8)
    # one scale a matrix: the fp8 grid, scaled, holds every value
    for r in range(prog.n_layers):
        scale = wq[r].float().abs().amax() / 448.0
        back = (wq8[r].float() / scale).to(torch.float8_e4m3fn).float()
        assert torch.allclose(back * scale, wq8[r].float(), rtol=1e-2)
    moe = params["blocks"]["layer0"]["moe"]
    assert low["blocks"]["layer0"]["moe"]["router"] is moe["router"]
    assert low["final_norm"]["scale"] is params["final_norm"]["scale"]


def test_flops_equal_a_hand_count():
    c = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 4, "n_experts": 4, "top_k": 2, "d_ff": 6,
         "vocab_size": 10}
    f = flops.prefill(c, B=3, S=5)
    # per layer: q 8x8, k 8x4, v 8x4, o 8x8 -> 192 MACs a token, 15 tokens
    assert f["projections"] == 2 * 2 * 15 * 192
    # causal pairs per (batch, head): 5 * 6 / 2 = 15; QK^T and PV: 2 x 4
    # MACs a pair; 3 x 2 (batch, head) x 2 layers
    assert f["attention"] == 2 * 3 * 2 * 15 * 2 * 4 * 2
    assert f["router"] == 2 * 2 * 15 * 8 * 4
    # 2 experts a token, 3 GEMMs of 8 x 6
    assert f["experts"] == 2 * 2 * 15 * 2 * 3 * 8 * 6
    assert f["lm_head"] == 2 * 3 * 8 * 10
    assert f["moe"] == f["router"] + f["experts"]
    assert f["total"] == sum(f[k] for k in ("projections", "attention",
                                            "moe", "lm_head"))
    # bytes: bf16 experts and activations in and out, a float32 router
    assert f["moe_bytes"] == 2 * (2 * 4 * 3 * 8 * 6 + 4 * 8 * 4
                                  + 2 * 2 * 15 * 8)
    assert f["attention_bytes"] == 2 * 2 * 15 * 4 * (2 * 2 + 2 * 1)
    # the full model: ~18.7 TFLOP a 4 x 2048 call
    full = flops.prefill(CONFIG, 4, 2048)
    assert 18.6e12 < full["total"] < 18.8e12
    assert flops.roofline_pct(flops.PEAK_BF16_FLOPS, 0.0, 2.0) == 50.0
    assert flops.roofline_pct(0.0, flops.HBM_BYTES_PER_S, 4.0) == 25.0


def _synthetic_run(on_device):
    """Two calls of 10 ms each; in each, a 4 ms MoE span that launches a 3
    ms operation, a 1 ms attention span launching the flash kernel for
    0.5 ms, and a 1 ms operation outside both."""
    ms = 1_000_000
    plan = prefill.Plan(0, 0, 4, 2048, flops.prefill(CONFIG, 4, 2048))
    calls, spans, ops = [], [], []
    for i in range(2):
        t = i * 10 * ms
        calls.append((t, t + 10 * ms))
        spans += [(prefill.PREFILL, t, t + 9 * ms),
                  (prefill.MOE, t + 1 * ms, t + 5 * ms),
                  (prefill.ATTENTION, t + 6 * ms, t + 7 * ms)]
        ops += [("gemm", t + 2 * ms, t + 5 * ms, t + 1 * ms),
                ("void flash_wgmma_kernel<128, 128>", t + 6 * ms,
                 t + 6 * ms + ms // 2, t + 6 * ms),
                ("elementwise", t + 8 * ms, t + 9 * ms, t + 8 * ms)]
    tr = trace.Trace(calls=calls, work=2 * 8192, counts={}, device_ops=ops,
                     host_spans=spans, on_device=on_device)
    return harness.Run(setup_s=1.0, trace=tr, calls=[
        Call(plan=plan, start=s / 1e9, end=e / 1e9, work=8192)
        for s, e in calls])


def _read(name, run):
    return harness.read_metrics(
        [m for m in BENCH["per_layer"] + BENCH["end_to_end"]
         if m["name"] == name], run)[name]["value"]


def test_the_readers_on_a_synthetic_trace():
    f = flops.prefill(CONFIG, 4, 2048)
    peak = flops.PEAK_BF16_FLOPS
    on = _synthetic_run(True)
    assert _read("moe_ffn_share_pct", on) == pytest.approx(
        100 * 3 / 4.5)
    assert _read("moe_ffn_roofline", on) == pytest.approx(
        100 * 2 * f["moe"] / peak / 6e-3)
    assert _read("flash_attention_roofline", on) == pytest.approx(
        100 * 2 * f["attention"] / peak / 1e-3)
    assert _read("step_mfu", on) == pytest.approx(
        100 * 2 * f["total"] / peak / 20e-3)
    assert _read("prefill_tokens_per_s", on) == pytest.approx(
        2 * 8192 / 20e-3)
    # off the card the rooflines take the spans' host time
    off = _synthetic_run(False)
    assert _read("moe_ffn_roofline", off) == pytest.approx(
        100 * 2 * f["moe"] / peak / 8e-3)
    assert _read("flash_attention_roofline", off) == pytest.approx(
        100 * 2 * f["attention"] / peak / 2e-3)


def test_a_reader_with_nothing_to_read_gives_nothing():
    run = _synthetic_run(True)
    run.trace.device_ops = [o for o in run.trace.device_ops
                            if "flash" not in o[0]]
    got = harness.read_metrics(
        [m for m in BENCH["per_layer"] if m["name"] ==
         "flash_attention_roofline"], run)
    assert got == {}


def test_a_program_of_other_sizes_is_refused():
    _, prog, _ = prefill.sizes(CONFIG, TRAFFIC)
    assert prog.n_experts == 64 and prog.head_dim == 128
    for key, value in (("n_experts", 32), ("top_k", 4), ("d_ff", 2048),
                       ("qk_norm", True), ("capacity_factor", 2.0)):
        with pytest.raises(ValueError, match=key):
            prefill.check_sizes(dataclasses.replace(prog, **{key: value}),
                                CONFIG)


def test_every_seed_gives_the_same_work():
    entry = harness.make_entry(harness.resolve(BENCH, CELL), "cpu")
    assert entry.min_calls == 8 and entry.work == 8192
    for seed in (0, 2**31 + 9, 3300000001):
        plans = [entry.plan(seed, k) for k in range(16)]
        for cycle in range(4):
            got = plans[4 * cycle:4 * cycle + 4]
            assert sorted(p.shape for p in got) == [0, 1, 2, 3]
            assert {p.batch for p in got} == {cycle % 2}
            assert all(p.B * p.S == 8192 for p in got)
        assert plans == [entry.plan(seed, k) for k in range(16)]
    orders = {tuple(entry.plan(seed, k).shape for k in range(4))
              for seed in range(6)}
    assert len(orders) > 1           # the seed permutes each cycle
