"""The MLA prefill entry type on the CPU (`prefill_mla.TINY`: a DeepSeek-V2-
shaped model of 3 layers a test run holds): sound runs equal the plain
reference (`reference/mla_lm.py`); its FLOP count equals a hand count and
the full cell's figures; the two readers of the program's
`model.mla` spans give their values on a synthetic trace and nothing on a
program without the spans; every seed gives the same work; a program of
other sizes, or of no MLA, is refused. The control and the planted faults
are refused in `test_portbench_faults.py`, as every cell's are."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import flops as flops_mod
from portbench import harness, trace
from portbench.entries import Call, prefill, prefill_mla

HERE = Path(__file__).resolve().parent
CELL = "prefill-dsv2lite-long"
BENCH = harness.load_bench()
CONFIG = json.loads((HERE / "configs" / "deepseek-v2-lite.json")
                    .read_text())
TRAFFIC = json.loads((HERE / "traffic" / "prefill-dsv2lite-long.json")
                     .read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [0, 2**31 + 21])
def test_the_entry_equals_the_reference(seed):
    result, checks = harness.run_cell(CELL, seed, 0.0, False, device="cpu",
                                      shrink=prefill_mla.TINY,
                                      log=lambda m: None)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] == 4
    assert all(c["value"] <= c["limit"] for c in checks.values())


def test_flops_equal_a_hand_count():
    c = {"n_layers": 3, "first_dense_layers": 1, "d_model": 8,
         "n_heads": 2, "qk_nope_head_dim": 4, "qk_rope_head_dim": 2,
         "v_head_dim": 3, "kv_lora_rank": 5, "n_experts": 4, "top_k": 2,
         "moe_d_ff": 6, "n_shared_experts": 1, "d_ff": 7, "vocab_size": 10}
    f = prefill_mla.flops(c, B=3, S=5)
    # a token a layer: q 8x(2x6), W_kv_a 8x(5+2), W_kv_b 5x(2x(4+3)),
    # o (2x3)x8 -> 96 + 56 + 70 + 48 = 270 MACs; 15 tokens, 3 layers
    assert f["projections"] == 2 * 3 * 15 * 270
    # causal pairs a (batch, head): 15; q.k over 6 and p.v over 3 columns
    assert f["attention"] == 3 * 2 * 3 * 15 * 2 * (6 + 3)
    assert f["router"] == 2 * 2 * 15 * 8 * 4
    # 2 routed and 1 shared expert a token, 3 GEMMs of 8 x 6, 2 MoE layers
    assert f["experts"] == 2 * 2 * 15 * 3 * 3 * 8 * 6
    assert f["dense_ffn"] == 2 * 15 * 3 * 8 * 7
    assert f["lm_head"] == 2 * 3 * 8 * 10
    assert f["moe"] == f["router"] + f["experts"]
    assert f["total"] == sum(f[k] for k in ("projections", "attention",
                                            "moe", "dense_ffn", "lm_head"))
    assert f["moe_bytes"] == 2 * (2 * (4 + 1) * 3 * 8 * 6 + 4 * 8 * 4
                                  + 2 * 2 * 15 * 8)
    assert f["attention_bytes"] == 3 * 2 * 15 * 2 * (2 * 6 + 2 * 3)
    assert set(flops_mod.prefill(
        dict(c, n_kv_heads=2, head_dim=4), 3, 5)) < set(f)


def test_the_cell_does_what_its_flops_count():
    two, one = (prefill_mla.flops(CONFIG, *s) for s in TRAFFIC["shapes"])
    assert 221.0e12 < two["total"] < 221.3e12
    assert 295.2e12 < one["total"] < 295.5e12
    assert 74.1e12 < two["attention"] < 74.3e12
    assert 148.3e12 < one["attention"] < 148.6e12
    assert two["moe"] == one["moe"]


def _synthetic_run(monkeypatch, mla_spans):
    """Two calls of 10 ms; in each, a program `model.mla` span of 3 ms
    (bytes 1e9) that launches a 2 ms operation, and a 4 ms operation
    launched outside it."""
    ms = 1_000_000
    plan = prefill.Plan(0, 0, 1, 32768, prefill_mla.flops(CONFIG, 1, 32768))
    calls, ops, recs = [], [], []
    for i in range(2):
        t = i * 10 * ms
        calls.append((t, t + 10 * ms))
        ops += [("flash_wgmma_kernel<192, 128, 128>", t + 2 * ms, t + 4 * ms,
                 t + 1 * ms),
                ("gemm", t + 5 * ms, t + 9 * ms, t + 5 * ms)]
        recs.append(("model.mla", t + 1 * ms, t + 4 * ms, -1,
                     {"bytes": 10 ** 9}))
    from repro_torch import spans
    monkeypatch.setattr(spans, "log", lambda: recs if mla_spans else [])
    tr = trace.Trace(calls=calls, work=2 * 32768, counts={}, device_ops=ops,
                     host_spans=[], on_device=True)
    return harness.Run(setup_s=1.0, trace=tr, calls=[
        Call(plan=plan, start=s / 1e9, end=e / 1e9, work=32768)
        for s, e in calls])


def _read(names, run):
    return harness.read_metrics([m for m in BENCH["per_layer"]
                                 if m["name"] in names], run)


def test_the_mla_readers_on_a_synthetic_trace(monkeypatch):
    got = _read(("mla_share_pct", "latent_cache_mb_per_call"),
                _synthetic_run(monkeypatch, True))
    assert got["mla_share_pct"]["value"] == pytest.approx(100 * 2 / 6)
    assert got["latent_cache_mb_per_call"]["value"] == pytest.approx(1000.0)
    f = prefill_mla.flops(CONFIG, 1, 32768)
    roof = _read(("flash_attention_roofline",),
                 _synthetic_run(monkeypatch, True))
    assert roof["flash_attention_roofline"]["value"] == pytest.approx(
        100 * 2 * f["attention"] / flops_mod.PEAK_BF16_FLOPS / 4e-3)


def test_a_program_without_the_spans_gives_nothing(monkeypatch):
    assert _read(("mla_share_pct", "latent_cache_mb_per_call"),
                 _synthetic_run(monkeypatch, False)) == {}


def test_every_seed_gives_the_same_work():
    entry = harness.make_entry(harness.resolve(BENCH, CELL), "cpu")
    assert entry.min_calls == 4 and entry.work == 32768
    for seed in (0, 2**31 + 9, 3400000001):
        plans = [entry.plan(seed, k) for k in range(8)]
        for cycle in range(4):
            got = plans[2 * cycle:2 * cycle + 2]
            assert sorted(p.shape for p in got) == [0, 1]
            assert {p.batch for p in got} == {cycle % 2}
            assert all(p.B * p.S == 32768 for p in got)
    orders = {tuple(entry.plan(seed, k).shape for k in range(2))
              for seed in range(8)}
    assert len(orders) == 2          # the seed permutes each cycle


def test_a_program_of_other_sizes_is_refused():
    _, prog, _ = prefill.sizes(CONFIG, TRAFFIC)
    assert prog.kv_lora_rank == 512 and prog.n_shared_experts == 2
    for key, value in (("kv_lora_rank", 256), ("qk_rope_head_dim", 32),
                       ("v_head_dim", 192), ("yarn_factor", 1.0),
                       ("n_shared_experts", 0), ("first_dense_layers", 0),
                       ("norm_topk_prob", True), ("top_k", 8)):
        with pytest.raises(ValueError, match=key):
            prefill.check_sizes(dataclasses.replace(prog, **{key: value}),
                                CONFIG)


@pytest.mark.parametrize("program_key, published", [
    ("n_layers", "num_hidden_layers"), ("d_model", "hidden_size"),
    ("n_heads", "num_attention_heads"), ("n_kv_heads", "num_key_value_heads"),
    ("d_ff", "intermediate_size"), ("moe_d_ff", "moe_intermediate_size"),
    ("n_experts", "n_routed_experts"), ("top_k", "num_experts_per_tok"),
    ("moe_every", "moe_layer_freq"),
    ("first_dense_layers", "first_k_dense_replace"),
    ("context_length", "max_position_embeddings"),
    ("norm_eps", "rms_norm_eps"), ("tie_embeddings", "tie_word_embeddings"),
    ("yarn_factor", "rope_scaling.factor"),
    ("yarn_original_max_pos", "rope_scaling.original_max_position_embeddings"),
    ("yarn_beta_fast", "rope_scaling.beta_fast"),
    ("yarn_beta_slow", "rope_scaling.beta_slow"),
    ("yarn_mscale", "rope_scaling.mscale"),
    ("yarn_mscale_all_dim", "rope_scaling.mscale_all_dim")])
def test_the_program_sizes_are_the_published_ones(program_key, published):
    """The file holds the published config.json at its top level, beside
    the program's own names for the same sizes: each pair agrees."""
    value = CONFIG
    for part in published.split("."):
        value = value[part]
    assert CONFIG[program_key] == value
    assert CONFIG["q_lora_rank"] is None and CONFIG["reduced"] == []


def test_a_model_without_latent_attention_is_refused():
    olmoe = json.loads((HERE / "configs" / "olmoe-1b-7b.json").read_text())
    with pytest.raises(ValueError, match="MLA"):
        prefill_mla.make(olmoe, TRAFFIC, "cpu")


def test_the_median_is_over_the_distinct_sequences():
    """An input run three times counts once, at its worst call; a row a
    call did not answer counts as inf."""
    truth = {(0, 0): torch.ones(2, 4), (1, 0): torch.ones(1, 4)}

    def call(si, B, errs):
        got = torch.ones(B, 4) + torch.tensor(errs)[:, None]
        return Call(plan=prefill.Plan(si, 0, B, 8 // B, {}), start=0.0,
                    results=got)
    calls = [call(0, 2, [0.1, 0.2]), call(0, 2, [0.1, 0.3]),
             call(0, 2, [0.1, 0.2]), call(1, 1, [0.9])]
    assert prefill_mla.sequence_median(calls, truth) == pytest.approx(0.3)
    # the rows' median would be 0.2, weighing the repeated input thrice
    calls.append(Call(plan=prefill.Plan(1, 0, 1, 8, {}), start=0.0))
    assert prefill_mla.sequence_median(calls, truth) == pytest.approx(0.3)
    assert prefill_mla.sequence_median(calls[-1:], truth) == float("inf")
    assert prefill_mla.sequence_median([], truth) == float("inf")
