"""`forward_prefill` of a latent-attention (MLA) model with a leading dense
layer and routed plus shared experts (DeepSeek-V2): one prefill step of a
fixed token budget a call, as `entries/prefill.py` runs it, with latent
caches built for the decode that would follow.

The traffic and the plans are `prefill`'s: `shapes` (B x S each equal to
`tokens_per_call`), `batches_per_shape`, `decode_room`,
`attention_impl`; calls in cycles of one a shape in an order `--seed`
permutes; weights (bf16, the router and the norms float32) and token ids
made on the device from `--seed` in set-up. Each plan carries the call's
model FLOPs (`flops`), under the keys of `portbench.flops.prefill` and
one more, "dense_ffn" (the leading dense layers' SwiGLU), in the total.

`correct`: after the window the plain reference (`reference/mla_lm.py`,
float32) runs once over each distinct input with the same weights. Every
call's last-token logits, a row a sequence, and the latent caches of the
last call of each shape, a layer at a time, are held to it by relative
error, as `prefill.compare` does (`LIMITS`), but for the median row,
which is taken over the distinct sequences (`sequence_median`).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.entries import Entry, Fault, Tests
from portbench.entries import prefill as base
from portbench.entries.prefill import SPANS, Plan, log, round_through

# The bf16 program against the float32 reference: relative errors of a
# sequence's last-token logits and of a layer's latent cache of a
# sequence. Each limit lies between the largest reading of sound runs
# (on the card) and the smallest of the fp8 control, or of the planted
# faults where the control does not separate (PERF.md §2 gives the
# readings). Top-6 routing turns bf16 rounding into another expert for a
# few tokens a layer, so single rows and the caches past the first layer
# swing with it: their limits catch gross faults, and the control is
# refused by the median over the 6 distinct sequences and by layer 0's
# latent, which no router precedes. The median's limit also refuses one
# of the six experts left out (0.0895-0.0960 on 3 seeds).
LIMITS = {"row": 0.25,           # any row: sound <= 0.095
          "median_row": 0.07,    # the median sequence: sound <= 0.0423
                                 # (13 seeds), the control >= 0.162
          "layer": 0.1,          # any layer's latent: sound <= 0.037
          "first_layer": 0.01}   # layer 0's latent: sound <= 0.0029,
                                 # the control >= 0.0377


def flops(config: dict, B: int, S: int) -> Dict[str, float]:
    """FLOPs of a (B, S) prefill of the MLA configuration `config`, by part,
    and the bytes the MoE FFN and attention must move (the model's
    mathematics, as `portbench.flops.prefill` counts it). "projections":
    each layer's q, W_kv_a, W_kv_b (the latent of every token expanded)
    and output projections; "attention": 2 (qk + v) FLOPs a causal (q, k)
    pair a head; "router"; "experts": every routed expert's three GEMMs a
    token and a choice (dropped ones too) and the shared experts' SwiGLU
    over every token; "dense_ffn": the leading dense layers' SwiGLU;
    "lm_head" at the last position; "moe" (router + experts), "total".
    Bytes: "moe_bytes", an MoE layer's bf16 experts (routed and shared),
    float32 router and bf16 input and output; "attention_bytes", q, k, v
    and o of the flash call in bf16."""
    L, d, H = config["n_layers"], config["d_model"], config["n_heads"]
    dn, dr = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
    dv, r = config["v_head_dim"], config["kv_lora_rank"]
    E, K, f = config["n_experts"], config["top_k"], config["moe_d_ff"]
    n_sh, L0 = config["n_shared_experts"], config["first_dense_layers"]
    T, dqk, Lm = B * S, dn + dr, L - L0
    out = {
        "projections": L * 2.0 * T * (d * H * dqk + d * (r + dr)
                                      + r * H * (dn + dv) + H * dv * d),
        "attention": L * 2.0 * B * H * (dqk + dv) * S * (S + 1) / 2,
        "router": Lm * 2.0 * T * d * E,
        "experts": Lm * 2.0 * T * (K + n_sh) * 3 * d * f,
        "dense_ffn": L0 * 2.0 * T * 3 * d * config["d_ff"],
        "lm_head": 2.0 * B * d * config["vocab_size"],
    }
    out["moe"] = out["router"] + out["experts"]
    out["total"] = (out["projections"] + out["attention"] + out["moe"]
                    + out["dense_ffn"] + out["lm_head"])
    out["moe_bytes"] = Lm * (2.0 * (E + n_sh) * 3 * d * f + 4.0 * d * E
                             + 2 * 2.0 * T * d)
    out["attention_bytes"] = L * 2.0 * T * H * (2 * dqk + 2 * dv)
    return out


def sequence_median(calls, truth) -> float:
    """The median over the distinct sequences of their last-token logits'
    relative error, each sequence's the largest over the calls that ran
    it (inf where one of them gave no answer for it). A window runs each
    input as often as its length allows, so the median over its calls'
    rows would weigh the sequences by that count."""
    worst: Dict[tuple, float] = {}
    for c in calls:
        got = c.results
        n = 0 if got is None else min(got.shape[0], c.plan.B)
        errs = base.rel_err(got[:n], truth[(c.plan.shape, c.plan.batch)][:n],
                            1).tolist() if n else []
        errs += [float("inf")] * (c.plan.B - n)
        for row, e in enumerate(errs):
            key = (c.plan.shape, c.plan.batch, row)
            worst[key] = max(worst.get(key, 0.0), e)
    return float(np.median(list(worst.values()))) if worst \
        else float("inf")


def reference_weights(params, n_layers: int, first_dense: int) -> dict:
    """The weights as `reference.mla_lm.prefill` takes them: views of the
    program's tree (one unstacked block of every layer), a dict a layer."""
    blocks = params["blocks"]
    attn = ("wq", "wkv_a", "wkv_b", "wo")
    layers = []
    for j in range(n_layers):
        lp = blocks[f"layer{j}"]
        lw = {n: lp["attn"][n] for n in attn}
        lw.update(norm1=lp["norm1"]["scale"], norm2=lp["norm2"]["scale"],
                  kv_norm=lp["attn"]["kv_norm"]["scale"])
        if j < first_dense:
            lw.update(lp["mlp"])
        else:
            m = lp["moe"]
            lw.update({n: m[n] for n in ("router", "w_gate", "w_up",
                                         "w_down")})
            lw.update({f"shared_{n[2:]}": w for n, w in m["shared"].items()})
        layers.append(lw)
    return {"embed": params["embed"]["table"],
            "lm_head": params["lm_head"]["table"],
            "final_norm": params["final_norm"]["scale"], "layers": layers}


def make(config: dict, traffic: dict, device, shrink=None) -> Entry:
    return _entry(config, traffic, device, shrink)


def control(config: dict, traffic: dict, device, shrink=None) -> Entry:
    """The program with every bf16 weight matrix rounded through
    float8_e4m3fn, the nearest precision below the configuration's bf16;
    the check's reference keeps the weights as made."""
    return _entry(config, traffic, device, shrink,
                  lower=torch.float8_e4m3fn)


def _entry(config, traffic, device, shrink, lower=None) -> Entry:
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import lm
    from repro_torch.models import model as model_mod
    from portbench.reference import mla_lm
    config, prog, traffic = base.sizes(config, traffic, shrink)
    limits = dict(LIMITS, **(shrink or {}).get("limits", {}))
    if not prog.is_mla or not prog.is_moe or not prog.first_dense_layers \
            or lm.block_pattern(prog)[0] != prog.n_layers \
            or prog.tie_embeddings:
        raise ValueError(f"{prog.name}: the MLA prefill reference is a stack "
                         "of MLA layers, leading dense layers then MoE "
                         "layers with shared experts, untied embeddings")
    if config["routed_scaling_factor"] != 1:
        raise ValueError(f"{prog.name}: the program scales no routed "
                         "expert's output (routed_scaling_factor 1)")
    shapes = [tuple(s) for s in traffic["shapes"]]
    n_in = traffic["batches_per_shape"]
    max_lens = [min(S + traffic["decode_room"], config["context_length"])
                for _, S in shapes]
    part_flops = [flops(config, B, S) for B, S in shapes]
    run = RunConfig(model=prog, shape=ShapeConfig(
        "prefill", shapes[0][1], shapes[0][0], "prefill"), remat=False,
        attention_impl=traffic["attention_impl"])
    on_cuda = torch.device(device).type == "cuda"
    st: dict = {"kept": {}}

    def plan(seed, k):
        cycle, pos = divmod(k, len(shapes))
        order = np.random.default_rng([seed % 2**64, cycle]).permutation(
            len(shapes))
        si = int(order[pos])
        return Plan(si, cycle % n_in, *shapes[si], part_flops[si])

    def call(p):
        logits, caches = model_mod.forward_prefill(
            prog, run, st["program"], {"tokens": st["inputs"][p.shape][
                p.batch]}, max_len=max_lens[p.shape])
        st["kept"][p.shape] = (p.batch, caches)
        return logits[:, -1].to("cpu")

    def prepare(seed):
        t0 = time.perf_counter()
        torch.empty(0, device=device)
        base._sync(on_cuda)
        log(f"the device's context in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        st["params"] = base.make_weights(prog, seed, device)
        st["program"] = st["params"] if lower is None else round_through(
            st["params"], lower)
        st["inputs"] = []
        for si, (B, S) in enumerate(shapes):
            row = []
            for bi in range(n_in):
                gen = torch.Generator(device=device)
                gen.manual_seed(base._seed(seed, 1, si, bi))
                row.append(torch.randint(0, prog.vocab_size, (B, S),
                                         generator=gen, device=device,
                                         dtype=torch.int32))
            st["inputs"].append(row)
        base._sync(on_cuda)
        log(f"weights and inputs made in {time.perf_counter() - t0:.3f} s")

    def warm():
        t0 = time.perf_counter()
        if on_cuda and traffic["attention_impl"] == "pallas_flash":
            from repro_torch.kernels import _build
            _build.load("flash_attention_sm90")
        took = [time.perf_counter() - t0]
        for si, (B, S) in enumerate(shapes):
            t0 = time.perf_counter()
            call(Plan(si, 0, B, S, part_flops[si]))
            took.append(time.perf_counter() - t0)
        st["kept"].clear()
        log("warm: kernel library " + ", ".join(
            [f"{took[0]:.3f} s"] + [f"{B}x{S} {t:.3f} s" for (B, S), t in
                                    zip(shapes, took[1:])]))

    def check(calls):
        st.pop("program")
        if on_cuda:
            torch.cuda.empty_cache()
        keys = [(si, bi) for si in range(len(shapes)) for bi in range(n_in)]
        kept = st["kept"]
        cache_err: Dict[int, List[float]] = {si: [] for si in kept}

        def on_layer(r, i, latent):
            si, bi = keys[i]
            if si not in kept or kept[si][0] != bi:
                return
            S = shapes[si][1]
            got = kept[si][1]["latent"][0, r]
            diff = (got[:, :S].float() - latent).square().sum((1, 2))
            diff += got[:, S:].float().square().sum((1, 2))
            err = diff.sqrt() / latent.square().sum((1, 2)).sqrt() \
                .clamp_min(1e-30)
            cache_err[si].append(float(err.max()))

        truth = mla_lm.prefill(config, reference_weights(
            st["params"], prog.n_layers, prog.first_dense_layers),
            [st["inputs"][si][bi] for si, bi in keys], on_layer)
        truth = {key: t.cpu() for key, t in zip(keys, truth)}
        checks, failed = base.compare(calls, truth, cache_err, kept, shapes,
                                      prog.n_layers, limits)
        checks["logits_err_median"]["value"] = median = sequence_median(
            calls, truth)
        log(f"logits rel err, the median over the distinct sequences: "
            f"{median:.6g}")
        return checks, failed

    return Entry(answers=1, work=traffic["tokens_per_call"], plan=plan,
                 call=call, warm=warm, check=check, spans=SPANS,
                 prepare=prepare, min_calls=len(shapes) * n_in)


# ---- what the benchmark's CPU tests plant under a run ---------------------

def _latent_half_written(monkeypatch, shrink):
    """Latent caches left unwritten past half the prompt."""
    from repro_torch.models import lm
    real = lm._pad_prefill_caches

    def half(cfg, caches, max_len):
        S = caches["latent"].shape[3]
        out = real(cfg, caches, max_len)
        out["latent"][:, :, :, S // 2:] = 0
        return out
    monkeypatch.setattr(lm, "_pad_prefill_caches", half)


def _half_the_batch(monkeypatch, shrink):
    """Half of the batch left out, the other half's answers and latent
    caches in its place."""
    from repro_torch.models import model
    real = model.forward_prefill

    def half(cfg, run, params, batch, max_len, **kw):
        tokens = batch["tokens"]
        keep = (tokens.shape[0] + 1) // 2
        logits, caches = real(cfg, run, params, {"tokens": tokens[:keep]},
                              max_len, **kw)
        idx = torch.arange(tokens.shape[0]) % keep
        return logits[idx], {k: v[:, :, idx] if k == "latent" else v[idx]
                             for k, v in caches.items()}
    monkeypatch.setattr(model, "forward_prefill", half)


def _layer_skipped(monkeypatch, shrink):
    """The last layer's output replaced by its input (its latent kept)."""
    from repro_torch.models import lm
    real = lm._layer

    def skip(cfg, run, kind, ix, r, x, lp, positions, **kw):
        out = real(cfg, run, kind, ix, r, x, lp, positions, **kw)
        return (x,) + out[1:] if ix == cfg.n_layers - 1 else out
    monkeypatch.setattr(lm, "_layer", skip)


def _yarn_off(monkeypatch, shrink):
    """Plain RoPE frequencies in place of YaRN's."""
    from repro_torch.models import attention, layers

    def plain(dim, theta, factor, original, fast, slow, device=None):
        return layers.rope_freqs(dim, theta, device)
    monkeypatch.setattr(attention, "yarn_freqs", plain)


def _scale_without_mscale(monkeypatch, shrink):
    """The softmax scale without YaRN's mscale squared."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "mla_scale",
                        lambda cfg: cfg.qk_head_dim ** -0.5)


def _shared_experts_left_out(monkeypatch, shrink):
    """The shared experts' SwiGLU replaced by zeros."""
    from repro_torch.models import moe
    monkeypatch.setattr(moe, "mlp", lambda p, x: torch.zeros_like(x))


def _gates_renormalised(monkeypatch, shrink):
    """The top-k gates renormalised to sum to 1 (the published model keeps
    them as the softmax gives them)."""
    from repro_torch.models import moe
    real = moe.moe_apply
    monkeypatch.setattr(moe, "moe_apply", lambda p, x, **kw: real(
        p, x, **dict(kw, norm_topk_prob=True)))


# a DeepSeek-V2-shaped model a CPU test holds: 3 layers (one dense), d_model
# 64, 4 heads with q/k of 16 + 16 (rope) and v of 16, a 32-wide latent,
# YaRN over 64 original positions, 8 experts of 32 with top 3 and 2 shared,
# a 512-token vocab, a 256-token budget in two shapes. Its limits are its
# own, from its own readings on the CPU (PERF.md §2: sound runs on 400
# seeds, the control on 200, each fault on 60): at 3 of 8 experts a
# flipped expert is a third of a token's routed FFN, so single rows swing
# wider than at full size (up to 0.30).
TINY = {"config": {"n_layers": 3, "d_model": 64, "n_heads": 4,
                   "n_kv_heads": 4, "d_ff": 96, "moe_d_ff": 32,
                   "n_experts": 8, "top_k": 3, "n_shared_experts": 2,
                   "kv_lora_rank": 32, "qk_nope_head_dim": 16,
                   "qk_rope_head_dim": 16, "v_head_dim": 16,
                   "yarn_original_max_pos": 64, "vocab_size": 512},
        "traffic": {"tokens_per_call": 256, "shapes": [[2, 128], [1, 256]]},
        "limits": {"row": 0.6, "median_row": 0.03, "layer": 0.1,
                   "first_layer": 0.01}}
TESTS = Tests(
    dry_run=TINY, faults_shrink=TINY,
    faults=(Fault(base._one_expert_left_out, ("logits_err_median",)),
            Fault(_layer_skipped, ("logits_err_median",)),
            Fault(_latent_half_written, ("caches_mismatched",)),
            Fault(base._half_the_answers_missing, ("rows_missing",)),
            Fault(_half_the_batch, ("rows_mismatched",)),
            Fault(base._last_token_altered, ("rows_mismatched",)),
            Fault(_yarn_off, ("first_cache_err_max",)),
            Fault(_scale_without_mscale, ("logits_err_median",)),
            Fault(_shared_experts_left_out, ("logits_err_median",)),
            Fault(_gates_renormalised, ("logits_err_median",))),
    control_checks=("logits_err_median", "first_cache_err_max"))
