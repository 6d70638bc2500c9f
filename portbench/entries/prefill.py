"""`forward_prefill`: one prefill step of a fixed token budget a call, the
batch of (B, S) prompts the traffic's shapes list, through the program's
model path, with KV caches built for the decode that would follow.

The traffic (`traffic/<name>.json`): `shapes`, each B x S equal to
`tokens_per_call`; `batches_per_shape` distinct inputs a shape;
`decode_room`, the cache's room past the prompt (up to the
configuration's `context_length`); `attention_impl`, the program's
attention route. Calls come in cycles of one call a shape, in an order
`--seed` permutes, the batch of cycle c being c % batches_per_shape: the
same work on every seed. Weights (bf16, the router float32) and token ids
are made on the device from `--seed`, in set-up.

The configuration (`configs/<name>.json`) names the program's model
(`repro_torch.configs.get_model`); the entry refuses a program whose
sizes differ from the file's.

`correct`: after the window, the plain reference (`reference/moe_lm.py`,
float32) runs once over each distinct input, with the same weights. Every
call's last-token logits, a row a sequence, and the caches of the last
call of each shape, a layer at a time, are held to it by their relative
error, the norm of the difference over the norm of the reference: each
row and each layer against a limit that catches gross faults, and the
median row and the first layer against tighter ones (`LIMITS`).
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from portbench import flops
from portbench.entries import Entry, Fault, Tests

PREFILL = "portbench.prefill"
MOE = "portbench.moe"
ATTENTION = "portbench.attention"
# the program's functions wrapped in spans in a traced run
SPANS = (
    ("repro_torch.models.model", "forward_prefill", PREFILL),
    ("repro_torch.models.moe", "moe_apply", MOE),
    ("repro_torch.models.attention", "attention", ATTENTION),
)
# The bf16 program against the float32 reference: relative errors (the
# norm of the difference over the reference's) of a sequence's last-token
# logits and of a layer's k or v cache of a sequence. Each limit lies
# between the largest reading of sound runs over a dozen seeds or more
# and the smallest of the fp8 control, or of the planted faults where the
# control does not separate (PERF.md §2 gives the readings). The top-k
# routing turns bf16 rounding into a different expert for a few tokens a
# layer, so a single row, and the caches past the first layer, swing
# with it: their limits catch gross faults, and the control is refused
# by the median row and the first layer's caches, which no routing
# precedes.
LIMITS = {"row": 0.4,            # any row
          "median_row": 0.07,    # the median row of a run
          "layer": 0.2,          # any layer's cache of a kept call
          "first_layer": 0.012}  # the first layer's caches


class Plan(NamedTuple):
    """One call: the traffic's shape `shape` (B x S), its input `batch`,
    and the model FLOPs of the call by part (`flops.prefill`)."""
    shape: int
    batch: int
    B: int
    S: int
    flops: Dict[str, float]


def check_sizes(prog, config: dict) -> None:
    """Raise ValueError where the program's ModelConfig `prog` differs
    from the configuration file in a size or setting the file states."""
    names = [f.name for f in dataclasses.fields(prog)] + ["head_dim"]
    for name in names:
        if name in config and name != "name" \
                and getattr(prog, name) != config[name]:
            raise ValueError(
                f"the program's {prog.name} has {name} "
                f"{getattr(prog, name)!r}, the configuration "
                f"{config[name]!r}")


def sizes(config: dict, traffic: dict, shrink: Optional[dict] = None):
    """(the file's sizes, the program's ModelConfig, the traffic), with
    `shrink`'s "config" and "traffic" laid over them for the benchmark's
    CPU tests; the program's model is checked against the file first."""
    from repro_torch.configs import get_model
    prog = get_model(config["name"])
    check_sizes(prog, config)
    if shrink:
        fields = {f.name for f in dataclasses.fields(prog)}
        config = dict(config, **shrink["config"])
        prog = dataclasses.replace(prog, **{
            k: v for k, v in shrink["config"].items() if k in fields})
        check_sizes(prog, config)
        traffic = dict(traffic, **shrink["traffic"])
    for B, S in traffic["shapes"]:
        if B * S != traffic["tokens_per_call"]:
            raise ValueError(f"shape {B} x {S} is not the "
                             f"{traffic['tokens_per_call']}-token budget")
    return config, prog, traffic


def _seed(seed: int, *path: int) -> int:
    """A 64-bit seed of `--seed` and a path (what it seeds)."""
    return int(np.random.SeedSequence([seed % 2**64, *path])
               .generate_state(1, np.uint64)[0])


def make_weights(prog, seed: int, device):
    """The model's weights in the program's tree (`model.param_specs`),
    each leaf in its own type (bf16, the router float32), one call to the
    device's generator a leaf: normals of std 1 / sqrt(fan-in) (the
    contracted width: the LM head's last dim, any other weight's second
    to last), the embedding's std 1, the norms' scales 1."""
    from repro_torch.models import model
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed, 0))

    def leaf(path, p):
        if p.init in ("ones", "zeros", "constant"):
            val = {"ones": 1.0, "zeros": 0.0}.get(p.init, p.const)
            return torch.full(p.shape, val, dtype=p.dtype, device=device)
        fan_in = p.shape[-1] if path[0] == "lm_head" else p.shape[-2]
        std = p.scale if p.scale is not None else fan_in ** -0.5
        w = torch.randn(p.shape, generator=gen, dtype=p.dtype, device=device)
        return w.mul_(std)

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(tree[k], path + (k,)) for k in sorted(tree)}
        return leaf(path, tree)

    return walk(model.param_specs(prog))


def round_through(params, dtype):
    """The weights with every bf16 matrix rounded through `dtype` (fp8),
    one scale a matrix (its last two dims), the matrix's largest magnitude
    mapped to the type's largest finite value: an fp8 weight path. The
    router (float32) and the norms' scales stay as they are."""
    big = torch.finfo(dtype).max

    def leaf(w):
        if w.dtype != torch.bfloat16 or w.dim() < 2:
            return w
        out = torch.empty_like(w)
        src = w.reshape(-1, *w.shape[-2:])
        dst = out.view(-1, *w.shape[-2:])
        for i in range(src.shape[0]):
            m = src[i].float()
            scale = m.abs().amax().clamp_min(1e-30) / big
            dst[i] = ((m / scale).to(dtype).float() * scale).to(w.dtype)
        return out

    def walk(tree):
        return {k: walk(v) for k, v in tree.items()} \
            if isinstance(tree, dict) else leaf(tree)

    return walk(params)


def reference_weights(params, n_layers: int) -> dict:
    """The weights as `reference.moe_lm.prefill` takes them: views of the
    program's tree, a dict a layer."""
    blocks = params["blocks"]["layer0"]
    names = {"norm1": ("norm1", "scale"), "norm2": ("norm2", "scale"),
             "wq": ("attn", "wq"), "wk": ("attn", "wk"),
             "wv": ("attn", "wv"), "wo": ("attn", "wo"),
             "router": ("moe", "router"), "w_gate": ("moe", "w_gate"),
             "w_up": ("moe", "w_up"), "w_down": ("moe", "w_down")}
    stacked = n_layers > 1

    def at(r, a, b):
        w = blocks[a][b]
        return w[r] if stacked else w

    return {"embed": params["embed"]["table"],
            "lm_head": params["lm_head"]["table"],
            "final_norm": params["final_norm"]["scale"],
            "layers": [{n: at(r, a, b) for n, (a, b) in names.items()}
                       for r in range(n_layers)]}


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _sync(on_cuda: bool) -> None:
    if on_cuda:
        torch.cuda.synchronize()


def rel_err(got: torch.Tensor, want: torch.Tensor, dims) -> torch.Tensor:
    """|got - want| / |want| over `dims` (float32)."""
    got, want = got.float(), want.float()
    return ((got - want).square().sum(dims).sqrt()
            / want.square().sum(dims).sqrt().clamp_min(1e-30))


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
    from portbench.reference import moe_lm
    config, prog, traffic = sizes(config, traffic, shrink)
    limits = dict(LIMITS, **(shrink or {}).get("limits", {}))
    if lm.block_pattern(prog)[0] != 1 or not prog.is_moe or prog.qk_norm \
            or prog.sliding_window is not None or prog.tie_embeddings:
        raise ValueError(f"{prog.name}: the prefill reference is a stack of "
                         "attention + MoE layers, without QK-norm, window "
                         "or tied embeddings")
    shapes = [tuple(s) for s in traffic["shapes"]]
    n_in = traffic["batches_per_shape"]
    max_lens = [min(S + traffic["decode_room"], config["context_length"])
                for _, S in shapes]
    part_flops = [flops.prefill(config, B, S) for B, S in shapes]
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
        _sync(on_cuda)
        log(f"the device's context in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        st["params"] = make_weights(prog, seed, device)
        st["program"] = st["params"] if lower is None else round_through(
            st["params"], lower)
        st["inputs"] = []
        for si, (B, S) in enumerate(shapes):
            row = []
            for bi in range(n_in):
                gen = torch.Generator(device=device)
                gen.manual_seed(_seed(seed, 1, si, bi))
                row.append(torch.randint(0, prog.vocab_size, (B, S),
                                         generator=gen, device=device,
                                         dtype=torch.int32))
            st["inputs"].append(row)
        _sync(on_cuda)
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

        def on_layer(r, i, k, v):
            si, bi = keys[i]
            if si not in kept or kept[si][0] != bi:
                return
            S = shapes[si][1]
            errs = []
            for got, want in ((kept[si][1]["k"][r, 0], k),
                              (kept[si][1]["v"][r, 0], v)):
                diff = (got[:, :S].float() - want).square().sum((1, 2, 3))
                diff += got[:, S:].float().square().sum((1, 2, 3))
                errs.append(diff.sqrt() / want.square().sum((1, 2, 3))
                            .sqrt().clamp_min(1e-30))
            cache_err[si].append(float(torch.stack(errs).max()))

        truth = moe_lm.prefill(config, reference_weights(
            st["params"], prog.n_layers),
            [st["inputs"][si][bi] for si, bi in keys], on_layer)
        truth = {key: t.cpu() for key, t in zip(keys, truth)}
        return compare(calls, truth, cache_err, kept, shapes, prog.n_layers,
                       limits)

    return Entry(answers=1, work=traffic["tokens_per_call"], plan=plan,
                 call=call, warm=warm, check=check, spans=SPANS,
                 prepare=prepare, min_calls=len(shapes) * n_in)


def compare(calls, truth, cache_err, kept, shapes, n_layers, limits):
    """Every row of every call against the reference's logits, and each
    kept cache's layers against the reference's k and v, by `limits`
    (`LIMITS`): (checks, calls whose answer did not come whole). A call
    that raised or gave fewer rows than its batch misses them; a kept
    cache with the wrong `cache_len`, or a shape with none kept, misses
    every layer."""
    mismatched = missing = failed = 0
    errs: List[float] = []
    for c in calls:
        want = truth[(c.plan.shape, c.plan.batch)]
        got = c.results
        n = 0 if got is None else min(got.shape[0], c.plan.B)
        missing += c.plan.B - n
        failed += n < c.plan.B
        if n:
            e = rel_err(got[:n], want[:n], 1)
            errs += e.tolist()
            mismatched += int((e > limits["row"]).sum())
    bad_layers = 0
    first = 0.0
    for si, (B, S) in enumerate(shapes):
        errs_si = cache_err.get(si, [])
        lens_ok = si in kept and bool(
            (kept[si][1]["cache_len"] == S).all())
        if not lens_ok or len(errs_si) != n_layers:
            bad_layers += n_layers
            first = float("inf")
            continue
        bad_layers += sum(e > limits["layer"] for e in errs_si)
        first = max(first, errs_si[0])
    median = float(np.median(errs)) if errs else float("inf")
    if errs:
        q = np.quantile(errs, [0.1, 0.9, 0.99])
        log(f"logits rel err over {len(errs)} rows: min {min(errs):.6g}, "
            f"p10 {q[0]:.6g}, median {median:.6g}, p90 {q[1]:.6g}, p99 "
            f"{q[2]:.6g}, max {max(errs):.6g}; cache rel err by layer "
            "(max of k, v over the sequences), per kept shape: " + "; ".join(
                f"{shapes[si][0]}x{shapes[si][1]}: " + " ".join(
                    f"{e:.4g}" for e in v)
                for si, v in sorted(cache_err.items())))
    return ({"rows_mismatched": {"value": mismatched, "limit": 0},
             "caches_mismatched": {"value": bad_layers, "limit": 0},
             "rows_missing": {"value": missing, "limit": 0},
             "logits_err_median": {"value": median,
                                   "limit": limits["median_row"]},
             "first_cache_err_max": {"value": first,
                                     "limit": limits["first_layer"]}},
            failed)


# ---- what the benchmark's CPU tests plant under a run ---------------------

def _one_expert_left_out(monkeypatch, shrink):
    """Top-(k-1) for top-k: one routed expert a token left out."""
    from repro_torch.models import moe
    real = moe.moe_apply
    monkeypatch.setattr(moe, "moe_apply", lambda p, x, *, top_k, **kw:
                        real(p, x, top_k=top_k - 1, **kw))


def _layer_skipped(monkeypatch, shrink):
    """The last layer's output replaced by its input (its caches kept)."""
    from repro_torch.models import lm
    real = lm._layer

    def skip(cfg, run, kind, ix, r, x, lp, positions, **kw):
        out = real(cfg, run, kind, ix, r, x, lp, positions, **kw)
        return (x,) + out[1:] if r == cfg.n_layers - 1 else out
    monkeypatch.setattr(lm, "_layer", skip)


def _caches_half_written(monkeypatch, shrink):
    """Caches left unwritten past half the prompt: a step that leaves its
    state as it found it there."""
    from repro_torch.models import lm
    real = lm._pad_prefill_caches

    def half(cfg, caches, max_len):
        S = caches["k"].shape[3]
        out = real(cfg, caches, max_len)
        for key in ("k", "v"):
            out[key][:, :, :, S // 2:] = 0
        return out
    monkeypatch.setattr(lm, "_pad_prefill_caches", half)


def _half_the_answers_missing(monkeypatch, shrink):
    """Every second prefill returns no logits."""
    from repro_torch.models import model
    real = model.forward_prefill
    n = [0]

    def some(*args, **kw):
        logits, caches = real(*args, **kw)
        n[0] += 1
        return (logits[:0] if n[0] % 2 else logits), caches
    monkeypatch.setattr(model, "forward_prefill", some)


def _half_the_batch(monkeypatch, shrink):
    """Half of the batch left out, the other half's answers and caches in
    its place."""
    from repro_torch.models import model
    real = model.forward_prefill

    def half(cfg, run, params, batch, max_len, **kw):
        tokens = batch["tokens"]
        keep = (tokens.shape[0] + 1) // 2
        logits, caches = real(cfg, run, params, {"tokens": tokens[:keep]},
                              max_len, **kw)
        idx = torch.arange(tokens.shape[0]) % keep
        return logits[idx], {k: v[:, :, idx] if k in ("k", "v") else v[idx]
                             for k, v in caches.items()}
    monkeypatch.setattr(model, "forward_prefill", half)


def _last_token_altered(monkeypatch, shrink):
    """The first sequence's last prompt token altered where the program
    takes it."""
    from repro_torch.models import model
    real = model.forward_prefill

    def alter(cfg, run, params, batch, max_len, **kw):
        tokens = batch["tokens"].clone()
        tokens[0, -1] = (tokens[0, -1] + 1) % cfg.vocab_size
        return real(cfg, run, params, {"tokens": tokens}, max_len, **kw)
    monkeypatch.setattr(model, "forward_prefill", alter)


# an olmoe-shaped model a CPU test holds: 2 layers, d_model 64, 4 heads of
# 16, 8 experts of 32 with top 2, a 512-token vocab, a 256-token budget in
# two shapes. Its limits are its own, set from its own readings on the CPU
# (PERF.md §2: sound runs on 400 seeds, the control on 200, each fault on
# 60): with top 2 of 8 a flipped expert is half of a token's FFN, so a
# single row and layer swing wider than at full size, and the fp8 control
# moves the median row less.
TINY = {"config": {"n_layers": 2, "d_model": 64, "n_heads": 4,
                   "n_kv_heads": 4, "head_dim": 16, "d_ff": 32,
                   "n_experts": 8, "top_k": 2, "vocab_size": 512},
        "traffic": {"tokens_per_call": 256, "shapes": [[2, 128], [4, 64]]},
        "limits": {"row": 1.0, "median_row": 0.02, "layer": 0.3,
                   "first_layer": 0.012}}
TESTS = Tests(
    dry_run=TINY, faults_shrink=TINY,
    faults=(Fault(_one_expert_left_out, ("logits_err_median",)),
            Fault(_layer_skipped, ("logits_err_median",)),
            Fault(_caches_half_written, ("caches_mismatched",)),
            Fault(_half_the_answers_missing, ("rows_missing",)),
            Fault(_half_the_batch, ("rows_mismatched",)),
            Fault(_last_token_altered, ("rows_mismatched",))),
    control_checks=("logits_err_median", "first_cache_err_max"))
