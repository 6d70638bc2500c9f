"""Parity of the port's train step (`repro_torch.train.step`) with the
reference's `repro.train.step`, on the CPU, at reduced fp32 sizes.

The reference's params (float32) are carried across; the batch is seeded
numpy tokens and labels (random labels: the data pipeline's labels equal
its tokens, which a tied embedding predicts at once, giving mamba2 a loss
of ~0 and no gradient to compare). Archs: qwen3-4b (dense, qk-norm),
mamba2-1.3b (SSD) and olmoe-1b-7b (MoE with its aux loss,
capacity_factor = n_experts so no token is dropped). B = 4, S = 48,
16-row attention blocks; these sizes are used by no other test
under `tests/` (the reference's cold-cache tests count compiles).

* `build_loss_fn`'s loss within 1e-5 (relative) and every grad leaf within
  1e-4 x its largest |g_ref|.
* Microbatches: the grads the optimizer receives with M = 2 equal M = 1's
  within 1e-5 of their largest |g| in the port, and the reference's M = 2
  within 1e-4; the total losses likewise (with M = 1 the step reports the
  cross-entropy as "loss" and the aux loss apart, with M > 1 the mean
  total, in both packages).
* Remat on against off: loss and every grad bit-equal (and for jamba's
  reduced period of 8 layers, each layer rematerialized), and a 24-layer
  mamba2 (nested remat groups of `_scan_group(24)` = 4 blocks) too, whose
  SSD calls are counted: 24 forward, 18 to rebuild each group's
  boundaries (the last block of a group is not rebuilt), 24 per block.
* Three whole `train_step`s (AdamW, lr 1e-3 after 2 warmup steps) from
  the same params and batches: each step's loss within 1e-4 (relative).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import reduced_model as j_reduced  # noqa: E402
from repro.configs.base import RunConfig as JRun  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.params import materialize as jmaterialize  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import ARCHS as P_ARCHS  # noqa: E402
from repro_torch.configs import reduced_model as p_reduced  # noqa: E402
from repro_torch.configs.base import RunConfig as PRun  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.models.params import subtree, tree_items  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402
from repro_torch.train import step as pstep  # noqa: E402

ARCHS = ["qwen3-4b", "mamba2-1.3b", "olmoe-1b-7b"]
B, S = 4, 48
OPT = dict(lr=1e-3, warmup_steps=2)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch, **kw):
    cfg, pcfg = j_reduced(J_ARCHS[arch]), p_reduced(P_ARCHS[arch])
    if cfg.is_moe:
        kw["capacity_factor"] = float(cfg.n_experts)
    return dataclasses.replace(cfg, **kw), dataclasses.replace(pcfg, **kw)


def _runs(cfg, pcfg, microbatches=1, remat=False):
    kw = dict(microbatches=microbatches, remat=remat, attn_block_q=16,
              attn_block_k=16)
    return (JRun(model=cfg, shape=JShape("t", S, B, "train"), **kw),
            PRun(model=pcfg, shape=PShape("t", S, B, "train"), **kw))


def _params(cfg):
    params = jmaterialize(jax.random.PRNGKey(0), jlm.build_param_specs(cfg),
                          dtype_override=jnp.float32)
    return params, convert.tree_from_numpy(jax.device_get(params), "cpu")


def _batch(cfg, seed):
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _grads_close(got, want, tol):
    want = convert.tree_from_numpy(jax.device_get(want), "cpu") \
        if not isinstance(tree_items(want)[0][1], torch.Tensor) else want
    items = tree_items(got)
    assert [p for p, _ in items] == [p for p, _ in tree_items(want)]
    for path, g in items:
        w = subtree(want, path)
        assert g.dtype == w.dtype, path
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= tol * scale, path


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, pcfg = _cfgs(arch)
    run, prun = _runs(cfg, pcfg)
    params, pparams = _params(cfg)
    jb, pb = _batch(cfg, 1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        jstep.build_loss_fn(cfg, run), has_aux=True))(params, jb)
    (pl, pm), pg = pstep.value_and_grad(
        pstep.build_loss_fn(pcfg, prun))(pparams, pb)
    assert _rel(pl, jl) <= 1e-5
    for k in ("loss", "accuracy", "tokens", "aux"):
        assert abs(float(pm[k]) - float(jm[k])) <= 1e-5 * max(
            1.0, abs(float(jm[k]))), k
    if cfg.is_moe:
        assert float(pm["aux"]) > 0
    _grads_close(pg, jg, 1e-4)
    assert not any(p.requires_grad for _, p in tree_items(pparams))


def _recorded_step(mod, opt_mod, monkeypatch, cfg, run, opt_cfg):
    """The train step, with the grads it hands the optimizer recorded."""
    seen = []
    update = opt_mod.update

    def rec(params, grads, state, c):
        seen.append(grads)
        return update(params, grads, state, c)

    monkeypatch.setattr(mod.opt_mod, "update", rec)
    return mod.build_train_step(cfg, run, opt_cfg), seen


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches(arch, monkeypatch):
    cfg, pcfg = _cfgs(arch)
    jb, pb = _batch(cfg, 2)
    grads, losses = {}, {}
    for m in (1, 2):
        _, prun = _runs(cfg, pcfg, microbatches=m)
        _, pparams = _params(cfg)
        step, seen = _recorded_step(pstep, popt, monkeypatch, pcfg, prun,
                                    popt.OptConfig(**OPT))
        _, _, met = step(pparams, popt.init(pparams, popt.OptConfig(**OPT)),
                         pb)
        # M = 1 reports the cross-entropy as "loss" and the aux loss apart;
        # M > 1 the mean total (the reference's step does the same)
        grads[m] = seen[0]
        losses[m] = met["loss"] + (pstep.AUX_WEIGHT * met["aux"] if m == 1
                                   else 0.0)
    run, _ = _runs(cfg, pcfg, microbatches=2)
    params, _ = _params(cfg)
    jstep_fn, jseen = _recorded_step(jstep, jopt, monkeypatch, cfg, run,
                                     jopt.OptConfig(**OPT))
    _, _, jmet = jstep_fn(params, jopt.init(params, jopt.OptConfig(**OPT)),
                          jb)
    assert all(g.dtype == torch.float32 for _, g in tree_items(grads[2]))
    _grads_close(grads[2], grads[1], 1e-5)
    _grads_close(grads[2], jseen[0], 1e-4)
    assert _rel(losses[2], losses[1]) <= 1e-5
    assert _rel(losses[2], jmet["loss"]) <= 1e-5


def _loss_and_grads(pcfg, prun, pparams, pb):
    return pstep.value_and_grad(pstep.build_loss_fn(pcfg, prun))(pparams, pb)


def _bit_equal(a, b):
    for (path, x), (_, y) in zip(tree_items(a), tree_items(b)):
        assert torch.equal(x, y), path


@pytest.mark.parametrize("arch", ARCHS + ["jamba-1.5-large-398b"])
def test_remat_is_bit_equal(arch):
    """jamba's 8-layer period runs the per-layer remat path."""
    cfg, pcfg = _cfgs(arch)
    _, pparams = _params(cfg)
    _, pb = _batch(cfg, 3)
    out = {}
    for remat in (False, True):
        _, prun = _runs(cfg, pcfg, remat=remat)
        out[remat] = _loss_and_grads(pcfg, prun, pparams, pb)
    assert torch.equal(out[True][0][0], out[False][0][0])
    _bit_equal(out[True][1], out[False][1])


def test_nested_remat_groups(monkeypatch):
    """24 Mamba2 layers: remat nests groups of 4 blocks; bit-equal to no
    remat, and the SSD calls of one forward + backward counted."""
    assert plm._scan_group(24) == 4 and plm._scan_group(48) == 6
    assert plm._scan_group(20) == 1
    calls = []
    plain = ssd_ops.ssd_intra_chunk_ref
    monkeypatch.setattr(ssd_ops, "ssd_intra_chunk_ref",
                        lambda *a: calls.append(1) or plain(*a))
    _, pcfg = _cfgs("mamba2-1.3b", n_layers=24, d_model=32)
    params = plm.build_param_specs(pcfg)
    from repro_torch.models.params import materialize
    pparams = materialize(params, generator=torch.Generator().manual_seed(0),
                          device="cpu", dtype_override=torch.float32)
    _, pb = _batch(pcfg, 4)
    out, counts = {}, {}
    for remat in (False, True):
        calls.clear()
        _, prun = _runs(pcfg, pcfg, remat=remat)
        out[remat] = _loss_and_grads(pcfg, prun, pparams, pb)
        counts[remat] = len(calls)
    assert torch.equal(out[True][0][0], out[False][0][0])
    _bit_equal(out[True][1], out[False][1])
    assert counts == {False: 24, True: 24 + 18 + 24}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    cfg, pcfg = _cfgs(arch)
    run, prun = _runs(cfg, pcfg, remat=True)
    params, pparams = _params(cfg)
    jcfg, pcfg_opt = jopt.OptConfig(**OPT), popt.OptConfig(**OPT)
    jstate, pstate = jopt.init(params, jcfg), popt.init(pparams, pcfg_opt)
    jfn = jax.jit(jstep.build_train_step(cfg, run, jcfg))
    pfn = pstep.build_train_step(pcfg, prun, pcfg_opt)
    for i in range(3):
        jb, pb = _batch(cfg, 10 + i)
        params, jstate, jm = jfn(params, jstate, jb)
        pparams, pstate, pm = pfn(pparams, pstate, pb)
        for k in ("loss", "grad_norm"):
            assert _rel(pm[k], jm[k]) <= 1e-4, (i, k)
        assert float(pm["lr"]) == float(jm["lr"])
    assert int(pstate["step"]) == 3


def test_prefill_and_decode_steps_are_the_model_entries():
    cfg, pcfg = _cfgs("qwen3-4b")
    _, prun = _runs(cfg, pcfg)
    _, pparams = _params(cfg)
    _, pb = _batch(cfg, 5)
    prompt = {"tokens": pb["tokens"][:, :16]}
    logits, caches = pstep.build_prefill_step(pcfg, prun, 24)(pparams,
                                                              prompt)
    want, _ = functools.partial(plm.forward_prefill, pcfg, prun)(
        pparams, prompt, 24)
    assert torch.equal(logits, want)
    nxt, caches = pstep.build_decode_step(pcfg, prun)(
        pparams, caches, {"tokens": logits.argmax(-1).int()})
    assert nxt.shape == (B, 1, pcfg.padded_vocab)
    assert int(caches["cache_len"][0]) == 17
