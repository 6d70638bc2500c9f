"""Parity of the port's training parts with the reference's, on the CPU.

* `models/losses.py::cross_entropy` against the reference's, with and
  without a mask, over padded vocab columns: loss, accuracy and token
  count within 1e-6 (float32 sums in another order).
* `train/optimizer.py`: AdamW, AdamW with bf16 moments and Adafactor over
  one seeded tree of 1-, 2- and 3-D leaves (float32 and one bf16 leaf),
  3 steps from the same grads: every param and state leaf keeps the
  reference's dtype and is within 1e-6 of its largest |value| in float32;
  a bf16 leaf within one bf16 step (2**-8 relative) of it. The
  `abstract_state` trees have the reference's shapes and dtypes.
* `data/pipeline.py`: batches equal exactly for qwen3-4b, phi-3-vision
  (patches) and whisper (frames) at steps 0, 7 and 1000, for a host
  slice, and through the prefetching iterator.
* `checkpoint/checkpointer.py`: a reference checkpoint restores into the
  port and the port's into the reference, bit-equal, with bf16 leaves.
* `distributed/fault_tolerance.py`: the reference's laws
  (`tests/test_train_ckpt_ft.py`) on the port.
* The ssd autograd Function (`kernels/ssd_scan/ops.py::SsdIntraChunk`),
  with the plain version passed in as its forward, gives the gradients
  of autograd through `ssd_intra_chunk_ref` within 1e-5; the CUDA route
  runs the kernel inside it. `flash_attention` raises under a gradient.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as JCkpt  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import losses as jlosses  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.checkpoint.checkpointer import \
    Checkpointer as PCkpt  # noqa: E402
from repro_torch.configs import ARCHS as P_ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.data import pipeline as ppipe  # noqa: E402
from repro_torch.distributed import fault_tolerance as ft  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import \
    ssd_intra_chunk_ref  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import lm as plm  # noqa: E402
from repro_torch.models import losses as plosses  # noqa: E402
from repro_torch.models.params import (subtree, tree_items,  # noqa: E402
                                       tree_map)
from repro_torch.train import optimizer as popt  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return convert.tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.tensor_to_numpy(x)
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if x.dtype == jnp.bfloat16 else np.asarray(x)


# ---------------------------------------------------------------------------
# cross_entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("real_vocab", [None, 130])
def test_cross_entropy_matches_reference(masked, real_vocab):
    rng = np.random.RandomState(5)
    logits = (rng.randn(3, 7, 136) * 3).astype(np.float32)
    labels = rng.randint(0, real_vocab or 136, (3, 7)).astype(np.int32)
    labels[0, :3] = np.argmax(logits[0, :3, :real_vocab], -1)  # some hits
    mask = (rng.rand(3, 7) > 0.3).astype(np.float32) if masked else None
    jl, jm = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   None if mask is None else
                                   jnp.asarray(mask), real_vocab=real_vocab)
    pl, pm = plosses.cross_entropy(_t(logits), _t(labels),
                                   None if mask is None else _t(mask),
                                   real_vocab=real_vocab)
    assert pl.dtype == torch.float32
    for k in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(_np(pm[k]), _np(jm[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert float(pm["accuracy"]) > 0


def test_cross_entropy_bf16_logits_in_float32():
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 5, 128).astype(np.float32)
    labels = rng.randint(0, 128, (2, 5)).astype(np.int32)
    jl, _ = jlosses.cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16),
                                  jnp.asarray(labels))
    pl, _ = plosses.cross_entropy(_t(logits).to(torch.bfloat16), _t(labels))
    assert pl.dtype == torch.float32
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

SHAPES = {"a": ((7,), np.float32), "b": {"w": ((5, 6), np.float32),
                                          "z": ((2, 3, 4), np.float32)},
          "c": ((4, 8), "bfloat16")}


def _tree(rng, shapes, scale):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    shape, dt = shapes
    a = (rng.randn(*shape) * scale).astype(np.float32)
    return (jnp.asarray(a).astype(jnp.bfloat16) if dt == "bfloat16"
            else jnp.asarray(a))


def _close_tree(got, want, what):
    for path, w in tree_items(want):
        g = subtree(got, path)
        wd = str(w.dtype)
        assert str(g.dtype).replace("torch.", "") == wd, (what, path)
        gn, wn = _np(g).astype(np.float64), _np(w).astype(np.float64)
        scale = max(np.abs(wn).max(), 1e-30)
        tol = 2.0 ** -8 if wd == "bfloat16" else 1e-6
        assert np.abs(gn - wn).max() <= tol * scale, (what, path)


@pytest.mark.parametrize("opt", [
    dict(name="adamw"), dict(name="adamw", bf16_moments=True),
    dict(name="adafactor")], ids=["adamw", "adamw-bf16", "adafactor"])
def test_optimizer_matches_reference(opt):
    cfg_kw = dict(lr=1e-2, warmup_steps=2, **opt)
    jcfg, pcfg = jopt.OptConfig(**cfg_kw), popt.OptConfig(**cfg_kw)
    rng = np.random.RandomState(11)
    jp = _tree(rng, SHAPES, 1.0)
    pp = convert.tree_from_numpy(jax.device_get(jp), "cpu")
    pp["c"] = pp["c"].to(torch.bfloat16)
    js, ps = jopt.init(jp, jcfg), popt.init(pp, pcfg)
    _close_tree(ps, js, "init")
    for i in range(3):
        jg = _tree(rng, SHAPES, 0.5 + i)       # the clip engages at i > 0
        pg = convert.tree_from_numpy(jax.device_get(jg), "cpu")
        pg["c"] = pg["c"].to(torch.bfloat16)
        jp, js, jm = jopt.update(jp, jg, js, jcfg)
        pp2, ps, pm = popt.update(pp, pg, ps, pcfg)
        assert pp2 is pp                       # updated in place
        _close_tree(pp, jp, f"params, step {i}")
        _close_tree(ps, js, f"state, step {i}")
        assert ps["step"].dtype == torch.int32 and int(ps["step"]) == i + 1
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("opt", [dict(name="adamw"),
                                 dict(name="adamw", bf16_moments=True),
                                 dict(name="adafactor")])
def test_abstract_state_matches_reference(opt):
    jspecs = jlm.build_param_specs(_jcfg("mamba2-1.3b"))
    pspecs = plm.build_param_specs(_pcfg("mamba2-1.3b"))
    want = jopt.abstract_state(jspecs, jopt.OptConfig(**opt))
    got = popt.abstract_state(pspecs, popt.OptConfig(**opt))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    items = tree_items(got)
    assert len(items) == len(flat)
    for (path, g), (jpath, w) in zip(items, flat):
        assert "/".join(path) == "/".join(p.key for p in jpath)
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)


def test_lr_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=7)
    for s in (0, 1, 3, 7, 20):
        got = popt.lr_schedule(popt.OptConfig(**cfg),
                               torch.tensor(s, dtype=torch.int32))
        want = jopt.lr_schedule(jopt.OptConfig(**cfg), jnp.int32(s))
        assert got.dtype == torch.float32
        assert float(got) == float(want)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

def _jcfg(arch):
    return J_ARCHS[arch]


def _pcfg(arch):
    return P_ARCHS[arch]


@pytest.mark.parametrize("arch", ["qwen3-4b", "phi-3-vision-4.2b",
                                  "whisper-base"])
def test_data_pipeline_batches_equal(arch):
    jshape = JShape("t", seq_len=96, global_batch=4, kind="train")
    pshape = PShape("t", seq_len=96, global_batch=4, kind="train")
    dcfg = dict(seed=77, noise=0.25)
    for hosts in ((0, 1), (1, 2)):
        jp = jpipe.DataPipeline(_jcfg(arch), jshape,
                                jpipe.DataConfig(**dcfg), *hosts)
        pp = ppipe.DataPipeline(_pcfg(arch), pshape,
                                ppipe.DataConfig(**dcfg), *hosts)
        for step in (0, 7, 1000):
            want, got = jp.batch_at(step), pp.batch_at(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    keys = {"phi-3-vision-4.2b": "patch_embeds", "whisper-base": "frames"}
    if arch in keys:
        assert keys[arch] in want
    it = pp.iterate(5, 8)
    got = [(s, b["labels"]) for s, b in it]
    assert [s for s, _ in got] == [5, 6, 7]
    for s, labels in got:
        np.testing.assert_array_equal(labels, jp.batch_at(s)["labels"])


def test_pipeline_iterator_stops_its_thread():
    import threading
    pp = ppipe.DataPipeline(_pcfg("qwen3-4b"),
                            PShape("t", seq_len=16, global_batch=2,
                                   kind="train"), prefetch=1)
    before = threading.active_count()
    it = pp.iterate(0)                       # unbounded
    assert next(it)[0] == 0
    it.close()                               # consumer breaks off
    assert threading.active_count() == before


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _state_trees(rng):
    jparams = {"blocks": {"w": jnp.asarray(rng.randn(3, 4, 5).astype(
        np.float32)).astype(jnp.bfloat16),
        "scale": jnp.asarray(rng.randn(5).astype(np.float32))},
        "embed": {"table": jnp.asarray(rng.randn(6, 5).astype(
            np.float32)).astype(jnp.bfloat16)}}
    jopt_state = {"v": {"blocks": {"w": {"vr": jnp.asarray(
        rng.rand(3, 4).astype(np.float32)), "vc": jnp.asarray(
        rng.rand(3, 5).astype(np.float32))},
        "scale": {"v": jnp.asarray(rng.rand(5).astype(np.float32))}},
        "embed": {"table": {"vr": jnp.asarray(rng.rand(6).astype(
            np.float32)), "vc": jnp.asarray(rng.rand(5).astype(
                np.float32))}}},
        "step": jnp.asarray(9, jnp.int32)}
    return jparams, jopt_state


def _same(got, want):
    gi, wi = tree_items(got), jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(gi) == len(wi)
    for (path, g), (jpath, w) in zip(gi, wi):
        assert "/".join(path) == "/".join(p.key for p in jpath)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_array_equal(_np(g), _np(w))


def test_reference_checkpoint_restores_in_port(tmp_path):
    jparams, jstate = _state_trees(np.random.RandomState(3))
    JCkpt(str(tmp_path)).save(4, jparams, jstate, extra={"next_step": 5})
    pparams = convert.tree_from_numpy(jax.device_get(jparams), "cpu")
    pparams = {"blocks": dict(pparams["blocks"], w=pparams["blocks"]["w"]
                              .to(torch.bfloat16)),
               "embed": {"table": pparams["embed"]["table"]
                         .to(torch.bfloat16)}}
    like_p = tree_map(torch.zeros_like, pparams)
    like_o = convert.tree_from_numpy(jax.device_get(jstate), "cpu")
    ck = PCkpt(str(tmp_path))
    assert ck.latest_step() == 4
    p, o, extra = ck.restore(4, like_p, like_o)
    assert extra == {"next_step": 5}
    _same(p, jparams)
    _same(o, jstate)


def test_port_checkpoint_restores_in_reference(tmp_path):
    jparams, jstate = _state_trees(np.random.RandomState(4))
    pparams = {"blocks": {"w": _t(_np(jparams["blocks"]["w"])).to(
        torch.bfloat16), "scale": _t(_np(jparams["blocks"]["scale"]))},
        "embed": {"table": _t(_np(jparams["embed"]["table"])).to(
            torch.bfloat16)}}
    pstate = convert.tree_from_numpy(jax.device_get(jstate), "cpu")
    ck = PCkpt(str(tmp_path))
    ck.save(6, pparams, pstate, extra={"next_step": 7}, blocking=False)
    pparams["blocks"]["scale"].add_(1.0)    # after the snapshot: not saved
    ck.wait()
    like_p = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    like_o = jax.tree_util.tree_map(jnp.zeros_like, jstate)
    p, o, extra = JCkpt(str(tmp_path)).restore(6, like_p, like_o)
    assert extra == {"next_step": 7}
    _same(p, jparams)
    _same(o, jstate)


def test_checkpoint_atomicity_and_gc(tmp_path):
    """The reference's test_checkpoint_atomicity and test_checkpoint_gc on
    the port."""
    ck = PCkpt(str(tmp_path))
    params = {"w": torch.ones(3)}
    opt = {"m": torch.zeros(3), "step": torch.zeros((), dtype=torch.int32)}
    ck.save(5, params, opt)
    bad = tmp_path / "step_000000009"
    bad.mkdir()
    (bad / "shard_0.npz").write_bytes(b"garbage")
    assert ck.latest_step() == 5
    p2, _, _ = ck.restore(5, params, opt)
    np.testing.assert_array_equal(p2["w"].numpy(), np.ones(3))
    ck2 = PCkpt(str(tmp_path / "gc"), keep=2)
    for s in (1, 2, 3, 4):
        ck2.save(s, {"w": torch.ones(2)},
                 {"step": torch.zeros((), dtype=torch.int32)})
    assert ck2._committed_steps() == [3, 4]


# ---------------------------------------------------------------------------
# Fault tolerance: the reference's laws on the port
# ---------------------------------------------------------------------------

def test_elastic_remesh():
    t = ft.MeshTopology(pod=2, data=16, model=16)
    assert ft.elastic_remesh(t, lost_chips=256) == ft.MeshTopology(1, 16, 16)
    t3 = ft.elastic_remesh(t, lost_chips=10)
    assert t3.chips <= 502 and t3.model == 16
    assert ft.elastic_remesh(ft.MeshTopology(1, 2, 16), lost_chips=31) \
        is None


def test_straggler_policy():
    sp = ft.StragglerPolicy(threshold=3.0, warmup_steps=3)
    assert not any(sp.record(0.1) for _ in range(10))
    assert sp.record(0.5)
    assert not sp.record(0.12)


def test_resume_or_init_fresh_and_resumed(tmp_path):
    ck = PCkpt(str(tmp_path))
    calls = []

    def init_fn():
        calls.append(1)
        return ({"w": torch.zeros(2)},
                {"step": torch.zeros((), dtype=torch.int32)})

    p, o, start = ft.resume_or_init(ck, init_fn)
    assert start == 0 and len(calls) == 1
    ck.save(3, {"w": torch.full((2,), 2.0)},
            {"step": torch.tensor(3, dtype=torch.int32)},
            extra={"next_step": 4})
    p, o, start = ft.resume_or_init(ck, init_fn)
    assert start == 4 and len(calls) == 2 and float(p["w"][0]) == 2.0
    assert o["step"].dtype == torch.int32


def test_bounded_dispatcher_on_cpu():
    d = ft.BoundedDispatcher(max_inflight=1)
    for i in range(3):
        assert d.dispatch({"loss": torch.tensor(float(i))})["loss"] == i
    assert len(d._inflight) == 1
    d.drain()
    assert d._inflight == []
    ft.block_until_ready({"x": torch.zeros(2)})


# ---------------------------------------------------------------------------
# The ssd autograd Function; flash refuses a gradient
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, B=2, nc=3, Q=16, nh=3, hd=8, ds=4):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, nc, Q, nh, hd, generator=g) * 0.5,
            -torch.rand(B, nc, Q, nh, generator=g) * 0.2,
            torch.randn(B, nc, Q, ds, generator=g) * 0.5,
            torch.randn(B, nc, Q, ds, generator=g) * 0.5]


@pytest.mark.parametrize("need", [(True, True, True, True),
                                  (False, True, False, True)])
def test_ssd_function_backward_matches_autograd(need):
    base = _ssd_inputs(1)
    cot = [torch.randn(s.shape, generator=torch.Generator().manual_seed(i))
           for i, s in enumerate(ssd_intra_chunk_ref(*base))]

    def grads(fn):
        ins = [t.clone().requires_grad_(n) for t, n in zip(base, need)]
        outs = fn(*ins)
        torch.autograd.backward(outs, cot)
        return [t.grad for t in ins]

    want = grads(ssd_intra_chunk_ref)
    got = grads(lambda *a: ssd_ops.SsdIntraChunk.apply(
        ssd_intra_chunk_ref, *a))
    for g, w, n in zip(got, want, need):
        if not n:
            assert g is None and w is None
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_ssd_backward_is_finite_past_exp_overflow():
    """Over a chunk whose decays sum past -88, exp(cs[q] - cs[s]) above
    the diagonal overflows float32; the plain version masks before the
    exp, so its values are unchanged and its gradient stays finite (the
    mamba2-1.3b training step at full width reaches this)."""
    x, dA, Bm, Cm = _ssd_inputs(3, Q=64)
    dA = dA * 20.0                     # ~-2 a row: ~-128 over the chunk
    assert float(dA.sum(dim=2).min()) < -88.0
    ins = [t.clone().requires_grad_() for t in (x, dA, Bm, Cm)]
    outs = ssd_ops.SsdIntraChunk.apply(ssd_intra_chunk_ref, *ins)
    grads = torch.autograd.grad([o.sum() for o in outs], ins)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert all(bool(torch.isfinite(o).all()) for o in outs)


def test_cuda_route_runs_the_kernel_inside_the_function(monkeypatch):
    """Off the CPU, `ssd_intra_chunk` launches the kernel's wrapper inside
    `SsdIntraChunk`: its outputs carry the Function's grad_fn (the
    wrapper's own outputs, from ctypes, carry none), and the gradient
    reaches every input. Meta tensors stand in for the card; the stub
    wrapper computes shapes under no_grad, as the kernel's outputs come."""
    calls = []

    def stub(*args):
        calls.append(1)
        with torch.no_grad():
            return ssd_intra_chunk_ref(*args)

    monkeypatch.setattr(ssd_ops._kernel, "ssd_intra_chunk", stub)
    ins = [t.to("meta").requires_grad_() for t in _ssd_inputs(2)]
    outs = ssd_ops.ssd_intra_chunk(*ins)
    assert calls == [1]
    assert all("SsdIntraChunk" in type(o.grad_fn).__name__ for o in outs)
    grads = torch.autograd.grad([o.sum() for o in outs], ins)
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in ins]
    assert calls == [1]                      # the backward is the plain one


def test_flash_attention_refuses_a_gradient():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, 2, 32, generator=g) for _ in range(3))
    out = fa_ops.flash_attention(q, k, v, block_q=16, block_k=16)
    assert out.shape == q.shape                  # no grad: runs
    kr = k.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="xla_blocked"):
        fa_ops.flash_attention(q, kr, v, block_q=16, block_k=16)
    with torch.no_grad():                        # as forward_train serves
        fa_ops.flash_attention(q, kr, v, block_q=16, block_k=16)

