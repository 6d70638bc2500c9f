"""The port's dry run (`repro_torch.launch.dryrun`) against the
reference's (`src/repro/launch/dryrun.py`), on the CPU.

* Argument bytes: for every applicable cell of `ARCHS` x shapes, on the
  (16, 16) and (2, 16, 16) meshes, rank 0's bytes of params (bf16 and
  int8), optimizer state, batch and caches, from the port's abstract
  state, equal the sum over the reference's leaves of each shape
  ceil-divided by the mesh axes of its `PartitionSpec` (the reference's
  `Sharder` on a stub mesh; nothing is traced).
* Traced cells: a reduced cell of each kind (train, prefill, decode) at
  (16, 16) and a prefill at (2, 16, 16), on the CPU route over the fake
  process group: every report key, `hbm_per_device_bytes` by the
  reference's formula.
* FLOPs: a dense prefill whose widths split over every rank, at 16
  tokens: the counted product FLOPs x 256 chips within 5% of
  `model_flops` without the vocab table's share (the lookup is no
  product, and prefill takes the logits of the last token only).
* The counter's live-bytes peak on a hand-made op sequence, exactly.
* The kernels' fake branches on fake CUDA tensors (this CPU build makes
  them, but cannot take a view of one): the plain version's output
  shapes and dtypes, the kernel's `ValueError`s, no launch, the work
  counted.
* The CLI against the reference: flags, the cell list and the skip
  list from `repro.configs`; the reference's dry run is not imported
  (it sets `XLA_FLAGS` at import, which every later subprocess would
  inherit).
"""
import dataclasses
import math
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.configs import get_run_config as j_run_config  # noqa: E402
from repro.configs.registry import all_cells  # noqa: E402
from repro.distributed.sharding import Sharder as JSharder  # noqa: E402
from repro.models import model as jM  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.configs import ARCHS, get_run_config, reduced_model  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import Sharder  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.roofline.counter import StepCounter  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the reference dry run's cache axes (`src/repro/launch/dryrun.py:40-48`)
REF_CACHE_AXES = {
    "cache_len": ("batch",),
    "k": (None, None, "batch", "kvseq", "kv_heads", None),
    "v": (None, None, "batch", "kvseq", "kv_heads", None),
    "ssm_h": (None, None, "batch", "heads", None, None),
    "ssm_conv": (None, None, "batch", None, "ssm"),
    "cross_k": (None, None, "batch", None, "kv_heads", None),
    "cross_v": (None, None, "batch", None, "kv_heads", None),
}
CELLS = [(a, s) for a, s, ok in all_cells() if ok]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
KEYS = {"arch", "shape", "mesh", "chips", "kind", "lower_s", "compile_s",
        "tag", "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes", "hbm_per_device_bytes",
        "hlo_flops_per_device", "hlo_bytes_per_device", "hlo_text_bytes",
        "parsed_flops_per_device", "parsed_hbm_bytes_per_device",
        "collective_bytes_by_op", "collective_bytes_per_device", "roofline"}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fake_world():
    """The fake process group of the reference's 512 devices, ended after
    the test (other files run in this process afterwards)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- argument bytes

def _stub(names, shape):
    return (types.SimpleNamespace(shape=dict(zip(names, shape)),
                                  axis_names=names),
            types.SimpleNamespace(shape=shape, mesh_dim_names=names))


def _spec_bytes(shape, itemsize, spec, sizes):
    """Bytes of `shape` ceil-divided by the mesh axes of a PartitionSpec."""
    dims = list(shape)
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple)
                     else (entry,) if entry else ()):
            dims[d] = math.ceil(dims[d] / sizes[name])
    return math.prod(dims) * itemsize


def _ref_bytes(run, jmesh, sizes):
    """Rank 0's argument bytes of the reference's cell: its own spec trees,
    each leaf's PartitionSpec from its `Sharder`."""
    sh = JSharder(jmesh, run)
    cfg, shape = run.model, run.shape
    seen = []                      # the Params the shardings are asked of
    jM.abstract_params(cfg, lambda p: seen.append(p),
                       quantize=run.quantize_weights)
    total = sum(_spec_bytes(p.shape, jnp.dtype(p.dtype).itemsize,
                            sh.param_spec(p), sizes) for p in seen)
    asked = []
    batch = jM.input_specs(cfg, shape,
                           lambda axes, s: asked.append((axes, s)))
    for (axes, s), leaf in zip(asked, batch.values()):
        total += _spec_bytes(s, leaf.dtype.itemsize, sh.act_spec(axes, s),
                             sizes)
    if shape.kind == "train":
        seen = []
        ocfg = j_opt.OptConfig(name=run.optimizer,
                               bf16_moments=run.bf16_moments)
        j_opt.abstract_state(jM.param_specs(cfg), ocfg,
                             lambda p: seen.append(p))
        total += 4 + sum(_spec_bytes(p.shape, jnp.dtype(p.dtype).itemsize,
                                     sh.param_spec(p), sizes) for p in seen)
    elif shape.kind == "decode":
        for k, v in jM.cache_shapes(cfg, shape.global_batch,
                                    shape.seq_len).items():
            total += _spec_bytes(v.shape, v.dtype.itemsize,
                                 sh.act_spec(REF_CACHE_AXES[k], v.shape),
                                 sizes)
    return total


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch, shape_name", CELLS)
def test_argument_bytes_match_reference(arch, shape_name, mesh):
    names, shape = MESHES[mesh]
    jmesh, pmesh = _stub(names, shape)
    sizes = dict(zip(names, shape))
    for quantize in (False, True):
        jrun = dataclasses.replace(j_run_config(arch, shape_name),
                                   quantize_weights=quantize)
        prun = dataclasses.replace(get_run_config(arch, shape_name),
                                   quantize_weights=quantize)
        specs, _ = D.abstract_args(prun, prun.shape, Sharder(pmesh, prun))
        assert D.local_bytes(specs, shape) == _ref_bytes(jrun, jmesh, sizes)


def test_cache_axes_are_the_reference_dry_run_s():
    assert D.CACHE_AXES == REF_CACHE_AXES


# --------------------------------------------------------- traced cells

def _reduced(arch, shape_name, seq, batch, **kw):
    run = get_run_config(arch, shape_name)
    shape = ShapeConfig(shape_name, seq, batch, run.shape.kind)
    return dataclasses.replace(run, model=reduced_model(run.model),
                               shape=shape, **kw)


TRACED = [
    ("llama3-8b", "train_4k", False, dict(seq=32, batch=32, microbatches=2,
                                          attn_block_q=16, attn_block_k=16)),
    ("qwen3-4b", "prefill_32k", False, dict(seq=32, batch=32,
                                            attn_block_q=16,
                                            attn_block_k=16)),
    ("mamba2-1.3b", "decode_32k", False, dict(seq=64, batch=32)),
    ("llama3-8b", "prefill_32k", True, dict(seq=32, batch=64,
                                            attn_block_q=16,
                                            attn_block_k=16)),
]


@pytest.mark.parametrize("arch, shape_name, multi_pod, kw", TRACED)
def test_reduced_cell_traces(fake_world, arch, shape_name, multi_pod, kw):
    kw = dict(kw)
    run = _reduced(arch, shape_name, kw.pop("seq"), kw.pop("batch"), **kw)
    rep = D.lower_cell(arch, shape_name, multi_pod, run_override=run,
                       device="cpu")
    assert KEYS <= set(rep), KEYS - set(rep)
    assert rep["chips"] == (512 if multi_pod else 256)
    assert rep["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert rep["kind"] == run.shape.kind
    assert rep["hbm_per_device_bytes"] == (
        rep["argument_size_in_bytes"] + rep["temp_size_in_bytes"]
        + max(rep["output_size_in_bytes"] - rep["alias_size_in_bytes"], 0))
    specs, _ = D.abstract_args(run, run.shape,
                               Sharder(types.SimpleNamespace(
                                   shape=(2, 16, 16) if multi_pod
                                   else (16, 16),
                                   mesh_dim_names=MESHES[rep["mesh"]][0]),
                                   run))
    assert rep["argument_size_in_bytes"] == D.local_bytes(
        specs, MESHES[rep["mesh"]][1])
    if run.shape.kind == "train":        # params and moments donated
        assert rep["alias_size_in_bytes"] == D.local_bytes(
            [specs["params"], specs["opt_state"]], MESHES[rep["mesh"]][1])
    elif run.shape.kind == "decode":
        assert rep["alias_size_in_bytes"] == D.local_bytes(
            specs["caches"], MESHES[rep["mesh"]][1])
    else:
        assert rep["alias_size_in_bytes"] == 0
    assert rep["parsed_flops_per_device"] > 0
    assert rep["hlo_flops_per_device"] == rep["parsed_flops_per_device"]
    assert rep["hlo_text_bytes"] > 0
    assert rep["collective_bytes_per_device"] == pytest.approx(
        sum(rep["collective_bytes_by_op"].values()))
    assert rep["roofline"]["model_flops"] == RA.model_flops(run.model,
                                                            run.shape)


def test_flops_match_model_flops(fake_world):
    """Dense prefill, every width split over the 16 model ranks and the
    batch over the 16 data ranks, 16 tokens a sequence: the counted
    products x 256 against 2 N tokens without the vocab table's share
    (N counts the untied head for every token; prefill unembeds the last
    one, counted back in). Attention's S^2 products (all 16 x 16 pairs
    of each sequence, masked: 1.2%) make the rest; measured ratio
    1.0116."""
    base = reduced_model(ARCHS["llama3-8b"])
    cfg = dataclasses.replace(base, d_model=256, n_heads=16, n_kv_heads=16,
                              d_head=16, d_ff=512)
    run = dataclasses.replace(get_run_config("llama3-8b", "prefill_32k"),
                              model=cfg,
                              shape=ShapeConfig("prefill_32k", 16, 32,
                                                "prefill"),
                              attn_block_q=16, attn_block_k=16)
    rep = D.lower_cell("llama3-8b", "prefill_32k", False, run_override=run,
                       device="cpu")
    B, S = run.shape.global_batch, run.shape.seq_len
    vd = cfg.vocab_size * cfg.d_model
    tables = 1 if cfg.tie_embeddings else 2       # embedding and head
    want = RA.model_flops(cfg, run.shape) - 2 * tables * vd * B * S \
        + 2 * vd * B                              # the last token's logits
    ratio = rep["parsed_flops_per_device"] * rep["chips"] / want
    assert abs(ratio - 1) <= 0.05, ratio


# -------------------------------------------------------------- tracker

@pytest.mark.parametrize("fake", [False, True])
def test_tracker_peak_is_exact(fake):
    from torch._subclasses.fake_tensor import FakeTensorMode
    ctx = FakeTensorMode() if fake else torch.autograd.grad_mode.no_grad()
    with ctx:
        a = torch.ones(1000)                       # 4000 B, an argument
        with StepCounter() as c:
            assert c.track({"a": a}) == 4000
            b = a * 2                              # 8000 live
            v = b.view(10, 100)                    # a view: nothing
            b.add_(1)                              # in place: nothing
            d = v.sum(0)                           # 8400
            del b, v                               # b's storage freed: 4400
            e = torch.empty(3000)                  # 16400 live: the peak
            del e                                  # 4400
            f = d.to(torch.float64)                # 5200
        assert c.peak == 16400
        assert c.live == 5200
        assert c.totals()["peak_bytes"] == 16400
        del f


# --------------------------------------------------------- fake kernels

def _fake_cuda(*shapes, dtype=torch.float32):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    with mode:
        return mode, [torch.empty(s, dtype=dtype, device="cuda")
                      for s in shapes]


def test_ssd_fake_branch():
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    B, nc, Q, nh, hd, ds = 2, 3, 16, 4, 8, 16
    shapes = [(B, nc, Q, nh, hd), (B, nc, Q, nh), (B, nc, Q, ds),
              (B, nc, Q, ds)]
    want = ssd_intra_chunk_ref(*(torch.zeros(s) for s in shapes))
    launches, fakes = K.ssd_intra_chunk.launches, K.ssd_intra_chunk.fake_calls
    mode, args = _fake_cuda(*shapes)
    with mode, StepCounter() as c:
        got = K.ssd_intra_chunk(*args)
        with pytest.raises(ValueError, match="head dim"):
            K.ssd_intra_chunk(torch.empty(B, nc, Q, nh, 72, device="cuda"),
                              *args[1:])
        with pytest.raises(ValueError, match="float32"):
            K.ssd_intra_chunk(args[0].to(torch.bfloat16), *args[1:])
        with pytest.raises(ValueError, match="does not match"):
            K.ssd_intra_chunk(args[0], torch.empty(B, nc, 8, nh,
                                                   device="cuda"),
                              *args[2:])
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    assert all(t.dtype == w.dtype and t.device.type == "cuda"
               for t, w in zip(got, want))
    assert K.ssd_intra_chunk.launches == launches
    assert K.ssd_intra_chunk.fake_calls == fakes + 1
    assert c.totals()["kernels"]["ssd_intra_chunk"] == {
        "calls": 1, "flops": K.work(B, nc, Q, nh, hd, ds)[0],
        "bytes": K.work(B, nc, Q, nh, hd, ds)[1]}
    # the work of the serving shape, the figure of the kernel's bound
    assert K.work(4, 8, 256, 64, 64, 128)[0] == pytest.approx(1.748e10,
                                                               rel=1e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fake_branch(dtype):
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q_s, kv_s = (2, 8, 64, 32), (2, 2, 64, 32)
    want = attention_ref(torch.zeros(q_s, dtype=dtype),
                         torch.zeros(kv_s, dtype=dtype),
                         torch.zeros(kv_s, dtype=dtype), causal=True)
    launches, fakes = K.flash_attention_bhsd.launches, \
        K.flash_attention_bhsd.fake_calls
    mode, (q, k, v) = _fake_cuda(q_s, kv_s, kv_s, dtype=dtype)
    with mode, StepCounter() as c:
        o = K.flash_attention_bhsd(q, k, v, causal=True)
        with pytest.raises(ValueError, match="head dim"):
            K.flash_attention_bhsd(*(torch.empty(2, 8, 64, 40, dtype=dtype,
                                                 device="cuda")
                                     for _ in range(3)))
        with pytest.raises(ValueError, match="multiples"):
            K.flash_attention_bhsd(q, k, v, block_q=48)
        with pytest.raises(ValueError, match="contiguous"):
            K.flash_attention_bhsd(torch.empty_strided(
                q_s, (16384, 2048, 1, 64), dtype=dtype, device="cuda"), k, v)
    assert tuple(o.shape) == tuple(want.shape) and o.dtype == want.dtype
    assert o.device.type == "cuda"
    assert K.flash_attention_bhsd.launches == launches
    assert K.flash_attention_bhsd.fake_calls == fakes + 1
    flops, nbytes = K.work(q, k, causal=True)
    assert flops == 4 * 32 * 2 * 8 * (64 * 65 // 2)
    assert c.totals()["kernels"]["flash_attention"] == {
        "calls": 1, "flops": flops, "bytes": nbytes}


# ------------------------------------------------------------------ CLI

def test_cli_cells_and_skips_match_reference():
    ref = list(all_cells())
    assert D.cells(D.parser().parse_args(["--all"])) == ref
    for arch, shape_name, ok in ref:
        args = D.parser().parse_args(["--arch", arch, "--shape", shape_name])
        assert D.cells(args) == [(arch, shape_name, ok)]
    with pytest.raises(AssertionError, match="--all"):
        D.cells(D.parser().parse_args([]))
    args = D.parser().parse_args(["--multi-pod", "both", "--skip-existing",
                                  "--out", "x", "--device", "cpu"])
    assert (args.multi_pod, args.skip_existing, args.out, args.device) == (
        "both", True, "x", "cpu")
    assert Path(D.parser().parse_args([]).out) == ROOT / "reports" / \
        "dryrun_torch"


def test_cli_writes_reports_and_skips(tmp_path, capsys, monkeypatch):
    """`main` as the reference's: the skip line (its text read from the
    reference's source), one report a mesh under the reference's names;
    the cell's run is cut to the reduced model (`get_run_config` patched)."""
    src = (ROOT / "src/repro/launch/dryrun.py").read_text()
    D.main(["--arch", "qwen3-4b", "--shape", "long_500k", "--device", "cpu",
            "--out", str(tmp_path)])
    line = capsys.readouterr().out.splitlines()[0]
    assert line == ("[SKIP] qwen3-4b__long_500k (long_500k needs "
                    "sub-quadratic attention; see DESIGN.md §4)")
    assert "long_500k needs sub-quadratic" in src
    monkeypatch.setattr(D, "get_run_config", lambda arch, shape_name: _reduced(
        arch, shape_name, 64, 64))
    D.main(["--arch", "qwen3-4b", "--shape", "decode_32k", "--multi-pod",
            "both", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[ok] qwen3-4b__decode_32k__pod1" in out
    assert "[ok] qwen3-4b__decode_32k__pod2" in out
    assert "done: ok=2 fail=0 skipped_cells=0" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "qwen3-4b__decode_32k__pod1.json", "qwen3-4b__decode_32k__pod2.json"]


def test_lower_cell_starts_and_ends_its_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(KeyError):
        D.lower_cell("no-such-arch", "decode_32k", False, device="cpu")
    assert not dist.is_initialized()
    run = _reduced("qwen3-4b", "decode_32k", 64, 32)
    D.lower_cell("qwen3-4b", "decode_32k", False, run_override=run,
                 device="cpu")
    assert not dist.is_initialized()


def test_importing_starts_nothing():
    import subprocess
    import sys
    probe = ("import torch.distributed as dist, repro_torch.launch.dryrun, "
             "sys; sys.exit(int(dist.is_initialized()))")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    assert subprocess.run([sys.executable, "-c", probe], env=env,
                          timeout=120).returncode == 0
