"""The port's distributed layer (`repro_torch.distributed.sharding`,
`launch/mesh.py`) against the reference's `repro.distributed.sharding`,
on the CPU.

* Spec parity: for every config of `ARCHS` with each of its applicable
  run configs, every param of `param_specs(cfg)` (bf16 and int8) gets the
  reference's `PartitionSpec` entries from the port's `param_spec`, at
  meshes (16, 16), (2, 16, 16), (2, 4) and (1, 1). Stub meshes drive
  both (each `Sharder` reads only the mesh's shape and axis names).
  `act_spec` likewise, with and without a shape, at every axes tuple the
  reference's model constrains (recorded from its reduced forwards) and
  the port's extra ones, and at the cache axes of the reference's
  dry run (`src/repro/launch/dryrun.py:38-54`).
* Placements: each spec entry becomes `Shard(dim)` on its mesh dims.
  On the fake process group (256 ranks, `FakeTensorMode`, no data), a
  (4096, 1024) ("embed", "ffn") param distributes to (256, 64) a rank.
* The step law: a 4-rank gloo world (subprocesses, FileStore rendezvous
  in tmp_path) on a (2, 2) mesh runs one AdamW step of llama3-8b reduced
  (d_model widened to 1024 so that FSDP shards the embed dims; fp32,
  seq 32, batch 4) through `Sharder.constrain`, DTensor params and
  moments from `param_sharding`: the loss within 1e-5 of the
  one-process step's, every gradient leaf within 1e-5 of its largest
  |g|, every updated leaf within 1e-5 of its largest |p|, and the
  step's collective bytes (`roofline.counter`) nonzero. On the same
  mesh, mamba2 reduced runs its SSD on (batch / 2, heads / 2) shards
  (`kernels/_dtensor.run_local`), its logits within 1e-5 of the
  one-process forward's largest |logit|. The optimizer
  is `OptConfig()` (first-step lr 3e-6): AdamW's first step divides each
  gradient entry by its own magnitude, so entries within ~1e-8 of zero
  turn reduction-order differences into update differences of up to lr
  (at lr 1e-3, 2.9e-4 of max |p|); the gradients are held directly.
  The vocab is split on "model" there: `cross_entropy` alone on the
  sharded logits (a padded tail masked) equals the whole-logits loss
  within 1e-5 with no all-gather and all-reduces of (B, S) values only,
  and `blocked_attention` on (batch, head) shards with GQA kv heads split
  like q's equals the plain call and gathers nothing.
* A (1, 1) mesh keeps the whole-vocab loss path, bit-equal.
"""
import functools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_run_config as j_run_config  # noqa: E402
from repro.configs import reduced_model as j_reduced  # noqa: E402
from repro.configs.base import RunConfig as JRun  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.registry import all_cells  # noqa: E402
from repro.distributed.sharding import Sharder as JSharder  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.params import Param as JParam  # noqa: E402
from repro.models.params import materialize as jmaterialize  # noqa: E402
from repro_torch.configs import get_run_config as p_run_config  # noqa: E402
from repro_torch.distributed.sharding import Sharder  # noqa: E402
from repro_torch.models import model as pM  # noqa: E402
from repro_torch.models.params import Param, tree_items  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (2, 4)), (("data", "model"), (1, 1))]
CELLS = [(a, s) for a, s, ok in all_cells() if ok]

# the dry run's cache axes (`src/repro/launch/dryrun.py:40-48`)
CACHE_AXES = {
    "cache_len": ("batch",),
    "k": (None, None, "batch", "kvseq", "kv_heads", None),
    "v": (None, None, "batch", "kvseq", "kv_heads", None),
    "ssm_h": (None, None, "batch", "heads", None, None),
    "ssm_conv": (None, None, "batch", None, "ssm"),
    "cross_k": (None, None, "batch", None, "kv_heads", None),
    "cross_v": (None, None, "batch", None, "kv_heads", None),
}
# axes the port constrains that the reference's model does not: its SSD
# constrains the (b, S, nh[, hd]) inputs where the reference constrains
# the chunked ones
PORT_AXES = {("batch", None, "heads", None), ("batch", None, "heads")}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _meshes(names, shape):
    return (types.SimpleNamespace(shape=dict(zip(names, shape)),
                                  axis_names=names),
            types.SimpleNamespace(shape=shape, mesh_dim_names=names))


def _jax_leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JParam))[0]


def _ref_param_specs(cfg, quantize):
    specs = jlm.build_param_specs(cfg)
    if quantize:
        from repro.models.quant import quantize_spec_tree
        specs = dict(specs, blocks=quantize_spec_tree(specs["blocks"]))
    return _jax_leaves(specs)


@pytest.mark.parametrize("arch, shape_name", CELLS)
def test_param_specs_match_reference(arch, shape_name):
    jrun, prun = j_run_config(arch, shape_name), p_run_config(arch,
                                                              shape_name)
    for quantize in (False, True):
        refs = _ref_param_specs(jrun.model, quantize)
        items = tree_items(pM.param_specs(prun.model, quantize))
        assert len(refs) == len(items)
        for names, shape in MESHES:
            jmesh, pmesh = _meshes(names, shape)
            jsh, psh = JSharder(jmesh, jrun), Sharder(pmesh, prun)
            for (jpath, jp), (path, pp) in zip(refs, items):
                assert "/".join(path) == "/".join(k.key for k in jpath)
                assert (tuple(pp.shape), tuple(pp.axes)) == (
                    tuple(jp.shape), tuple(jp.axes))
                assert psh.param_spec(pp) == tuple(jsh.param_spec(jp)), \
                    (arch, shape_name, names, path)


def _recorded_axes(arch):
    """Every (axes, shape) the reference's reduced model constrains in a
    train forward, a prefill and a decode step."""
    seen = set()

    def rec(x, axes):
        seen.add(tuple(axes))
        return x

    cfg = j_reduced(J_ARCHS[arch])
    run = JRun(model=cfg, shape=JShape("t", 16, 2, "train"),
               attn_block_q=8, attn_block_k=8, remat=False)
    params = jmaterialize(jax.random.PRNGKey(0), jlm.build_param_specs(cfg))
    batch = {"tokens": np.zeros((2, 16 - (cfg.n_patches or 0)), np.int32)}
    if cfg.is_enc_dec:
        # bf16 frames: with float32 ones the reference's decoder scan
        # refuses its promoted carry (ROADMAP Queue 3)
        batch["frames"] = jnp.zeros((2, cfg.enc_len, cfg.d_model),
                                    jnp.bfloat16)
    jax.eval_shape(lambda p, b: jlm.forward_train(cfg, run, p, b, rec),
                   params, batch)
    _, caches = jax.eval_shape(
        lambda p, b: jlm.forward_prefill(cfg, run, p, b, 24, rec),
        params, batch)
    jax.eval_shape(
        lambda p, c: jlm.forward_decode(
            cfg, run, p, {"tokens": np.zeros((2, 1), np.int32)}, c,
            constrain=rec), params, caches)
    return seen


@functools.lru_cache(maxsize=1)
def _axes():
    """The reference's recorded axes, the port's extra ones and the cache
    axes (recorded once, at the first test that needs them)."""
    return sorted({a for arch in ("llama3-8b", "mamba2-1.3b", "olmoe-1b-7b",
                                  "whisper-base", "jamba-1.5-large-398b")
                   for a in _recorded_axes(arch)} | PORT_AXES
                  | set(CACHE_AXES.values()), key=repr)


def _dims(cfg, shape):
    return {"batch": shape.global_batch, "kvseq": shape.seq_len,
            "heads": cfg.n_heads or 1, "kv_heads": cfg.n_kv_heads or 1,
            "embed": cfg.d_model, "vocab": cfg.padded_vocab,
            "experts": cfg.n_experts or 1, "ffn": cfg.d_ff or 1,
            "ssm": 2 * cfg.d_model, None: 7}


@pytest.mark.parametrize("arch, shape_name", CELLS)
def test_act_specs_match_reference(arch, shape_name):
    jrun, prun = j_run_config(arch, shape_name), p_run_config(arch,
                                                              shape_name)
    dims = _dims(jrun.model, jrun.shape)
    for names, shape in MESHES:
        jmesh, pmesh = _meshes(names, shape)
        jsh, psh = JSharder(jmesh, jrun), Sharder(pmesh, prun)
        for axes in _axes():
            for shp in (None, tuple(dims[a] for a in axes)):
                assert psh.act_spec(axes, shp) == \
                    tuple(jsh.act_spec(axes, shp)), (names, axes, shp)
        for key, spec in pM.cache_shapes(prun.model, jrun.shape.global_batch,
                                         jrun.shape.seq_len).items():
            axes = CACHE_AXES[key]
            assert psh.act_spec(axes, spec.shape) == \
                tuple(jsh.act_spec(axes, spec.shape)), (names, key)


def test_recorded_axes_cover_every_model_site():
    """The reference's model constrains these logical layouts (a guard that
    the recording above reached the attention, SSD, MoE, cross-attention
    and decode-cache sites)."""
    for axes in [("batch", None, "heads", None), ("batch", None, "embed"),
                 ("batch", "kvseq", "kv_heads", None),
                 ("batch", None, "vocab"), ("batch", None, "ssm"),
                 ("batch", "experts", None, None),
                 ("batch", None, None, "heads", None)]:
        assert axes in _axes(), axes


def test_param_spec_no_duplicate_axes():
    """`tests/test_data_sharding_hlo.py`'s law on jamba: a mesh axis at
    most once per spec, at every mesh."""
    run = p_run_config("jamba-1.5-large-398b", "train_4k")
    p = Param((16, 8192, 24576), ("experts", "embed", "ffn"))
    for names, shape in MESHES:
        spec = Sharder(_meshes(names, shape)[1], run).param_spec(p)
        flat = [e for entry in spec if entry for e in
                (entry if isinstance(entry, tuple) else (entry,))]
        assert len(flat) == len(set(flat)), (names, spec)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    run = p_run_config("llama3-8b", "train_4k")
    sh = Sharder(_meshes(("pod", "data", "model"), (2, 16, 16))[1], run)
    assert sh.placements((("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements((None, "data")) == (Replicate(), Shard(1),
                                             Replicate())
    assert sh.replicated() == (Replicate(),) * 3
    p = Param((4096, 1024), ("embed", "ffn"))
    assert sh.param_sharding(p) == sh.placements(sh.param_spec(p))


@pytest.fixture
def fake_world():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_local_shapes_on_the_fake_group(fake_world):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(device_type="cpu")
    assert tuple(mesh.shape) == (16, 16)
    assert mesh.mesh_dim_names == ("data", "model")
    with pytest.raises(RuntimeError, match="512"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    run = p_run_config("llama3-8b", "train_4k")
    assert run.fsdp
    sh = Sharder(mesh, run)
    p = Param((4096, 1024), ("embed", "ffn"))
    assert sh.param_spec(p) == ("data", "model")
    with FakeTensorMode():
        t = distribute_tensor(torch.empty(p.shape), mesh,
                              sh.param_sharding(p))
        assert tuple(t.to_local().shape) == (256, 64)
        assert tuple(t.shape) == (4096, 1024)


def test_constrain_leaves_plain_tensors_alone():
    run = p_run_config("llama3-8b", "train_4k")
    sh = Sharder(_meshes(("data", "model"), (2, 4))[1], run)
    x = torch.ones(4, 8, 16)
    assert sh.constrain(x, ("batch", None, "embed")) is x


# ------------------------------------------------------------ the step law

_WORKER = r"""
import dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor
from repro_torch.configs import ARCHS, reduced_model
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.distributed.sharding import Sharder
from repro_torch.models import model as M
from repro_torch.models.params import subtree, tree_items, tree_map
from repro_torch.roofline.counter import count_step
from repro_torch.train import optimizer as opt, step as st

cfg = dataclasses.replace(reduced_model(ARCHS["llama3-8b"]), d_model=1024)
run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 4, "train"),
                fsdp=True, remat=False, attn_block_q=16, attn_block_k=16)
ocfg = opt.OptConfig()
specs = M.param_specs(cfg)
params = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu",
                       dtype_override=torch.float32)
rng = np.random.RandomState(0)
batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 32))
                             .astype(np.int32)) for k in ("tokens", "labels")}

seen = []
update = opt.update
def rec(p, g, s, c):
    seen.append(g)
    return update(p, g, s, c)
opt.update = rec

p1 = tree_map(lambda a: a.clone(), params)
p1, _, m1 = st.build_train_step(cfg, run, ocfg)(p1, opt.init(p1, ocfg), batch)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
sh = Sharder(mesh, run)
p2 = tree_map(lambda p, a: distribute_tensor(a.clone(), mesh,
                                             sh.param_sharding(p)),
              specs, params)
(p2, s2, m2), counts = count_step(
    st.build_train_step(cfg, run, ocfg, sh.constrain), p2,
    opt.init(p2, ocfg), batch)
full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
out = {"loss": [float(m1["loss"]), float(full(m2["loss"]))],
       "sharded": sorted("/".join(path) for path, p in tree_items(p2)
                         if any(pl.is_shard() for pl in p.placements)),
       "moments_sharded": all(
           subtree(s2["m"], path).placements == p.placements
           for path, p in tree_items(p2)),
       "grad": {}, "param": {}, "coll_bytes": counts["coll_bytes"],
       "coll_by_op": counts["coll_by_op"]}
for path, a in tree_items(seen[0]):
    b = full(subtree(seen[1], path))
    out["grad"]["/".join(path)] = float((a - b).abs().max()) / float(
        a.abs().max())
for path, a in tree_items(p1):
    b = full(subtree(p2, path))
    out["param"]["/".join(path)] = float((a - b).abs().max()) / float(
        a.abs().max())

# the SSD on head shards: mamba2 reduced, its forward on the same mesh
from repro_torch.kernels.ssd_scan import ops as ssd_ops
local = []
ref = ssd_ops.ssd_intra_chunk_ref
def counted(x, *a):
    local.append(list(x.shape))
    return ref(x, *a)
ssd_ops.ssd_intra_chunk_ref = counted
mcfg = reduced_model(ARCHS["mamba2-1.3b"])
mrun = RunConfig(model=mcfg, shape=ShapeConfig("t", 32, 4, "train"),
                 fsdp=True, remat=False)
mp_ = M.init_params(torch.Generator().manual_seed(0), mcfg, device="cpu",
                    dtype_override=torch.float32)
with torch.no_grad():
    want, _ = M.forward_train(mcfg, mrun, mp_, batch)
    n = len(local)
    got, _ = M.forward_train(mcfg, mrun, tree_map(
        lambda p, a: distribute_tensor(a.clone(), mesh, sh.param_sharding(p)),
        M.param_specs(mcfg), mp_), batch, Sharder(mesh, mrun).constrain)
out["ssd_logits"] = float((want - full(got)).abs().max()) / float(
    want.abs().max())
out["ssd_local"] = [local[0], local[n]]

# the vocab-sharded loss alone, on the sharded logits
from repro_torch.distributed.sharding import plain_as_replicated
from repro_torch.models import attention as attn
from repro_torch.models.losses import cross_entropy
with torch.no_grad():
    lg, _ = M.forward_train(cfg, run, p2, batch, sh.constrain)
    out["vocab_sharded"] = any(pl.is_shard(2) for pl in lg.placements)
    with plain_as_replicated(lg):
        (l_sh, m_sh), c = count_step(cross_entropy, lg, batch["labels"],
                                     real_vocab=cfg.vocab_size - 3)
    l_pl, m_pl = cross_entropy(full(lg), batch["labels"],
                               real_vocab=cfg.vocab_size - 3)
out["ce"] = [float(full(l_sh)), float(l_pl)]
out["acc"] = [float(full(m_sh["accuracy"])), float(m_pl["accuracy"])]
out["ce_coll"] = c["coll_by_op"]

# blocked attention on (batch, head) shards, kv heads split like q's
g = torch.Generator().manual_seed(3)
q, k, v = (torch.randn(4, 32, h, 16, generator=g) for h in (4, 2, 2))
want = attn.blocked_attention(q, k, v, block_q=16, block_k=16)
dq, dk, dv = (distribute_tensor(t, mesh, [Shard(0), Shard(2)])
              for t in (q, k, v))
got, c = count_step(attn.blocked_attention, dq, dk, dv, block_q=16,
                    block_k=16)
out["attn_err"] = float((full(got) - want).abs().max())
out["attn_coll"] = c["coll_by_op"]
if rank == 0:
    print("RESULT " + json.dumps(out))
dist.destroy_process_group()
"""


def test_sharded_step_matches_one_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), "4",
                               store], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), \
        [err[-2000:] for _, err in outs]
    line = [s for s in outs[0][0].splitlines() if s.startswith("RESULT ")]
    res = json.loads(line[0][len("RESULT "):])
    l1, l2 = res["loss"]
    assert abs(l1 - l2) <= 1e-5 * abs(l1)
    assert max(res["grad"].values()) <= 1e-5, res["grad"]
    assert max(res["param"].values()) <= 1e-5, res["param"]
    # TP and FSDP both took: the attention/MLP weights and the tables are
    # DTensors sharded over the mesh, and their moments shard like them
    assert "blocks/layer0/mlp/w_gate" in res["sharded"]
    assert "embed/table" in res["sharded"]
    assert res["moments_sharded"]
    assert res["coll_bytes"] > 0
    assert res["coll_by_op"].get("all-reduce", 0) > 0
    # the SSD ran on (batch / 2, heads / 2) shards, and agrees
    (b, nc, q, nh, hd), local = res["ssd_local"]
    assert local == [b // 2, nc, q, nh // 2, hd]
    assert res["ssd_logits"] <= 1e-5
    # the loss over a vocab split on "model": no gather of the logits,
    # all-reduces of (B, S) values only (max, sum of exp, label logit,
    # argmax value and index: 5 x 4 x 32 values of <= 8 B, and scalars)
    assert res["vocab_sharded"]
    l_sh, l_pl = res["ce"]
    assert abs(l_sh - l_pl) <= 1e-5 * abs(l_pl)
    assert res["acc"][0] == res["acc"][1]
    assert "all-gather" not in res["ce_coll"], res["ce_coll"]
    assert 0 < res["ce_coll"]["all-reduce"] <= 8 * 4 * 32 * 8, \
        res["ce_coll"]
    # GQA heads on head shards: each rank's own q and k/v heads, no gather
    assert res["attn_err"] <= 1e-6
    assert "all-gather" not in res["attn_coll"], res["attn_coll"]


# ------------------------------------------- a (1, 1) mesh in this process

@pytest.fixture
def host_mesh():
    """`make_host_mesh` on the CPU: a one-rank gloo group (started by the
    call) and a (1, 1) mesh; the group is ended after the test, since
    other files run in this process afterwards."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    try:
        yield make_host_mesh(device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _distribute(specs, params, mesh, sh):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.params import tree_map
    return tree_map(lambda p, a: distribute_tensor(a.clone(), mesh,
                                                   sh.param_sharding(p)),
                    specs, params)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def test_one_rank_mesh_train_step_is_bit_equal(host_mesh, monkeypatch):
    """The CPU rehearsal of `chip_smoke.py` phase 18 (b): mamba2 reduced
    (bf16, fsdp) on a (1, 1) mesh, DTensor params and AdamW moments,
    `Sharder.constrain`: loss and updated params bit-equal to the plain
    step, with as many SSD intra-chunk calls (each on its local shard)."""
    from repro_torch.configs import ARCHS, reduced_model
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.params import tree_map
    from repro_torch.train import optimizer as opt, step as st

    calls = []
    ref = ssd_ops.ssd_intra_chunk_ref

    def counted(*a):
        calls.append(type(a[0]).__name__)
        return ref(*a)

    monkeypatch.setattr(ssd_ops, "ssd_intra_chunk_ref", counted)
    cfg = reduced_model(ARCHS["mamba2-1.3b"])
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 32, 2, "train"),
                    fsdp=True, remat=True)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=2)
    params = pM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    p1 = tree_map(lambda a: a.clone(), params)
    p1, _, m1 = st.build_train_step(cfg, run, ocfg)(p1, opt.init(p1, ocfg),
                                                    batch)
    plain = len(calls)
    sh = Sharder(host_mesh, run)
    p2 = _distribute(pM.param_specs(cfg), params, host_mesh, sh)
    p2, s2, m2 = st.build_train_step(cfg, run, ocfg, sh.constrain)(
        p2, opt.init(p2, ocfg), batch)
    assert len(calls) == 2 * plain and set(calls[plain:]) == {"Tensor"}
    assert torch.equal(m1["loss"], _full(m2["loss"]))
    for path, a in tree_items(p1):
        from repro_torch.models.params import subtree
        b = subtree(p2, path)
        assert type(b).__name__ == "DTensor", path
        assert torch.equal(a, _full(b)), path


def test_one_rank_mesh_prefill_is_bit_equal(host_mesh):
    """The CPU rehearsal of phase 18 (c): qwen3-4b reduced in bf16,
    `forward_prefill` through the flash route (its plain version here,
    on each local shard) with the (1, 1) mesh's `constrain`: logits and
    caches bit-equal to the plain call."""
    from repro_torch.configs import ARCHS, reduced_model
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import lm as plm
    cfg = reduced_model(ARCHS["qwen3-4b"])
    run = RunConfig(model=cfg, shape=ShapeConfig("p", 32, 2, "prefill"),
                    attention_impl="pallas_flash")
    params = pM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32)
    with torch.no_grad():
        la, ca = plm.forward_prefill(cfg, run, params, {"tokens": tokens},
                                     40)
        sh = Sharder(host_mesh, run)
        dparams = _distribute(pM.param_specs(cfg), params, host_mesh, sh)
        lb, cb = plm.forward_prefill(cfg, run, dparams, {"tokens": tokens},
                                     40, sh.constrain)
    assert torch.equal(la, _full(lb))
    for key in ca:
        assert torch.equal(ca[key], _full(cb[key])), key


def test_one_rank_mesh_loss_takes_the_whole_vocab_path(host_mesh,
                                                      monkeypatch):
    """On a (1, 1) mesh no mesh dim of size > 1 splits the vocab, so the
    loss takes the whole-vocab path (the sharded one is stubbed to
    raise), bit-equal to the plain call."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.distributed.sharding import plain_as_replicated
    from repro_torch.models import losses
    monkeypatch.setattr(losses, "_sharded_terms", lambda *a: 1 / 0)
    g = torch.Generator().manual_seed(4)
    logits = torch.randn(2, 8, 256, generator=g)
    labels = torch.randint(0, 250, (2, 8), generator=g)
    want = losses.cross_entropy(logits, labels, real_vocab=250)
    d = distribute_tensor(logits, host_mesh, [Shard(0), Shard(2)])
    with plain_as_replicated(d):
        got = losses.cross_entropy(d, labels, real_vocab=250)
    assert torch.equal(_full(got[0]), want[0])
    for key in want[1]:
        assert torch.equal(_full(got[1][key]), want[1][key]), key


def test_kernels_refuse_a_coupled_shard(host_mesh):
    """A DTensor sharded along a dim the kernel couples (the sequence for
    flash attention, the chunk's rows for the SSD) raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    q = distribute_tensor(torch.randn(1, 64, 2, 32), host_mesh,
                          (Replicate(), Shard(1)))
    with torch.no_grad(), pytest.raises(ValueError, match="dim 1"):
        fa_ops.flash_attention(q, q, q)
    x = distribute_tensor(torch.randn(1, 2, 8, 2, 4), host_mesh,
                          (Shard(2), Replicate()))
    dA = distribute_tensor(torch.randn(1, 2, 8, 2), host_mesh,
                           (Replicate(), Replicate()))
    bm = distribute_tensor(torch.randn(1, 2, 8, 3), host_mesh,
                           (Replicate(), Replicate()))
    with pytest.raises(ValueError, match="dim 2"):
        ssd_ops.ssd_intra_chunk(x, dA, bm, bm)
    # batch and heads shards run (here one rank: the local shard is all)
    x = distribute_tensor(torch.randn(1, 2, 8, 2, 4), host_mesh,
                          (Shard(0), Shard(3)))
    y, s, d = ssd_ops.ssd_intra_chunk(x, dA, bm, bm)
    assert [p for p in y.placements] == [Shard(0), Shard(3)]
    assert [p for p in s.placements] == [Shard(0), Shard(2)]
    want = ssd_ops.ssd_intra_chunk_ref(x.full_tensor(), dA.full_tensor(),
                                       bm.full_tensor(), bm.full_tensor())
    assert torch.equal(y.full_tensor(), want[0])


def test_one_rank_mesh_adafactor_moments_shard_like_params(host_mesh):
    """Adafactor's factored moments of a DTensor param are DTensors that
    keep the param's shards on the dims they keep (a shard of the dropped
    dim replicates); the step equals the plain step bit for bit."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import ARCHS, reduced_model
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models.params import subtree, tree_map
    from repro_torch.train import optimizer as opt, step as st
    cfg = reduced_model(ARCHS["qwen3-4b"])
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 16, 2, "train"),
                    fsdp=True, remat=False, attn_block_q=8, attn_block_k=8)
    ocfg = opt.OptConfig(name="adafactor", lr=1e-3, warmup_steps=2)
    params = pM.init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu", dtype_override=torch.float32)
    g = torch.Generator().manual_seed(4)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    p1 = tree_map(lambda a: a.clone(), params)
    p1, _, _ = st.build_train_step(cfg, run, ocfg)(p1, opt.init(p1, ocfg),
                                                   batch)
    sh = Sharder(host_mesh, run)
    p2 = _distribute(pM.param_specs(cfg), params, host_mesh, sh)
    state = opt.init(p2, ocfg)
    # wq (layers, embed, heads): heads on "model", nothing on "data" at
    # this width; vr drops the heads dim, vc keeps it as its dim 1
    wq = subtree(state["v"], ("blocks", "layer0", "attn", "wq"))
    assert tuple(wq["vr"].placements) == (Replicate(), Replicate())
    assert tuple(wq["vc"].placements) == (Replicate(), Shard(1))
    p2, _, _ = st.build_train_step(cfg, run, ocfg, sh.constrain)(p2, state,
                                                                batch)
    for path, a in tree_items(p1):
        assert torch.equal(a, _full(subtree(p2, path))), path
