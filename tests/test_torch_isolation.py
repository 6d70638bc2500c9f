"""The port stands alone and never hides its device.

* Importing every module of `repro_torch` leaves `jax` and every `repro.*`
  module out of `sys.modules` (checked in a fresh interpreter), and
  `chip_smoke.py` and the `scripts/torch_*.py` import neither.
  The walk loads the serving slice (`serving/`, `launch/serve.py`,
  `sim/profiles.py`) and the training slice (`train/`, `data/`,
  `checkpoint/`, `distributed/`, `models/losses.py`, `launch/train.py`)
  and the distributed layer (`distributed/sharding.py`, `launch/mesh.py`,
  `roofline/`, `kernels/_dtensor.py`).
* `run_mix`, the serving engine, the contention oracle and the
  launcher's `build_engine` with the default device run on CUDA or
  raise; they never carry on on the CPU. The fused round follows the device of its
  tensors alone: a CPU state runs the plain round, and a plane on any
  other device goes to the kernel's wrapper, which launches or raises.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.design import design_params  # noqa: E402
from repro_torch.kernels.fused_tlb import kernel as kernel_mod  # noqa: E402
from repro_torch.kernels.fused_tlb import ops as fused_ops  # noqa: E402
from repro_torch.sim import config, memsys, runner  # noqa: E402
from repro_torch.sim.workloads import app_matrix  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the serving and training slices: every one of these must be loaded by
# the walk
SERVING = ("repro_torch.sim.profiles", "repro_torch.serving.engine",
           "repro_torch.serving.placement", "repro_torch.serving.oracle",
           "repro_torch.serving.stream", "repro_torch.serving.metrics",
           "repro_torch.launch.serve", "repro_torch.models.losses",
           "repro_torch.train.optimizer", "repro_torch.train.step",
           "repro_torch.train.loop", "repro_torch.data.pipeline",
           "repro_torch.checkpoint.checkpointer",
           "repro_torch.distributed.fault_tolerance",
           "repro_torch.launch.train", "repro_torch.distributed.sharding",
           "repro_torch.launch.mesh", "repro_torch.roofline.analysis",
           "repro_torch.roofline.hlo_parse", "repro_torch.roofline.counter",
           "repro_torch.kernels._dtensor")

_PROBE = """
import importlib, pkgutil, sys
SERVING = %r
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import repro_torch.sim.runner
for name in SERVING:
    assert name in sys.modules, name
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len([m for m in sys.modules if m.startswith("repro_torch")]))
sys.exit("imported: " + ", ".join(bad) if bad else 0)
""" % (SERVING,)


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert int(proc.stdout.split()[-1]) >= 91     # every module was loaded


@pytest.mark.parametrize("path", [
    "chip_smoke.py", "scripts/torch_step_profile.py",
    "scripts/torch_serve_profile.py", "scripts/torch_ssd_variants.py",
    "scripts/torch_paged_variants.py", "scripts/torch_trace_rate.py",
    "scripts/torch_grid_time.py", "scripts/torch_train_profile.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "src/repro_torch").rglob("*.py")))
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "repro", "jaxlib"), \
                f"{path}: imports {n}"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.run_mix("gpu-mmu", ["3DS", "BLK"], cycles=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.SimConfig()


def test_serving_default_device_raises_without_cuda():
    """The engine, the oracle, the oracle policy and the launcher's
    `build_engine` run on the card by default; without one they raise
    before anything runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs on it")
    from repro_torch.launch.serve import build_engine
    from repro_torch.memmgr.kv_cache import PoolConfig
    from repro_torch.serving.engine import (ServingEngine, stub_forwards,
                                            stub_model_config)
    from repro_torch.serving.oracle import ContentionOracle
    from repro_torch.serving.placement import make_policy
    pool = PoolConfig(n_pages=8, page_size=4, n_kv=1, head_dim=4,
                      n_layers=1, max_seqs=2, pages_per_seq=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(stub_model_config(), None, None, pool,
                      forwards=stub_forwards())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContentionOracle(cycles=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_policy("oracle", profiles={0: "heavy"}, cycles=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine("qwen3-4b")
    # named, the CPU runs
    assert ServingEngine(stub_model_config(), None, None, pool,
                         forwards=stub_forwards(),
                         device="cpu").pool.seq_lens.device.type == "cpu"
    assert ContentionOracle(cycles=2, device="cpu").device.type == "cpu"


def test_fused_round_follows_the_device(monkeypatch):
    """A CPU state's cycles run the plain round (no kernel launch); a plane
    that is not on the CPU is never run by the plain round: the wrapper
    refuses it before any build."""
    calls = []
    plain = fused_ops.fused_tlb_access_ref
    monkeypatch.setattr(fused_ops, "fused_tlb_access_ref",
                        lambda *a, **k: calls.append(a[0].shape)
                        or plain(*a, **k))
    cfg = config.SimConfig(design="pwc", sim_cycles=3, device="cpu")
    dp = design_params(cfg.design)
    pm = torch.tensor(app_matrix(["3DS", "BLK"]))[None].repeat(2, 1, 1)
    before = kernel_mod.fused_tlb_round.launches
    st = memsys.init_state(cfg, dp, rows=2)
    for cycle in range(3):
        st = memsys.step(cfg, dp, pm, st, cycle)
    assert kernel_mod.fused_tlb_round.launches == before
    # the PWC and the L2$ round each cycle, both rows in one call
    assert calls == [(2, 64, 16), (2, 1024, 16)] * 3

    def no_build(*_):
        raise AssertionError("the wrapper built the kernel before checking")
    monkeypatch.setattr(kernel_mod._build, "load", no_build)
    kernel_mod._entry.cache_clear()
    plane = torch.zeros((2, 4, 16), dtype=torch.int32, device="meta")
    lanes = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    mask = torch.zeros((2, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fused_ops.fused_tlb_access(plane, plane, plane, lanes, lanes, mask,
                                   mask, 0)
    assert calls == [(2, 64, 16), (2, 1024, 16)] * 3
