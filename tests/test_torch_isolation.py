"""The port stands alone and never hides its device.

* Importing every module of `repro_torch` leaves `jax` and every `repro.*`
  module out of `sys.modules` (checked in a fresh interpreter), and
  `chip_smoke.py` and the `scripts/torch_*.py` import neither.
* `run_mix` with the default device runs on CUDA or raises; it never
  carries on on the CPU. A kernel backend that does not match the device
  raises.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.sim import config, runner  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import repro_torch.sim.runner
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len([m for m in sys.modules if m.startswith("repro_torch")]))
sys.exit("imported: " + ", ".join(bad) if bad else 0)
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert int(proc.stdout.split()[-1]) >= 15     # every module was loaded


@pytest.mark.parametrize("path", [
    "chip_smoke.py", "scripts/torch_step_profile.py",
    "scripts/torch_serve_profile.py", "scripts/torch_ssd_variants.py"] + sorted(
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


def test_backend_must_match_device():
    with pytest.raises(ValueError, match="cannot run on device"):
        config.SimConfig(device="cpu", tlb_backend="cuda")
    with pytest.raises(ValueError, match="cannot run on device"):
        config.resolve_tlb_backend("torch", "cuda")
    with pytest.raises(ValueError, match="must be one of"):
        config.SimConfig(device="cpu", tlb_backend="xla")
    assert config.resolve_tlb_backend(None, "cuda:0") == "cuda"
    assert config.SimConfig(device="cpu").tlb_backend == "torch"
