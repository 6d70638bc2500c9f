"""What the benchmark may load, and the form of `BENCHMARK.json`.

Nothing under `portbench/` imports JAX, jaxlib, flax or the JAX package
`repro`, compared by whole top-level names (`repro_torch` begins with
`repro`); the plain reference imports nothing of the program."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = sorted(str(p.relative_to(ROOT)) for p in HERE.rglob("*.py"))


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES)
def test_no_jax_under_portbench(path):
    assert not top_level_imports(ROOT / path) & FORBIDDEN


@pytest.mark.parametrize("path", [s for s in SOURCES
                                  if s.startswith("portbench/reference/")])
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(ROOT / path)
    assert "repro_torch" not in names and "portbench" not in names
    assert not ({"repro_torch"} & {n.split(".")[0] for n in names})


def test_the_forbidden_check_compares_whole_names():
    from portbench import harness
    assert harness.forbidden_modules(["repro_torch", "repro_torch.sim",
                                      "jax_like", "numpy"]) == []
    assert harness.forbidden_modules(["repro.sim", "jax.numpy",
                                      "flax"]) == ["flax", "jax", "repro"]


def test_a_run_loads_no_jax():
    """A CPU run of a cell, in a process of its own, leaves neither JAX
    nor the JAX package in `sys.modules`."""
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "from portbench import harness\n"
        "harness.run_cell('batch3-mask-all', 3, 0.0, True, device='cpu',"
        " shrink={'rows': 2, 'cycles': 11, 'warm_cycles': 13},"
        " log=lambda m: None)\n"
        "print(harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_benchmark_json_keeps_the_contract():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][1] == "portbench/run.py"
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert 1 <= len(w["why"]) <= 200
        used.add(w["config"])
    assert used == set(configs)
    names = [x["name"] for x in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]] + list(configs)
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    assert "setup_s" in [m["name"] for m in b["end_to_end"]]
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        layers.setdefault(m["layer"], m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["better"] in ("lower", "higher")
