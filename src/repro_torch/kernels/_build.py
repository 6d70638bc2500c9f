"""Build the port's CUDA sources into shared libraries, at first use.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a library
with a plain C interface, loaded with `ctypes`. The library lands in
`build/repro_torch/` at the root of the checkout, named by a hash of its
source, so an edited source rebuilds and an unchanged one loads at once.
The compiler's report (`-Xptxas -v`: registers, shared memory, spills) is
kept beside the library as `<name>-<hash>.log`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "port's CUDA kernels are built on the GPU host")
    return str(path)


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` is built (hash of its source)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its library is missing; load it."""
    lib = library_path(name)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.parent / f"{lib.name}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))
