"""Time the `ssd_scan` kernel against two variants of it on one card.

The kernel (`src/repro_torch/csrc/ssd_scan.cu`) runs its three products
(G = C.B^T, y = (G o L).x, S = (d2e o x)^T.B) on the tensor cores in split
TF32, and keeps the 8 heads' whole cumsums in shared memory while they fit
(Q <= 768). Its variants:
  * `fp32`: the same kernel -- the same 8-head tile and G strip, the same
    cp.async double buffers, the same warp tiles and register layout of
    the accumulators -- with each product as float32 FMAs on the CUDA
    cores instead (each lane reads its operands from shared memory and
    forms M = G o L for its own rows);
  * `windows`: the kernel with its WIN instance, the one longer chunks
    run (tile prefixes, cs windows), at every chunk length.
The script writes each variant's source from the kernel's, builds all
three with `nvcc` (one process each, in parallel; the variants under
`build/var/<name>/`), holds each against the plain version
(`kernels/ssd_scan/ref.py`) on `chip_smoke.py`'s ssd cases at atol = rtol
= 1e-4 and at the serving shape within `ref.ssd_limits`, and times each at
the serving shape (mamba2-1.3b prefill: B=4, S=2048 in chunks of 256, 64
heads of 64, d_state 128) with CUDA events, in the order kernel, fp32,
windows, windows, fp32, kernel. It prints one line per time and, last, a
JSON object.

    python3 scripts/torch_ssd_variants.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_intra_chunk_ref)

VAR_DIR = ROOT / "build" / "var"

# (first line, last line, replacement) of each product loop of the kernel
FP32_PRODUCTS = [
    ("            float acc[1][2][4] = {};\n",
     "              mma3(acc, a, b0, b1);\n            }\n",
     """            float acc[1][2][4] = {};
            const float* ca = Cs + (16 * mw + g) * CP;
            const float* bb = Bs + (16 * nw + 2 * t) * CP;
#pragma unroll 4
            for (int k = 0; k < dsw; ++k) {       // the ds slice
              const float a0 = ca[k], a1 = ca[8 * CP + k];
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int n = 0; n < 2; ++n) {
                  const float bv = bb[(8 * j + n) * CP + k];
                  acc[0][j][n] = fmaf(a0, bv, acc[0][j][n]);
                  acc[0][j][2 + n] = fmaf(a1, bv, acc[0][j][2 + n]);
                }
            }
"""),
    ("            for (int kk = 0; kk < kend; ++kk) {      // the diagonal\n",
     "              mma3(yacc, a, b0, b1);\n            }\n",
     """#pragma unroll 4
            for (int sl = 0; sl < 8 * kend; ++sl) {
              const float c = css[sl];
              float m0 = gr[sl] * expf(ca - c);
              float m1 = gr[8 * GP + sl] * expf(cb - c);
              if (diag) {
                if (sl > r0) m0 = 0.f;
                if (sl > r0 + 8) m1 = 0.f;
              }
              const float* xr = X + sl * XP + 2 * t;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float2 xv = *reinterpret_cast<const float2*>(xr + 8 * j);
                yacc[0][j][0] = fmaf(m0, xv.x, yacc[0][j][0]);
                yacc[0][j][1] = fmaf(m0, xv.y, yacc[0][j][1]);
                yacc[0][j][2] = fmaf(m1, xv.x, yacc[0][j][2]);
                yacc[0][j][3] = fmaf(m1, xv.y, yacc[0][j][3]);
              }
            }
"""),
    ("          for (int kk = 0; kk < 8; ++kk) {\n",
     "            mma3(sacc, a, b0, b1);\n          }\n",
     """#pragma unroll 4
          for (int s = 0; s < T; ++s) {
            const float w = expf(cs_end - css[s]);
            const float* xr = X + s * XP + 32 * pm + g;
            const float xa[4] = {xr[0] * w, xr[8] * w, xr[16] * w, xr[24] * w};
            const float* br = Bs + s * CP + 32 * dn + 2 * t;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 bv = *reinterpret_cast<const float2*>(br + 8 * j);
#pragma unroll
              for (int m = 0; m < 2; ++m) {
                sacc[m][j][0] = fmaf(xa[2 * m], bv.x, sacc[m][j][0]);
                sacc[m][j][1] = fmaf(xa[2 * m], bv.y, sacc[m][j][1]);
                sacc[m][j][2] = fmaf(xa[2 * m + 1], bv.x, sacc[m][j][2]);
                sacc[m][j][3] = fmaf(xa[2 * m + 1], bv.y, sacc[m][j][3]);
              }
            }
          }
"""),
]


def fp32_source(src):
    """The kernel's source with each product loop in float32 FMAs."""
    for first, last, new in FP32_PRODUCTS:
        if src.count(first) != 1 or src.count(last) != 1:
            raise RuntimeError(f"ssd_scan.cu no longer has one {first!r}")
        a = src.index(first)
        b = src.index(last, a) + len(last)
        src = src[:a] + new + src[b:]
    return src


WIN_CHOICE = "  const bool win = smem_bytes(Q, false) > SMEM_MAX;\n"


def windows_source(src):
    """The kernel's source with its WIN instance at every chunk length."""
    if src.count(WIN_CHOICE) != 1:
        raise RuntimeError("ssd_scan.cu no longer picks its instance by "
                           f"{WIN_CHOICE!r}")
    return src.replace(WIN_CHOICE, "  const bool win = true;\n")


VARIANTS = {"fp32": fp32_source, "windows": windows_source}


def build_variant(name):
    """Compile a variant; returns its entry point."""
    out = VAR_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "ssd_scan.cu"
    cu.write_text(VARIANTS[name]((_build.CSRC / "ssd_scan.cu").read_text()))
    lib = out / "ssd_scan.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    (out / "ssd_scan.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib)).ssd_intra_chunk_fwd


def wrap(fn):
    """A callable like `kernel.ssd_intra_chunk` around a C entry point."""
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, dA, Bm, Cm):
        B, nc, Q, nh, hd = x.shape
        ds = Bm.shape[3]
        y = torch.empty_like(x)
        S = torch.empty((B, nc, nh, hd, ds), device=x.device)
        decay = torch.empty((B, nc, nh), device=x.device)
        err = fn(x.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), S.data_ptr(), decay.data_ptr(), B, nc, Q, nh,
                 hd, ds, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"ssd kernel launch failed: CUDA error {err}")
        return y, S, decay
    return call


def sweep_inputs(np, S, nh, hd, ds, chunk):
    """chip_smoke.py phase 8's inputs of one case, chunked."""
    rng = np.random.RandomState(S + nh)
    arrays = [rng.randn(2, S, nh, hd) * .5,
              np.abs(rng.randn(2, S, nh)) * .1 + .02,
              -np.abs(rng.randn(nh)) * .5 - .1,
              rng.randn(2, S, ds) * .5, rng.randn(2, S, ds) * .5]
    return ops.chunk_inputs(*(torch.tensor(a, dtype=torch.float32,
                                           device="cuda") for a in arrays),
                            chunk)


def serve_inputs():
    """chip_smoke.py phase 8's serving-shape inputs, chunked."""
    sv = smoke.SSD_SERVE
    B_, S, nh, hd, ds, Q = (sv[k] for k in ("B", "S", "nh", "hd", "ds", "Q"))
    gen = torch.Generator(device="cuda").manual_seed(8)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, B, C = draw(B_, S, nh, hd) * .5, draw(B_, S, ds) * .5, \
        draw(B_, S, ds) * .5
    dt = torch.rand((B_, S, nh), generator=gen, device="cuda") * .1 + .02
    A = -(torch.rand((nh,), generator=gen, device="cuda") * .5 + .1)
    return ops.chunk_inputs(x, dt, A, B, C, Q)


def main():
    import numpy as np
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    card = smoke.card_line()
    with ThreadPoolExecutor(1 + len(VARIANTS)) as pool:
        kernel = pool.submit(_build.load, "ssd_scan")
        built = {name: pool.submit(build_variant, name) for name in VARIANTS}
        fns = {"kernel": wrap(kernel.result().ssd_intra_chunk_fwd)}
        fns.update((name, wrap(f.result())) for name, f in built.items())
    errs = {}
    for name, fn in fns.items():
        errs[name] = max(
            smoke.ssd_compare(torch, fn, ssd_intra_chunk_ref,
                              sweep_inputs(np, *case), smoke.SSD_TOL)[0]
            for case in smoke.SSD_SHAPES + smoke.SSD_EDGES)
    args = serve_inputs()
    shares = {}
    for name, fn in fns.items():
        err, shares[name] = smoke.ssd_compare(torch, fn, ssd_intra_chunk_ref,
                                              args)
        errs[name] = max(errs[name], err)
        print(f"[variants] {name}: == plain version on "
              f"{len(smoke.SSD_SHAPES + smoke.SSD_EDGES)} cases at 1e-4 and "
              f"the serving shape within ref.ssd_limits (largest share "
              f"{shares[name]:.3g}); max |err| {errs[name]:.3g} [{card}]",
              flush=True)
    times = {name: [] for name in fns}
    order = list(fns)
    for name in order + order[::-1]:
        ms = smoke.time_events(torch, lambda: fns[name](*args), 20)
        times[name].append(ms)
        print(f"[variants] {name}: {ms:.4f} ms at the serving shape "
              f"[{card}]", flush=True)
    print(json.dumps({"card": card, "ms": times, "max_abs_err": errs,
                      "limit_share": shares}))


if __name__ == "__main__":
    main()
