"""Time the `paged_attention` kernel against two variants of it on one card.

The kernel (`src/repro_torch/csrc/paged_attention.cu`) splits each
sequence's pages over blocks (`kernel.split_plan`: spans of ~128 tokens)
and streams each span's K and V rows through a shared-memory ring by
16-byte cp.async; a second launch merges the spans' partials. Its
variants:
  * `stage1`: the same split and combine, with each block's span walked
    page by page as the kernel before the ring did it -- one token per
    warp per step, lanes across the head dimension, q in registers, a
    shuffle reduction per query head, each thread one column of p.v, K and
    V read straight from device memory;
  * `single`: the kernel with one split per sequence (every block walks
    all of its sequence's pages).
Beside them, two yardsticks that are not attention and are not checked:
`stream`, the kernel with its per-tile compute cut out (the ring's loads,
waits and barriers alone), and `sum`, one `torch.sum` reading as many
bytes as the live K and V.
The script writes the variants' sources from the kernel's (`stage1`: the
split kernel between its `// ---- split kernel` markers replaced;
`stream`: the tile loop's compute cut), builds the kernel and both with
`nvcc` (one process each, in parallel; the variants under
`build/var/<name>/`), prints each kernel instance's registers and spills,
holds `kernel`, `stage1` and `single` to the plain version
(`kernels/paged_attention/ref.py`) on `chip_smoke.py`'s paged cases (the
sweep, `PAGED_EDGES`, `PAGED_SPLIT_EDGES`, both dtypes, at `PAGED_TOL`)
and at the pool's shape (`chip_smoke.POOL`: 32 sequences with the pool's
lengths after its 8 decode steps, 8 KV heads and 32 query heads of 128,
pages of 128, 16 per sequence, bf16) within `flash_compare`'s rounding
limit, and times all five there with CUDA events (20 calls) in the order
kernel, stage1, single, stream, sum and back, twice; then the kernel's
split and combine launches apart (torch.profiler). It prints one line per
time and, last, a JSON object.

    python3 scripts/torch_paged_variants.py
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.paged_attention import kernel  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref)

VAR_DIR = ROOT / "build" / "var"
BEGIN = "// ---- split kernel: begin ----\n"
END = "// ---- split kernel: end ----\n"

STAGE1 = BEGIN + r"""template <typename T, int DH, int GB>
size_t split_smem_bytes(int G, int page, int pps) {
  (void)pps;
  return sizeof(float) * (size_t(G) * page + 3 * size_t(G));
}

template <typename T, int DH, int GB, bool EXACT>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ bt,
                   const int* __restrict__ seq_lens,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int H, int KV, int G_all,
                   int GS, int n_groups, int dh, int page, int n_pages,
                   int P, int pps, int n_splits, float scale) {
  constexpr int NV = DH / 32;     // head-dim elements per lane
  const int s = blockIdx.x % n_splits;
  const int rest = blockIdx.x / n_splits;
  const int hg = rest % n_groups, kv = (rest / n_groups) % KV,
            b = rest / n_groups / KV;
  const int G = min(GS, G_all - hg * GS);
  extern __shared__ float smem[];
  float* ss = smem;               // G x page: scores, then p
  float* m_s = ss + G * page;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long hrow = (long long)b * H + (long long)kv * G_all +
                         (long long)hg * GS;
  const int len = seq_lens[b];
  const int n_live = len > 0 ? min((len + page - 1) / page, n_pages) : 0;
  const int pg0 = s * pps;
  if (pg0 >= n_live) {
    if (tid < G) {
      part_m[(hrow + tid) * n_splits + s] = NEG_INF;
      part_l[(hrow + tid) * n_splits + s] = 0.f;
    }
    return;
  }
  const int pg1 = min(pg0 + pps, n_live);
  const T* qb = q + hrow * dh;
  float qr[GB][NV];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int i = 0; i < NV; ++i)
      qr[g][i] = g < G && lane + 32 * i < dh
                     ? to_float(qb[g * dh + lane + 32 * i]) : 0.f;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) acc[g] = 0.f;
  const long long tok = (long long)KV * dh;
  const long long pstride = (long long)page * tok;
  __syncthreads();

  for (int pi = pg0; pi < pg1; ++pi) {
    const int phys = min(max(bt[(long long)b * n_pages + pi], 0), P - 1);
    const T* kpg = kp + phys * pstride + (long long)kv * dh;
    const T* vpg = vp + phys * pstride + (long long)kv * dh;
    const int p0 = pi * page;
    for (int t = warp; t < page; t += NWARPS) {
      float kr[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i)
        kr[i] = lane + 32 * i < dh ? to_float(kpg[t * tok + lane + 32 * i])
                                   : 0.f;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) part = fmaf(qr[g][i], kr[i], part);
        part = warp_sum(part);
        if (lane == 0) ss[g * page + t] = p0 + t < len ? part * scale : NEG_INF;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += NWARPS) {
      float mx = NEG_INF;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, ss[g * page + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(ss[g * page + t] - m_new);
        sum += p;
        ss[g * page + t] = to_float(from_float<T>(p));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();
    if (tid < dh) {      // the smoke's cases: dh <= 128 = THREADS
#pragma unroll
      for (int g = 0; g < GB; ++g)
        if (g < G) acc[g] *= c_s[g];
      for (int t = 0; t < page; ++t) {
        const float vv = to_float(vpg[t * tok + tid]);
#pragma unroll
        for (int g = 0; g < GB; ++g)
          if (g < G) acc[g] = fmaf(ss[g * page + t], vv, acc[g]);
      }
    }
    __syncthreads();
  }
  if (tid < G) {
    part_m[(hrow + tid) * n_splits + s] = m_s[tid];
    part_l[(hrow + tid) * n_splits + s] = l_s[tid];
  }
  if (tid < dh) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < G) part_acc[((hrow + g) * n_splits + s) * DH + tid] = acc[g];
  }
}
""" + END


def stage1_source(src):
    """The kernel's source with its split kernel walked page by page."""
    if src.count(BEGIN) != 1 or src.count(END) != 1:
        raise RuntimeError("paged_attention.cu no longer has one split "
                           "kernel between its markers")
    return src[:src.index(BEGIN)] + STAGE1 + src[src.index(END) + len(END):]


# the per-tile compute of the kernel: from the q.k phase to the end of the
# tile loop
COMPUTE = ("    // q.k: lane = tokens", "  }\n\n  // the span's partial")


def stream_source(src):
    """The kernel's source with its per-tile compute taken out: the ring's
    loads, waits and barriers alone."""
    first, last = COMPUTE
    if src.count(first) != 1 or src.count(last) != 1:
        raise RuntimeError("paged_attention.cu no longer has one tile "
                           f"loop from {first!r} to {last!r}")
    return src[:src.index(first)] + "    (void)vt;\n" + src[src.index(last):]


VARIANTS = {"stage1": stage1_source, "stream": stream_source}


def build_variant(name):
    """Compile a variant; returns its bound entry point."""
    out = VAR_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "paged_attention.cu"
    cu.write_text(VARIANTS[name](
        (_build.CSRC / "paged_attention.cu").read_text()))
    lib = out / "paged_attention.so"
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    (out / "paged_attention.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    return kernel.bind(ctypes.CDLL(str(lib)).paged_attention_fwd)


def ptxas_report(log):
    """One line per kernel instance of a `-Xptxas -v` log: name,
    registers, spills, static shared memory."""
    out, name = [], None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '\S*?\d(paged_[a-z]+_kernel)"
                        r"I(13__nv_bfloat16|f)(?:Li(\d+)ELi(\d+)E)?", line)
        if hit:
            dtype = "bf16" if hit.group(2) != "f" else "fp32"
            name = hit.group(1) + "<" + ", ".join(
                x for x in (dtype,) + hit.group(3, 4) if x) + ">"
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def pool_inputs():
    """The pool's shape after its 8 decode steps: seeded q, K/V pages and
    a table of distinct random pages, bf16."""
    P, page, KV, dh, H, nseq, pps = (smoke.POOL[k] for k in (
        "n_pages", "page", "n_kv", "dh", "heads", "seqs", "pages_per_seq"))
    lens = smoke.pool_lens(np) + smoke.POOL["steps"]
    gen = torch.Generator(device="cuda").manual_seed(17)
    kp, vp = (torch.randn((P, page, KV, dh), generator=gen, device="cuda"
                          ).to(torch.bfloat16) for _ in range(2))
    q = torch.randn((nseq, H, dh), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    table = torch.randperm(P, generator=gen, device="cuda")[:nseq * pps]
    table = table.reshape(nseq, pps).to(torch.int32)
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, table, sl


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    card = smoke.card_line()
    with ThreadPoolExecutor(1 + len(VARIANTS)) as pool:
        built = pool.submit(_build.load, "paged_attention")
        variants = {name: pool.submit(build_variant, name)
                    for name in VARIANTS}
        entry = kernel.bind(built.result().paged_attention_fwd)
        variants = {name: f.result() for name, f in variants.items()}
    for name in ("kernel",) + tuple(VARIANTS):
        log = (_build.library_path("paged_attention") if name == "kernel"
               else VAR_DIR / name / "paged_attention.so").with_suffix(".log")
        for line in ptxas_report(log.read_text()):
            print(f"[variants] ptxas {name}: {line}", flush=True)
    args = pool_inputs()
    n_pages = args[3].shape[1]
    fns = {
        "kernel": lambda *a: kernel.launch_split(*a, entry=entry)[0],
        "stage1": lambda *a: kernel.launch_split(
            *a, entry=variants["stage1"])[0],
        "single": lambda *a: kernel.launch_split(
            *a, plan=(a[3].shape[1], 1), entry=entry)[0],
    }
    errs, shares = {}, {}
    want = paged_attention_ref(*args)
    B, H, dh = args[0].shape
    T, KV = n_pages * args[1].shape[1], args[1].shape[2]
    gathered = args[3].long()
    kg = args[1][gathered].reshape(B, T, KV, dh)
    vg = args[2][gathered].reshape(B, T, KV, dh)
    _, spread = smoke.dense_decode(torch, args[0], kg, vg, args[4])
    del kg, vg
    for name, fn in fns.items():
        errs[name] = max(smoke.paged_check(torch, np, fn,
                                           paged_attention_ref))
        err, shares[name] = smoke.rounding_check(
            torch, fn(*args), want, spread, f"{name} at the pool's shape")
        errs[name] = max(errs[name], err)
        print(f"[variants] {name}: == plain version on "
              f"{len(smoke.paged_cases())} checks at PAGED_TOL and at the "
              f"pool's shape within the rounding limit (largest share "
              f"{shares[name]:.3g}); max |err| {errs[name]:.3g} [{card}]",
              flush=True)
    # not checked: the ring's loads alone (its output is not attention),
    # and one PyTorch reduction reading as many bytes as the live K and V
    fns["stream"] = lambda *a: kernel.launch_split(
        *a, entry=variants["stream"])[0]
    nbytes = 2 * int(args[4].sum()) * KV * dh * args[1].element_size()
    ruler = torch.ones(nbytes // 2, dtype=torch.bfloat16, device="cuda")
    fns["sum"] = lambda *a: ruler.sum(dtype=torch.float32)
    times = {name: [] for name in fns}
    order = list(fns)
    for name in (order + order[::-1]) * 2:
        ms = smoke.time_events(torch, lambda: fns[name](*args), 20)
        times[name].append(ms)
        print(f"[variants] {name}: {ms:.4f} ms at the pool's shape [{card}]",
              flush=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fns["kernel"](*args)
        torch.cuda.synchronize()
    launches = {e.key.split("<")[0].split("::")[-1]:
                e.device_time_total / e.count / 1e3
                for e in prof.key_averages() if "paged_" in e.key}
    for name, ms in launches.items():
        print(f"[variants] kernel's {name}: {ms:.4f} ms per call "
              f"(torch.profiler, 20 calls) [{card}]", flush=True)
    print(json.dumps({"card": card, "split_plan": kernel.split_plan(
        args[1].shape[1], n_pages), "live_tokens": int(args[4].sum()),
        "live_bytes": nbytes, "ms": times, "launch_ms": launches,
        "max_abs_err": errs, "limit_share": shares}))


if __name__ == "__main__":
    main()
