// Mamba2 SSD intra-chunk step, for Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/ssd_scan/kernel.py::_kernel`
// (wrapper `ssd_intra_chunk`). The model calls it once per Mamba2 layer on
// its full-sequence path (`models/mamba2.py::ssd_chunked`, so in
// `forward_prefill` and `forward_train`).
//
// What it computes, per (batch b, chunk c, head h), all in float32, as the
// TPU kernel does: cs = inclusive cumsum of dA over the chunk's Q rows;
// L[q, s] = exp(cs[q] - cs[s]) for s <= q, else 0; G = C . B^T;
// y[q, p] = sum_s G[q, s] L[q, s] x[s, p];
// S[p, d] = sum_s exp(cs[Q-1] - cs[s]) x[s, p] B[s, d];
// decay = exp(cs[Q-1]).
//
// What bounds it: only s <= q is needed. At the serving shape (mamba2-1.3b
// prefill, B=4, S=2048 in 8 chunks of 256, 64 heads of 64, d_state 128)
// y and S need ~1.7e10 flop against ~3.5e8 bytes in and out: the fp32
// rate of the CUDA cores bounds it (tensor cores would round the products
// to TF32 and miss the reference's 1e-4; later work). This first design
// is plain SIMT, chosen to be right first:
//  * one thread block of 256 threads per (head, chunk, batch); G is
//    recomputed by each head's block (64 times per chunk at the serving
//    shape), where the TPU kernel shares it across an 8-head tile: G is
//    not worth keeping, since one chunk's B and C alone (256 KB) exceed
//    the 227 KB of shared memory a block can have;
//  * the block walks q tiles of 64 rows; for each, s tiles of 64 rows up
//    to the diagonal: a C tile (64 x ds), a B and an x tile in shared
//    memory, the 64 x 64 G tile built in registers (4 x 4 per thread),
//    multiplied by L and staged in shared memory, then y += M . x;
//  * the chunk state S (hd x ds, 4 x 8 per thread) accumulates in
//    registers on each diagonal tile, so each s tile is read for it once;
//  * a ragged chunk (Q not a multiple of 64, any Q >= 1) zero-fills the
//    rows past Q and masks them out of L.
// Limits: hd <= 64 and ds <= 128 (every Mamba2 config of the repo); the
// wrapper raises on others.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int T = 64;              // rows per q tile and per s tile
constexpr int HD_MAX = 64;
constexpr int DS_MAX = 128;
constexpr int DSP = DS_MAX + 1;    // padded row of the B and C tiles
constexpr int MP = T + 1;          // padded row of the M tile
constexpr int THREADS = 256;       // 16 x 16 threads

size_t smem_bytes(int Q) {
  return sizeof(float) *
         (2 * size_t(T) * DSP + size_t(T) * HD_MAX + size_t(T) * MP +
          2 * size_t(Q));
}

__global__ void __launch_bounds__(THREADS)
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ S,
                 float* __restrict__ decay, int nc, int Q, int nh, int hd,
                 int ds) {
  extern __shared__ float smem[];
  float* Cs = smem;                  // T x DSP
  float* Bs = Cs + T * DSP;          // T x DSP
  float* Xs = Bs + T * DSP;          // T x HD_MAX
  float* Ms = Xs + T * HD_MAX;       // T x MP
  float* cs = Ms + T * MP;           // Q
  float* d2e = cs + Q;               // Q

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const long long bc = (long long)b * nc + c;
  const long long xrow = (long long)nh * hd;           // x / y row stride
  const float* xb = x + bc * Q * xrow + (long long)h * hd;
  const float* ab = dA + bc * Q * nh + h;
  const float* Bb = Bm + bc * Q * ds;
  const float* Cb = Cm + bc * Q * ds;
  float* yb = y + bc * Q * xrow + (long long)h * hd;
  float* Sb = S + (bc * nh + h) * hd * ds;

  // inclusive cumsum of dA: one warp, each lane a run of rows, then a
  // shuffle scan of the lanes' totals
  if (warp == 0) {
    const int per = (Q + 31) / 32;
    const int lo = min(lane * per, Q), hi = min(lo + per, Q);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run += ab[(long long)i * nh];
      cs[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    const float excl = incl - run;
    for (int i = lo; i < hi; ++i) cs[i] += excl;
  }
  __syncthreads();
  const float cs_end = cs[Q - 1];
  for (int i = tid; i < Q; i += THREADS) d2e[i] = expf(cs_end - cs[i]);
  if (tid == 0) decay[bc * nh + h] = expf(cs_end);

  float sacc[4][8];                 // S[ty*4+i][tx+16*j]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;

  const int nt = (Q + T - 1) / T;
  for (int qt = 0; qt < nt; ++qt) {
    const int q0 = qt * T;
    __syncthreads();                // the previous q tile's C is consumed
    for (int i = tid; i < T * ds; i += THREADS) {
      const int r = i / ds, d = i % ds, q = q0 + r;
      Cs[r * DSP + d] = q < Q ? Cb[(long long)q * ds + d] : 0.f;
    }
    float yacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;

    for (int st = 0; st <= qt; ++st) {
      const int s0 = st * T;
      __syncthreads();              // the previous s tile is consumed
      for (int i = tid; i < T * ds; i += THREADS) {
        const int r = i / ds, d = i % ds, s = s0 + r;
        Bs[r * DSP + d] = s < Q ? Bb[(long long)s * ds + d] : 0.f;
      }
      for (int i = tid; i < T * HD_MAX; i += THREADS) {
        const int r = i / HD_MAX, p = i % HD_MAX, s = s0 + r;
        Xs[i] = (s < Q && p < hd) ? xb[s * xrow + p] : 0.f;
      }
      __syncthreads();

      // G tile = C . B^T, rows ty*4+i, columns tx+16*j
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < ds; ++d) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Cs[(ty * 4 + i) * DSP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * DSP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = fmaf(a[i], bv[j], g[i][j]);
      }
      // M = G o L, masked to s <= q < Q
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, q = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = tx + 16 * j, s = s0 + cc;
          Ms[r * MP + cc] =
              (s <= q && q < Q) ? g[i][j] * expf(cs[q] - cs[s]) : 0.f;
        }
      }
      __syncthreads();

      // y += M . x, rows ty*4+i, head columns tx+16*j
#pragma unroll 4
      for (int s = 0; s < T; ++s) {
        float m[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) m[i] = Ms[(ty * 4 + i) * MP + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xv = Xs[s * HD_MAX + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) yacc[i][j] = fmaf(m[i], xv, yacc[i][j]);
        }
      }

      // the chunk state, once per s tile (on the diagonal):
      // S[p, d] += sum_s d2e[s] x[s, p] B[s, d], p = ty*4+i, d = tx+16*j
      if (st == qt) {
        const int n = min(T, Q - s0);
        for (int s = 0; s < n; ++s) {
          const float w = d2e[s0 + s];
          float xp[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xp[i] = Xs[s * HD_MAX + ty * 4 + i] * w;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float bv = Bs[s * DSP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              sacc[i][j] = fmaf(xp[i], bv, sacc[i][j]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty * 4 + i;
      if (q >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (p < hd) yb[q * xrow + p] = yacc[i][j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty * 4 + i;
    if (p >= hd) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = tx + 16 * j;
      if (d < ds) Sb[(long long)p * ds + d] = sacc[i][j];
    }
  }
}

}  // namespace

// x: (B, nc, Q, nh, hd); dA: (B, nc, Q, nh); Bm, Cm: (B, nc, Q, ds);
// y like x; S: (B, nc, nh, hd, ds); decay: (B, nc, nh). All float32,
// contiguous. Returns a cudaError_t (0 = launched).
extern "C" int ssd_intra_chunk_fwd(const void* x, const void* dA,
                                   const void* Bm, const void* Cm, void* y,
                                   void* S, void* decay, int B, int nc,
                                   int Q, int nh, int hd, int ds,
                                   void* stream) {
  if (B < 1 || nc < 1 || Q < 1 || nh < 1 || hd < 1 || ds < 1 ||
      hd > HD_MAX || ds > DS_MAX || B > 65535 || nc > 65535)
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(nh, nc, B);
  ssd_intra_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dA),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), static_cast<float*>(S),
      static_cast<float*>(decay), nc, Q, nh, hd, ds);
  return int(cudaGetLastError());
}
