// Forward flash attention in float32 (causal or bidirectional, optional
// sliding window, grouped-query heads), for Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/flash_attention/kernel.py::_kernel`
// (wrapper `flash_attention_bhsd`) for float32 inputs; bfloat16 inputs go
// to the tensor-core kernel of `flash_attention_sm90.cu`. Its float32 FMAs
// keep the reference's 2e-5 tolerance, which TF32 tensor cores would miss.
// The model calls it once per attention layer on its full-sequence path
// (`models/lm.py::_self_attention_full`, so in `forward_prefill` and
// `forward_train`) when `RunConfig.attention_impl == "pallas_flash"`.
//
// What it computes, exactly as the TPU kernel does: for query head h (KV
// head h / G), an online softmax over key tiles with running (m, l, acc)
// in float32; s = (q . k) * scale in float32; masked scores are the FINITE
// value -1e30 (a row whose first visited tile is fully masked takes p = 1
// there, and the next tile's correction exp(-1e30 - m) = 0 wipes it, where
// -inf would give NaN); p stays float32, as v is; the output is
// acc / max(l, 1e-30). Tiles that causality or the window masks completely
// are skipped. Positions count from 0 in both q and k.
//
// What bounds it: operations at the CUDA cores' float32 rate (67 TFLOP/s):
// at the fp32 match shape (qwen3-4b, 2 x 496 tokens, 32 heads of 128) the
// two products need ~2.0e10 flop against ~33 MB of q/k/v/o. It is a plain
// SIMT kernel, chosen to be right first. One thread block of
// 256 threads per (q tile of 64 rows, head, batch); q, k and v tiles are
// staged in shared memory (k/q rows padded by one word so the
// column walk of q.k^T is free of bank conflicts); each thread keeps a 4 x 4
// block of the score tile and a 4 x (dh/16) block of the accumulator in
// registers. One warp per 8 rows does the softmax with shuffles.
//
// Layout: q, k, v, o are read and written through (batch, head, position)
// strides with a contiguous head dimension, so the model's (B, S, H, dh)
// tensors are used in place. Ragged edges (lengths not a multiple of 64)
// are handled: q rows past Sq are not stored, keys past Sk get p = 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // 16 x 16 threads, 4 x 4 score block each
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;
};

template <int DH>
constexpr size_t smem_floats() {
  return size_t(BQ) * (DH + 1)      // q tile, padded
         + size_t(BK) * (DH + 1)    // k tile, padded
         + size_t(BK) * DH          // v tile
         + size_t(BQ) * (BK + 1)    // scores, then p
         + 3 * size_t(BQ);          // m, l, correction
}

template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int G,
                 int Sq,
                 int Sk, Strides qs, Strides ks, Strides vs, Strides os,
                 int causal, int has_window, int window, float scale) {
  constexpr int QP = DH + 1;
  constexpr int SP = BK + 1;
  constexpr int NC = DH / 16;      // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * QP;
  float* Ss = Vs + BK * DH;
  float* m_s = Ss + BQ * SP;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < BQ * DH; i += THREADS) {
    const int r = i / DH, d = i % DH, qi = q_start + r;
    Qs[r * QP + d] = qi < Sq ? qb[qi * qs.s + d] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  const int nk = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * BK;
    // tile visibility, as the TPU kernel decides it for its own tiles
    if (causal && k_start > q_start + BQ - 1) break;
    if (has_window && !(k_start + BK - 1 > q_start - window)) continue;

    __syncthreads();   // the previous tile's k, v and p are consumed
    for (int i = tid; i < BK * DH; i += THREADS) {
      const int r = i / DH, d = i % DH, ki = k_start + r;
      const bool in = ki < Sk;
      Ks[r * QP + d] = in ? kb[ki * ks.s + d] : 0.f;
      Vs[r * DH + d] = in ? vb[ki * vs.s + d] : 0.f;
    }
    __syncthreads();

    // s = q . k^T for rows ty*4+i, columns tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q_start + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k_start + c;
        bool vis = true;
        if (causal) vis = kpos <= qpos;
        if (has_window) vis = vis && kpos > qpos - window;
        // keys past Sk do not exist: -inf gives them p = 0 below
        Ss[r * SP + c] = kpos >= Sk ? -INFINITY
                                    : (vis ? s[i][j] * scale : NEG_INF);
      }
    }
    __syncthreads();

    // online softmax, one warp per 8 rows, two columns per lane
#pragma unroll
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float x0 = Ss[r * SP + lane], x1 = Ss[r * SP + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);     // >= -1e30, never -inf
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ss[r * SP + lane] = p0;
      Ss[r * SP + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v for rows ty*4+i, columns tx+16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty * 4 + i) * SP + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float vv = Vs[kk * DH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();   // l_s is final

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q_start + r;
    if (qi >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      ob[qi * os.s + tx + 16 * j] = acc[i][j] / l;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int has_window, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H / KV, Sq, Sk,
      qs, ks,
      vs, os, causal, has_window, window, scale);
  return int(cudaGetLastError());
}

int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o,
                int B, int H, int KV, int Sq, int Sk, Strides qs, Strides ks,
                Strides vs, Strides os, int causal, int has_window,
                int window, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<32>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os,
                        causal, has_window, window, scale, stream);
    case 64:
      return launch<64>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os,
                        causal, has_window, window, scale, stream);
    case 96:
      return launch<96>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os,
                        causal, has_window, window, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os,
                         causal, has_window, window, scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, H, Sq, dh), k/v: (B, KV, Sk, dh), o like q, each addressed through
// its (b, h, s) strides in elements with a contiguous head dim, float32.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int dh, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int has_window, int window,
    float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1 || B > 65535 ||
      H > 65535)
    return int(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_dh(dh, q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os,
                     causal, has_window, window, scale, st);
}
