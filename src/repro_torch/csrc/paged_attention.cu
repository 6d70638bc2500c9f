// Paged decode attention (one new token per sequence, K/V read through a
// block table), for Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/paged_attention/kernel.py::_kernel`
// (wrapper `paged_attention`). The serving side calls it once per layer
// per decode step on the table that `memmgr/kv_cache.py::gather_block_table`
// hands out.
//
// What it computes, as the TPU kernel does: for sequence b and query head
// h (KV head h / G), an online softmax across the sequence's pages with
// running (m, l, acc) in float32, one update per page; s = (q . k) * scale
// in float32; positions >= seq_len inside a live page take the FINITE
// score -1e30 (p = 0); pages past seq_len are skipped, so a sequence of
// length 0 gives 0; p is rounded to v's dtype before the p.v product while
// l sums the unrounded p; the output is acc / max(l, 1e-30). The TPU kernel
// has the block table prefetched into scalar memory; here each block reads
// its own row of the table. A table entry outside [0, P) is clamped into
// it, as JAX clamps an out-of-range gather.
//
// What bounds it: the bytes of the live K and V tokens, each read once
// (~4 KB per token and layer at 8 KV heads of 128 in bf16); the products
// are ~1 flop per byte, far below the card's ridge. This first design is
// plain and right first: one block of 128 threads per (KV head, sequence);
// per page, each warp takes tokens in turn and its lanes split the head
// dimension (q in registers, a shuffle reduction per query head of the
// group), one warp per query head does the page's softmax update, and each
// thread owns one column of the head dimension for p.v. K and V are read
// straight from device memory, coalesced across the head dimension; no
// tile is staged, so a block holds only q, the page's scores and (m, l).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int G_MAX = 16;         // query heads per KV head
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

// GB: the register arrays' bound on the group G = H / KV, 8 or 16, so a
// group of up to 8 keeps the smaller footprint
template <typename T, int DH, int GB>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ bt,
                       const int* __restrict__ seq_lens, T* __restrict__ o,
                       int H, int KV, int G, int page, int n_pages, int P,
                       float scale) {
  constexpr int NV = DH / 32;     // head-dim elements per lane
  extern __shared__ float smem[];
  float* ss = smem;               // G x page: scores, then p
  float* m_s = ss + G * page;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int kv = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = q + ((long long)b * H + (long long)kv * G) * DH;
  float qr[GB][NV];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int i = 0; i < NV; ++i)
      qr[g][i] = g < G ? to_float(qb[g * DH + lane + 32 * i]) : 0.f;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) acc[g] = 0.f;

  const int len = seq_lens[b];
  const int n_live = len > 0 ? min((len + page - 1) / page, n_pages) : 0;
  const long long tok = (long long)KV * DH;       // token stride
  const long long pstride = (long long)page * tok;
  __syncthreads();

  for (int pi = 0; pi < n_live; ++pi) {
    const int phys = min(max(bt[(long long)b * n_pages + pi], 0), P - 1);
    const T* kpg = kp + phys * pstride + (long long)kv * DH;
    const T* vpg = vp + phys * pstride + (long long)kv * DH;
    const int p0 = pi * page;

    // s[g, t] = (q_g . k_t) * scale, masked past the sequence's end
    for (int t = warp; t < page; t += NWARPS) {
      float kr[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) kr[i] = to_float(kpg[t * tok + lane + 32 * i]);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= G) break;                        // uniform across the warp
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) part = fmaf(qr[g][i], kr[i], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) ss[g * page + t] = p0 + t < len ? part * scale : NEG_INF;
      }
    }
    __syncthreads();

    // the page's online-softmax update, one warp per query head
    for (int g = warp; g < G; g += NWARPS) {
      float mx = NEG_INF;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, ss[g * page + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(ss[g * page + t] - m_new);
        sum += p;
        ss[g * page + t] = to_float(from_float<T>(p));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p . v, thread tid owns column tid
    if (tid < DH) {
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
    __syncthreads();   // the page's p and corr are consumed
  }

  if (tid < DH) {
    T* ob = o + ((long long)b * H + (long long)kv * G) * DH;
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < G) ob[g * DH + tid] = from_float<T>(acc[g] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int DH, int GB>
int launch_g(const void* q, const void* kp, const void* vp, const int* bt,
             const int* sl, void* o, int B, int H, int KV, int page,
             int n_pages, int P, float scale, cudaStream_t stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) * (size_t(G) * page + 3 * size_t(G));
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, DH, GB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(KV, B);
  paged_attention_kernel<T, DH, GB><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, sl, static_cast<T*>(o), H, KV, G, page,
      n_pages, P, scale);
  return int(cudaGetLastError());
}

template <typename T, int DH>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* sl, void* o, int B, int H, int KV, int page,
           int n_pages, int P, float scale, cudaStream_t stream) {
  if (H / KV <= 8)
    return launch_g<T, DH, 8>(q, kp, vp, bt, sl, o, B, H, KV, page, n_pages,
                              P, scale, stream);
  return launch_g<T, DH, G_MAX>(q, kp, vp, bt, sl, o, B, H, KV, page,
                                n_pages, P, scale, stream);
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* kp, const void* vp,
                const int* bt, const int* sl, void* o, int B, int H, int KV,
                int page, int n_pages, int P, float scale,
                cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, kp, vp, bt, sl, o, B, H, KV, page, n_pages, P,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, kp, vp, bt, sl, o, B, H, KV, page, n_pages, P,
                           scale, stream);
    case 96:
      return launch<T, 96>(q, kp, vp, bt, sl, o, B, H, KV, page, n_pages, P,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, kp, vp, bt, sl, o, B, H, KV, page, n_pages,
                            P, scale, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, H, dh); k/v pages: (P, page, KV, dh); block_table: (B, n_pages)
// int32; seq_lens: (B,) int32; o like q. All contiguous. dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int paged_attention_fwd(const void* q, const void* kp,
                                   const void* vp, const void* block_table,
                                   const void* seq_lens, void* o, int B,
                                   int H, int KV, int dh, int page,
                                   int n_pages, int P, float scale,
                                   int dtype, void* stream) {
  if (B < 1 || KV < 1 || H % KV || H / KV > G_MAX || page < 1 ||
      n_pages < 1 || P < 1 || B > 65535 || KV > 65535)
    return int(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_table);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(dh, q, kp, vp, bt, sl, o, B, H, KV, page,
                              n_pages, P, scale, st);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dh, q, kp, vp, bt, sl, o, B, H, KV,
                                      page, n_pages, P, scale, st);
  return int(cudaErrorInvalidValue);
}
