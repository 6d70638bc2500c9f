// Paged decode attention (one new token per sequence, K/V read through a
// block table), for Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/paged_attention/kernel.py::_kernel`
// (wrapper `paged_attention`). The serving side calls it once per layer
// per decode step on the table that `memmgr/kv_cache.py::gather_block_table`
// hands out.
//
// What it computes, as the TPU kernel does: for sequence b and query head
// h (KV head h / G), a softmax over the positions < seq_len of the
// sequence's live pages, with s = (q . k) * scale in float32 and (m, l,
// acc) in float32; positions >= seq_len inside a live page take the
// FINITE score -1e30 (p = 0); pages past seq_len are not read, so a
// sequence of length 0 gives 0; p is rounded to v's dtype before the p.v
// product while l sums the unrounded p; the output is acc / max(l, 1e-30).
// A table entry outside [0, P) is clamped into it, as JAX clamps an
// out-of-range gather.
//
// What bounds it: bytes. Each live K and V row is read once (4 KB per
// token and layer at 8 KV heads of 128 in bf16) for 4 G flop per 4 bytes
// of K+V (G = H / KV query heads share a KV head): 4 flop/byte at G = 4,
// 16 at G = 16, under the ~20 flop/byte the CUDA cores sustain at the
// memory's rate, so the products run as FMAs on the CUDA cores.
//
// The design, two launches per call:
//  * Split. The grid is one axis of (split, head group, KV head,
//    sequence), the split fastest, so no count of sequences or KV heads
//    meets the 65535 limit of grid dims y and z. A head group is at most
//    G_MAX = 16 of the G query heads of a KV head: a group of G <= 16 is
//    all of them, a larger G (71 for Falcon-7B's multi-query heads) is
//    cut into ceil(G / 16) groups of equal size but the last, each a
//    block of its own that streams the span's K and V again (from L2,
//    as the groups of one span run side by side). Each block takes a
//    fixed span of `pps` pages of one (KV head, sequence); the wrapper
//    picks the span on the host from the page size and the table's width
//    alone (`kernel.py::split_plan`, ~128 tokens), without reading
//    seq_lens. A block whose span starts at or past the sequence's live
//    pages writes the empty partial m = -1e30, l = 0 and exits. Every
//    other block runs the online softmax over its span and writes its
//    partial (m, l, acc) in float32 to scratch the wrapper allocated.
//  * Combine. One block per (query head, sequence), on one grid axis,
//    merges the partials in split order, m* = max m_i, o = sum_i e^(m_i - m*) acc_i /
//    max(sum_i e^(m_i - m*) l_i, 1e-30), over the splits with l_i > 0: no
//    atomics, so a result repeats bit for bit from run to run, and a row
//    with no live split gives 0.
//  * Ring. A block streams its span's K and V rows through a ring of NS = 2
//    stages of TT = 32 logical tokens each, by 16-byte cp.async
//    (zero-filled past the span): the next tile is in flight while one is
//    computed. Each row's address comes through the block table (token /
//    page), so any page size works and a tile may cross pages. Rows are
//    padded by 16 bytes, so lanes on different rows hit different banks.
//    Two stages, not more: a deeper ring takes shared memory that would
//    otherwise hold more blocks per SM, and was slower on the card.
//  * Prologue. seq_len, the span's table entries and q are loaded in one
//    round trip, before the block knows whether it is live.
//  * Head widths: the widths the models run (32, 64, 96, 128) with one
//    head group have exact instances, which compile no column checks and
//    no group arithmetic. Every other call runs a padded instance (DH
//    128, 192 or 256, blocks of up to 16 heads): a head of dh < DH
//    columns (whole 16-byte pieces: dh a multiple of 8 in bf16, 4 in
//    fp32) reads the columns past dh as zeros (q's by a select, K's and
//    V's by cp.async's source size 0), which add nothing to q.k, and
//    stores only its dh columns. Other heads and layouts the wrapper
//    stages (kernel.py::plan).
//  * Per tile: q.k with lane = token and warp = a quarter of the head
//    dim, q as float32 in shared memory (broadcast reads); the four
//    quarters summed, the tile's online-softmax update with one warp per
//    query head (lane = token), p rounded to v's dtype; p.v with warp =
//    every 4th token and lane = DH / 32 columns, accumulators kept in
//    registers over the span and summed across the four warps in a fixed
//    order at its end. Tokens past seq_len in the last live page are read
//    and weighted 0.
//
// Resources (`-Xptxas -v`, build/repro_torch/paged_attention-*.log, as
// `scripts/torch_paged_variants.py` prints it). Registers per thread of
// the split kernel's instances <dtype, DH, GB>, GB 4 / 8 / 16:
//   bf16: DH 128: 56 / 80 / 126; DH 96: 56 / 72 / 128;
//         DH 64: 48 / 61 / 92;   DH 32: 44 / 56 / 72;
//   fp32: DH 128: 56 / 80 / 135; DH 96: 62 / 80 / 144;
//         DH 64: 44 / 62 / 102;  DH 32: 44 / 56 / 79;
// no instance spills but <fp32, 128, 8> (8 bytes of stack). The combine
// kernel: 32 registers, 272 bytes of static shared memory. (The readings
// before the head groups, one grid axis and padded widths.) Now, the exact
// instances (EXACT, below) as before within a few registers (the pool's
// <bf16, 128, 4>: 56, no spill); the padded ones (GB 16), DH 128 / 192 /
// 256: bf16 168 / 168 (20 B spilled) / 244, fp32 192 / 189 / 253. The
// combine kernel: 32 registers, 288 bytes of static shared memory. Dynamic shared
// memory of a split block (split_smem_bytes): the ring, 2 x 2 x 32 rows of
// DH x sizeof(T) + 16 bytes, plus q, the q.k quarters, p and the span's
// table: 39,444 bytes at the pool's shape (bf16, DH 128, G 4, one page per
// span), so 5 blocks of 4 warps per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int G_MAX = 16;         // query heads of a block (a head group)
constexpr int DH_MAX = 256;       // the widest instance
constexpr float NEG_INF = -1e30f;
constexpr int TT = 32;            // tokens per ring tile
constexpr int NS = 2;             // ring stages
constexpr int PAD = 16;           // bytes after each staged row

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

// the floats of one 32-bit word: one float32, or two bf16 (low half first)
__device__ __forceinline__ void unpack(uint32_t w, float* x, float) {
  x[0] = __uint_as_float(w);
}
__device__ __forceinline__ void unpack(uint32_t w, float* x, __nv_bfloat16) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

// N elements of type T at p (shared memory) as floats, by the widest load
// the byte count and its alignment allow
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float* x) {
  constexpr int BYTES = N * int(sizeof(T));
  constexpr int PER = 4 / int(sizeof(T));         // elements per word
  if constexpr (BYTES == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    unpack(u.x, x, T{});
    unpack(u.y, x + PER, T{});
    unpack(u.z, x + 2 * PER, T{});
    unpack(u.w, x + 3 * PER, T{});
  } else if constexpr (BYTES == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack(u.x, x, T{});
    unpack(u.y, x + PER, T{});
  } else if constexpr (BYTES == 4) {
    unpack(*reinterpret_cast<const uint32_t*>(p), x, T{});
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_float(p[i]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !pred (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---- split kernel: begin ----
// Dynamic shared memory of one block: the ring (NS stages of TT K rows
// and TT V rows), q (G x DH float32), the q.k quarters (G x NWARPS x TT),
// p (TT x GB), the rescale factors (GB) and the span's table (pps ints).
template <typename T, int DH, int GB>
size_t split_smem_bytes(int G, int page, int pps) {
  (void)page;
  constexpr size_t ROW = DH * sizeof(T) + PAD;
  return size_t(NS) * 2 * TT * ROW +
         sizeof(float) * (size_t(G) * DH + size_t(G) * NWARPS * TT +
                          size_t(TT) * GB + GB) +
         sizeof(int) * size_t(pps);
}

// One block per (split s, head group hg, KV head kv, sequence b); see the
// note above. DH: the instance's padded head width; dh <= DH the true one.
// G_all query heads per KV head, in groups of GS (the last may be short).
// EXACT: dh == DH and one group (G_all <= GB), as every model's call; the
// instance then compiles no column checks and no group arithmetic.
template <typename T, int DH, int GB, bool EXACT>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ bt,
                   const int* __restrict__ seq_lens,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int H, int KV, int G_all,
                   int GS, int n_groups_rt, int dh_rt, int page,
                   int n_pages, int P, int pps, int n_splits, float scale) {
  constexpr int SZ = sizeof(T);
  constexpr int ROW = DH * SZ + PAD;       // bytes of a staged row
  constexpr int CPR = DH * SZ / 16;        // 16-byte chunks per row
  constexpr int E = 16 / SZ;               // elements per chunk
  constexpr int SL = DH / NWARPS;          // q.k: a warp's head-dim quarter
  constexpr int NCA = SL / E;              // its chunks per row
  constexpr int CW = DH / 32;              // p.v: a lane's columns
  constexpr int GW = (GB + NWARPS - 1) / NWARPS;   // heads per warp
  constexpr int TPL = TT / 32;             // q.k: tokens per lane
  static_assert(SL % E == 0 && DH % 32 == 0, "head dim");
  static_assert(TT % 32 == 0, "tile");

  const int dh = EXACT ? DH : dh_rt;
  const int n_groups = EXACT ? 1 : n_groups_rt;
  const int s = blockIdx.x % n_splits;
  const int rest = blockIdx.x / n_splits;
  const int hg = EXACT ? 0 : rest % n_groups;
  const int kvb = EXACT ? rest : rest / n_groups;   // kv + KV * b
  const int kv = kvb % KV, b = kvb / KV;
  // the query heads of this block
  const int G = EXACT ? G_all : min(GS, G_all - hg * GS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long hrow = (long long)b * H + (long long)kv * G_all +
                         (long long)hg * GS;                 // (b, h0)
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + size_t(NS) * 2 * TT * ROW);
  float* red = qs + G * DH;                // [g][warp][t]
  float* ps = red + G * NWARPS * TT;       // [t][GB]
  float* cs = ps + TT * GB;                // [GB]
  int* tbl = reinterpret_cast<int*>(cs + GB);

  // seq_len, the span's first table entries and q are loaded together,
  // before the block knows whether its span is live: one round trip
  // before the first K/V tile is asked for, not two
  const int pg0 = s * pps;
  const int* btb = bt + (long long)b * n_pages + pg0;
  const int len = seq_lens[b];
  const int entry = btb[min(tid, min(pps, n_pages - pg0) - 1)];
  const T* qb = q + hrow * dh;
  if constexpr (EXACT) {
#pragma unroll 4
    for (int i = tid; i < G * DH; i += THREADS) qs[i] = to_float(qb[i]);
  } else {
#pragma unroll 4
    for (int i = tid; i < G * DH; i += THREADS) {
      const int g = i / DH, d = i - g * DH;   // columns past dh read as 0
      qs[i] = d < dh ? to_float(qb[g * dh + d]) : 0.f;
    }
  }
  const int n_live = len > 0 ? min((len + page - 1) / page, n_pages) : 0;
  if (pg0 >= n_live) {                     // the empty partial
    if (tid < G) {
      part_m[(hrow + tid) * n_splits + s] = NEG_INF;
      part_l[(hrow + tid) * n_splits + s] = 0.f;
    }
    return;
  }
  const int np = min(pg0 + pps, n_live) - pg0;     // live pages of the span
  const int span = np * page;                      // tokens read
  // tokens of the span that are < seq_len (>= 1: the span's first page is
  // live)
  const int lim = (int)min((long long)span, (long long)len -
                                                (long long)pg0 * page);
  const int ntiles = (span + TT - 1) / TT;
  if (tid < np) tbl[tid] = min(max(entry, 0), P - 1);
  for (int i = tid + THREADS; i < np; i += THREADS)
    tbl[i] = min(max(btb[i], 0), P - 1);
  __syncthreads();

  const long long tok = (long long)KV * dh;        // elements per token
  const int cpr = dh * SZ / 16;                    // live chunks of a row
  const unsigned char* kbase =
      reinterpret_cast<const unsigned char*>(kp + (long long)kv * dh);
  const unsigned char* vbase =
      reinterpret_cast<const unsigned char*>(vp + (long long)kv * dh);
  // tile `tile` of the span into ring stage `stage`: TT rows of K and V
  auto issue = [&](int tile, int stage) {
    unsigned char* kd = ring + size_t(stage) * 2 * TT * ROW;
    unsigned char* vd = kd + TT * ROW;
    for (int c = tid; c < TT * CPR; c += THREADS) {
      const int r = c / CPR, cc = c % CPR;
      const int u = tile * TT + r;                 // token within the span
      const bool in = u < span && (EXACT || cc < cpr);
      long long off = 0;
      if (in) {
        const int lp = u / page;
        off = (((long long)tbl[lp] * page + (u - lp * page)) * tok) * SZ +
              cc * 16;
      }
      cp_async16(kd + r * ROW + cc * 16, kbase + off, in);
      cp_async16(vd + r * ROW + cc * 16, vbase + off, in);
    }
  };

#pragma unroll
  for (int j = 0; j < NS - 1; ++j) {
    if (j < ntiles) issue(j, j);
    cp_commit();
  }

  float m_run[GW], l_run[GW];
#pragma unroll
  for (int j = 0; j < GW; ++j) {
    m_run[j] = NEG_INF;
    l_run[j] = 0.f;
  }
  float acc[GB][CW];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[g][c] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<NS - 2>();
    __syncthreads();       // tile `it` landed; stage (it - 1) % NS is free
    if (it + NS - 1 < ntiles) issue(it + NS - 1, (it + NS - 1) % NS);
    cp_commit();
    const unsigned char* kt = ring + size_t(it % NS) * 2 * TT * ROW;
    const unsigned char* vt = kt + TT * ROW;

    // q.k: lane = tokens lane + 32 i, warp = a quarter of the head dim
#pragma unroll
    for (int i = 0; i < TPL; ++i) {
      float part[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) part[g] = 0.f;
      const T* krow =
          reinterpret_cast<const T*>(kt + (lane + 32 * i) * ROW) + warp * SL;
#pragma unroll
      for (int c = 0; c < NCA; ++c) {
        float kx[E];
        load_floats<T, E>(krow + c * E, kx);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < G) {
            const float4* qv = reinterpret_cast<const float4*>(
                qs + g * DH + warp * SL + c * E);
#pragma unroll
            for (int e4 = 0; e4 < E / 4; ++e4) {
              const float4 qq = qv[e4];
              part[g] = fmaf(qq.x, kx[4 * e4], part[g]);
              part[g] = fmaf(qq.y, kx[4 * e4 + 1], part[g]);
              part[g] = fmaf(qq.z, kx[4 * e4 + 2], part[g]);
              part[g] = fmaf(qq.w, kx[4 * e4 + 3], part[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g)
        if (g < G) red[(g * NWARPS + warp) * TT + lane + 32 * i] = part[g];
    }
    __syncthreads();

    // the tile's online-softmax update: warp w takes heads w, w + 4, ...
#pragma unroll
    for (int j = 0; j < GW; ++j) {
      const int g = warp + NWARPS * j;
      if (g < G) {                                 // uniform in the warp
        float sc[TPL];
        float mx = NEG_INF;
#pragma unroll
        for (int i = 0; i < TPL; ++i) {
          const float* rg = red + g * NWARPS * TT + lane + 32 * i;
          sc[i] = ((rg[0] + rg[TT]) + (rg[2 * TT] + rg[3 * TT])) * scale;
          sc[i] = it * TT + lane + 32 * i < lim ? sc[i] : NEG_INF;
          mx = fmaxf(mx, sc[i]);
        }
        const float m_new = fmaxf(m_run[j], warp_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < TPL; ++i) {
          const float p = sc[i] > NEG_INF ? expf(sc[i] - m_new) : 0.f;
          sum += p;
          ps[(lane + 32 * i) * GB + g] = to_float(from_float<T>(p));
        }
        const float corr = expf(m_run[j] - m_new);
        l_run[j] = l_run[j] * corr + warp_sum(sum);
        m_run[j] = m_new;
        if (lane == 0) cs[g] = corr;
      }
    }
    __syncthreads();

    // p.v: warp w takes tokens w, w + 4, ...; lane = CW columns
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
        const float corr = cs[g];
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[g][c] *= corr;
      }
    }
#pragma unroll 2
    for (int i = 0; i < TT / NWARPS; ++i) {
      const int t = warp + NWARPS * i;
      float vx[CW];
      load_floats<T, CW>(reinterpret_cast<const T*>(vt + t * ROW) + lane * CW,
                         vx);
      const float4* pt = reinterpret_cast<const float4*>(ps + t * GB);
#pragma unroll
      for (int g4 = 0; g4 < GB / 4; ++g4) {
        if (4 * g4 < G) {
          const float4 pp = pt[g4];
          const float pg[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int c = 0; c < CW; ++c)
              acc[4 * g4 + k][c] = fmaf(pg[k], vx[c], acc[4 * g4 + k][c]);
        }
      }
    }
  }

  // the span's partial: m, l from each head's warp; acc summed over the
  // four warps in a fixed order, through the (now idle) ring
  cp_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < GW; ++j) {
    const int g = warp + NWARPS * j;
    if (g < G && lane == 0) {
      part_m[(hrow + g) * n_splits + s] = m_run[j];
      part_l[(hrow + g) * n_splits + s] = l_run[j];
    }
  }
  float* buf = reinterpret_cast<float*>(ring);     // [warp][g][DH]
#pragma unroll
  for (int g = 0; g < GB; ++g)
    if (g < G)
#pragma unroll
      for (int c = 0; c < CW; ++c)
        buf[(warp * G + g) * DH + lane * CW + c] = acc[g][c];
  __syncthreads();
  for (int i = tid; i < G * DH; i += THREADS) {
    const float a = (buf[i] + buf[G * DH + i]) +
                    (buf[2 * G * DH + i] + buf[3 * G * DH + i]);
    const int g = i / DH, d = i - g * DH;
    part_acc[((hrow + g) * n_splits + s) * DH + d] = a;
  }
}
// ---- split kernel: end ----

// One block of DH threads per (query head h, sequence b), thread d on
// column d: the partials of the row merged in split order. The splits'
// weights are formed CB at a time in shared memory, one per thread; each
// thread then loads its column of 8 splits' acc at once. The live splits
// (l > 0) are a prefix of the row's splits (split s is live when s * pps
// < the sequence's live pages), so only they are loaded; an empty
// split's acc is never written.
constexpr int CB = 32;            // combine: splits weighed at a time
template <typename T>
__global__ void paged_combine_kernel(const float* __restrict__ part_m,
                                     const float* __restrict__ part_l,
                                     const float* __restrict__ part_acc,
                                     T* __restrict__ o, int DH, int dh,
                                     int n_splits) {
  __shared__ float w_s[CB], l_s[CB], mx_s[DH_MAX / 32];
  const int d = threadIdx.x;
  const long long row = blockIdx.x;       // b * H + h
  const float* pm = part_m + row * n_splits;
  const float* pl = part_l + row * n_splits;
  const float* pa = part_acc + row * n_splits * DH + d;
  float mx = NEG_INF;
  for (int i = d; i < n_splits; i += DH) mx = fmaxf(mx, pm[i]);
  mx = warp_max(mx);
  if (d % 32 == 0) mx_s[d / 32] = mx;
  __syncthreads();
  mx = mx_s[0];
  for (int w = 1; w < DH / 32; ++w) mx = fmaxf(mx, mx_s[w]);
  float num = 0.f, den = 0.f;
  for (int c0 = 0; c0 < n_splits; c0 += CB) {
    const int cn = min(CB, n_splits - c0);
    __syncthreads();                       // the last chunk's weights read
    if (d < cn) {
      const float li = pl[c0 + d];         // an empty split has l = 0
      w_s[d] = li > 0.f ? expf(pm[c0 + d] - mx) : 0.f;
      l_s[d] = li;
    }
    const int live = __syncthreads_count(d < cn && l_s[d] > 0.f);
    for (int j0 = 0; j0 < live; j0 += 8) {
      float a[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        a[k] = pa[(long long)(c0 + min(j0 + k, live - 1)) * DH];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (j0 + k < live) {
          num = fmaf(w_s[j0 + k], a[k], num);
          den = fmaf(w_s[j0 + k], l_s[j0 + k], den);
        }
      }
    }
    if (live < cn) break;                  // the rest are empty
  }
  if (d < dh) o[row * dh + d] = from_float<T>(num / fmaxf(den, 1e-30f));
}

template <typename T, int DH, int GB, bool EXACT>
int launch_g(const void* q, const void* kp, const void* vp, const int* bt,
             const int* sl, float* pm, float* pl, float* pa, void* o, int B,
             int H, int KV, int GS, int n_groups, int dh, int page,
             int n_pages, int P, int pps, int n_splits, float scale,
             cudaStream_t stream) {
  const size_t smem = split_smem_bytes<T, DH, GB>(GS, page, pps);
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T, DH, GB, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const unsigned blocks = unsigned(n_splits) * n_groups * KV * B;
  paged_split_kernel<T, DH, GB, EXACT><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, sl, pm, pl, pa, H, KV, H / KV, GS,
      n_groups, dh, page, n_pages, P, pps, n_splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  paged_combine_kernel<T><<<unsigned(H) * B, DH, 0, stream>>>(
      pm, pl, pa, static_cast<T*>(o), DH, dh, n_splits);
  return int(cudaGetLastError());
}

// The instance of a call. Exact (dh == DH, one group): the widths the
// models run, 32-128, with GB = 4, 8 or 16 for the block's GS query heads.
// Padded (any other head of whole 16-byte pieces, or G > 16): the widths
// 128, 192 and 256, with blocks of up to 16 heads; fewer instances keep
// the source's build short, at the cost of registers for a padded call
// of few heads.
template <typename T, int DH>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* sl, float* pm, float* pl, float* pa, void* o, int B,
           int H, int KV, int GS, int n_groups, int dh, int page,
           int n_pages, int P, int pps, int n_splits, float scale,
           cudaStream_t stream) {
#define PAGED_LAUNCH_G(GB, EXACT)                                           \
  launch_g<T, DH, GB, EXACT>(q, kp, vp, bt, sl, pm, pl, pa, o, B, H, KV,    \
                             GS, n_groups, dh, page, n_pages, P, pps,       \
                             n_splits, scale, stream)
  if constexpr (DH <= 128) {
    if (dh == DH && n_groups == 1) {
      if (GS <= 4) return PAGED_LAUNCH_G(4, true);
      if (GS <= 8) return PAGED_LAUNCH_G(8, true);
      return PAGED_LAUNCH_G(G_MAX, true);
    }
  }
  if constexpr (DH >= 128)
    return PAGED_LAUNCH_G(G_MAX, false);
  else
    return int(cudaErrorInvalidValue);        // no padded instance below 128
#undef PAGED_LAUNCH_G
}

template <typename T>
int dispatch_dh(int dhp, const void* q, const void* kp, const void* vp,
                const int* bt, const int* sl, float* pm, float* pl, float* pa,
                void* o, int B, int H, int KV, int GS, int n_groups, int dh,
                int page, int n_pages, int P, int pps, int n_splits,
                float scale, cudaStream_t stream) {
  switch (dhp) {
#define PAGED_CASE(DH)                                                      \
  case DH:                                                                  \
    return launch<T, DH>(q, kp, vp, bt, sl, pm, pl, pa, o, B, H, KV, GS,    \
                         n_groups, dh, page, n_pages, P, pps, n_splits,     \
                         scale, stream);
    PAGED_CASE(32)
    PAGED_CASE(64)
    PAGED_CASE(96)
    PAGED_CASE(128)
    PAGED_CASE(192)
    PAGED_CASE(256)
#undef PAGED_CASE
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, H, dh); k/v pages: (P, page, KV, dh); block_table: (B, n_pages)
// int32; seq_lens: (B,) int32; o like q. All contiguous, 16-byte aligned,
// dh whole 16-byte pieces. `dhp`: the instance's padded width (32, 64, 96,
// 128, 192 or 256, at least dh); `gs`: query heads of a block, the G = H /
// KV of a KV head in n_groups = ceil(G / gs) groups. The split: `pps`
// pages per block, n_splits = ceil(n_pages / pps) blocks per (head group,
// KV head, sequence). Scratch, float32: part_m and part_l (B, H,
// n_splits), part_acc (B, H, n_splits, dhp). dtype: 0 = float32, 1 =
// bfloat16. Two launches on `stream`; returns a cudaError_t (0 =
// launched).
extern "C" int paged_attention_fwd(const void* q, const void* kp,
                                   const void* vp, const void* block_table,
                                   const void* seq_lens, void* part_m,
                                   void* part_l, void* part_acc, void* o,
                                   int B, int H, int KV, int dh, int dhp,
                                   int gs, int page, int n_pages, int P,
                                   int pps, int n_splits, float scale,
                                   int dtype, void* stream) {
  if (B < 1 || KV < 1 || H % KV || gs < 1 || gs > G_MAX || page < 1 ||
      n_pages < 1 || P < 1 || pps < 1 ||
      n_splits != (n_pages + pps - 1) / pps || dh < 1 || dh > dhp ||
      dh * (dtype == 0 ? 4 : 2) % 16)
    return int(cudaErrorInvalidValue);
  const int n_groups = (H / KV + gs - 1) / gs;
  if ((long long)n_splits * n_groups * KV * B > 2147483647LL ||
      (long long)H * B > 2147483647LL)
    return int(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_table);
  const int* sl = static_cast<const int*>(seq_lens);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dh<float>(dhp, q, kp, vp, bt, sl, pm, pl, pa, o, B, H,
                              KV, gs, n_groups, dh, page, n_pages, P, pps,
                              n_splits, scale, st);
  if (dtype == 1)
    return dispatch_dh<__nv_bfloat16>(dhp, q, kp, vp, bt, sl, pm, pl, pa, o,
                                      B, H, KV, gs, n_groups, dh, page,
                                      n_pages, P, pps, n_splits, scale, st);
  return int(cudaErrorInvalidValue);
}
