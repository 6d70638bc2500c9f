// Forward flash attention in float32 (causal or bidirectional, optional
// sliding window, grouped-query heads), for Hopper (sm_90a), on the tensor
// cores in split TF32.
//
// Replaces the TPU kernel `src/repro/kernels/flash_attention/kernel.py::_kernel`
// (wrapper `flash_attention_bhsd`) for float32 inputs; bfloat16 inputs go
// to the kernel of `flash_attention_sm90.cu`. The model calls it once per
// attention layer on its full-sequence path (`models/lm.py::
// _self_attention_full`, so in `forward_prefill` and `forward_train`) when
// `RunConfig.attention_impl == "pallas_flash"`.
//
// What it computes, exactly as the TPU kernel does: for query head h (KV
// head h / G), an online softmax over key tiles with running (m, l, acc)
// in float32; s = (q . k) * scale; masked scores are the FINITE value
// -1e30 (a row whose first visited tile is fully masked takes p = 1 there,
// and the next tile's correction exp(-1e30 - m) = 0 wipes it, where -inf
// would give NaN); p stays float32, as v is; the output is
// acc / max(l, 1e-30). Tiles that causality or the window masks completely
// are skipped. Positions count from 0 in both q and k. Keys past Sk get
// -inf, so p = 0.
//
// What bounds it: operations. At the fp32 match shape (qwen3-4b, 2 x 496
// tokens, 32 heads of 128, 8 KV heads, causal) the two products need
// 4.039e9 flop on the visible (q, k) pairs, against 40.6 MB of q, k, v
// and o (0.0121 ms at 3.35 TB/s). On the CUDA cores' 67 TFLOP/s (the SIMT
// kernel this one replaced) that is 0.0603 ms. Here each product is three
// TF32 tensor-core passes (split TF32, below): 1.21e10 flop at 495 TFLOP/s,
// 0.0245 ms. mma.sync runs below that rate, and the CUDA-core work around
// each mma (the operands' splits, the fragment loads, the softmax's exps)
// issues several instructions per mma.
//
// The design:
//  * One block of 4 warps per (q tile of 64 rows, head, batch); each warp
//    owns 16 query rows. The grid is one axis of q tiles x batch x heads,
//    heads fastest (so no count of batches or q tiles meets the 65535
//    limit of grid dims y and z), the q tiles from the last, so the causal
//    rows with the most keys start first.
//  * Instances by padded head width DHP, every multiple of 32 up to 256;
//    a head of dh < DHP columns (dh a multiple of 4, so each 16-byte piece
//    is whole) reads the columns past dh as zeros (cp.async's source size
//    0), which add nothing to q.k and are not stored. The widths the
//    models run (32, 64, 96, 128) have an exact instance too, which
//    compiles no column checks. Up to DHP 128 q's
//    fragments stay in registers; above, they would not fit next to the
//    accumulator (128 registers at DHP 256), so the q tile waits in
//    shared memory (pitch DHP + 16, as k's) and the fragments are loaded
//    from there for each key tile.
//  * Both products run on mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 in
//    split TF32: each operand a = a_hi + a_lo with a_hi = tf32(a),
//    a_lo = tf32(a - a_hi), rounded as cvt.rna.tf32.f32 rounds (two integer
//    operations, the same bits), and a.b = a_lo.b_hi + a_hi.b_lo +
//    a_hi.b_hi accumulated in float32. The dropped terms are ~3 2^-22
//    |a||b|; plain TF32 (hi.hi alone) would miss the reference's 2e-5.
//    Each pass runs over all of a step's tiles before the next, so no mma
//    waits on the one before it for its accumulator. q's fragments stay in
//    registers as float32 (64 registers at dh 128; its halves would take
//    128) and are split once per key tile; k, p and v are split as their
//    fragments are loaded.
//  * s = q.k^T: the warp's 16 x 32 score tile is 4 n-tiles of 8 keys. The
//    head dim is permuted in both operands, so that a thread's values of
//    two k-steps (16 columns) are 4 adjacent floats: one 16-byte load for
//    q (from device memory, once) and for k (from shared memory) each.
//  * The online softmax runs on the score fragments in registers: row max
//    by quad shuffles, exps in float32, each thread keeping its own part of
//    l (the quad's parts are summed at the end), the accumulator rescaled
//    in registers. Nothing of s or p goes through shared memory.
//  * acc += p.v: the score fragment is p.v's A fragment once the k index of
//    each 8-key step is permuted (slot t <-> key 2t, slot t + 4 <-> key
//    2t + 1) in both operands; the output columns are permuted so that a
//    thread's v values of 4 n-tiles are one 16-byte load, and its output
//    values of a row are 8 adjacent floats (two 16-byte stores).
//  * K and V tiles of 32 keys come by 16-byte cp.async through a 2-stage
//    shared-memory ring, the next tile's copy under the current tile's
//    products; rows past Sk are zero-filled (src-size 0). Row pitches of
//    dh + 16 (k) and dh + 4 (v) floats keep the fragment loads free of
//    bank conflicts. 70.7 KB a block at dh 128; with the q tile, 205.8
//    KB at DHP 256.
//
// Resources (`-Xptxas -v`, build/repro_torch/flash_attention-*.log;
// registers a thread, bytes of spill stores; exact / padded instance):
// DH 32: 133 / 137, none; 64: 192 / 203, none; 96: 244 / 245, none; 128:
// 255 / 255, 40 / 28 B; padded only: 160: 202, 192: 229, 224: 241, 256:
// 243, none. Shared memory (Tile<DH>::SMEM): 2 x 32 x (DH + 16 + DH + 4)
// x 4 B, plus the q tile, 64 x (DH + 16) x 4 B, past 128: 70.7 KB at 128,
// 205.8 KB at 256.
//
// Layout: q, k, v, o are read and written through (batch, head, position)
// strides with a contiguous head dimension, so the model's (B, S, H, dh)
// tensors are used in place. Addresses and strides are multiples of 16
// bytes (the wrapper checks, and stages other inputs). Ragged edges (lengths not a multiple of the
// tiles) are handled: q rows past Sq are read as zero and not stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per tile
constexpr int WARPS = BQ / 16;      // 16 query rows a warp
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;
};

template <int DH>
struct Tile {
  static constexpr bool QS = DH > 128; // q tile in shared memory
  static constexpr int KP = DH + 16;   // k (and q) row pitch: 16 mod 32
  static constexpr int VP = DH + 4;    // v row pitch: 4 mod 32 floats
  static constexpr int STAGE = BK * (KP + VP);
  static constexpr size_t SMEM =
      sizeof(float) * (2 * STAGE + (QS ? BQ * KP : 0));
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

struct Split {
  uint32_t hi, lo;
};

// cvt.rna.tf32.f32's rounding (to nearest, ties away; the low 13 bits
// cleared) on the int32 view: the same bits in two integer operations
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment (rows g, g + 8; k slots t, t + 4) of four float32 values
// in the register order of mma: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ FragA(float a0, float a1, float a2, float a3) {
    const float v[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Split s = split(v[i]);
      hi[i] = s.hi;
      lo[i] = s.lo;
    }
  }
};

// d[j] += a . b[j] in split TF32, the small cross terms first; b[j] is the
// B fragment (b0[j], b1[j]). Each pass runs over every tile before the
// next, so no mma waits on the one before it for its accumulator.
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const FragA& a,
                                     const Split (&b0)[N],
                                     const Split (&b1)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], a.lo, b0[j].hi, b1[j].hi);
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], a.hi, b0[j].lo, b1[j].lo);
#pragma unroll
  for (int j = 0; j < N; ++j) mma(d[j], a.hi, b0[j].hi, b1[j].hi);
}

// DH: the padded head width of the instance; PAD: the true head dh_rt may
// be narrower (else it is DH, and the instance compiles no column checks)
template <int DH, bool PAD>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H,
                 int B, int G, int Sq, int Sk, int dh_rt, Strides qs,
                 Strides ks, Strides vs, Strides os, int causal,
                 int has_window, int window, float scale) {
  using T = Tile<DH>;
  const int dh = PAD ? dh_rt : DH;
  constexpr int NP = DH / 16;      // k-step pairs of q.k^T (16 columns)
  constexpr int NS = BK / 8;       // n-tiles of s = k-steps of p.v
  constexpr int NC = DH / 32;      // output column groups (4 n-tiles each)
  constexpr int CPR = DH / 4;      // 16-byte chunks of a k or v row
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;          // mma fragment coordinates
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % B;
  const int nqt = (Sq + BQ - 1) / BQ;
  const int q_start = (nqt - 1 - int(blockIdx.x / H) / B) * BQ;
  const int kvh = h / G;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  float* ob = o + b * os.b + h * os.h;
  const int r0 = q_start + warp * 16 + g, r1 = r0 + 8;   // this thread's rows

  // q: rows r0, r1, columns 16p + 4t .. 16p + 4t + 3; the first two are
  // k-step 2p's slots t and t + 4, the last two k-step 2p + 1's. In
  // registers up to DH 128; above, the tile is copied to shared memory
  // with the first k/v tile and the fragments read from there.
  float4 qf[T::QS ? 1 : NP][2];
  float* Qs = smem + 2 * T::STAGE;                  // QS: the q tile
  if constexpr (T::QS) {
    for (int c = tid; c < BQ * CPR; c += THREADS) {
      const int r = c / CPR, col = (c % CPR) * 4;
      const bool in = q_start + r < Sq && col < dh;
      cp_async16(Qs + r * T::KP + col,
                 in ? qb + (q_start + r) * qs.s + col : qb, in);
    }
  } else {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int c = 16 * p + 4 * t;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      qf[p][0] = r0 < Sq && c < dh
                     ? *reinterpret_cast<const float4*>(qb + r0 * qs.s + c)
                     : zero;
      qf[p][1] = r1 < Sq && c < dh
                     ? *reinterpret_cast<const float4*>(qb + r1 * qs.s + c)
                     : zero;
    }
  }

  // the visible key tiles, as the TPU kernel decides for its own tiles
  const int nk = (Sk + BK - 1) / BK;
  const int kt_end = causal ? min(nk, (q_start + BQ - 1) / BK + 1) : nk;
  int kt_begin = 0;
  if (has_window) {
    const int lo = q_start - window + 1;          // first row's first key
    kt_begin = lo > 0 ? lo / BK : 0;
  }

  auto load = [&](int kt, int stage) {
    float* Ks = smem + stage * T::STAGE;
    float* Vs = Ks + BK * T::KP;
    const int k0 = kt * BK;
    for (int c = tid; c < BK * CPR; c += THREADS) {
      const int r = c / CPR, col = (c % CPR) * 4;
      const bool in = k0 + r < Sk && col < dh;
      const long long kr = in ? k0 + r : 0;     // src-size 0 reads nothing
      const int cc = in ? col : 0;
      cp_async16(Ks + r * T::KP + col, kb + kr * ks.s + cc, in);
      cp_async16(Vs + r * T::VP + col, vb + kr * vs.s + cc, in);
    }
  };

  // acc[c][j], n-tile 4c + j, holds output columns 32c + 4n + j (n the B
  // fragment's column): a thread's c0/c1 are columns 32c + 8t + j and
  // 32c + 8t + 4 + j of row r0, c2/c3 the same of row r1
  float acc[NC][4][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;   // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;           // this thread's part of their sums

  if (kt_begin < kt_end) load(kt_begin, 0);
  cp_commit();
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load(kt + 1, stage ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();                  // tile kt has landed for every thread
    const float* Ks = smem + stage * T::STAGE;
    const float* Vs = Ks + BK * T::KP;

    // ---- s = q . k^T: 16 rows x 32 keys, key 8n + g of n-tile n ------
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float4 x, y;
      if constexpr (T::QS) {
        const float* qr = Qs + (warp * 16 + g) * T::KP + 16 * p + 4 * t;
        x = *reinterpret_cast<const float4*>(qr);
        y = *reinterpret_cast<const float4*>(qr + 8 * T::KP);
      } else {
        x = qf[p][0];
        y = qf[p][1];
      }
      float4 kk[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n)
        kk[n] = *reinterpret_cast<const float4*>(
            Ks + (8 * n + g) * T::KP + 16 * p + 4 * t);
      Split b0[NS], b1[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) {            // k-step 2p
        b0[n] = split(kk[n].x);
        b1[n] = split(kk[n].y);
      }
      mma3(s, FragA(x.x, y.x, x.y, y.y), b0, b1);
#pragma unroll
      for (int n = 0; n < NS; ++n) {            // k-step 2p + 1
        b0[n] = split(kk[n].z);
        b1[n] = split(kk[n].w);
      }
      mma3(s, FragA(x.z, y.z, x.w, y.w), b0, b1);
    }

    // ---- scale, mask, online softmax on the fragments ----------------
    const int k0 = kt * BK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        bool vis = true;
        if (causal) vis = key <= row;
        if (has_window) vis = vis && key > row - window;
        // keys past Sk do not exist: -inf gives them p = 0 below
        const float x = key >= Sk ? -INFINITY
                                  : (vis ? s[n][e] * scale : NEG_INF);
        s[n][e] = x;
        if (e < 2)
          mx0 = fmaxf(mx0, x);
        else
          mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {     // the quad holds the row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float c0 = expf(m0 - mx0), c1 = expf(m1 - mx1);   // >= -1e30
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = expf(s[n][0] - m0);
      s[n][1] = expf(s[n][1] - m0);
      s[n][2] = expf(s[n][2] - m1);
      s[n][3] = expf(s[n][3] - m1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[c][j][0] *= c0;
        acc[c][j][1] *= c0;
        acc[c][j][2] *= c1;
        acc[c][j][3] *= c1;
      }

    // ---- acc += p . v: k-step j is n-tile j of s (slot t <-> key 2t) -
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const FragA a(s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* v0 = Vs + (8 * j + 2 * t) * T::VP + 4 * g;
      const float* v1 = v0 + T::VP;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(v0 + 32 * c);
        const float4 y = *reinterpret_cast<const float4*>(v1 + 32 * c);
        const Split b0[4] = {split(x.x), split(x.y), split(x.z), split(x.w)};
        const Split b1[4] = {split(y.x), split(y.y), split(y.z), split(y.w)};
        mma3(acc[c], a, b0, b1);
      }
    }
    __syncthreads();                  // the stage is read before its refill
  }
  if constexpr (T::QS) cp_wait<0>();  // no tile visible: q's copy is unread

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float(&a)[4][4] = acc[c];
    const int col = 32 * c + 8 * t;        // columns col .. col + 7
    if (col >= dh) continue;               // dh is a multiple of 4
    const bool two = col + 4 < dh;
    if (r0 < Sq) {
      float* dst = ob + r0 * os.s + col;
      *reinterpret_cast<float4*>(dst) = make_float4(
          a[0][0] / l0, a[1][0] / l0, a[2][0] / l0, a[3][0] / l0);
      if (two)
        *reinterpret_cast<float4*>(dst + 4) = make_float4(
            a[0][1] / l0, a[1][1] / l0, a[2][1] / l0, a[3][1] / l0);
    }
    if (r1 < Sq) {
      float* dst = ob + r1 * os.s + col;
      *reinterpret_cast<float4*>(dst) = make_float4(
          a[0][2] / l1, a[1][2] / l1, a[2][2] / l1, a[3][2] / l1);
      if (two)
        *reinterpret_cast<float4*>(dst + 4) = make_float4(
            a[0][3] / l1, a[1][3] / l1, a[2][3] / l1, a[3][3] / l1);
    }
  }
}

template <int DH, bool PAD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Sq, int Sk, int dh, Strides qs, Strides ks,
           Strides vs, Strides os, int causal, int has_window, int window,
           float scale, cudaStream_t stream) {
  // set on every launch: the attribute is per device, and cheap next to
  // the kernel
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH, PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(Tile<DH>::SMEM));
  if (err != cudaSuccess) return int(err);
  // one axis: (q tile, batch, head), the head fastest
  const unsigned grid = unsigned((Sq + BQ - 1) / BQ) * unsigned(B) * H;
  flash_fwd_kernel<DH, PAD><<<grid, THREADS, Tile<DH>::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, B, H / KV, Sq,
      Sk, dh, qs, ks, vs, os, causal, has_window, window, scale);
  return int(cudaGetLastError());
}

// the instances of width DHP: an exact one (dh == DHP) for the widths up
// to 128 that the models run, a padded one for every width
template <int DHP>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int H, int KV, int Sq, int Sk, int dh, Strides qs, Strides ks,
              Strides vs, Strides os, int causal, int has_window, int window,
              float scale, cudaStream_t stream) {
  if constexpr (DHP <= 128) {
    if (dh == DHP)
      return launch<DHP, false>(q, k, v, o, B, H, KV, Sq, Sk, dh, qs, ks,
                                vs, os, causal, has_window, window, scale,
                                stream);
  }
  return launch<DHP, true>(q, k, v, o, B, H, KV, Sq, Sk, dh, qs, ks, vs, os,
                           causal, has_window, window, scale, stream);
}

int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o,
                int B, int H, int KV, int Sq, int Sk, Strides qs, Strides ks,
                Strides vs, Strides os, int causal, int has_window,
                int window, float scale, cudaStream_t stream) {
  switch ((dh + 31) / 32 * 32) {
#define FLASH_FP32_CASE(DHP)                                                \
  case DHP:                                                                 \
    return launch_dh<DHP>(q, k, v, o, B, H, KV, Sq, Sk, dh, qs, ks, vs, os, \
                          causal, has_window, window, scale, stream);
    FLASH_FP32_CASE(32)
    FLASH_FP32_CASE(64)
    FLASH_FP32_CASE(96)
    FLASH_FP32_CASE(128)
    FLASH_FP32_CASE(160)
    FLASH_FP32_CASE(192)
    FLASH_FP32_CASE(224)
    FLASH_FP32_CASE(256)
#undef FLASH_FP32_CASE
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, H, Sq, dh), k/v: (B, KV, Sk, dh), o like q, each addressed through
// its (b, h, s) strides in elements with a contiguous head dim, float32;
// dh a multiple of 4 up to 256, run by the instance of dh rounded up to 32;
// addresses and strides multiples of 16 bytes. Returns a cudaError_t
// (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int dh, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int has_window, int window,
    float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1 || dh < 4 || dh > 256 ||
      dh % 4 || (long long)((Sq + BQ - 1) / BQ) * B * H > 2147483647LL)
    return int(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_dh(dh, q, k, v, o, B, H, KV, Sq, Sk, qs, ks, vs, os,
                     causal, has_window, window, scale, st);
}
