// Mamba2 SSD intra-chunk step, for Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/ssd_scan/kernel.py::_kernel`
// (wrapper `ssd_intra_chunk`). The model calls it once per Mamba2 layer on
// its full-sequence path (`models/mamba2.py::ssd_chunked`, so in
// `forward_prefill` and `forward_train`).
//
// What it computes, per (batch b, chunk c, head h), in float32, as the TPU
// kernel does: cs = inclusive cumsum of dA over the chunk's Q rows;
// L[q, s] = exp(cs[q] - cs[s]) for s <= q, else 0; G = C . B^T;
// y[q, p] = sum_s G[q, s] L[q, s] x[s, p];
// S[p, d] = sum_s exp(cs[Q-1] - cs[s]) x[s, p] B[s, d];
// decay = exp(cs[Q-1]).
//
// What bounds it: operations. At the serving shape (mamba2-1.3b prefill,
// B=4, S=2048 in 8 chunks of 256, 64 heads of 64, d_state 128) the
// products need 1.75e10 flop (G once per chunk on the s <= q pairs, y and
// S per head) against 3.5e8 bytes in and out. In split TF32 (below) that
// is three tensor-core passes, 5.2e10 flop at 495 TFLOP/s: 0.106 ms, about
// the bytes' 0.103 ms at 3.35 TB/s. mma.sync runs below that rate, and
// the CUDA-core work around each product (fragment loads, the splits, the
// exps of L) issues several instructions per mma: that work and its
// latency, not the tensor cores, set the kernel's time (PERF.md).
//
// The design:
//  * One block of 512 threads (16 warps) per (head tile of HT = 8 heads,
//    chunk, batch), as the TPU kernel tiles heads by 8: G = C . B^T is the
//    same for every head of a chunk and is built once per tile, not per
//    head (at the serving shape 2.7e9 flop, not 2.15e10).
//  * The block walks q tiles of 64 rows. For each it builds the G strip
//    (64 rows x the s tiles up to the diagonal, at most GT = 4 tiles of 64
//    columns) in shared memory from the C tile and the B tiles (warp tiles
//    of 16 x 16). Then, YH = 4 heads at a time (4 warps a head, 16 q rows
//    each), it forms M = G o L in registers and accumulates
//    y_h += M . x_h over the strip's s tiles. A chunk longer than GT tiles
//    (Q > 256) takes the strip in groups of GT tiles; each group after the
//    first adds to the y it stored. Diagonal tiles skip the k steps above
//    the diagonal.
//  * Then S_h = (d2e_h o x_h)^T . B, two heads at a time over all s tiles
//    (warp tiles of 32 x 32). Each block writes its own S, y and decay: no
//    atomics, the result is deterministic.
//  * Tiles of C, B and x come in by cp.async (16-byte copies when rows are
//    16-byte aligned, else 4-byte ones; rows past Q and columns past hd or
//    ds zero-filled) into two buffers, so the next tile's copy overlaps the
//    current tile's products. Padded row pitches keep every fragment read
//    free of bank conflicts.
//  * The three products run on the tensor cores as
//    mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 in split TF32: each operand
//    a = a_hi + a_lo with a_hi = tf32(a), a_lo = tf32(a - a_hi), rounded as
//    cvt.rna.tf32.f32 rounds (computed with two integer operations, the
//    same bits, faster on this card), and a.b = a_lo.b_hi + a_hi.b_lo +
//    a_hi.b_hi accumulated in float32; each partial product is exact in
//    float32, and the dropped terms are ~3 2^-22 |a||b| (plain TF32 would
//    miss the reference's 1e-4; the same kernel with float32 FMA products
//    is slower, scripts/torch_ssd_variants.py times both). Each pass runs
//    over all of a k step's tiles before the next, so no mma waits on the
//    one before it. M is split after the o L, the d2e weights are applied
//    to x before the split; the exps, the o L and the weights stay float32
//    on the CUDA cores. For y and S the k index of each 8-wide step is
//    permuted (k = t <-> s = 2t, k = t + 4 <-> s = 2t + 1) in both
//    operands, so a thread's two s columns of M are adjacent in the G
//    strip.
//  * The 8 heads' cumsums of dA, found once per block (one warp a head),
//    stay in shared memory whole while they fit, Q <= 768. A longer chunk
//    runs the kernel's WIN instance: it keeps each head's tile prefixes (8
//    floats a tile), and one warp per head scans the cs of up to 5 tiles
//    (tile_cs: the prefix plus a warp scan of the tile's dA rows) into a
//    window (10 KB for the 8 heads) under a phase's first copies: for the
//    y phase the q tile and the strip's s tiles; for the S phase, which
//    then takes the s tiles in groups of 5 (a group after the first adds
//    to the S it stored), the group. The windows cost time at the serving
//    shape (scripts/torch_ssd_variants.py times both), so the model's
//    chunks keep the whole cumsums.
//  * A ragged chunk (Q not a multiple of 64) zero-fills the rows past Q
//    and masks s > q.
//  * The grid is one axis of (head tile, hd slice, batch x chunk), the
//    head tile fastest, so no count of batches or chunks meets the 65535
//    limit of grid dims y and z.
//  * Widths past the tiles (the WIDE instances): hd in slices of 64 and
//    ds in slices of 128, up to 256 each. Each hd slice is a block of its
//    own: it rebuilds the G strip and the cumsums (G over the whole ds),
//    and writes its slice of y and of S's rows. Within a block the ds
//    slices are a loop: G's products accumulate slice after slice (a
//    slice after the first adds to the strip it stored), and S is written
//    a ds slice at a time, the x tiles read again for each. At the
//    serving shape (hd 64, ds 128) nothing of this runs: the main path's
//    instances are the narrow ones, compiled with one slice of each.
//    Where it runs, at hd 128 and ds 256, G and the cumsums are built
//    twice (once per hd slice) and x read twice in the S phase: 1.0542 ms
//    at B 4, S 2048, 32 heads of 128 (chip_smoke.py phase 20, H100)
//    against 0.6981 ms for the serving shape's 64 heads of 64, ds 128.
// Resources (`-Xptxas -v`, build/repro_torch/ssd_scan-*.log): 128
// registers a thread in every instance (16 warps, one block an SM); spill
// stores <WIN, WIDE>: <false, false> (the serving shape) 56 B, as before
// the slices; <true, false> 208 B; <false, true> 176 B; <true, true>
// 604 B.
// Limits: hd <= 256, ds <= 256, Q <= 30656 (479 tiles, whose prefixes fit
// in shared memory beside the windows and buffers); the wrapper raises on
// others.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T = 64;              // rows of a q tile and of an s tile
constexpr int HT = 8;              // heads per block
constexpr int GT = 4;              // s tiles in the G strip
constexpr int HD_T = 64;           // columns of an x tile: an hd slice
constexpr int DS_T = 128;          // columns of a C or B tile: a ds slice
constexpr int HD_MAX = 4 * HD_T;   // the widest hd and ds the kernel takes
constexpr int DS_MAX = 2 * DS_T;
constexpr int CP = DS_T + 4;       // row pitch of C and B tiles (4 mod 32)
constexpr int XP = HD_T + 4;       // row pitch of x tiles (4 mod 32)
constexpr int GP = GT * T + 8;     // row pitch of the G strip (8 mod 32)
constexpr int THREADS = 512;
constexpr int TILE_C = T * CP;     // floats of a C or B tile
constexpr int TILE_X = T * XP;     // floats of an x tile
constexpr int YH = 4;              // heads at a time in the y phase
constexpr int WT = 1 + GT;         // tiles of a head's cs window
constexpr int CW = WT * T;         // floats of a head's cs window
// shared memory after the cumsums: the G strip, then the G phase's C tile
// and two B buffers, or the y phase's two buffers of YH x tiles; the S
// phase, which needs no G, has two buffers of a B tile and two x tiles
// from the strip's start
constexpr int REGION = T * GP + 2 * YH * TILE_X;
static_assert(T * GP + 3 * TILE_C <= REGION, "G phase buffers");
static_assert(2 * (TILE_C + 2 * TILE_X) <= REGION, "S phase buffers");

constexpr int SMEM_MAX = 227 * 1024;  // dynamic shared memory of a block

// the heads' cs[Q-1]; then either their whole cumsums (win false) or
// their tile prefixes and cs windows (win true); then the region
size_t smem_bytes(int Q, bool win) {
  const size_t nt = (Q + T - 1) / T;
  return sizeof(float) *
         (HT * (1 + (win ? nt + CW : nt * T)) + size_t(REGION));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, 64) x columns [0, width) of a row-major matrix (row stride ld
// floats) into shared memory at pitch `pitch`; rows >= nrows and columns
// >= ncols are zero-filled. `vec`: rows and ncols are 16-byte aligned.
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, long long ld,
                                          int nrows, int ncols, int width,
                                          bool vec) {
  if (vec) {
    const int per = width / 4;
    for (int i = threadIdx.x; i < T * per; i += THREADS) {
      const int r = i / per, c = (i % per) * 4;
      const bool ok = r < nrows && c < ncols;
      cp_async16(dst + r * pitch + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < T * width; i += THREADS) {
      const int r = i / width, c = i % width;
      const bool ok = r < nrows && c < ncols;
      cp_async4(dst + r * pitch + c, ok ? src + r * ld + c : src, ok);
    }
  }
}

// Double-buffered loop over n steps: issue(i, buf) starts step i's copies
// into buffer buf, compute(i, buf) uses them. Step i + 1's copies run under
// step i's compute; the syncs keep a buffer from being refilled while read.
template <class Issue, class Compute>
__device__ __forceinline__ void pipeline(int n, Issue issue,
                                         Compute compute) {
  issue(0, 0);
  cp_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) {
      issue(i + 1, (i + 1) & 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    compute(i, i & 1);
    __syncthreads();
  }
}

// cs of one head's 64-row tile at rows 2 lane and 2 lane + 1 (c0, c1):
// `base`, the cumsum before the tile, plus a warp scan of the tile's dA
// (a0, a1: this lane's rows; rows past Q hold 0). `total` is the tile's
// sum, the same in every lane.
struct TileCs {
  float c0, c1, total;
};

__device__ __forceinline__ TileCs tile_cs(float a0, float a1, float base,
                                          int lane) {
  float incl = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float l0 = excl + a0, l1 = l0 + a1;
  return {base + l0, base + l1, __shfl_sync(0xffffffffu, l1, 31)};
}

// the value at tile row r of a TileCs (held by lane r / 2)
__device__ __forceinline__ float cs_at(const TileCs& c, int r) {
  const float v0 = __shfl_sync(0xffffffffu, c.c0, r / 2);
  const float v1 = __shfl_sync(0xffffffffu, c.c1, r / 2);
  return r & 1 ? v1 : v0;
}

// One warp per head: the cs of up to WT tiles into the head's window,
// slot 0 tile t0, slot k > 0 tile t1 + k - 1, n slots. ah: the head's dA
// column (row stride nh); pre: its tile prefixes.
__device__ __forceinline__ void fill_window(float* w, const float* ah,
                                            const float* pre, int nh, int Q,
                                            int t0, int t1, int n,
                                            int lane) {
  float a[WT][2];
#pragma unroll
  for (int k = 0; k < WT; ++k) {   // every load first, then the scans
    const int r = (k == 0 ? t0 : t1 + k - 1) * T + 2 * lane;
    a[k][0] = k < n && r < Q ? ah[(long long)r * nh] : 0.f;
    a[k][1] = k < n && r + 1 < Q ? ah[(long long)(r + 1) * nh] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < WT; ++k) {
    if (k >= n) break;
    const TileCs c =
        tile_cs(a[k][0], a[k][1], pre[k == 0 ? t0 : t1 + k - 1], lane);
    *reinterpret_cast<float2*>(w + k * T + 2 * lane) =
        make_float2(c.c0, c.c1);
  }
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
  FragA() = default;
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

// d[m][j] += a[m] . b[j] in split TF32, the small cross terms first; b[j]
// is the B fragment (b0[j], b1[j]). Each pass runs over every tile before
// the next, so no mma waits on the one before it for its accumulator.
template <int M, int N>
__device__ __forceinline__ void mma3(float (&d)[M][N][4],
                                     const FragA (&a)[M],
                                     const Split (&b0)[N],
                                     const Split (&b1)[N]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < N; ++j) mma(d[m][j], a[m].lo, b0[j].hi, b1[j].hi);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < N; ++j) mma(d[m][j], a[m].hi, b0[j].lo, b1[j].lo);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < N; ++j) mma(d[m][j], a[m].hi, b0[j].hi, b1[j].hi);
}

// WIN: cs windows (Q > 768); WIDE: hd > 64 or ds > 128, in slices
template <bool WIN, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
ssd_intra_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 float* __restrict__ y, float* __restrict__ S,
                 float* __restrict__ decay, int Q, int nh, int hd, int ds,
                 int vec) {
  extern __shared__ __align__(16) float smem[];
  const int nt = (Q + T - 1) / T;
  const int cstride = WIN ? CW : nt * T;
  float* csend = smem;               // HT: cs[Q-1] of each head
  float* pre = csend + HT;           // WIN: HT x nt, cumsum before each tile
  float* cs = pre + (WIN ? HT * nt : 0);  // HT x cstride: cs windows or all
  float* Gs = cs + HT * cstride;     // T x GP: the G strip
  float* R = Gs + T * GP;            // the G and y phases' buffers

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;        // mma fragment coordinates
  // the block: head tile, hd slice, (batch, chunk), on one grid axis
  const int nht = (nh + HT - 1) / HT;
  const int nhs = WIDE ? (hd + HD_T - 1) / HD_T : 1;
  const int h0 = int(blockIdx.x % nht) * HT;
  const int p0 = WIDE ? int(blockIdx.x / nht % nhs) * HD_T : 0;
  const long long bc = blockIdx.x / nht / nhs;    // b * nc + chunk
  const int hdl = WIDE ? min(HD_T, hd - p0) : hd; // this slice's columns
  const int nds = WIDE ? (ds + DS_T - 1) / DS_T : 1;   // ds slices
  const int nhb = min(HT, nh - h0);            // heads of this block
  const int pairs = (nhb + 1) / 2;
  const long long xrow = (long long)nh * hd;   // x / y row stride
  const float* xb = x + bc * Q * xrow + (long long)h0 * hd + p0;
  const float* Bb = Bm + bc * Q * ds;
  const float* Cb = Cm + bc * Q * ds;
  const float* ab = dA + bc * Q * nh + h0;
  float* yb = y + bc * Q * xrow + (long long)h0 * hd + p0;
  float* Sb = S + (bc * nh + h0) * hd * ds + (long long)p0 * ds;
  const bool v = vec != 0;

  // the cumsum of dA, one warp per head. Kept whole: each lane sums a run
  // of rows, then a shuffle scan of the lanes' totals; rows past Q take
  // cs[Q-1]. WIN: tile by tile, each tile's prefix (the tiles before it)
  // and a warp scan (tile_cs) for cs[Q-1]; a phase scans the tiles it
  // needs into a window (fill_window)
  if (warp < nhb) {
    const float* ah = ab + warp;
    float cs_end;
    if constexpr (WIN) {
      float run = 0.f;
      TileCs last{};
      for (int tile = 0; tile < nt; ++tile) {
        const int r = tile * T + 2 * lane;
        const float a0 = r < Q ? ah[(long long)r * nh] : 0.f;
        const float a1 = r + 1 < Q ? ah[(long long)(r + 1) * nh] : 0.f;
        last = tile_cs(a0, a1, run, lane);
        if (lane == 0) pre[warp * nt + tile] = run;
        run += last.total;
      }
      cs_end = cs_at(last, Q - 1 - (nt - 1) * T);
    } else {
      float* csh = cs + warp * cstride;
      const int per = (Q + 31) / 32;
      const int lo = min(lane * per, Q), hi = min(lo + per, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += ah[(long long)i * nh];
        csh[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += u;
      }
      const float excl = incl - run;
      for (int i = lo; i < hi; ++i) csh[i] += excl;
      __syncwarp();
      cs_end = csh[Q - 1];
      for (int i = Q + lane; i < cstride; i += 32) csh[i] = cs_end;
    }
    if (lane == 0) {
      csend[warp] = cs_end;
      if (p0 == 0) decay[bc * nh + h0 + warp] = expf(cs_end);
    }
  }
  __syncthreads();

  const int quads = (nhb + YH - 1) / YH;
  const int mw = warp % 4;           // G and y: q rows 16 mw + (g, g + 8)
  const int ye = warp / 4;           // y: head ye of YH

  for (int qt = 0; qt < nt; ++qt) {
    const int q0 = qt * T;
    for (int sa = 0; sa <= qt; sa += GT) {
      const int ns = min(GT, qt + 1 - sa);       // s tiles of this strip

      // ---- G strip: G[q, s] = C[q, :] . B[s, :] (warp: 16 rows x 16
      // columns of a 64 x 64 tile; k over ds, unpermuted), a ds slice at
      // a time (one but for the WIDE instances)
      float* Cs = R;
      for (int dsl = 0; dsl < nds; ++dsl) {
      const int d0 = dsl * DS_T;
      const int dsw = WIDE ? min(DS_T, ds - d0) : ds;  // the slice's width
      pipeline(
          ns,
          [&](int i, int buf) {
            if (i == 0)
              load_tile(Cs, CP, Cb + (long long)q0 * ds + d0, ds, Q - q0,
                        dsw, DS_T, v);
            const int s0 = (sa + i) * T;
            load_tile(R + (1 + buf) * TILE_C, CP,
                      Bb + (long long)s0 * ds + d0, ds, Q - s0, dsw, DS_T,
                      v);
            // under the first copies, each head's cs window for the y
            // phase: the q tile, then the strip's s tiles
            if (WIN && i == 0 && dsl == 0 && warp < nhb)
              fill_window(cs + warp * CW, ab + warp, pre + warp * nt, nh,
                          Q, qt, sa, 1 + ns, lane);
          },
          [&](int i, int buf) {
            const int st = sa + i, nw = warp / 4;
            if (st == qt && nw > mw) return;         // above the diagonal
            const float* Bs = R + (1 + buf) * TILE_C;
            float acc[1][2][4] = {};
            const float* ca = Cs + (16 * mw + g) * CP + t;
            const float* bb = Bs + (16 * nw + g) * CP + t;
            for (int k0 = 0; k0 < dsw; k0 += 8) {
              const FragA a[1] = {FragA(ca[k0], ca[k0 + 8 * CP], ca[k0 + 4],
                                        ca[k0 + 8 * CP + 4])};
              Split b0[2], b1[2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                b0[j] = split(bb[8 * j * CP + k0]);
                b1[j] = split(bb[8 * j * CP + k0 + 4]);
              }
              mma3(acc, a, b0, b1);
            }
            float* gs = Gs + (16 * mw + g) * GP + i * T + 16 * nw + 2 * t;
            if (WIDE && dsl > 0) {           // add to the earlier slices'
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const float2 a = *reinterpret_cast<float2*>(gs + 8 * j);
                const float2 b = *reinterpret_cast<float2*>(gs + 8 * GP +
                                                            8 * j);
                acc[0][j][0] += a.x;
                acc[0][j][1] += a.y;
                acc[0][j][2] += b.x;
                acc[0][j][3] += b.y;
              }
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              *reinterpret_cast<float2*>(gs + 8 * j) =
                  make_float2(acc[0][j][0], acc[0][j][1]);
              *reinterpret_cast<float2*>(gs + 8 * GP + 8 * j) =
                  make_float2(acc[0][j][2], acc[0][j][3]);
            }
          });
      }

      // ---- y_h += (G o L_h) . x_h over the strip, YH heads at a time
      // (warp: head ye of YH, q rows 16 mw + (g, g + 8), all p)
      float yacc[1][8][4];
      pipeline(
          quads * ns,
          [&](int i, int buf) {
            const int hq = i / ns, s0 = (sa + i % ns) * T;
#pragma unroll
            for (int ee = 0; ee < YH; ++ee) {
              const int hl = YH * hq + ee;
              load_tile(R + (YH * buf + ee) * TILE_X, XP,
                        xb + s0 * xrow + (long long)hl * hd, xrow,
                        hl < nhb ? Q - s0 : 0, hdl, HD_T, v);
            }
          },
          [&](int i, int buf) {
            const int hq = i / ns, si = i % ns, st = sa + si;
            const int hl = YH * hq + ye;
            if (hl >= nhb) return;
            const int r0 = 16 * mw + g;                // q rows r0, r0 + 8
            const int qa = q0 + r0, qb = qa + 8;
            if (si == 0) {
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  const int q = k < 2 ? qa : qb, p = 8 * j + 2 * t + k % 2;
                  // add to the earlier strips' sums
                  yacc[0][j][k] = sa > 0 && q < Q && p < hdl
                      ? yb[q * xrow + (long long)hl * hd + p] : 0.f;
                }
            }
            // the cs of the q tile and of the s tile
            const float* csq = cs + hl * cstride + (WIN ? 0 : qt * T);
            const float* css = cs + hl * cstride + (WIN ? 1 + si : st) * T;
            const float ca = csq[r0], cb = csq[r0 + 8];
            const float* X = R + (YH * buf + ye) * TILE_X;
            const float* gr = Gs + r0 * GP + si * T;
            const bool diag = st == qt;
            const int kend = diag ? 2 * mw + 2 : 8;  // k steps at or below
            for (int kk = 0; kk < kend; ++kk) {      // the diagonal
              const int sl = 8 * kk + 2 * t;         // s = sl, sl + 1
              const float* xr = X + sl * XP + g;
              float xv[2][8];
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                xv[0][j] = xr[8 * j];
                xv[1][j] = xr[XP + 8 * j];
              }
              const float2 g0 = *reinterpret_cast<const float2*>(gr + sl);
              const float2 g1 =
                  *reinterpret_cast<const float2*>(gr + 8 * GP + sl);
              const float2 c2 =
                  *reinterpret_cast<const float2*>(css + sl);
              float m00 = g0.x * expf(ca - c2.x), m01 = g0.y * expf(ca - c2.y);
              float m10 = g1.x * expf(cb - c2.x), m11 = g1.y * expf(cb - c2.y);
              if (diag) {
                if (sl > r0) m00 = 0.f;
                if (sl + 1 > r0) m01 = 0.f;
                if (sl > r0 + 8) m10 = 0.f;
                if (sl + 1 > r0 + 8) m11 = 0.f;
              }
              const FragA a[1] = {FragA(m00, m10, m01, m11)};
              Split b0[8], b1[8];
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                b0[j] = split(xv[0][j]);
                b1[j] = split(xv[1][j]);
              }
              mma3(yacc, a, b0, b1);
            }
            if (si == ns - 1) {
#pragma unroll
              for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  const int q = k < 2 ? qa : qb, p = 8 * j + 2 * t + k % 2;
                  if (q < Q && p < hdl)
                    yb[q * xrow + (long long)hl * hd + p] = yacc[0][j][k];
                }
            }
          });
    }
  }

  // ---- S_h = (d2e_h o x_h)^T . B, two heads at a time, over the s tiles
  // (WIN: in groups of WT, one cs window each; a group after the first
  // adds to the S it stored), a ds slice of columns at a time (one but
  // for the WIDE instances) (warp: head e of the pair, p rows 32 pm +
  // 16 m + (g, g + 8), d columns 32 dn + 8 j + (2t, 2t + 1))
  const int e = warp / 8, pm = (warp / 4) % 2, dn = warp % 4;
  const int gs = WIN ? WT : nt;                    // s tiles of a group
  float sacc[2][4][4];
  for (int sg = 0; sg < nt; sg += gs) {
    const int ng = min(gs, nt - sg);               // s tiles of this group
    for (int dsl = 0; dsl < nds; ++dsl) {
    const int d0 = dsl * DS_T;
    const int dsw = WIDE ? min(DS_T, ds - d0) : ds;  // the slice's width
    pipeline(
        pairs * ng,
        [&](int i, int buf) {
          const int hp = i / ng, s0 = (sg + i % ng) * T;
          float* base = Gs + buf * (TILE_C + 2 * TILE_X);
          load_tile(base, CP, Bb + (long long)s0 * ds + d0, ds, Q - s0, dsw,
                    DS_T, v);
#pragma unroll
          for (int ee = 0; ee < 2; ++ee) {
            const int hl = 2 * hp + ee;
            load_tile(base + TILE_C + ee * TILE_X, XP,
                      xb + s0 * xrow + (long long)hl * hd, xrow,
                      hl < nhb ? Q - s0 : 0, hdl, HD_T, v);
          }
          if (WIN && i == 0 && dsl == 0 && warp < nhb)
            fill_window(cs + warp * CW, ab + warp, pre + warp * nt, nh, Q,
                        sg, sg + 1, ng, lane);
        },
        [&](int i, int buf) {
          const int hp = i / ng, si = i % ng, hl = 2 * hp + e;
          if (hl >= nhb) return;
          float* so = Sb + (long long)hl * hd * ds + d0;
          if (si == 0) {
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  const int p = 32 * pm + 16 * m + g + (k < 2 ? 0 : 8);
                  const int d = 32 * dn + 8 * j + 2 * t + k % 2;
                  // add to the earlier groups' sums
                  sacc[m][j][k] =
                      WIN && sg > 0 && p < hdl && d < dsw ? so[p * ds + d]
                                                           : 0.f;
                }
          }
          const float* base = Gs + buf * (TILE_C + 2 * TILE_X);
          const float* Bs = base;
          const float* X = base + TILE_C + e * TILE_X;
          const float* css = cs + hl * cstride + (WIN ? si : sg + si) * T;
          const float cs_end = csend[hl];
          for (int kk = 0; kk < 8; ++kk) {
            const int sl = 8 * kk + 2 * t;
            const float2 c2 = *reinterpret_cast<const float2*>(css + sl);
            const float w0 = expf(cs_end - c2.x), w1 = expf(cs_end - c2.y);
            const float* xr = X + sl * XP + 32 * pm + g;
            const float* br = Bs + sl * CP + 32 * dn + g;
            float bv[2][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              bv[0][j] = br[8 * j];
              bv[1][j] = br[CP + 8 * j];
            }
            const FragA a[2] = {
                FragA(xr[0] * w0, xr[8] * w0, xr[XP] * w1, xr[XP + 8] * w1),
                FragA(xr[16] * w0, xr[24] * w0, xr[XP + 16] * w1,
                      xr[XP + 24] * w1)};
            Split b0[4], b1[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              b0[j] = split(bv[0][j]);
              b1[j] = split(bv[1][j]);
            }
            mma3(sacc, a, b0, b1);
          }
          if (si == ng - 1) {
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  const int p = 32 * pm + 16 * m + g + (k < 2 ? 0 : 8);
                  const int d = 32 * dn + 8 * j + 2 * t + k % 2;
                  if (p < hdl && d < dsw) so[p * ds + d] = sacc[m][j][k];
                }
          }
        });
    }
  }
}

}  // namespace

// x: (B, nc, Q, nh, hd); dA: (B, nc, Q, nh); Bm, Cm: (B, nc, Q, ds);
// y like x; S: (B, nc, nh, hd, ds); decay: (B, nc, nh). All float32,
// contiguous; hd, ds <= 256. Returns a cudaError_t (0 = launched).
extern "C" int ssd_intra_chunk_fwd(const void* x, const void* dA,
                                   const void* Bm, const void* Cm, void* y,
                                   void* S, void* decay, int B, int nc,
                                   int Q, int nh, int hd, int ds,
                                   void* stream) {
  if (B < 1 || nc < 1 || Q < 1 || nh < 1 || hd < 1 || ds < 1 ||
      hd > HD_MAX || ds > DS_MAX)
    return int(cudaErrorInvalidValue);
  const int nhs = (hd + HD_T - 1) / HD_T;           // hd slices
  const long long blocks = (long long)((nh + HT - 1) / HT) * nhs * B * nc;
  if (blocks > 2147483647LL) return int(cudaErrorInvalidValue);
  // the whole cumsums while they fit (Q <= 768), else windows
  const bool win = smem_bytes(Q, false) > SMEM_MAX;
  const size_t smem = smem_bytes(Q, win);
  if (smem > SMEM_MAX) return int(cudaErrorInvalidValue);
  const bool wide = hd > HD_T || ds > DS_T;
  const auto kernel = win ? (wide ? ssd_intra_kernel<true, true>
                                  : ssd_intra_kernel<true, false>)
                          : (wide ? ssd_intra_kernel<false, true>
                                  : ssd_intra_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  // 16-byte copies need 16-byte aligned rows of x, B and C
  const int vec = hd % 4 == 0 && ds % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(Bm) |
                    reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;
  kernel<<<unsigned(blocks), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dA),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), static_cast<float*>(S),
      static_cast<float*>(decay), Q, nh, hd, ds, vec);
  return int(cudaGetLastError());
}
