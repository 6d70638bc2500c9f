// Forward flash attention in bf16 on Hopper's tensor cores (sm_90a): causal
// or bidirectional, optional sliding window, grouped-query heads.
//
// Replaces the TPU kernel `src/repro/kernels/flash_attention/kernel.py::_kernel`
// (wrapper `flash_attention_bhsd`) for bfloat16 inputs. float32 inputs go to
// the split-TF32 kernel of `flash_attention.cu`: plain TF32 would miss the
// float32 tolerance. The model calls it once per attention layer on its
// full-sequence path (`models/lm.py::_self_attention_full`, so in
// `forward_prefill` and `forward_train`) when
// `RunConfig.attention_impl == "pallas_flash"`.
//
// What it computes, as the TPU kernel does: for query head h (KV head h / G),
// an online softmax over key tiles with running (m, l, acc) in float32;
// s = (q . k) * scale accumulated in float32, here times log2(e) so that exp2
// serves; masked scores take the FINITE value -1e30 (times log2(e)): a row
// whose first visited tile is fully masked takes p = 1 there, and the next
// tile's correction exp(-1e30 - m) = 0 wipes it, where -inf would give NaN.
// Keys past Sk get p = 0, decided by index (TMA fills them with zeros, which
// would score 0). p is rounded to bf16 before the p.v product while l sums
// the unrounded p; the output is acc / max(l, 1e-30), rounded to bf16.
// Tiles that causality or the window masks completely are skipped. Positions
// count from 0 in both q and k.
//
// What bounds it: operations. At the serving shape (qwen3-4b prefill, B=4,
// S=2048, 32 query heads and 8 KV heads of 128, causal) the two products
// need 1.375e11 flop over the visible (q, k) pairs against 1.7e8 bytes of q,
// k, v and o, ~800 flop per byte, above the card's ~295 flop/byte ridge in
// bf16: the tensor cores' 989 TFLOP/s bound it at 0.139 ms.
//
// What the design does about it:
// - Both products run on the tensor cores. S = Q.K^T is a wgmma m64n128k16
//   with Q and K read from shared memory, both K-major as they lie. O += P.V
//   is a wgmma with A = P from registers (the S accumulator fragment, packed
//   into bf16 pairs after the softmax, is already in A's layout) and B = V
//   from shared memory through the descriptor's transpose.
// - Three warpgroups per CTA. A producer keeps TMA loads of K and V tiles
//   (128 keys) in flight in a 2-stage ring guarded by mbarriers (K and V
//   each with a full and a free barrier, so a K stage frees as soon as its
//   scores are in) and gives its registers away (setmaxnreg 24); two
//   consumers (setmaxnreg 240) own 64 q rows each of a 128-row work tile.
// - Within a consumer the two products overlap the softmax: tile i's
//   Q.K^T and tile i-1's P.V are issued together; once the scores are in,
//   tile i's softmax runs on the CUDA cores while P.V runs on the tensor
//   cores. Between the consumers, one's softmax overlaps the other's
//   products.
// - TMA: q, k and v are 4-D tensor maps (dh, S, heads, B) over their strides
//   with the 128-byte swizzle that wgmma reads without bank conflicts; a
//   128-column head is two 64-column boxes. Shared memory at dh 128: Q 32 KB
//   plus 2 stages of K and V, 32 KB each: 160 KB. A 32-column head is read as
//   one 64-column box whose upper half TMA fills with zeros (they add nothing
//   to q.k, and o's zero columns are not stored); a 96-column head likewise
//   as two boxes, columns 96-127 zero-filled.
// - The softmax stays in registers: each thread holds pieces of two rows and
//   takes their max over the 4 threads of a quad with shuffles; l stays a
//   per-thread partial sum until the end; exp2 is the MUFU's ex2.approx.
//   Only tiles that cross the diagonal, the window's edge or Sk run the mask
//   code; the others fold the scale into one FFMA per score. A warp whose
//   rows kept their maxima skips the rescale of its accumulator.
// - Scheduling: persistent, one CTA per SM. Each walks the work tiles
//   (128 q rows, q head, batch) blockIdx.x, + gridDim.x, ..., heaviest
//   causal q tiles first; the ring runs on across work tiles, and the next
//   tile's Q loads while the consumers finish the last one. The query heads
//   of one KV head are neighbours, so they find its K/V in L2. A windowed
//   tile starts at its first visible k tile.
// - The epilogue multiplies by 1 / max(l, 1e-30), rounds to bf16 and
//   stores pairs through o's strides.
// - Heads past 128 columns (instances 192 and 256) take K/V tiles of 64
//   keys: with 128-key tiles Q and two stages of K and V would need
//   (1 + 2 x 2) x 4 x 16 KB = 320 KB of shared memory at 256 columns, and
//   S's 64 registers beside a 128-register accumulator would not fit a
//   consumer's 240. P.V past 128 columns is two wgmmas on the two halves
//   of the accumulator (128 + 64, or 128 + 128 columns).
// - v may be narrower than q and k (DV < DHP): latent attention (MLA,
//   DeepSeek-V2) has q/k heads of 192 (128 + a 64-column rotary part) and
//   v heads of 128. The instance <192, 128, 128> reads q and k through
//   three boxes and v through two, keeps a 128-column accumulator and
//   writes 128 columns, so P.V costs what it does at dh 128: padding v to
//   192 would add half again to those products and a copy of v. Its
//   registers are those of <128, 128, 128> (S and the accumulator 64
//   each), so it keeps 128-key tiles: Q 48 KB and two stages of K (48 KB)
//   and V (32 KB), 208 KB of shared memory. The caller gives the scale.
//
// Resources (`-Xptxas -v`, build/repro_torch/flash_attention_sm90-*.log):
// every instance <DHP, DV, BK> (<64, 64, 128>, <128, 128, 128>, <192, 192,
// 64>, <256, 256, 64>, <192, 128, 128>) is allocated 168 registers a
// thread at launch (384 threads, one CTA an SM; setmaxnreg moves them to
// the consumers), no stack, no spill. Dynamic shared memory, Q + 2 stages
// of K and V + 1 KB of alignment: 82,944 B (64), 164,864 B (128), 148,480
// B (192), 197,632 B (256), 214,016 B (192 / 128).

#include <cuda.h>            // CUtensorMap and its enums; the encode
#include <cuda_bf16.h>       // function is looked up through the runtime,
#include <cuda_runtime.h>    // so the library needs no -lcuda
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;               // query rows per CTA, 64 per consumer
constexpr int BOX_COLS = 64;          // a TMA box row: 128 bytes of bf16
constexpr int BOX_BYTES = BQ * 128;   // a Q box: 128 rows of 128 bytes
constexpr int STAGES = 2;             // K/V ring depth
constexpr int THREADS = 384;          // producer + 2 consumer warpgroups
constexpr int CONSUMER_THREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = -1e30f * LOG2E;    // the finite mask value, base 2

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo & 0x3FFFF) >> 4) << 16) |
         (uint64_t((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N of this thread's committed groups are pending;
// groups complete in the order they were committed
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin registers in place around the asynchronous products: the compiler
// must not move a read or write of them across a fence or a wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the MUFU; a result below 2^-126 flushes to 0 (such a p adds
// nothing to l, which is at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x N, float32, the accumulator layout) += A . B, bf16 inputs. _ss:
// A and B from shared memory (both K-major); _rs: A from registers, B from
// shared memory transposed (MN-major). scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// the N accumulators of d from index `at` on, as an array of their own
template <int N, int M>
__device__ __forceinline__ float (&part(float (&d)[M], int at))[N] {
  return *reinterpret_cast<float(*)[N]>(&d[at]);
}

// acc (64 x DHP) += P (64 x 16 keys, registers) . V (16 keys x DHP, the
// boxes of 64 columns `lbo` bytes apart from `addr`): one wgmma up to 128
// columns, two for 192 (128 + 64) and 256 (128 + 128)
template <int DHP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DHP / 2],
                                         const uint32_t (&a)[4],
                                         uint32_t addr, uint32_t lbo) {
  if constexpr (DHP == 64) {
    wgmma_rs_n64(d, a, sw128_desc(addr, lbo, 1024), 1);
  } else if constexpr (DHP == 128) {
    wgmma_rs_n128(d, a, sw128_desc(addr, lbo, 1024), 1);
  } else {
    wgmma_rs_n128(part<64>(d, 0), a, sw128_desc(addr, lbo, 1024), 1);
    if constexpr (DHP == 192)
      wgmma_rs_n64(part<32>(d, 64), a, sw128_desc(addr + 2 * lbo, lbo, 1024),
                   1);
    if constexpr (DHP == 256)
      wgmma_rs_n128(part<64>(d, 64), a,
                    sw128_desc(addr + 2 * lbo, lbo, 1024), 1);
  }
}

// S (64 x BK keys) = Q . K^T, K-major tiles of BK rows
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BK == 128)
    wgmma_ss_n128(d, da, db, scale_d);
  else
    wgmma_ss_n64(d, da, db, scale_d);
}

// S = Q . K^T for the consumer's 64 rows over the head dim, 16 columns a
// step; issued, not waited for. A K box is BK rows of 128 bytes.
template <int DHP, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_rows,
                                        uint32_t k_tile) {
  constexpr uint32_t KBOX = BK * 128;
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    wgmma_qk<BK>(s, sw128_desc(q_rows + (kk / 4) * BOX_BYTES + step, 16, 1024),
                 sw128_desc(k_tile + (kk / 4) * KBOX + step, 16, 1024),
                 kk > 0);
  }
  wgmma_commit();
}

// acc += P . V over the tile's keys, 16 a step; issued, not waited for
template <int DHP, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[DHP / 2],
                                        const uint32_t (&p)[BK / 4],
                                        uint32_t v_tile) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    const uint32_t a[4] = {p[4 * kc], p[4 * kc + 1], p[4 * kc + 2],
                           p[4 * kc + 3]};
    wgmma_pv<DHP>(acc, a, v_tile + kc * 16 * 128, BK * 128);
  }
  wgmma_commit();
}

struct Mask {
  int Sk, causal, has_window, window;
};

// The online softmax of one tile, in base 2, in registers: s (raw q.k, in
// the accumulator layout: s[4j + e] is row `row + 8 (e / 2)` of the
// consumer's rows, key k0 + 8 j + col + e % 2) becomes p, unrounded; m
// and l move on, corr is exp2(m_old - m_new) per row. m never falls below
// MASKED, so it is never -inf. Tiles that no mask touches (`edge` false)
// fold the scale into one FFMA per score.
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool edge, int k0, int qrow, int col, const Mask& mk, float scale_log2) {
  float mx[2] = {m[0], m[1]};
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + col + (e & 1);
        const int qpos = qrow + 8 * (e >> 1);
        float x = s[4 * j + e] * scale_log2;
        if (kpos >= mk.Sk)
          x = -INFINITY;                     // no such key: p = 0
        else if ((mk.causal && kpos > qpos) ||
                 (mk.has_window && kpos <= qpos - mk.window))
          x = MASKED;
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
  } else {
    float raw[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      raw[0] = fmaxf(raw[0], fmaxf(s[4 * j], s[4 * j + 1]));
      raw[1] = fmaxf(raw[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], raw[r] * scale_log2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = ex2(s[i] - m[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];             // l sums the unrounded p
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = ex2(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += s[i];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
}

// The work tile w of nqt x B x H: the q tile is the slowest index, its
// heaviest (last, under causality) first, and the head the fastest, so the
// query heads of one KV head run side by side and share its K/V in L2.
struct Work {
  int q0, h, b, kt_lo, ntiles;
};

template <int BK>
__device__ __forceinline__ Work work_tile(int w, int H, int B, int nqt,
                                          int Sk, int causal, int has_window,
                                          int window) {
  Work t;
  t.h = w % H;
  t.b = (w / H) % B;
  t.q0 = (nqt - 1 - w / (H * B)) * BQ;
  const int nk = (Sk + BK - 1) / BK;
  const int kt_hi = causal ? min(nk, (t.q0 + BQ - 1) / BK + 1) : nk;
  t.kt_lo = has_window ? max(0, t.q0 - window + 1) / BK : 0;
  t.ntiles = kt_hi - t.kt_lo;              // <= 0: no key is visible
  return t;
}

// DHP: q's and k's head dim as tiled, 64, 128, 192 or 256 (a narrower head
// is read through the next one up, its extra columns zero-filled by TMA);
// DV: v's and o's, DHP or narrower; BK: keys per K/V tile, 128, or 64 at
// DHP = DV = 192 and 256, where 128-key tiles would take more shared memory
// than a block has, and S next to the wide accumulator more registers.
// Persistent: each CTA walks the work tiles blockIdx.x, + gridDim.x, ...;
// the K/V ring runs on across tiles, and the next tile's Q loads while the
// consumers finish the last one's products and store its output.
template <int DHP, int DV, int BK>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   __nv_bfloat16* __restrict__ o, Strides os, int H, int B,
                   int G, int Sq, int Sk, int dv, int causal, int has_window,
                   int window, float scale_log2) {
  constexpr int NB = DHP / BOX_COLS;       // boxes per Q or K tile
  constexpr int NBV = DV / BOX_COLS;       // boxes per V tile
  constexpr int QTILE = NB * BOX_BYTES;    // bytes of a Q tile
  constexpr int KBOX = BK * 128;           // bytes of a K or V box
  constexpr int TILE = NB * KBOX;          // bytes of a K tile
  constexpr int VTILE = NBV * KBOX;        // bytes of a V tile
  extern __shared__ uint8_t smem_raw[];
  // Q full, Q free; per stage K full, V full, K free, V free
  __shared__ __align__(8) uint64_t bars[2 + 4 * STAGES];

  // swizzle atoms must start on a 1 KB boundary
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + QTILE;                  // stage i: + i * TILE
  const uint32_t v_s = k_s + STAGES * TILE;          // stage i: + i * VTILE
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_qfree = bar_q + 8;
  const uint32_t bar_k = bar_qfree + 8;              // stage i: + 8 i
  const uint32_t bar_v = bar_k + 8 * STAGES;
  const uint32_t bar_kfree = bar_v + 8 * STAGES;
  const uint32_t bar_vfree = bar_kfree + 8 * STAGES;
  const int nqt = (Sq + BQ - 1) / BQ;
  const int n_work = nqt * H * B;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qfree, CONSUMER_THREADS);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bar_k + 8 * i, 1);
      mbar_init(bar_v + 8 * i, 1);
      mbar_init(bar_kfree + 8 * i, CONSUMER_THREADS);
      mbar_init(bar_vfree + 8 * i, CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      int it = 0;                            // k tiles loaded so far
      for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
        const Work t = work_tile<BK>(w, H, B, nqt, Sk, causal, has_window,
                                     window);
        mbar_wait(bar_qfree, (n & 1) ^ 1);   // the last tile's Q is read
        mbar_expect_tx(bar_q, QTILE);
        for (int j = 0; j < NB; ++j)
          tma_load(q_s + j * BOX_BYTES, &qmap, bar_q, j * BOX_COLS, t.q0,
                   t.h, t.b);
        for (int i = 0; i < t.ntiles; ++i, ++it) {
          const int st = it % STAGES;
          const uint32_t free_phase = ((it / STAGES) & 1) ^ 1;
          const int k0 = (t.kt_lo + i) * BK;
          mbar_wait(bar_kfree + 8 * st, free_phase);
          mbar_expect_tx(bar_k + 8 * st, TILE);
          for (int j = 0; j < NB; ++j)
            tma_load(k_s + st * TILE + j * KBOX, &kmap, bar_k + 8 * st,
                     j * BOX_COLS, k0, t.h / G, t.b);
          mbar_wait(bar_vfree + 8 * st, free_phase);
          mbar_expect_tx(bar_v + 8 * st, VTILE);
          for (int j = 0; j < NBV; ++j)
            tma_load(v_s + st * VTILE + j * KBOX, &vmap, bar_v + 8 * st,
                     j * BOX_COLS, k0, t.h / G, t.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row = 16 * warp + lane / 4;    // this thread's rows: row, row+8
    const int col = 2 * (lane % 4);          // its columns in each 8: col, +1
    const uint32_t q_rows = q_s + c * 64 * 128;
    const Mask mk{Sk, causal, has_window, window};
    float acc[DV / 2], s[BK / 2], m[2], l[2], corr[2];
    uint32_t p[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

    int it = 0;                              // k tiles consumed so far
    for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
      const Work t = work_tile<BK>(w, H, B, nqt, Sk, causal, has_window,
                                   window);
      const int r0 = t.q0 + 64 * c;          // the consumer's first row
      // a tile needs the mask where it crosses the diagonal, the window's
      // edge or Sk for any of the consumer's rows
      auto edge = [&](int k0) {
        return k0 + BK > Sk || (causal && k0 + BK - 1 > r0) ||
               (has_window && k0 <= r0 + 63 - window);
      };
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      m[0] = m[1] = MASKED;
      l[0] = l[1] = 0.f;

      mbar_wait(bar_q, n & 1);
      if (t.ntiles > 0) {
        // tile 0: its scores and softmax
        int k0 = t.kt_lo * BK;
        int st = it % STAGES;
        mbar_wait(bar_k + 8 * st, (it / STAGES) & 1);
        reg_fence(s);
        wgmma_fence();
        issue_qk<DHP, BK>(s, q_rows, k_s + st * TILE);
        wgmma_wait<0>();
        reg_fence(s);
        mbar_arrive(bar_kfree + 8 * st);
        if (t.ntiles == 1) mbar_arrive(bar_qfree);
        softmax_tile<BK>(s, m, l, corr, edge(k0), k0, r0 + row, col, mk,
                         scale_log2);
#pragma unroll
        for (int i = 0; i < BK / 4; ++i)
          p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

        // tile i's scores and tile i-1's P.V run on the tensor cores while
        // tile i's softmax runs on the CUDA cores
        for (int i = 1; i < t.ntiles; ++i) {
          const int pst = st, pph = ((it + i - 1) / STAGES) & 1;
          st = (it + i) % STAGES;
          k0 += BK;
          mbar_wait(bar_k + 8 * st, ((it + i) / STAGES) & 1);
          reg_fence(s);
          reg_fence(acc);
          reg_fence(p);
          wgmma_fence();
          issue_qk<DHP, BK>(s, q_rows, k_s + st * TILE);
          mbar_wait(bar_v + 8 * pst, pph);
          issue_pv<DV, BK>(acc, p, v_s + pst * VTILE);
          wgmma_wait<1>();                   // the scores are in
          reg_fence(s);
          mbar_arrive(bar_kfree + 8 * st);
          if (i == t.ntiles - 1) mbar_arrive(bar_qfree);
          softmax_tile<BK>(s, m, l, corr, edge(k0), k0, r0 + row, col, mk,
                           scale_log2);
          wgmma_wait<0>();                   // P.V of tile i-1 is in
          reg_fence(acc);
          reg_fence(p);
          mbar_arrive(bar_vfree + 8 * pst);
          // a warp whose rows kept their maxima has nothing to rescale
          if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
            for (int j = 0; j < DV / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
          }
#pragma unroll
          for (int j = 0; j < BK / 4; ++j)
            p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
        }

        // the last tile's P.V
        mbar_wait(bar_v + 8 * st, ((it + t.ntiles - 1) / STAGES) & 1);
        reg_fence(acc);
        reg_fence(p);
        wgmma_fence();
        issue_pv<DV, BK>(acc, p, v_s + st * VTILE);
        wgmma_wait<0>();
        reg_fence(acc);
        mbar_arrive(bar_vfree + 8 * st);
        it += t.ntiles;
      } else {
        mbar_arrive(bar_qfree);
      }

      // epilogue: o = acc / max(l, 1e-30), rounded to bf16 (l becomes
      // its reciprocal)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
      __nv_bfloat16* ob = o + t.b * os.b + t.h * os.h;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = r0 + row + 8 * r;
        if (qi >= Sq) continue;
        __nv_bfloat16* orow = ob + qi * os.s;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          const int d = 8 * j + col;
          if (d < dv)
            *reinterpret_cast<uint32_t*>(orow + d) = pack_bf16(
                acc[4 * j + 2 * r] * l[r], acc[4 * j + 2 * r + 1] * l[r]);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// (dh, S, heads, B) over the tensor's strides, boxes of 64 columns x
// `rows`, 128-byte swizzle; rows past S (and columns past dh) are filled
// with zeros
CUresult encode(CUtensorMap* map, const void* ptr, int dh, int S, int heads,
                int B, Strides st, int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(S),
                              cuuint64_t(heads), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st.s) * 2, cuuint64_t(st.h) * 2,
                                 cuuint64_t(st.b) * 2};
  const cuuint32_t box[4] = {BOX_COLS, cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DHP, int DV, int BK>
int launch(const CUtensorMap& qm, const CUtensorMap& km,
           const CUtensorMap& vm, void* o, int B, int H, int KV, int Sq,
           int Sk, int dv, Strides os, int causal, int has_window, int window,
           float scale, cudaStream_t stream) {
  // Q, then STAGES K and V tiles, and room to align to 1 KB
  const int smem = (DHP / BOX_COLS) * (BOX_BYTES + STAGES * BK * 128) +
                   (DV / BOX_COLS) * STAGES * BK * 128 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DHP, DV, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return int(err);
  const long long n_work = (long long)((Sq + BQ - 1) / BQ) * H * B;
  const int grid = int(n_work < sms ? n_work : sms);   // one CTA per SM
  flash_wgmma_kernel<DHP, DV, BK><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), os, H, B, H / KV, Sq, Sk,
      dv, causal, has_window, window, scale * LOG2E);
  return int(cudaGetLastError());
}

}  // namespace

// q: (B, H, Sq, dh), k/v: (B, KV, Sk, dh), o like q, bfloat16, each
// addressed through its (b, h, s) strides in elements with a contiguous head
// dim; dh a multiple of 8 up to 256; pointers and q/k/v strides 16-byte
// aligned (TMA's rule, checked by the caller, which stages other inputs).
// The instance: DHP the first of 64, 128, 192, 256 at or above dh.
// Returns a cudaError_t (0 = launched), or 1000 + the CUresult of a tensor
// map that could not be encoded.
extern "C" int flash_attention_sm90_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int dh, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int has_window, int window,
    float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1 ||
      (long long)((Sq + BQ - 1) / BQ) * H * B > 2147483647LL)
    return int(cudaErrorInvalidValue);
  if (dh < 8 || dh > 256 || dh % 8) return int(cudaErrorInvalidValue);
  if (!encoder()) return int(cudaErrorSymbolNotFound);
  const int bk = dh <= 128 ? 128 : 64;       // keys per K/V tile
  CUtensorMap qm, km, vm;
  CUresult res = encode(&qm, q, dh, Sq, H, B, Strides{qsb, qsh, qss}, BQ);
  if (res == CUDA_SUCCESS)
    res = encode(&km, k, dh, Sk, KV, B, Strides{ksb, ksh, kss}, bk);
  if (res == CUDA_SUCCESS)
    res = encode(&vm, v, dh, Sk, KV, B, Strides{vsb, vsh, vss}, bk);
  if (res != CUDA_SUCCESS) return 1000 + int(res);
  const Strides os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh <= 64)
    return launch<64, 64, 128>(qm, km, vm, o, B, H, KV, Sq, Sk, dh, os,
                               causal, has_window, window, scale, st);
  if (dh <= 128)
    return launch<128, 128, 128>(qm, km, vm, o, B, H, KV, Sq, Sk, dh, os,
                                 causal, has_window, window, scale, st);
  if (dh <= 192)
    return launch<192, 192, 64>(qm, km, vm, o, B, H, KV, Sq, Sk, dh, os,
                                causal, has_window, window, scale, st);
  return launch<256, 256, 64>(qm, km, vm, o, B, H, KV, Sq, Sk, dh, os,
                              causal, has_window, window, scale, st);
}

// As flash_attention_sm90_fwd, with v and o of dv columns where q and k
// have dh: the instance <192, 128, 128>, for dh in 136..192 and dv in
// 8..128 (multiples of 8); o's strides are of a (B, H, Sq, dv) tensor.
extern "C" int flash_attention_sm90_dv_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KV, int Sq, int Sk, int dh, int dv, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, int causal, int has_window, int window,
    float scale, void* stream) {
  if (B < 1 || KV < 1 || H % KV || Sq < 1 || Sk < 1 ||
      (long long)((Sq + BQ - 1) / BQ) * H * B > 2147483647LL)
    return int(cudaErrorInvalidValue);
  if (dh <= 128 || dh > 192 || dh % 8 || dv < 8 || dv > 128 || dv % 8)
    return int(cudaErrorInvalidValue);
  if (!encoder()) return int(cudaErrorSymbolNotFound);
  CUtensorMap qm, km, vm;
  CUresult res = encode(&qm, q, dh, Sq, H, B, Strides{qsb, qsh, qss}, BQ);
  if (res == CUDA_SUCCESS)
    res = encode(&km, k, dh, Sk, KV, B, Strides{ksb, ksh, kss}, 128);
  if (res == CUDA_SUCCESS)
    res = encode(&vm, v, dv, Sk, KV, B, Strides{vsb, vsh, vss}, 128);
  if (res != CUDA_SUCCESS) return 1000 + int(res);
  return launch<192, 128, 128>(qm, km, vm, o, B, H, KV, Sq, Sk, dv,
                               Strides{osb, osh, oss}, causal, has_window,
                               window, scale, static_cast<cudaStream_t>(stream));
}
