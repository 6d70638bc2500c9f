// Fused cross-wave probe+fill round of a set-associative int32 cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/fused_tlb/kernel.py::_kernel`
// (wrapper `fused_tlb_round`), which serves `repro.core.tlb.access_fused`.
// The simulator calls it once per cycle for the shared L2 data cache
// (1024 sets x 16 ways, 240 lanes in 8 waves; 120 lanes in 4 waves under
// the ideal design) and once more for the page-walk cache under the pwc
// design (64 x 16, 120 lanes in 4 waves). Both rounds are tag-only. A grid
// of R simulations (`run_grid`'s rows) runs R independent rounds, one per
// row, in the same launch. The lanes are the simulator's (L + K) x n_cores
// requests, so a configuration of more cores (132 cores: 1056 lanes) runs
// the wide instances below.
//
// What bounds it: an L2 round reads about 30 KB of table rows and writes a
// few hundred words. At 3.35 TB/s that is ~10 ns of memory traffic and far
// below a microsecond of integer work, so the launch latency (a few us)
// sets the floor, not bandwidth or arithmetic. The design therefore does
// a row's whole round in ONE thread block, one thread per lane, with the
// phases separated by __syncthreads(), launches ONE block per row (the
// rows share nothing, so R rounds cost one launch and, up to the SM count,
// about one round's time), and keeps each lane's chain of dependent memory
// accesses short:
//  * The main path's 16-way rounds run an instance compiled for 16 ways;
//    one more instance takes the way count at run time for every other
//    shape. A 16-way lane reads its set's tag row (and asid row) and, if
//    it may fill, its LRU row, all at once, with four 16-byte loads each,
//    and compares in registers. The LRU row stays in registers, so the
//    victim's rank (16 x 16 compares) touches no memory.
//  * Those instances take one lane a thread (LPT = 1), up to 1024 lanes.
//    A round of more lanes runs the wide instances (LPT = LPT_WIDE): 1024
//    threads, thread t taking lanes t, t + 1024, ..., each phase a loop
//    over the thread's lanes with their state in registers; the 16-way
//    wide instance loads a winner's LRU row in phase 3, not beside its tag
//    row, so that no lane keeps 16 LRU words across the barriers. Past
//    8192 lanes the owner hash and lane tables outgrow shared memory.
//  * Rows are read by 16-byte loads only by the 16-way instances, which
//    the wrapper picks for planes whose every row is 16-byte aligned; the
//    run-time-width instances read words, so any row layout works.
//  * Block r offsets its plane and lane pointers by row r; the cross-lane
//    tables are the block's own. They live in shared memory: the per-(set, wave) fill
//    ports (only the rows of sets that have a candidate are initialised,
//    by those candidates), the lanes' lines and candidate flags, and the
//    write owners, in a hash table of the <= N targeted slots (open
//    addressing, 2N to 4N entries), so nothing per call is allocated in
//    device memory.
// Resources (`-Xptxas -v`, build/repro_torch/fused_tlb-*.log): <16, 1>
// 62 registers and <0, 1> 32, no spill, as before the wide instances;
// <16, 8> and <0, 8> 64 (the cap of 1024 threads) with 384 and 322 bytes
// of spill stores: the wide rounds pay for their lanes' state in local
// memory (on the H100, chip_smoke.py phase 20: 13.84 us for 1056 lanes
// against ~3 us for 240).
// Fusing rounds of many cycles into one launch (a CUDA graph per cycle) is
// the way past the launch floor, and is left to a later change.
//
// Phases:
//   1. pre-probe against the start-of-cycle tags (and asids); candidates
//      set their set's fill-port row and load its LRU row;
//   2. per-position duplicate suppression across waves, then the fill
//      port: first candidate (lowest lane) of each (set, wave) wins, by a
//      shared-memory atomicMin;
//   3. winner cap (rank < n_ways) and victim = the rank-th way in stable
//      (lru, way) order of the start-of-cycle LRU row; write ownership: a
//      pre-hit lane and a winner can name one slot; the higher lane index
//      owns it (the order of the reference's serial scatter), by a shared
//      atomicMax in the slot's hash entry;
//   4. the owners write tag, lru (and asid);
//   5. post-probe of the updated tags: forwarding to non-winning lanes.
//      It reads the planes with plain global loads after a barrier: never
//      the read-only path, which could return rows from before phase 4.
//
// `vpn % n_sets` is a floor mod: the L2 round's tags are routinely negative
// after the int32 wrap, and C's % truncates.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int MAX_THREADS = 1024;   // one block a row
constexpr int LPT_WIDE = 8;         // lanes a thread of the wide instances
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr int MAX_DEVICES = 64;     // devices whose limits are cached

__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// K consecutive int32 of a plane row into registers by 16-byte loads (the
// wrapper checks the planes' alignment).
template <int K>
__device__ __forceinline__ void load_row(int (&r)[K], const int* p) {
  static_assert(K % 4 == 0, "rows are read by int4");
#pragma unroll
  for (int i = 0; i < K / 4; ++i) {
    const int4 x = reinterpret_cast<const int4*>(p)[i];
    r[4 * i] = x.x;
    r[4 * i + 1] = x.y;
    r[4 * i + 2] = x.z;
    r[4 * i + 3] = x.w;
  }
}

// The first way of a row whose tag (and asid, when tracked) matches, or
// -1. NW = 0: the way count n is read at run time.
template <int NW>
__device__ __forceinline__ int first_match(const int* trow, const int* arow,
                                           int n, int v, int a, bool track) {
  if constexpr (NW == 0) {
    for (int w = 0; w < n; ++w)
      if (trow[w] == v && (!track || arow[w] == a)) return w;
    return -1;
  } else {
    int t[NW], s[NW];
    load_row<NW>(t, trow);
    if (track) load_row<NW>(s, arow);
    int way = -1;
#pragma unroll
    for (int w = NW - 1; w >= 0; --w) {   // keeps the first match
      bool m = t[w] == v;
      if (track) m = m && s[w] == a;
      if (m) way = w;
    }
    return way;
  }
}

// The way of stable rank `want` in (lru, way) order of K ways held in
// registers: the ranks are a permutation, so exactly one way matches.
template <int K>
__device__ __forceinline__ int rank_select(const int (&l)[K], int want) {
  int victim = 0;
#pragma unroll
  for (int w = 0; w < K; ++w) {
    int r = 0;
#pragma unroll
    for (int u = 0; u < K; ++u) r += u < w ? l[u] <= l[w] : l[u] < l[w];
    if (r == want) victim = w;
  }
  return victim;
}

// The same for a row of a run-time width, read from the plane.
__device__ int rank_select_rt(const int* lrow, int n, int want) {
  for (int w = 0; w < n; ++w) {
    const int lw = lrow[w];
    int r = 0;
    for (int u = 0; u < n; ++u) {
      const int lu = lrow[u];
      r += lu < lw || (lu == lw && u < w);
    }
    if (r == want) return w;
  }
  return 0;
}

// NW: the compiled way count (0: read at run time); LPT: lanes a thread
// at most (1, or LPT_WIDE for rounds of more than 1024 lanes)
template <int NW, int LPT>
__global__ void __launch_bounds__(MAX_THREADS)
fused_tlb_kernel(int* tags, int* asids, int* lru,
                 const int* __restrict__ vpn, const int* __restrict__ asid,
                 const bool* __restrict__ active,
                 const bool* __restrict__ may_fill,
                 int* __restrict__ hit_out, int* __restrict__ filled_out,
                 int n_sets, int n_ways_rt, int n, int n_waves,
                 int track_asids, int time, int hash_bits) {
  const int n_ways = NW ? NW : n_ways_rt;
  const bool track = track_asids;
  const int n_hash = 1 << hash_bits;
  extern __shared__ int smem[];
  int* s_port = smem;                      // (n_sets, n_waves) first lane
  int* s_vpn = s_port + n_sets * n_waves;  // (n) lane lines
  int* s_cand = s_vpn + n;                 // (n) pre-suppression candidates
  int* s_key = s_cand + n;                 // (n_hash) slot, -1 if free
  int* s_own = s_key + n_hash;             // (n_hash) highest writing lane

  // this block's row: its planes and lanes
  const size_t plane_off = size_t(blockIdx.x) * n_sets * n_ways;
  const size_t lane_off = size_t(blockIdx.x) * n;
  tags += plane_off;
  asids += plane_off;
  lru += plane_off;
  vpn += lane_off;
  asid += lane_off;
  active += lane_off;
  may_fill += lane_off;
  hit_out += lane_off;
  filled_out += lane_off;

  for (int k = threadIdx.x; k < n_hash; k += blockDim.x) {
    s_key[k] = -1;
    s_own[k] = -1;
  }

  // this thread's lanes: lane(j) = threadIdx.x + j * blockDim.x, j < LPT
  auto lane_of = [&](int j) { return int(threadIdx.x) + j * int(blockDim.x); };

  // ---- 1. pre-probe ------------------------------------------------------
  int v[LPT], a[LPT], set[LPT], way[LPT];
  bool act[LPT], pre_hit[LPT], cand[LPT];
  int lrow[NW && LPT == 1 ? NW : 1];      // the LRU row in registers
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int i = lane_of(j);
    v[j] = 0;
    a[j] = 0;
    set[j] = 0;
    way[j] = -1;
    act[j] = pre_hit[j] = cand[j] = false;
    if (i < n) {
      v[j] = vpn[i];
      act[j] = active[i];
      if (act[j]) {
        a[j] = track ? asid[i] : 0;
        set[j] = n_sets > 1 ? floor_mod(v[j], n_sets) : 0;
        const int row = set[j] * n_ways;
        const bool may = may_fill[i];
        if constexpr (NW > 0 && LPT == 1) {
          if (may) load_row<NW>(lrow, lru + row);   // beside the tag row
        }
        way[j] = first_match<NW>(tags + row, asids + row, n_ways, v[j], a[j],
                                 track);
        pre_hit[j] = way[j] >= 0;
        cand[j] = !pre_hit[j] && may;
        if (cand[j])
          for (int w = 0; w < n_waves; ++w) s_port[set[j] * n_waves + w] = n;
      }
      s_vpn[i] = v[j];
      s_cand[i] = cand[j];
    }
  }
  __syncthreads();

  // ---- 2. duplicate suppression + fill port ------------------------------
  const int C = n / n_waves;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int i = lane_of(j);
    if (cand[j]) {
      const int wave = i / C;
      const int c = i - wave * C;
      for (int w = 0; w < wave; ++w) {
        const int l = w * C + c;
        if (s_cand[l] && s_vpn[l] == v[j]) {
          cand[j] = false;
          break;
        }
      }
      if (cand[j]) atomicMin(&s_port[set[j] * n_waves + wave], i);
    }
  }
  __syncthreads();

  // ---- 3. winner, rank, victim; write ownership --------------------------
  bool winner[LPT];
  int target[LPT], h[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int i = lane_of(j);
    winner[j] = false;
    target[j] = -1;
    if (pre_hit[j]) {
      target[j] = set[j] * n_ways + way[j];
    } else if (cand[j]) {
      const int wave = i / C;
      const int* prow = s_port + set[j] * n_waves;
      int rank = 0;
      for (int w = 0; w < wave; ++w) rank += prow[w] < n;
      winner[j] = prow[wave] == i && rank < n_ways;
      if (winner[j]) {
        int victim;
        if constexpr (NW > 0 && LPT == 1) {
          victim = rank_select<NW>(lrow, rank);
        } else if constexpr (NW > 0) {
          int lr[NW];                        // unchanged until phase 4
          load_row<NW>(lr, lru + set[j] * n_ways);
          victim = rank_select<NW>(lr, rank);
        } else {
          victim = rank_select_rt(lru + set[j] * n_ways, n_ways, rank);
        }
        target[j] = set[j] * n_ways + victim;
      }
    }
    h[j] = 0;
    if (target[j] >= 0) {   // the slot's hash entry: the highest lane wins
      h[j] = int((unsigned(target[j]) * 2654435761u) >> (32 - hash_bits));
      for (;;) {
        const int prev = atomicCAS(&s_key[h[j]], -1, target[j]);
        if (prev == -1 || prev == target[j]) break;
        h[j] = (h[j] + 1) & (n_hash - 1);
      }
      atomicMax(&s_own[h[j]], i);
    }
  }
  __syncthreads();

  // ---- 4. merged in-place update -----------------------------------------
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    if (target[j] >= 0 && s_own[h[j]] == lane_of(j)) {
      tags[target[j]] = v[j];
      lru[target[j]] = time;
      if (track) asids[target[j]] = a[j];
    }
  }
  __syncthreads();

  // ---- 5. post-probe: forwarding from the filled table -------------------
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    const int i = lane_of(j);
    if (i < n) {
      bool post = false;
      if (act[j] && !pre_hit[j] && !winner[j]) {
        const int row = set[j] * n_ways;
        post = first_match<NW>(tags + row, asids + row, n_ways, v[j], a[j],
                               track) >= 0;
      }
      hit_out[i] = pre_hit[j] || post;
      filled_out[i] = winner[j];
    }
  }
}

// Raises the instance's dynamic shared-memory limit to `smem` on the
// current device where an earlier launch there has not: the attribute is
// set once per instance, device and size, not on every launch.
template <int NW, int LPT>
int allow_smem(size_t smem) {
  static std::atomic<size_t> allowed[MAX_DEVICES];   // 0: the default
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (smem <= DEFAULT_SMEM ||
      (dev < MAX_DEVICES && smem <= allowed[dev].load()))
    return 0;
  err = cudaFuncSetAttribute(fused_tlb_kernel<NW, LPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  if (dev < MAX_DEVICES) {
    size_t cur = allowed[dev].load();
    while (cur < smem && !allowed[dev].compare_exchange_weak(cur, smem)) {
    }
  }
  return 0;
}

template <int NW, int LPT>
int launch(int* tags, int* asids, int* lru, const int* vpn, const int* asid,
           const bool* active, const bool* may_fill, int* hit, int* filled,
           int n_rows, int n_sets, int n_ways, int n, int n_waves,
           int track_asids, int time, int hash_bits, size_t smem,
           cudaStream_t stream) {
  const int err = allow_smem<NW, LPT>(smem);
  if (err != 0) return err;
  const int threads = LPT == 1 ? ((n + 31) / 32) * 32 : MAX_THREADS;
  fused_tlb_kernel<NW, LPT><<<n_rows, threads, smem, stream>>>(
      tags, asids, lru, vpn, asid, active, may_fill, hit, filled, n_sets,
      n_ways, n, n_waves, track_asids, time, hash_bits);
  return int(cudaGetLastError());
}

}  // namespace

// C entry for ctypes. `instance` is the way count of the compiled instance
// to launch (16, equal to n_ways, for planes whose rows are 16-byte
// aligned) or 0 for the one that reads n_ways at run time; up to 1024
// lanes take one thread each, more (up to 8192) the wide instance of that
// way count. The Python wrapper picks it
// (`repro_torch/kernels/fused_tlb/kernel.py::instance`) and checks shapes,
// types and alignment (of every row, for instance 16). The planes are (n_rows, n_sets,
// n_ways) and the lanes (n_rows, n), contiguous; one block per row. The
// write-owner hash table has 2^hash_bits entries, at least 2 n. Returns the
// launch's cudaError_t (0 on success).
extern "C" int fused_tlb_round(void* tags, void* asids, void* lru,
                               const void* vpn, const void* asid,
                               const void* active, const void* may_fill,
                               void* hit, void* filled, int instance,
                               int n_rows, int n_sets, int n_ways, int n,
                               int n_waves, int track_asids, int time,
                               int hash_bits, void* stream) {
  if (n_rows < 1 || n < 1 || n > MAX_THREADS * LPT_WIDE || n_waves < 1 ||
      n % n_waves ||
      (instance && instance != n_ways) || hash_bits < 1 || hash_bits > 16 ||
      (1 << hash_bits) < 2 * n)
    return int(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * (size_t(n_sets) * n_waves + 2 * size_t(n) +
                                     2 * (size_t(1) << hash_bits));
  auto* t = static_cast<int*>(tags);
  auto* s = static_cast<int*>(asids);
  auto* l = static_cast<int*>(lru);
  auto* vp = static_cast<const int*>(vpn);
  auto* as = static_cast<const int*>(asid);
  auto* ac = static_cast<const bool*>(active);
  auto* mf = static_cast<const bool*>(may_fill);
  auto* ht = static_cast<int*>(hit);
  auto* fl = static_cast<int*>(filled);
  auto st = static_cast<cudaStream_t>(stream);
#define FUSED_TLB_LAUNCH(NW, LPT)                                            \
  launch<NW, LPT>(t, s, l, vp, as, ac, mf, ht, fl, n_rows, n_sets, n_ways,  \
                  n, n_waves, track_asids, time, hash_bits, smem, st)
  const bool wide = n > MAX_THREADS;
  switch (instance) {
    case 16: return wide ? FUSED_TLB_LAUNCH(16, LPT_WIDE)
                         : FUSED_TLB_LAUNCH(16, 1);
    case 0: return wide ? FUSED_TLB_LAUNCH(0, LPT_WIDE)
                        : FUSED_TLB_LAUNCH(0, 1);
    default: return int(cudaErrorInvalidValue);
  }
#undef FUSED_TLB_LAUNCH
}
