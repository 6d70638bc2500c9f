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
// row, in the same launch.
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
//  * Block r offsets its plane and lane pointers by row r; the cross-lane
//    tables are the block's own. They live in shared memory: the per-(set, wave) fill
//    ports (only the rows of sets that have a candidate are initialised,
//    by those candidates), the lanes' lines and candidate flags, and the
//    write owners, in a hash table of the <= N targeted slots (open
//    addressing, 2N to 4N entries), so nothing per call is allocated in
//    device memory.
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

constexpr int MAX_THREADS = 1024;   // one thread per lane, one block a row
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

template <int NW>
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

  const int i = threadIdx.x;
  const bool lane = i < n;
  for (int k = i; k < n_hash; k += blockDim.x) {
    s_key[k] = -1;
    s_own[k] = -1;
  }

  // ---- 1. pre-probe ------------------------------------------------------
  int v = 0, a = 0, set = 0, way = -1;
  bool act = false, pre_hit = false, cand = false;
  int lrow[NW ? NW : 1];                  // the LRU row in registers
  if (lane) {
    v = vpn[i];
    act = active[i];
    if (act) {
      a = track ? asid[i] : 0;
      set = n_sets > 1 ? floor_mod(v, n_sets) : 0;
      const int row = set * n_ways;
      const bool may = may_fill[i];
      if constexpr (NW > 0) {
        if (may) load_row<NW>(lrow, lru + row);   // beside the tag row
      }
      way = first_match<NW>(tags + row, asids + row, n_ways, v, a, track);
      pre_hit = way >= 0;
      cand = !pre_hit && may;
      if (cand)
        for (int w = 0; w < n_waves; ++w) s_port[set * n_waves + w] = n;
    }
    s_vpn[i] = v;
    s_cand[i] = cand;
  }
  __syncthreads();

  // ---- 2. duplicate suppression + fill port ------------------------------
  const int C = n / n_waves;
  const int wave = i / C;
  if (cand) {
    const int c = i - wave * C;
    for (int w = 0; w < wave; ++w) {
      const int j = w * C + c;
      if (s_cand[j] && s_vpn[j] == v) {
        cand = false;
        break;
      }
    }
    if (cand) atomicMin(&s_port[set * n_waves + wave], i);
  }
  __syncthreads();

  // ---- 3. winner, rank, victim; write ownership --------------------------
  bool winner = false;
  int target = -1;
  if (pre_hit) {
    target = set * n_ways + way;
  } else if (cand) {
    const int* prow = s_port + set * n_waves;
    int rank = 0;
    for (int w = 0; w < wave; ++w) rank += prow[w] < n;
    winner = prow[wave] == i && rank < n_ways;
    if (winner) {
      int victim;
      if constexpr (NW > 0)
        victim = rank_select<NW>(lrow, rank);
      else
        victim = rank_select_rt(lru + set * n_ways, n_ways, rank);
      target = set * n_ways + victim;
    }
  }
  int h = 0;
  if (target >= 0) {        // the slot's hash entry: the highest lane wins
    h = int((unsigned(target) * 2654435761u) >> (32 - hash_bits));
    for (;;) {
      const int prev = atomicCAS(&s_key[h], -1, target);
      if (prev == -1 || prev == target) break;
      h = (h + 1) & (n_hash - 1);
    }
    atomicMax(&s_own[h], i);
  }
  __syncthreads();

  // ---- 4. merged in-place update -----------------------------------------
  if (target >= 0 && s_own[h] == i) {
    tags[target] = v;
    lru[target] = time;
    if (track) asids[target] = a;
  }
  __syncthreads();

  // ---- 5. post-probe: forwarding from the filled table -------------------
  if (lane) {
    bool post = false;
    if (act && !pre_hit && !winner) {
      const int row = set * n_ways;
      post = first_match<NW>(tags + row, asids + row, n_ways, v, a,
                             track) >= 0;
    }
    hit_out[i] = pre_hit || post;
    filled_out[i] = winner;
  }
}

// Raises the instance's dynamic shared-memory limit to `smem` on the
// current device where an earlier launch there has not: the attribute is
// set once per instance, device and size, not on every launch.
template <int NW>
int allow_smem(size_t smem) {
  static std::atomic<size_t> allowed[MAX_DEVICES];   // 0: the default
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (smem <= DEFAULT_SMEM ||
      (dev < MAX_DEVICES && smem <= allowed[dev].load()))
    return 0;
  err = cudaFuncSetAttribute(fused_tlb_kernel<NW>,
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

template <int NW>
int launch(int* tags, int* asids, int* lru, const int* vpn, const int* asid,
           const bool* active, const bool* may_fill, int* hit, int* filled,
           int n_rows, int n_sets, int n_ways, int n, int n_waves,
           int track_asids, int time, int hash_bits, size_t smem,
           cudaStream_t stream) {
  const int err = allow_smem<NW>(smem);
  if (err != 0) return err;
  const int threads = ((n + 31) / 32) * 32;
  fused_tlb_kernel<NW><<<n_rows, threads, smem, stream>>>(
      tags, asids, lru, vpn, asid, active, may_fill, hit, filled, n_sets,
      n_ways, n, n_waves, track_asids, time, hash_bits);
  return int(cudaGetLastError());
}

}  // namespace

// C entry for ctypes. `instance` is the way count of the compiled instance
// to launch (16, equal to n_ways) or 0 for the one that reads n_ways at
// run time; the Python wrapper picks it
// (`repro_torch/kernels/fused_tlb/kernel.py::instance`) and checks shapes,
// types and alignment (of every row). The planes are (n_rows, n_sets,
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
  if (n_rows < 1 || n < 1 || n > MAX_THREADS || n_waves < 1 || n % n_waves ||
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
#define FUSED_TLB_LAUNCH(NW)                                                 \
  launch<NW>(t, s, l, vp, as, ac, mf, ht, fl, n_rows, n_sets, n_ways, n,    \
             n_waves, track_asids, time, hash_bits, smem, st)
  switch (instance) {
    case 16: return FUSED_TLB_LAUNCH(16);
    case 0: return FUSED_TLB_LAUNCH(0);
    default: return int(cudaErrorInvalidValue);
  }
#undef FUSED_TLB_LAUNCH
}
