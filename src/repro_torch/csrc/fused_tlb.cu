// Fused cross-wave probe+fill round of a set-associative int32 cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `src/repro/kernels/fused_tlb/kernel.py::_kernel`
// (wrapper `fused_tlb_round`), which serves `repro.core.tlb.access_fused`.
// The simulator calls it once per cycle for the shared L2 data cache
// (1024 sets x 16 ways, 240 lanes in 8 waves; 120 lanes in 4 waves under
// the ideal design) and once more for the page-walk cache under the pwc
// design (64 x 16, 120 lanes in 4 waves). Both rounds are tag-only.
//
// What bounds it: an L2 round reads about 30 KB of table rows and writes a
// few hundred words. At 3.35 TB/s that is ~10 ns of memory traffic and far
// below a microsecond of integer work, so the launch latency (several us)
// sets the floor, not bandwidth or arithmetic. The design therefore does
// the whole round in ONE launch of ONE thread block, one thread per lane,
// with the phases separated by __syncthreads(); the cross-lane tables (the
// per-(set, wave) fill ports, the lanes' lines and candidate flags) live
// in shared memory, and the planes are updated in place in device memory.
// Fusing rounds of many cycles or many grid rows into one launch is the
// way past that floor, and is left to a later change.
//
// Phases:
//   1. pre-probe against the start-of-cycle tags (and asids);
//   2. per-position duplicate suppression across waves, then the fill
//      port: first candidate (lowest lane) of each (set, wave) wins, by a
//      shared-memory atomicMin;
//   3. winner cap (rank < n_ways) and victim = the rank-th way in stable
//      (lru, way) order of the start-of-cycle LRU row;
//   4. write ownership: a pre-hit lane and a winner can name one slot; the
//      higher lane index owns it (the order of the reference's serial
//      scatter), by an atomicMax into a per-slot owner scratch;
//   5. the owners write tag, lru (and asid);
//   6. post-probe of the updated tags: forwarding to non-winning lanes.
//
// `vpn % n_sets` is a floor mod: the L2 round's tags are routinely negative
// after the int32 wrap, and C's % truncates.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void fused_tlb_kernel(int* tags, int* asids, int* lru,
                                 const int* __restrict__ vpn,
                                 const int* __restrict__ asid,
                                 const bool* __restrict__ active,
                                 const bool* __restrict__ may_fill,
                                 int* __restrict__ hit_out,
                                 int* __restrict__ filled_out, int* owner,
                                 int n_sets, int n_ways, int n, int n_waves,
                                 int track_asids, int time) {
  extern __shared__ int smem[];
  const int n_port = n_sets * n_waves;
  int* s_port = smem;              // (n_sets * n_waves) first candidate lane
  int* s_vpn = s_port + n_port;    // (n) lane lines
  int* s_cand = s_vpn + n;         // (n) pre-suppression candidate flags

  const int i = threadIdx.x;
  const bool lane = i < n;
  for (int k = i; k < n_port; k += blockDim.x) s_port[k] = n;

  // ---- 1. pre-probe ------------------------------------------------------
  int v = 0, a = 0, set = 0, way = 0;
  bool act = false, pre_hit = false, cand = false;
  if (lane) {
    v = vpn[i];
    a = track_asids ? asid[i] : 0;
    act = active[i];
    set = n_sets > 1 ? floor_mod(v, n_sets) : 0;
    const int* trow = tags + set * n_ways;
    const int* arow = asids + set * n_ways;
    bool any = false;
    for (int w = n_ways - 1; w >= 0; --w) {   // keeps the first match
      if (trow[w] == v && (!track_asids || arow[w] == a)) {
        any = true;
        way = w;
      }
    }
    pre_hit = any && act;
    cand = act && !pre_hit && may_fill[i];
    s_vpn[i] = v;
    s_cand[i] = cand;
  }
  __syncthreads();

  // ---- 2. duplicate suppression + fill port ------------------------------
  const int C = n / n_waves;
  int wave = 0;
  if (lane) {
    wave = i / C;
    const int c = i - wave * C;
    for (int w = 0; cand && w < wave; ++w) {
      const int j = w * C + c;
      if (s_cand[j] && s_vpn[j] == v) cand = false;
    }
    if (cand) atomicMin(&s_port[set * n_waves + wave], i);
  }
  __syncthreads();

  // ---- 3. winner, rank, victim -------------------------------------------
  bool winner = false;
  int target = -1;
  if (lane) {
    int rank = 0;
    for (int w = 0; w < wave; ++w) rank += s_port[set * n_waves + w] < n;
    winner = cand && s_port[set * n_waves + wave] == i && rank < n_ways;
    if (pre_hit) {
      target = set * n_ways + way;
    } else if (winner) {
      const int want = rank < n_ways - 1 ? rank : n_ways - 1;
      const int* lrow = lru + set * n_ways;
      int victim = 0;
      for (int w = 0; w < n_ways; ++w) {
        const int lw = lrow[w];
        int r = 0;
        for (int u = 0; u < n_ways; ++u) {
          const int lu = lrow[u];
          r += lu < lw || (lu == lw && u < w);
        }
        if (r == want) {           // ranks are a permutation: one match
          victim = w;
          break;
        }
      }
      target = set * n_ways + victim;
    }
    if (target >= 0) owner[target] = -1;
  }
  __syncthreads();

  // ---- 4. write ownership: the highest lane index wins a slot ------------
  if (target >= 0) atomicMax(&owner[target], i);
  __syncthreads();

  // ---- 5. merged in-place update -----------------------------------------
  if (target >= 0 && __ldcg(&owner[target]) == i) {
    tags[target] = v;
    lru[target] = time;
    if (track_asids) asids[target] = a;
  }
  __syncthreads();

  // ---- 6. post-probe: forwarding from the filled table -------------------
  if (lane) {
    const int* trow = tags + set * n_ways;
    const int* arow = asids + set * n_ways;
    bool post = false;
    for (int w = 0; w < n_ways; ++w)
      post |= trow[w] == v && (!track_asids || arow[w] == a);
    hit_out[i] = pre_hit || (act && !winner && post);
    filled_out[i] = winner;
  }
}

}  // namespace

// C entry for ctypes. Shapes and types are checked by the Python wrapper
// (`repro_torch/kernels/fused_tlb/kernel.py`); returns the launch's
// cudaError_t (0 on success).
extern "C" int fused_tlb_round(void* tags, void* asids, void* lru,
                               const void* vpn, const void* asid,
                               const void* active, const void* may_fill,
                               void* hit, void* filled, void* owner,
                               int n_sets, int n_ways, int n, int n_waves,
                               int track_asids, int time, void* stream) {
  const size_t smem = sizeof(int) * (size_t(n_sets) * n_waves + 2 * size_t(n));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_tlb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int threads = ((n + 31) / 32) * 32;
  fused_tlb_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(tags), static_cast<int*>(asids),
      static_cast<int*>(lru), static_cast<const int*>(vpn),
      static_cast<const int*>(asid), static_cast<const bool*>(active),
      static_cast<const bool*>(may_fill), static_cast<int*>(hit),
      static_cast<int*>(filled), static_cast<int*>(owner), n_sets, n_ways,
      n, n_waves, track_asids, time);
  return int(cudaGetLastError());
}
