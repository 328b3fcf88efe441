// The walk kernel's FIRST DESIGN, kept only as a yardstick:
// chip_smoke.py times csrc/dbg_walk.cu against it in the same call.  It is
// built into _build.baseline_library() alone and no path of the port
// launches it.
//
// Speculative greedy De Bruijn walks on Hopper (sm_90a): the walk half of
// search_De_Bruijn_graph (consensus.c:299-335, 384-423, 534-573), one walk
// per (query, direction, start node) job.
//
// Replaces mtr_tpu/ops/dbg_device.py:132 _stage_b (a jitted pair of
// lax.fori_loops, not Pallas).  The plain PyTorch statement of the same
// function is mtr_tpu_torch/ops/dbg_device.py::stage_b_plain.
//
// Design: one warp per job, so T_DEV = 32 ties are one per lane.  A walk
// step looks ahead m = 1 .. max_la bases (max_la = 1 for the first 10
// steps, else k).  Lane t holds tie t and its 4 candidate extensions in
// JAX's order (index 4t + j); each candidate's live count is a binary
// search in the job's row of the chunk's sorted tables (row tq: nothing is
// copied per job).  The best count is a warp max, the candidates that
// reach it a 4-bit mask per lane, their number nt the warp sum of the
// popcounts; the first one (lowest 4t + j, the ballot's first lane) is
// md, and the r-th one (a warp exclusive scan of the popcounts gives each
// lane its base rank) becomes tie r of the next lookahead step, through
// 32 ints of shared memory per warp.  nt > 32 sets the overflow flag: the
// tie list was cut, and the host re-walks the query.  Forward breaks at
// nt == 1, backward at nt <= 1; a lookahead that never breaks leaves
// m = max_la + 1 (consensus.c:335).  Forward records the current node's
// digit and score before stepping, backward the new node's after.  A warp
// ends at its own loop or at lmax steps; every value a warp branches on
// is warp-uniform.
//
// Bound: latency.  A step is a chain of dependent binary searches (up to
// 17 loads each, in the L2 when the chunk's tables fit its 50 MB) with a
// few shuffles between them; the four searches of a lane are independent
// and overlap.  Throughput comes from many walks in flight: 8 warps per
// block, one job each.
//
// Bounds (checked by the wrapper): 1 <= k <= 15 (codes < 4^15 fit int32),
// 0 <= tq < rows of the tables.  Outputs units/scores are zeroed by the
// wrapper; the kernel writes only the steps a walk takes.  The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPeriod = 500;
constexpr int kTies = 32;  // T_DEV
constexpr int kWarps = 8;  // jobs per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int pow4(int e) {  // 4^clip(e, 0, 15)
  e = min(max(e, 0), 15);
  return 1 << (2 * e);
}

// Live count of key in one sorted row (0 when absent): the first index
// with sv[idx] >= key, as jnp.searchsorted(side="left"), clipped to the
// row.
__device__ __forceinline__ int lookup(const int32_t* __restrict__ sv,
                                      const int32_t* __restrict__ sc,
                                      int v_pad, int key) {
  int lo = 0, hi = v_pad;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(sv + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int idx = min(lo, v_pad - 1);
  return __ldg(sv + idx) == key ? __ldg(sc + idx) : 0;
}

__global__ void __launch_bounds__(kWarps * 32)
dbg_walk_kernel(const int32_t* __restrict__ sv,
                const int32_t* __restrict__ sc, int v_pad,
                const int32_t* __restrict__ tq,
                const int32_t* __restrict__ node0_a,
                const int32_t* __restrict__ fwd_a,
                const int32_t* __restrict__ k_a,
                const int32_t* __restrict__ lmax_a, int n_jobs,
                uint8_t* __restrict__ found_o, int32_t* __restrict__ period_o,
                int32_t* __restrict__ units_o, int32_t* __restrict__ scores_o,
                uint8_t* __restrict__ ovf_o) {
  __shared__ int s_ties[kWarps][kTies];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int job = blockIdx.x * kWarps + w;
  if (job >= n_jobs) return;  // the whole warp leaves together

  const int64_t row = (int64_t)tq[job] * v_pad;
  const int32_t* rsv = sv + row;
  const int32_t* rsc = sc + row;
  const int node0 = node0_a[job];
  const bool fwd = fwd_a[job] != 0;
  const int k = k_a[job];
  const int lmax = lmax_a[job];
  const int k1 = pow4(k - 1);
  int32_t* units = units_o + (int64_t)job * kMaxPeriod;
  int32_t* scores = scores_o + (int64_t)job * kMaxPeriod;

  int node = node0;
  int period = 0;
  bool found = false, ovf = false;
  for (int l = 0; l < lmax; ++l) {
    const int fdig = node / k1;
    const int fsc = fwd ? lookup(rsv, rsc, v_pad, node) : 0;
    const int max_la = l < 10 ? 1 : k;
    int tie = 0;   // this lane's tie, valid for lane < tcnt
    int tcnt = 1;
    int md = 0;
    int m_out = max_la + 1;
    for (int m = 1; m <= max_la; ++m) {
      const int km = pow4(k - m), pm1 = pow4(m - 1), pm = pow4(m);
      const bool valid = lane < tcnt;
      int cand[4], cnt[4];
      int best = -1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lsd = 4 * tie + j;    // forward: append base j
        const int msd = j * pm1 + tie;  // backward: prepend base j
        cand[j] = fwd ? lsd : msd;
        const int key = fwd ? pm * (node % km) + lsd : msd * km + node / pm;
        cnt[j] = valid ? lookup(rsv, rsc, v_pad, key) : -1;
        best = max(best, cnt[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        best = max(best, __shfl_xor_sync(kFull, best, off));
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (valid && cnt[j] == best) bits |= 1u << j;
      const int c = __popc(bits);
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      const int nt = __shfl_sync(kFull, incl, 31);
      const unsigned has = __ballot_sync(kFull, bits != 0);
      int mine = 0;
#pragma unroll
      for (int j = 3; j >= 0; --j)
        if (bits & (1u << j)) mine = cand[j];  // lowest set j wins
      md = __shfl_sync(kFull, mine, __ffs(has) - 1);
      if (nt > kTies) ovf = true;
      if (fwd ? nt == 1 : nt <= 1) {
        m_out = m;
        break;
      }
      // the r-th maximal candidate (r < 32) becomes lane r's tie
      int r = incl - c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (bits & (1u << j)) {
          if (r < kTies) s_ties[w][r] = cand[j];
          ++r;
        }
      }
      __syncwarp();
      tie = s_ties[w][lane];
      __syncwarp();
      tcnt = min(nt, kTies);
    }
    if (fwd) {
      node = 4 * (node % k1) + md / pow4(m_out - 1);
    } else {
      node = (md % 4) * k1 + node / 4;
    }
    if (lane == 0) {
      units[l] = fwd ? fdig : node / k1;
      scores[l] = fwd ? fsc : lookup(rsv, rsc, v_pad, node);
    }
    if (node == node0) {
      period = l + 1;
      found = l + 1 < kMaxPeriod;
      break;
    }
  }
  if (lane == 0) {
    found_o[job] = found ? 1 : 0;
    period_o[job] = period;
    ovf_o[job] = ovf ? 1 : 0;
  }
}

}  // namespace

// C entry point for ctypes.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int mtr_dbg_walk_v1(const void* sv, const void* sc,
                               int v_pad,
                               const void* tq, const void* node0,
                               const void* is_fwd, const void* k,
                               const void* lmax, int n_jobs, void* found,
                               void* period, void* units, void* scores,
                               void* ovf, void* stream) {
  if (n_jobs <= 0) return 0;
  dbg_walk_kernel<<<(n_jobs + kWarps - 1) / kWarps, kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(sv), static_cast<const int32_t*>(sc),
      v_pad, static_cast<const int32_t*>(tq),
      static_cast<const int32_t*>(node0), static_cast<const int32_t*>(is_fwd),
      static_cast<const int32_t*>(k), static_cast<const int32_t*>(lmax),
      n_jobs, static_cast<uint8_t*>(found), static_cast<int32_t*>(period),
      static_cast<int32_t*>(units), static_cast<int32_t*>(scores),
      static_cast<uint8_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}
