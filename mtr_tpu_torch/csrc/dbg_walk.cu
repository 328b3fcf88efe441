// Speculative greedy De Bruijn walks on Hopper (sm_90a): the walk half of
// search_De_Bruijn_graph (consensus.c:299-335, 384-423, 534-573), one walk
// per (query, direction, start node) job.
//
// Replaces mtr_tpu/ops/dbg_device.py:132 _stage_b (a jitted pair of
// lax.fori_loops, not Pallas).  The plain PyTorch statement of the same
// function is mtr_tpu_torch/ops/dbg_device.py::stage_b_plain; the first
// design (one warp a job, a binary search of up to 17 dependent global
// loads a lookup) is csrc/dbg_walk_v1.cu, kept as a yardstick.
//
// What bounds it: latency.  A walk is a chain of steps, a step a chain of
// lookahead rounds (m = 1 .. max_la, max_la = k after the first 10 steps),
// and a round needs the live counts of 4 x (ties) candidate k-mers.  On
// the bench set a launch lasts its slowest walk: 500 steps that never
// loop, with tie lists of 32 through all k rounds (measured: ~61 lookups a
// step over a launch's jobs).  The operations and bytes are tiny against
// the card's rates; what counts is the dependent latency of one round.
//
// Design: one block per (query row, up to kWarps of its jobs), one warp
// per job.  The block first stages the row's search level in shared
// memory: the whole sorted row when v_pad <= 32,768 (128 KB), else every
// second value (the last of each 2-element segment: V 65,536).  A lookup
// is then a branchless lower bound in shared memory (log2 of the level's
// length + 1 dependent shared loads) and at most ONE global load: the
// live count at the position (stride 1, only when the key is present: a
// dead end costs no global load), or the segment's two values and counts
// (one 8-byte vector each, stride 2).  A lane runs its 4 candidates'
// searches in lockstep, so a round costs one shared-search chain and at
// most one global latency, against up to 17 dependent global loads in
// the first design.  The round's warp max is one __reduce_max_sync and
// the candidates' ranks come from three ballots.  The score of the walk's
// current node rides the first round as a fifth lookup on lane 1 (free
// there: a lookahead starts from one tie), so a step adds no round of its
// own; a backward walk records it one step late, and looks up its last
// node once when it ends without a loop.
//
// Everything else is the first design's: lane t holds tie t (T_DEV = 32)
// and its 4 candidate extensions in JAX's order (index 4t + j); the best
// count is a warp max, the candidates that reach it a 4-bit mask per
// lane, their number nt the warp sum of the popcounts; the first one
// (lowest 4t + j) is md, and the r-th one becomes tie r of the next
// round through 32 ints of shared memory per warp.  nt > 32 sets the
// overflow flag (the host re-walks the query).  Forward breaks at nt == 1,
// backward at nt <= 1; a lookahead that never breaks leaves m = max_la + 1
// (consensus.c:335).  Forward records the current node's digit and score
// before stepping, backward the new node's after.  A warp ends at its own
// loop or at lmax steps; every value a warp branches on is warp-uniform.
//
// Bounds (checked by the wrapper): 1 <= k <= 15 (codes < 4^15 fit int32),
// 0 <= row < rows of the tables, lmax <= 500, v_pad a power of two in
// 64 .. 65,536, tables 16-byte aligned.  Outputs units/scores are zeroed
// by the wrapper; the kernel writes only the steps a walk takes.  The
// kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPeriod = 500;
constexpr int kTies = 32;          // T_DEV
constexpr int kWarps = 2;          // jobs of one row a block
constexpr int kTopMax = 1 << 15;   // shared search level: 128 KB
constexpr unsigned kFull = 0xffffffffu;

// 4^e as a shift, e clipped to 0 .. 15: the codes are base-4 numbers, so
// every division and remainder by a power of 4 is a shift or a mask
__device__ __forceinline__ int sh4(int e) { return 2 * min(max(e, 0), 15); }

__device__ __forceinline__ bool bit(unsigned m, int j) {
  return (m >> j) & 1u;
}

// Live counts of up to 4 keys (slot j when bit j of `live`, else 0) in one
// sorted row: jnp.searchsorted(side="left") clipped to the row, 0 where
// the value there is not the key.  top holds n_top (a power of two)
// ascending values: the row (S = 1) or each S-segment's last value.
template <int S>
__device__ __forceinline__ void lookup4(const int* top, int n_top,
                                        const int32_t* __restrict__ rsv,
                                        const int32_t* __restrict__ rsc,
                                        const int (&key)[4], unsigned live,
                                        int (&out)[4]) {
  int pos[4] = {0, 0, 0, 0};
  for (int step = n_top >> 1; step > 0; step >>= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pos[j] += top[pos[j] + step - 1] < key[j] ? step : 0;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // the first entry >= key, n_top if none (then every value < key)
    const int c = pos[j] + (top[pos[j]] < key[j] ? 1 : 0);
    int r = 0;
    if (bit(live, j) && c < n_top) {
      if constexpr (S == 1) {
        if (top[c] == key[j]) r = __ldg(rsc + c);
      } else {
        // the segment's first match is the key's first position
        const int2 v = __ldg(reinterpret_cast<const int2*>(rsv) + c);
        const int2 n = __ldg(reinterpret_cast<const int2*>(rsc) + c);
        r = v.x == key[j] ? n.x : v.y == key[j] ? n.y : 0;
      }
    }
    out[j] = r;
  }
}

template <int S>
__global__ void __launch_bounds__(kWarps * 32)
dbg_walk_kernel(const int32_t* __restrict__ sv,
                const int32_t* __restrict__ sc, int v_pad,
                const int32_t* __restrict__ blocks,  // (row, first, count)
                const int32_t* __restrict__ perm,
                const int32_t* __restrict__ node0_a,
                const int32_t* __restrict__ fwd_a,
                const int32_t* __restrict__ k_a,
                const int32_t* __restrict__ lmax_a,
                uint8_t* __restrict__ found_o, int32_t* __restrict__ period_o,
                int32_t* __restrict__ units_o, int32_t* __restrict__ scores_o,
                uint8_t* __restrict__ ovf_o) {
  extern __shared__ int s_top[];  // v_pad / S entries
  __shared__ int s_ties[kWarps][kTies];
  const int row = blocks[3 * blockIdx.x];
  const int first = blocks[3 * blockIdx.x + 1];
  const int count = blocks[3 * blockIdx.x + 2];
  const int n_top = v_pad / S;
  const int32_t* rsv = sv + (int64_t)row * v_pad;
  const int32_t* rsc = sc + (int64_t)row * v_pad;

  // ---- stage the row's search level ----
  if constexpr (S == 1) {
    const int4* src = reinterpret_cast<const int4*>(rsv);
    int4* dst = reinterpret_cast<int4*>(s_top);
    for (int i = threadIdx.x; i < n_top / 4; i += blockDim.x)
      dst[i] = __ldg(src + i);
  } else {
    for (int i = threadIdx.x; i < n_top; i += blockDim.x)
      s_top[i] = __ldg(rsv + i * S + S - 1);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  if (w >= count) return;  // the whole warp leaves together
  const int job = perm[first + w];
  const int node0 = node0_a[job];
  const bool fwd = fwd_a[job] != 0;
  const int k = k_a[job];
  const int lmax = lmax_a[job];
  const int s_k1 = sh4(k - 1);  // k1 = 4^(k-1)
  const int k1_mask = (1 << s_k1) - 1;
  int32_t* units = units_o + (int64_t)job * kMaxPeriod;
  int32_t* scores = scores_o + (int64_t)job * kMaxPeriod;

  int node = node0;
  int period = 0;
  int sc0 = 0;  // score of node0: a backward walk's last one when it loops
  bool found = false, ovf = false;
  int l = 0;
  for (; l < lmax; ++l) {
    const int fdig = node >> s_k1;
    const int max_la = l < 10 ? 1 : k;
    int tie = 0;   // this lane's tie, valid for lane < tcnt
    int tcnt = 1;
    int md = 0;
    int m_out = max_la + 1;
    int cur_sc = 0;  // score of the current node (round 1, lane 1)
    for (int m = 1; m <= max_la; ++m) {
      const int s_km = sh4(k - m), s_pm1 = sh4(m - 1), s_pm = sh4(m);
      const bool valid = lane < tcnt;
      const bool score_lane = m == 1 && lane == 1;  // tcnt == 1 here
      int cand[4], key[4], cnt[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int lsd = 4 * tie + j;    // forward: append base j
        const int msd = (j << s_pm1) + tie;  // backward: prepend base j
        cand[j] = fwd ? lsd : msd;
        key[j] = fwd ? ((node & ((1 << s_km) - 1)) << s_pm) + lsd
                     : (msd << s_km) + (node >> s_pm);
      }
      if (score_lane) key[0] = node;
      lookup4<S>(s_top, n_top, rsv, rsc, key,
                 valid ? 0xfu : score_lane ? 1u : 0u, cnt);
      if (m == 1) cur_sc = __shfl_sync(kFull, cnt[0], 1);
      int best = -1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!valid) cnt[j] = -1;
        best = max(best, cnt[j]);
      }
      best = __reduce_max_sync(kFull, best);
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (valid && cnt[j] == best) bits |= 1u << j;
      // each lane's count c (0..4) of maximal candidates: its rank base
      // and the total from three ballots of c's bits
      const int c = __popc(bits);
      const unsigned b0 = __ballot_sync(kFull, c & 1);
      const unsigned b1 = __ballot_sync(kFull, c & 2);
      const unsigned b2 = __ballot_sync(kFull, c & 4);
      const unsigned lt = (1u << lane) - 1u;
      const int incl = c + __popc(b0 & lt) + 2 * __popc(b1 & lt) +
                       4 * __popc(b2 & lt);
      const int nt = __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
      const unsigned has = b0 | b1 | b2;
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
    if (l == 0) sc0 = cur_sc;
    if (fwd) {
      node = ((node & k1_mask) << 2) + (md >> sh4(m_out - 1));
    } else {
      node = ((md & 3) << s_k1) + (node >> 2);
    }
    if (lane == 0) {
      if (fwd) {
        units[l] = fdig;
        scores[l] = cur_sc;
      } else {
        units[l] = node >> s_k1;
        if (l > 0) scores[l - 1] = cur_sc;  // this step's current node
      }
    }
    if (node == node0) {
      period = l + 1;
      found = l + 1 < kMaxPeriod;
      if (!fwd && lane == 0) scores[l] = sc0;
      break;
    }
  }
  if (!fwd && period == 0 && l > 0) {
    // a backward walk that ran out of steps: its last node's score
    const int key[4] = {node, 0, 0, 0};
    int cnt[4];
    lookup4<S>(s_top, n_top, rsv, rsc, key, lane == 0 ? 1u : 0u, cnt);
    if (lane == 0) scores[l - 1] = cnt[0];
  }
  if (lane == 0) {
    found_o[job] = found ? 1 : 0;
    period_o[job] = period;
    ovf_o[job] = ovf ? 1 : 0;
  }
}

template <int S>
int launch(const void* sv, const void* sc, int v_pad, const void* blocks,
           int n_blocks, const void* perm, const void* node0,
           const void* is_fwd, const void* k, const void* lmax, void* found,
           void* period, void* units, void* scores, void* ovf,
           cudaStream_t stream) {
  const int smem = v_pad / S * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dbg_walk_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTopMax * 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  dbg_walk_kernel<S><<<n_blocks, kWarps * 32, smem, stream>>>(
      static_cast<const int32_t*>(sv), static_cast<const int32_t*>(sc),
      v_pad, static_cast<const int32_t*>(blocks),
      static_cast<const int32_t*>(perm), static_cast<const int32_t*>(node0),
      static_cast<const int32_t*>(is_fwd), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(lmax), static_cast<uint8_t*>(found),
      static_cast<int32_t*>(period), static_cast<int32_t*>(units),
      static_cast<int32_t*>(scores), static_cast<uint8_t*>(ovf));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point for ctypes.  blocks (n_blocks, 3) int32: a block's table
// row, its first index into perm and its job count (1 .. 2: jobs_per_block
// below); perm (J,) int32 job indices grouped by row.  Returns the
// cudaError_t of the launch (0 on success); an unsupported v_pad returns
// cudaErrorInvalidValue.
extern "C" int mtr_dbg_walk_jobs_per_block() { return kWarps; }

extern "C" int mtr_dbg_walk(const void* sv, const void* sc, int v_pad,
                            const void* blocks, int n_blocks,
                            const void* perm, const void* node0,
                            const void* is_fwd, const void* k,
                            const void* lmax, void* found, void* period,
                            void* units, void* scores, void* ovf,
                            void* stream) {
  if (n_blocks <= 0) return 0;
  if (v_pad < 64 || v_pad > 2 * kTopMax || (v_pad & (v_pad - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v_pad <= kTopMax)
    return launch<1>(sv, sc, v_pad, blocks, n_blocks, perm, node0, is_fwd, k,
                     lmax, found, period, units, scores, ovf, s);
  return launch<2>(sv, sc, v_pad, blocks, n_blocks, perm, node0, is_fwd, k,
                   lmax, found, period, units, scores, ovf, s);
}
