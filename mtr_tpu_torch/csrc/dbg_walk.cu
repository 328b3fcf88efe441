// Greedy De Bruijn walks on Hopper (sm_90a), settled on the card: the walk
// half of search_De_Bruijn_graph (consensus.c:299-335, 384-423, 534-573),
// one block per query row of a chunk's stage-A tables.
//
// Replaces mtr_tpu/ops/dbg_device.py:132 _stage_b (a jitted pair of
// lax.fori_loops, not Pallas) together with the host's job table and
// winner selection.  The plain PyTorch statement of the same function is
// mtr_tpu_torch/ops/dbg_device.py::walk_rows_plain (stage_b_plain's walks
// in rank groups); the first design (one warp a speculative job, a binary
// search of up to 17 dependent global loads a lookup) was slower on every
// launch timed, and is no longer kept.
//
// What bounds it: latency.  A walk is a chain of steps, a step a chain of
// lookahead rounds (m = 1 .. max_la, max_la = k after the first 10 steps),
// and a round needs the live counts of 4 x (ties) candidate k-mers.  The
// operations and bytes are tiny against the card's rates; what counts is
// the dependent latency of one round, and that the host never waits for a
// chunk: the kernel reads stage A's outputs as they lie on the card and
// writes each query's result and winning rows where one pull a call reads
// them.
//
// Design: one block per table row (query); a row whose maxfreq is at most
// MIN_NUM_FREQ_UNIT exits at once (not gated).  Any other block stages its
// row's search level in shared memory once: the whole sorted row when
// v_pad <= 32,768 (128 KB), else every second value (the last of each
// 2-element segment: V 65,536).  A lookup is then a branchless lower bound
// in shared memory (log2 of the level's length + 1 dependent shared loads)
// and at most ONE global load: the live count at the position (stride 1,
// only when the key is present), or the segment's two values and counts
// (one 8-byte vector each, stride 2).  A lane runs its 4 candidates'
// searches in lockstep.
//
// The block's warps are G forward walkers and G backward walkers (G = 2
// below v_pad 8,192, where many small rows share an SM; G = 8 from there
// up, where the staged level lets at most three blocks onto an SM and a
// row with many max nodes would else walk them in up to 50 rounds).  Each
// direction takes the row's listed max nodes in rank order, G at a time,
// one warp a node, and stops after the first group in which some walk
// loops (found: period < 500); the lowest looping rank wins.  That is the
// reference's own order (walk the nodes in turn, stop at the first loop),
// so the winner is the speculative design's.  A walk whose direction has
// found a unit at a lower rank of its group stops at its next step: it
// cannot win, and nothing reads its overflow, so a round lasts as long as
// the walks up to its winner rather than its longest walk.  A query is
// bad (the host engine re-walks it) when a walk overflowed its tie list at
// or before the winner's rank in either direction, or anywhere in a
// direction without a winner.  Each walk records its units (digits 0..3)
// and scores in the warp's shared row; the winner's row is copied out cut
// to its period, reversed for backward walks, at an offset a 64-bit slot
// counter hands out.  Per row the kernel writes (fwd_period, bwd_period,
// found_last, bad) and the two rows' offsets (-1 without a winner).
//
// A walk: lane t holds tie t (T_DEV = 32) and its 4 candidate extensions
// in JAX's order (index 4t + j); the best count is a warp max
// (__reduce_max_sync), the candidates that reach it a 4-bit mask per
// lane, their number nt and ranks from three ballots; the first one
// (lowest 4t + j) is md, and the r-th one becomes tie r of the next round
// through 32 ints of shared memory per warp.  nt > 32 sets the overflow
// flag.  Forward breaks at nt == 1, backward at nt <= 1; a lookahead that
// never breaks leaves m = max_la + 1 (consensus.c:335).  Forward records
// the current node's digit and score before stepping, backward the new
// node's after (its score one step late: the current node's score rides
// the next step's first round as a fifth lookup on lane 1).  A warp ends
// at its own loop or at lmax steps; every value a warp branches on is
// warp-uniform, every value the block branches on block-uniform.
//
// Bounds (checked by the host): 1 <= k <= 15 (codes < 4^15 fit int32),
// lmax <= 500, 1 <= n_nodes <= 100 on gated rows, v_pad a power of two in
// 64 .. 65,536, tables 16-byte aligned, the row buffers large enough for
// 2 x lmax entries a row.  The kernel allocates nothing and launches on the
// caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPeriod = 500;
constexpr int kTies = 32;          // T_DEV
constexpr int kWideV = 1 << 13;    // v_pad from which a direction has 8 warps
constexpr int kMaxNodes = 100;     // MAX_NUM_MAXNODES
constexpr int kMinFreq = 5;        // MIN_NUM_FREQ_UNIT
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

// Max nodes a direction walks at once at table width v_pad.
__host__ __device__ constexpr int group_of(int v_pad) {
  return v_pad >= kWideV ? 8 : 2;
}

// One walk from node0 by the calling warp, rank g of its direction's
// group; lane 0 records its units and scores in urow / srow (the steps it
// takes).  Returns the period (0 when it never loops, or when it stops
// because *lead, the lowest rank of the group found so far, fell below g)
// and sets found and ovf, all warp-uniform.  A found walk lowers *lead.
template <int S>
__device__ int walk(const int* top, int n_top, const int32_t* __restrict__ rsv,
                    const int32_t* __restrict__ rsc, int node0, bool fwd,
                    int k, int lmax, int g, int* lead, int* ties,
                    uint8_t* urow, int* srow, bool& found, bool& ovf) {
  const int lane = threadIdx.x & 31;
  const int s_k1 = sh4(k - 1);  // k1 = 4^(k-1)
  const int k1_mask = (1 << s_k1) - 1;
  int node = node0;
  int sc0 = 0;  // score of node0: a backward walk's last one when it loops
  found = false;
  ovf = false;
  for (int l = 0; l < lmax; ++l) {
    // lane 0's read, shared, keeps the exit warp-uniform
    if (__shfl_sync(kFull, *static_cast<volatile int*>(lead), 0) < g)
      return 0;
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
      lookup4<S>(top, n_top, rsv, rsc, key,
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
          if (r < kTies) ties[r] = cand[j];
          ++r;
        }
      }
      __syncwarp();
      tie = ties[lane];
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
        urow[l] = static_cast<uint8_t>(fdig);
        srow[l] = cur_sc;
      } else {
        urow[l] = static_cast<uint8_t>(node >> s_k1);
        if (l > 0) srow[l - 1] = cur_sc;  // this step's current node
      }
    }
    if (node == node0) {
      found = l + 1 < kMaxPeriod;
      if (!fwd && lane == 0) srow[l] = sc0;
      if (found && lane == 0) atomicMin(lead, g);
      return l + 1;
    }
  }
  return 0;
}

template <int S, int G>
__global__ void __launch_bounds__(2 * G * 32)
dbg_walk_rows_kernel(const int32_t* __restrict__ sv,
                     const int32_t* __restrict__ sc, int v_pad,
                     const int32_t* __restrict__ maxfreq,
                     const int32_t* __restrict__ n_nodes,
                     const int32_t* __restrict__ nodes,
                     const int32_t* __restrict__ k_a,
                     const int32_t* __restrict__ lmax_a,
                     int32_t* __restrict__ tab_o,   // (rows, 4)
                     int64_t* __restrict__ off_o,   // (rows, 2)
                     uint8_t* __restrict__ units_o,
                     int32_t* __restrict__ scores_o,
                     unsigned long long* __restrict__ used) {
  constexpr int kWarps = 2 * G;  // forward walkers, then backward
  extern __shared__ int s_top[];  // v_pad / S entries
  __shared__ int s_ties[kWarps][kTies];
  __shared__ uint8_t s_units[kWarps][kMaxPeriod];
  __shared__ int s_scores[kWarps][kMaxPeriod];
  __shared__ int s_period[kWarps];
  __shared__ int s_found[kWarps], s_ovf[kWarps];
  __shared__ int s_next[2], s_open[2], s_win[2], s_per[2], s_lead[2], s_bad;
  __shared__ long long s_off[2];

  const int row = blockIdx.x;
  int32_t* tab = tab_o + 4 * (int64_t)row;
  int64_t* off = off_o + 2 * (int64_t)row;
  if (maxfreq[row] <= kMinFreq) {  // not gated: the whole block leaves
    if (threadIdx.x < 4) tab[threadIdx.x] = 0;
    if (threadIdx.x < 2) off[threadIdx.x] = -1;
    return;
  }
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
  if (threadIdx.x < 2) {
    s_next[threadIdx.x] = 0;
    s_open[threadIdx.x] = 1;
    s_per[threadIdx.x] = 0;
    s_lead[threadIdx.x] = G;
    s_off[threadIdx.x] = -1;
  }
  if (threadIdx.x == 0) s_bad = 0;
  __syncthreads();

  const int nn = min(n_nodes[row], kMaxNodes);
  const int k = k_a[row];
  const int lmax = lmax_a[row];
  const int32_t* row_nodes = nodes + (int64_t)row * kMaxNodes;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int d = w / G;  // 0 forward, 1 backward
  const int g = w % G;

  while (s_open[0] | s_open[1]) {
    // ---- a round: each open direction walks its next G ranks ----
    const int rank = s_next[d] + g;
    bool found = false, ovf = false;
    int period = 0;
    if (s_open[d] && rank < nn)
      period = walk<S>(s_top, n_top, rsv, rsc, row_nodes[rank], d == 0, k,
                       lmax, g, &s_lead[d], s_ties[w], s_units[w],
                       s_scores[w], found, ovf);
    if (lane == 0) {
      s_found[w] = found;
      s_ovf[w] = ovf;
      s_period[w] = period;
    }
    __syncthreads();
    // ---- settle: the lowest looping rank wins; overflows at or before ----
    if (threadIdx.x < 2) {
      const int dd = threadIdx.x;
      int win = -1;
      s_lead[dd] = G;  // every walk of the round has returned
      if (s_open[dd]) {
        bool bad = false;
        for (int gg = 0; gg < G && s_next[dd] + gg < nn; ++gg) {
          const int ww = dd * G + gg;
          bad |= s_ovf[ww] != 0;
          if (s_found[ww]) {
            win = ww;
            break;
          }
        }
        if (bad) atomicOr(&s_bad, 1);
        if (win >= 0) {
          const int p = s_period[win];
          s_per[dd] = p;
          s_off[dd] = static_cast<long long>(
              atomicAdd(used, static_cast<unsigned long long>(p)));
          s_open[dd] = 0;
        } else {
          s_next[dd] += G;
          if (s_next[dd] >= nn) s_open[dd] = 0;
        }
      }
      s_win[dd] = win;
    }
    __syncthreads();
    // ---- copy out this round's winning rows, cut and oriented ----
#pragma unroll
    for (int dd = 0; dd < 2; ++dd) {
      const int win = s_win[dd];
      if (win < 0) continue;
      const int p = s_per[dd];
      const long long o = s_off[dd];
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int src = dd == 0 ? i : p - 1 - i;
        units_o[o + i] = s_units[win][src];
        scores_o[o + i] = s_scores[win][src];
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    tab[0] = s_per[0];
    tab[1] = s_per[1];
    tab[2] = s_per[1] > 0;  // found_last: the backward walk found a unit
    tab[3] = s_bad;
    off[0] = s_off[0];
    off[1] = s_off[1];
  }
}

template <int S, int G>
int launch(const void* sv, const void* sc, int v_pad, int n_rows,
           const void* maxfreq, const void* n_nodes, const void* nodes,
           const void* k, const void* lmax, void* tab, void* off,
           void* units, void* scores, void* used, cudaStream_t stream) {
  const int smem = v_pad / S * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dbg_walk_rows_kernel<S, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kTopMax * 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  dbg_walk_rows_kernel<S, G><<<n_rows, 2 * G * 32, smem, stream>>>(
      static_cast<const int32_t*>(sv), static_cast<const int32_t*>(sc),
      v_pad, static_cast<const int32_t*>(maxfreq),
      static_cast<const int32_t*>(n_nodes),
      static_cast<const int32_t*>(nodes), static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(lmax), static_cast<int32_t*>(tab),
      static_cast<int64_t*>(off), static_cast<uint8_t*>(units),
      static_cast<int32_t*>(scores),
      static_cast<unsigned long long*>(used));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point for ctypes: one block per row of a chunk's tables.
// sv / sc (n_rows, v_pad), maxfreq / n_nodes / k / lmax (n_rows,), nodes
// (n_rows, 100), all int32; out tab (n_rows, 4) int32, off (n_rows, 2)
// int64, the row buffers units (uint8) / scores (int32) and their slot
// counter used (one uint64, advanced by each winning row's period).
// Returns the cudaError_t of the launch (0 on success); an unsupported
// v_pad returns cudaErrorInvalidValue.  mtr_dbg_walk_group(v_pad): the
// max nodes a direction walks at once at that width.
extern "C" int mtr_dbg_walk_group(int v_pad) { return group_of(v_pad); }

extern "C" int mtr_dbg_walk_rows(const void* sv, const void* sc, int v_pad,
                                 int n_rows, const void* maxfreq,
                                 const void* n_nodes, const void* nodes,
                                 const void* k, const void* lmax, void* tab,
                                 void* off, void* units, void* scores,
                                 void* used, void* stream) {
  if (n_rows <= 0) return 0;
  if (v_pad < 64 || v_pad > 2 * kTopMax || (v_pad & (v_pad - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v_pad < kWideV)
    return launch<1, group_of(1)>(sv, sc, v_pad, n_rows, maxfreq, n_nodes,
                                  nodes, k, lmax, tab, off, units, scores,
                                  used, s);
  if (v_pad <= kTopMax)
    return launch<1, group_of(kWideV)>(sv, sc, v_pad, n_rows, maxfreq,
                                       n_nodes, nodes, k, lmax, tab, off,
                                       units, scores, used, s);
  return launch<2, group_of(kWideV)>(sv, sc, v_pad, n_rows, maxfreq, n_nodes,
                                     nodes, k, lmax, tab, off, units, scores,
                                     used, s);
}
