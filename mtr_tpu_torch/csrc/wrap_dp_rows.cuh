// Device helpers of the one-block-per-job wrap-around DP kernels
// (wrap_dp_consensus.cu, and wrap_dp_counts_block.cu, the counts kernel's
// first design): one thread per unit column, rows strictly sequential.
#pragma once

#include <cuda_runtime.h>

namespace mtr {

constexpr unsigned kFull = 0xffffffffu;

// The in-row deletion chain D[i][j] = max(m_j, D[i][j-1] - ip), reset at
// match cells and j == 0, is a segmented inclusive max scan of
// v = m + ip*j (the caller subtracts ip*j again).  Step 1, inside the
// warp: `seg` enters as "a segment starts at this lane" and leaves as "a
// segment starts at or left of this lane, inside this warp"; lane 31
// publishes the warp's tail value and whether the warp holds a start.
// The caller places a block barrier between the two steps.
__device__ __forceinline__ int seg_max_scan_warp(int v, bool& seg, int lane,
                                                 int w, int* s_wv,
                                                 int* s_wf) {
  const unsigned starts = __ballot_sync(kFull, seg);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int nv = __shfl_up_sync(kFull, v, d);
    const int nf = __shfl_up_sync(kFull, (int)seg, d);
    if (lane >= d && !seg) {
      v = max(v, nv);
      seg = nf != 0;
    }
  }
  if (lane == 31) {
    s_wv[w] = v;
    s_wf[w] = starts != 0u;
  }
  return v;
}

// Step 2, after the barrier: a lane whose segment starts in an earlier
// warp folds in the tails of the warps back to that start.
__device__ __forceinline__ int seg_max_scan_close(int v, bool seg, int w,
                                                  const int* s_wv,
                                                  const int* s_wf) {
  if (!seg) {
    for (int k = w - 1; k >= 0; --k) {
      v = max(v, s_wv[k]);
      if (s_wf[k]) break;
    }
  }
  return v;
}

// Row-major-first argmax order: larger value, then smaller row, then
// smaller lane.
__device__ __forceinline__ bool argmax_before(int ov, int oi, int oj, int kv,
                                              int ki, int kj) {
  return ov > kv || (ov == kv && (oi < ki || (oi == ki && oj < kj)));
}

// Reduce each thread's (value, row, lane) across its warp; lane 0 holds
// the warp's winner.
__device__ __forceinline__ void argmax_warp(int& kv, int& ki, int& kj) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_down_sync(kFull, kv, off);
    const int oi = __shfl_down_sync(kFull, ki, off);
    const int oj = __shfl_down_sync(kFull, kj, off);
    if (argmax_before(ov, oi, oj, kv, ki, kj)) {
      kv = ov;
      ki = oi;
      kj = oj;
    }
  }
}

}  // namespace mtr
