// The row step of the one-warp-per-job wrap-around DP kernels
// (wrap_dp_counts.cu, wrap_dp_consensus.cu): lane l holds unit columns
// l*C .. l*C+C-1 of one job in registers, C = ceil(unit_len/32) a template
// parameter, and a row is computed without shared memory or barriers.
#pragma once

#include <cuda_runtime.h>

namespace mtr_warp {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool bit(unsigned m, int c) { return (m >> c) & 1u; }

// a[k] for a warp-uniform k (column U-1's slot in its lane): one switch,
// not a select per column
#define MTR_PICK_CASE(N)                 \
  case N:                                \
    if constexpr (N < C) v = a[N];       \
    break;
template <int C>
__device__ __forceinline__ int pick(const int (&a)[C], int k) {
  int v = 0;
  switch (k) {
    MTR_PICK_CASE(0) MTR_PICK_CASE(1) MTR_PICK_CASE(2) MTR_PICK_CASE(3)
    MTR_PICK_CASE(4) MTR_PICK_CASE(5) MTR_PICK_CASE(6) MTR_PICK_CASE(7)
    MTR_PICK_CASE(8) MTR_PICK_CASE(9) MTR_PICK_CASE(10) MTR_PICK_CASE(11)
    MTR_PICK_CASE(12) MTR_PICK_CASE(13) MTR_PICK_CASE(14) MTR_PICK_CASE(15)
  }
  return v;
}
#undef MTR_PICK_CASE

// One row's final values d[c] (0 past the unit) from the previous row
// prev[] and up_v, the previous row's column base_j - 1 (lane 0: the wrap
// column U-1):
//   - the candidates: a match takes diag + mg, else max(0, diag - mp,
//     prev - ip);
//   - the deletion chain D[j] = max(m_j, D[j-1] - ip), reset at match
//     cells and j == 0: a serial running max inside the lane (DPX
//     __viaddmax_s32), one segmented max scan over the 32 lane tails in
//     D[j] + ip*j (one shuffle a step: a lane takes its neighbour only
//     while the neighbour lies in its own segment, found by ballot and
//     __clz), then the lane's chain again from the carried value.
// Every lane of the warp calls it.  n_valid = unit_len - base_j.
template <int C>
__device__ __forceinline__ void row_values(const int (&u)[C], int code,
                                           const int (&prev)[C], int up_v,
                                           int mg, int mp, int ip, int lane,
                                           int base_j, int n_valid,
                                           int (&d)[C]) {
  unsigned seg = lane == 0 ? 1u : 0u;  // chain resets: matches and j == 0
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int diag = c ? prev[c - 1] : up_v;
    const bool mi = u[c] == code;
    seg |= (unsigned)mi << c;
    d[c] = mi ? diag + mg : __vimax_s32_relu(diag - mp, prev[c] - ip);
  }
  int t = d[0];
#pragma unroll
  for (int c = 1; c < C; ++c)
    t = bit(seg, c) ? d[c] : __viaddmax_s32(t, -ip, d[c]);

  int tt = t + ip * (base_j + C - 1);
  const unsigned sb = __ballot_sync(kFull, seg != 0u);
  const int seg_lane = 31 - __clz(sb & ((2u << lane) - 1u));
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int o = __shfl_up_sync(kFull, tt, s);
    if (lane - s >= seg_lane) tt = max(tt, o);
  }
  // D at column base_j - 1 (lane 0 starts a segment: unused there)
  int x = __shfl_up_sync(kFull, tt, 1) - ip * (base_j - 1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x = bit(seg, c) ? d[c] : __viaddmax_s32(x, -ip, d[c]);
    d[c] = c < n_valid ? x : 0;
  }
}

}  // namespace mtr_warp
