// Counts-mode wrap-around DP on Hopper (sm_90a): the fill plus traceback
// counts of wrap_around_DP.c:222-354, one (B, 15) int32 row per job.
//
// Replaces the three Pallas TPU kernels that compute this function:
//   mtr_tpu/ops/wrap_dp_fused2.py::_fused2_kernel    units <= 128  (U_SPAN 128)
//   mtr_tpu/ops/wrap_dp_fused2w.py::_fused2w_kernel  units 129-256 (U_SPAN 256)
//   mtr_tpu/ops/wrap_dp_fused.py::_fused_kernel      units 257-500 (U_SPAN 512)
// They differ only in how they work around TPU limits (the 128-lane
// gather, sublane vs lane layout, int32 payload packing); none of those
// limits exists here, so one template stands for all three and payloads
// stay unpacked int32.  The plain PyTorch statement of the same function
// is mtr_tpu_torch/ops/wrap_dp_counts.py::wrap_dp_counts_plain.
//
// Design: one thread block per job, one thread per unit column j.  The
// DP rows are strictly sequential (row i reads row i-1, and the in-row
// deletion chain and the aux copy are prefix scans across the row), so a
// job is bound by the LATENCY of one row: three block barriers, a warp
// shuffle scan and a few shared-memory reads.  Throughput comes from many
// jobs in flight (several blocks per SM); the batcher launches its
// longest jobs first so they do not start last.  Per row:
//   A  match / diag / insertion candidates; the deletion chain
//      D[i][j] = max(m_j, D[i][j-1] - ip) (reset at match cells and
//      j == 0) as a segmented inclusive max scan of m + ip*j: warp
//      __shfl_up_sync, then one shared-memory pass across warps;
//   B  publish the row; read the previous row's aux payloads;
//   C  traceback precedence match > mismatch > deletion > insertion on
//      final values selects each cell's aux base (m, ins, si);
//      deletion cells copy the payload of their nearest non-deletion
//      origin to the left, found with one ballot per warp; cells whose
//      whole prefix is deletions take the last lane's origin (the wrap);
//   D  gather the payloads from shared memory; per-thread argmax with a
//      strict > (first row wins).
// A block reduction resolves the argmax row-major-first at the end: max
// value, then smallest row, then smallest lane.
//
// Rep codes are read straight from the batch's resident flat reads at
// flat[start + i], staged U_SPAN codes at a time in shared memory.
// Bounds (checked by the dispatcher): rep_len <= 2^20, unit_len <= U_SPAN,
// rep_len*mg + ip*U_SPAN < 2^31, start + rep_len <= len(flat), ip >= 1.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wrap_dp_rows.cuh"

namespace {

using mtr::kFull;

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Highest k' <= k whose non-deletion bit is set in the per-warp ballots,
// or -1 when the whole prefix [0, k] is deletions.
__device__ __forceinline__ int origin_of(int k, const unsigned* ball) {
  int w = k >> 5;
  unsigned msk = ball[w] & ((2u << (k & 31)) - 1u);
  while (!msk) {
    if (--w < 0) return -1;
    msk = ball[w];
  }
  return (w << 5) + 31 - __clz(msk);
}

template <int U_SPAN>
__global__ void __launch_bounds__(U_SPAN)
wrap_dp_counts_kernel(const int8_t* __restrict__ flat,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ scal,
                      const int8_t* __restrict__ unit,
                      const int32_t* __restrict__ max_rep,
                      int32_t* __restrict__ out) {
  constexpr int NW = U_SPAN / 32;
  __shared__ int8_t s_rep[U_SPAN];
  __shared__ int s_val[2][U_SPAN];      // DP rows, double-buffered
  __shared__ int s_aux[2][3][U_SPAN];   // (m, ins, si) per cell, double-buffered
  __shared__ int s_base[3][U_SPAN];     // aux bases before the deletion copy
  __shared__ int s_wv[NW];              // per-warp scan tail value
  __shared__ int s_wf[NW];              // per-warp "has a segment start"
  __shared__ unsigned s_ball[NW];       // per-warp non-deletion ballot
  __shared__ int s_rv[NW], s_ri[NW], s_rj[NW];

  const int job = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int w = j >> 5;

  const int32_t* sc = scal + (int64_t)job * 8;
  const int rep_len = sc[0];
  const int unit_len = sc[1];
  const int mg = sc[2], mp = sc[3], ip = sc[4];
  const int64_t start = starts[job];
  const int ulm1 = max(unit_len - 1, 0);
  const bool sub_ok = j < unit_len;
  const bool j0 = j == 0;
  const int u = unit[(int64_t)job * U_SPAN + j];
  const int ipj = ip * j;

  int prev = 0, am = 0, ai = 0, as = 0;   // this cell's previous row
  int bv = 0, bi = 0, bm = 0, bins = 0, bsi = 0;
  s_val[0][j] = 0;
  s_aux[0][0][j] = 0;
  s_aux[0][1][j] = 0;
  s_aux[0][2][j] = 0;
  __syncthreads();

  for (int r = 0; r < rep_len; ++r) {
    const int cur = r & 1, nxt = cur ^ 1;
    const int i = r + 1;
    const int tr = r % U_SPAN;
    if (tr == 0) {
      const int rr = r + j;
      s_rep[j] = rr < rep_len ? flat[start + rr] : (int8_t)-1;
      __syncthreads();
    }
    // ---- A: candidates and the in-row deletion chain ----
    const bool mi = u == (int)s_rep[tr];
    const int diag = j0 ? s_val[cur][ulm1] : s_val[cur][j - 1];
    const int dmp = diag - mp;
    const int m = mi ? diag + mg : max(0, max(dmp, prev - ip));
    bool seg = mi || j0;
    int v = mtr::seg_max_scan_warp(m + ipj, seg, lane, w, s_wv, s_wf);
    __syncthreads();
    // ---- B: close the scan across warps, publish the row ----
    v = mtr::seg_max_scan_close(v, seg, w, s_wv, s_wf);
    int row = mi ? m : v - ipj;
    if (!sub_ok) row = 0;
    s_val[nxt][j] = row;
    const int da_m = j0 ? s_aux[cur][0][ulm1] : s_aux[cur][0][j - 1];
    const int da_i = j0 ? s_aux[cur][1][ulm1] : s_aux[cur][1][j - 1];
    const int da_s = j0 ? s_aux[cur][2][ulm1] : s_aux[cur][2][j - 1];
    __syncthreads();
    // ---- C: traceback precedence on final values ----
    const bool pos = row > 0;
    const bool e2v = row == dmp;
    const bool sel_diag = pos && (mi || e2v);
    const int left = j0 ? s_val[nxt][ulm1] : s_val[nxt][j - 1];
    const bool sel_d = pos && !mi && !e2v && row == left - ip;
    s_base[0][j] = sel_diag ? da_m + (int)mi : (pos ? am : 0);
    s_base[1][j] = sel_diag ? da_i : (pos ? ai + 1 : 0);
    s_base[2][j] = sel_diag ? da_s : (pos ? as : i);
    const unsigned nd = __ballot_sync(kFull, !sel_d);
    if (lane == 0) s_ball[w] = nd;
    __syncthreads();
    // ---- D: deletion-chain copy from the nearest origin, argmax ----
    int src = origin_of(j, s_ball);
    if (src < 0) src = max(origin_of(ulm1, s_ball), 0);
    am = s_base[0][src];
    ai = s_base[1][src];
    as = s_base[2][src];
    s_aux[nxt][0][j] = am;
    s_aux[nxt][1][j] = ai;
    s_aux[nxt][2][j] = as;
    if (row > bv) {
      bv = row;
      bi = i;
      bm = am;
      bins = ai;
      bsi = as;
    }
    prev = row;
  }

  // ---- row-major-first argmax: max value, smallest row, smallest lane ----
  int kv = bv, ki = bi, kj = j;
  mtr::argmax_warp(kv, ki, kj);
  // s_base is free after the last row's barrier
  __syncthreads();
  s_base[0][j] = bm;
  s_base[1][j] = bins;
  s_base[2][j] = bsi;
  if (lane == 0) {
    s_rv[w] = kv;
    s_ri[w] = ki;
    s_rj[w] = kj;
  }
  __syncthreads();
  if (j == 0) {
    for (int k = 1; k < NW; ++k) {
      const int ov = s_rv[k], oi = s_ri[k], oj = s_rj[k];
      if (mtr::argmax_before(ov, oi, oj, kv, ki, kj)) {
        kv = ov;
        ki = oi;
        kj = oj;
      }
    }
    const bool found = kv > 0;
    const int max_i = found ? ki : 0;
    const int max_j = found ? kj + 1 : 0;
    const int m = found ? s_base[0][kj] : 0;
    const int ins = found ? s_base[1][kj] : 0;
    const int si = found ? s_base[2][kj] : 0;
    // the wrap column of the batch's final row: rows past a job's own
    // rep_len are all zero, so only the batch's longest jobs keep it
    const int wrap = rep_len == *max_rep ? s_val[rep_len & 1][ulm1] : 0;
    const int x = max_i - si - m - ins;                      // read consumption
    const int dl = floor_div(m * mg - x * mp - kv - ins * ip, ip);  // score
    int32_t* o = out + (int64_t)job * 15;
    o[0] = m;
    o[1] = x;
    o[2] = ins;
    o[3] = dl;
    o[4] = m + x + dl;
    o[5] = si;
    o[6] = 1;
    o[7] = wrap;
    o[8] = kv;
    o[9] = max_i;
    o[10] = max_j;
    o[11] = m;
    o[12] = ins;
    o[13] = si;
    o[14] = 0;
  }
}

template <int U_SPAN>
void launch(const void* flat, const void* starts, const void* scal,
            const void* unit, const void* max_rep, void* out, int n_jobs,
            cudaStream_t stream) {
  wrap_dp_counts_kernel<U_SPAN><<<n_jobs, U_SPAN, 0, stream>>>(
      static_cast<const int8_t*>(flat), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(scal), static_cast<const int8_t*>(unit),
      static_cast<const int32_t*>(max_rep), static_cast<int32_t*>(out));
}

}  // namespace

// C entry point for ctypes.  Returns the cudaError_t of the launch (0 on
// success); an unsupported u_span returns cudaErrorInvalidValue.
extern "C" int mtr_wrap_dp_counts(int u_span, const void* flat,
                                  const void* starts, const void* scal,
                                  const void* unit, const void* max_rep,
                                  void* out, int n_jobs, void* stream) {
  if (n_jobs <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (u_span) {
    case 128: launch<128>(flat, starts, scal, unit, max_rep, out, n_jobs, s); break;
    case 256: launch<256>(flat, starts, scal, unit, max_rep, out, n_jobs, s); break;
    case 512: launch<512>(flat, starts, scal, unit, max_rep, out, n_jobs, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
