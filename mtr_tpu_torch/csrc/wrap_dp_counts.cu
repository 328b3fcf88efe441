// Counts-mode wrap-around DP on Hopper (sm_90a): the fill plus traceback
// counts of wrap_around_DP.c:222-354, one (B, 15) int32 row per job.
//
// Replaces the three Pallas TPU kernels that compute this function:
//   mtr_tpu/ops/wrap_dp_fused2.py::_fused2_kernel    units <= 128
//   mtr_tpu/ops/wrap_dp_fused2w.py::_fused2w_kernel  units 129-256
//   mtr_tpu/ops/wrap_dp_fused.py::_fused_kernel      units 257-500
// They differ only in how they work around TPU limits; one template
// stands for all three.  The plain PyTorch statement of the same function
// is mtr_tpu_torch/ops/wrap_dp_counts.py::wrap_dp_counts_plain.
//
// What bounds it: operations.  A cell needs about 30 int32 operations
// (the recurrence, the traceback precedence and three payloads carried
// through the fill); bytes are one rep code per row.  An H100 SXM does
// 132 SMs x 64 int32 lanes x 1.98 GHz = 16.7 T int32 operations/s, so
// its bound is ~550 G cells/s.  The rows of a job are strictly
// sequential, so a launch also lasts at least its longest job's rows
// times the latency of one row.
//
// Design: one warp per job (one warp a block), no shared memory and no
// barrier.  Lane l holds unit columns l*C .. l*C+C-1 in registers,
// C = ceil(unit_len/32) a template parameter (1..16) chosen per job inside
// one launch, so a batch's jobs of every unit width run side by side.
// Per row:
//   - the rep code: each lane loads one code of the next 32 rows, one
//     coalesced read, and __shfl_sync hands row r's code to all lanes;
//   - diag: the lane's own registers, one __shfl_up_sync for its first
//     column, and column U-1 (the wrap) kept from the previous row;
//   - the candidates and the deletion chain D[j] = max(m_j, D[j-1] - ip),
//     reset at match cells and j == 0: mtr_warp::row_values
//     (wrap_dp_warp.cuh, shared with the consensus kernel), a serial
//     running max inside the lane (DPX __viaddmax_s32) and one segmented
//     max scan over the 32 lane tails;
//   - one pass over the lane's columns: traceback precedence match >
//     mismatch > deletion > insertion on final values, each cell's base
//     of the aux payloads (m, ins, si), and the copy of that base from the
//     nearest non-deletion origin to the left; then one ballot + __clz +
//     shuffle carries the origin across lanes;
//     cells whose whole prefix is deletions take column U-1's value (the
//     wrap), in a warp-uniform fix-up that runs only when such cells
//     exist;
//   - the argmax per lane in registers with a strict > (DPX
//     __vibmax_s32), first row and first column win.
// A warp reduction resolves the argmax row-major-first at the end.
//
// Bounds (checked by the dispatcher): rep_len <= 2^20, unit_len <= 32*C,
// rep_len*mg + ip*32*C < 2^31 (the scan carries D[j] + ip*j),
// start + rep_len <= len(flat), ip >= 1.  The kernel allocates nothing
// and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wrap_dp_warp.cuh"

namespace {

using mtr_warp::bit;
using mtr_warp::kFull;
using mtr_warp::pick;

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

#define MTR_PICK3_CASE(N)                                 \
  case N:                                                 \
    if constexpr (N < C) {                                \
      x = a[N];                                           \
      y = b[N];                                           \
      z = c[N];                                           \
    }                                                     \
    break;
template <int C>
__device__ __forceinline__ void pick3(const int (&a)[C], const int (&b)[C],
                                      const int (&c)[C], int k, int& x,
                                      int& y, int& z) {
  switch (k) {
    MTR_PICK3_CASE(0) MTR_PICK3_CASE(1) MTR_PICK3_CASE(2) MTR_PICK3_CASE(3)
    MTR_PICK3_CASE(4) MTR_PICK3_CASE(5) MTR_PICK3_CASE(6) MTR_PICK3_CASE(7)
    MTR_PICK3_CASE(8) MTR_PICK3_CASE(9) MTR_PICK3_CASE(10) MTR_PICK3_CASE(11)
    MTR_PICK3_CASE(12) MTR_PICK3_CASE(13) MTR_PICK3_CASE(14) MTR_PICK3_CASE(15)
  }
}
#undef MTR_PICK3_CASE

// One job on one warp, its unit's C columns a lane.
template <int C>
__device__ __forceinline__ void counts_job(
    const int job, const int8_t* __restrict__ flat,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ scal,
    const int8_t* __restrict__ unit, const int u_span,
    const int32_t* __restrict__ max_rep, int32_t* __restrict__ out) {
  const int lane = threadIdx.x;

  const int32_t* sc = scal + (int64_t)job * 8;
  const int rep_len = sc[0];
  const int unit_len = sc[1];
  const int mg = sc[2], mp = sc[3], ip = sc[4];
  const int64_t start = starts[job];
  const int base_j = lane * C;
  const int ulm1 = max(unit_len - 1, 0);
  const int lane_w = ulm1 / C;           // the lane holding column U-1
  const int col_w = ulm1 - lane_w * C;   // ... and its column there

  const int n_valid = unit_len - base_j;  // column c is real iff c < n_valid
  int u[C];
#pragma unroll
  for (int c = 0; c < C; ++c) u[c] = unit[(int64_t)job * u_span + base_j + c];
  constexpr unsigned all = (1u << C) - 1u;

  int prev[C], am[C], ai[C], as[C];
#pragma unroll
  for (int c = 0; c < C; ++c) prev[c] = am[c] = ai[c] = as[c] = 0;
  int wrow = 0, wm = 0, wi = 0, ws = 0;  // column U-1 of the previous row
  int bv = 0, bic = 0, bm = 0, bins = 0, bsi = 0;  // bic = row << 4 | c
  int code_buf = -1;

  for (int r = 0; r < rep_len; ++r) {
    if ((r & 31) == 0) {
      const int rr = r + lane;
      code_buf = rr < rep_len ? flat[start + rr] : -1;
    }
    const int code = __shfl_sync(kFull, code_buf, r & 31);
    const int i = r + 1;

    // previous row's column base_j - 1 (lane 0: the wrap column U-1)
    int up_v = __shfl_up_sync(kFull, prev[C - 1], 1);
    int up_m = __shfl_up_sync(kFull, am[C - 1], 1);
    int up_i = __shfl_up_sync(kFull, ai[C - 1], 1);
    int up_s = __shfl_up_sync(kFull, as[C - 1], 1);
    if (lane == 0) {
      up_v = wrow;
      up_m = wm;
      up_i = wi;
      up_s = ws;
    }

    // ---- the row's final values (wrap_dp_warp.cuh) ----
    int d[C];
    mtr_warp::row_values<C>(u, code, prev, up_v, mg, mp, ip, lane, base_j,
                            n_valid, d);

    // ---- one pass over the lane: traceback precedence match >
    //      mismatch > deletion > insertion on final values, each cell's
    //      aux base from the previous row's payloads, and the deletion
    //      copy from the lane's last origin (non-deletion cell) ----
    const int r_u1 = __shfl_sync(kFull, pick<C>(d, col_w), lane_w);  // row[U-1]
    int left = __shfl_up_sync(kFull, d[C - 1], 1);
    if (lane == 0) left = r_u1;
    int om = up_m, oi = up_i, os = up_s;  // previous row, column c - 1
    int cm = 0, ci = 0, cs = 0;           // the lane's last origin so far
    int pm = 0, pi = 0, ps = 0;           // published: column 0's base, or
    unsigned ndm = 0;                     // the lane's last origin
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int row = d[c];
      const int diag = c ? prev[c - 1] : up_v;
      const bool mi = u[c] == code;
      const bool pos = row > 0;
      const bool e2v = row == diag - mp;
      const bool sd = pos && (mi || e2v);
      const bool del = pos && !mi && !e2v && row == left - ip;
      const int tm = am[c], ti = ai[c], ts = as[c];
      const int bm_ = sd ? om + (int)mi : (pos ? tm : 0);
      const int bi_ = sd ? oi : (pos ? ti + 1 : 0);
      const int bs_ = sd ? os : (pos ? ts : i);
      om = tm;
      oi = ti;
      os = ts;
      if (c == 0) {
        pm = bm_;
        pi = bi_;
        ps = bs_;
      }
      if (!del && c < n_valid) {
        cm = bm_;
        ci = bi_;
        cs = bs_;
        ndm |= 1u << c;
      }
      am[c] = cm;
      ai[c] = ci;
      as[c] = cs;
      left = row;
    }
    if (ndm) {
      pm = cm;
      pi = ci;
      ps = cs;
    }
    const unsigned nb = __ballot_sync(kFull, ndm != 0u);
    const unsigned lo = nb & ((1u << lane) - 1u);
    const int src = lo ? 31 - __clz(lo) : 0;
    const int km = __shfl_sync(kFull, pm, src);
    const int ki = __shfl_sync(kFull, pi, src);
    const int ks = __shfl_sync(kFull, ps, src);
    const unsigned before = ndm ? ((ndm & (0u - ndm)) - 1u) : all;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (bit(before, c)) {
        am[c] = km;
        ai[c] = ki;
        as[c] = ks;
      }
    }
    // column U-1's payloads: the next row's wrap, and the value of the
    // cells whose whole prefix is deletions (when the row has an origin;
    // with none, every cell already holds column 0's base)
    pick3<C>(am, ai, as, col_w, wm, wi, ws);
    wm = __shfl_sync(kFull, wm, lane_w);
    wi = __shfl_sync(kFull, wi, lane_w);
    ws = __shfl_sync(kFull, ws, lane_w);
    wrow = r_u1;
    const unsigned openm = (lo == 0u && nb != 0u) ? before : 0u;
    if (__any_sync(kFull, openm != 0u)) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (bit(openm, c)) {
          am[c] = wm;
          ai[c] = wi;
          as[c] = ws;
        }
      }
    }

    // ---- argmax: strict >, so the first row and column win ----
#pragma unroll
    for (int c = 0; c < C; ++c) {
      bool keep;
      bv = __vibmax_s32(bv, d[c], &keep);
      if (!keep) {
        bic = (i << 4) | c;
        bm = am[c];
        bins = ai[c];
        bsi = as[c];
      }
      prev[c] = d[c];
    }
  }

  // ---- row-major-first argmax over the lanes ----
  int kv = bv, ki = bic >> 4, kj = base_j + (bic & 15);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_down_sync(kFull, kv, off);
    const int oi = __shfl_down_sync(kFull, ki, off);
    const int oj = __shfl_down_sync(kFull, kj, off);
    if (ov > kv || (ov == kv && (oi < ki || (oi == ki && oj < kj)))) {
      kv = ov;
      ki = oi;
      kj = oj;
    }
  }
  kv = __shfl_sync(kFull, kv, 0);
  ki = __shfl_sync(kFull, ki, 0);
  kj = __shfl_sync(kFull, kj, 0);
  const int owner = kj / C;
  const int m0 = __shfl_sync(kFull, bm, owner);
  const int ins0 = __shfl_sync(kFull, bins, owner);
  const int si0 = __shfl_sync(kFull, bsi, owner);
  if (lane == 0) {
    const bool found = kv > 0;
    const int max_i = found ? ki : 0;
    const int max_j = found ? kj + 1 : 0;
    const int m = found ? m0 : 0;
    const int ins = found ? ins0 : 0;
    const int si = found ? si0 : 0;
    // the wrap column of the batch's final row: rows past a job's own
    // rep_len are all zero, so only the batch's longest jobs keep it
    const int wrap = rep_len == *max_rep ? wrow : 0;
    const int x = max_i - si - m - ins;                             // read consumption
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

// One launch for every job of a batch, whatever its unit: block b (one
// warp) runs job b with C = ceil(unit_len / 32), so jobs of every unit
// width run side by side and the batcher's longest-first order holds
// across them (a launch per C would serialise latency-bound launches).
// A kernel's register count is that of its widest body, so there are
// three: up to C = 4, 8 and 16, and a launch takes the narrowest that
// holds its widest job (more warps an SM for narrow units).
#define MTR_COLS_CASE(N)                                                   \
  case N:                                                                  \
    if constexpr (N <= MAX_C)                                              \
      counts_job<N>(job, flat, starts, scal, unit, u_span, max_rep, out);  \
    break;
template <int MAX_C>
__global__ void __launch_bounds__(32)
wrap_dp_counts_kernel(const int8_t* __restrict__ flat,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ scal,
                      const int8_t* __restrict__ unit, const int u_span,
                      const int32_t* __restrict__ max_rep,
                      int32_t* __restrict__ out) {
  const int job = blockIdx.x;
  const int cols = min(max((scal[(int64_t)job * 8 + 1] + 31) >> 5, 1),
                       u_span >> 5);
  switch (cols) {
    MTR_COLS_CASE(1) MTR_COLS_CASE(2) MTR_COLS_CASE(3) MTR_COLS_CASE(4)
    MTR_COLS_CASE(5) MTR_COLS_CASE(6) MTR_COLS_CASE(7) MTR_COLS_CASE(8)
    MTR_COLS_CASE(9) MTR_COLS_CASE(10) MTR_COLS_CASE(11) MTR_COLS_CASE(12)
    MTR_COLS_CASE(13) MTR_COLS_CASE(14) MTR_COLS_CASE(15) MTR_COLS_CASE(16)
  }
}
#undef MTR_COLS_CASE

template <int MAX_C>
void launch(const void* flat, const void* starts, const void* scal,
            const void* unit, int u_span, const void* max_rep, void* out,
            int n_jobs, cudaStream_t stream) {
  wrap_dp_counts_kernel<MAX_C><<<n_jobs, 32, 0, stream>>>(
      static_cast<const int8_t*>(flat), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(scal), static_cast<const int8_t*>(unit),
      u_span, static_cast<const int32_t*>(max_rep),
      static_cast<int32_t*>(out));
}

}  // namespace

// C entry point for ctypes.  Unit rows are u_span codes wide (a multiple
// of 32, at most 512; every job's unit_len <= u_span).  Returns the
// cudaError_t of the launch (0 on success); an unsupported u_span returns
// cudaErrorInvalidValue.
extern "C" int mtr_wrap_dp_counts(int u_span, const void* flat,
                                  const void* starts, const void* scal,
                                  const void* unit, const void* max_rep,
                                  void* out, int n_jobs, void* stream) {
  if (n_jobs <= 0) return 0;
  if (u_span < 32 || u_span > 512 || u_span % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_span <= 128)
    launch<4>(flat, starts, scal, unit, u_span, max_rep, out, n_jobs, s);
  else if (u_span <= 256)
    launch<8>(flat, starts, scal, unit, u_span, max_rep, out, n_jobs, s);
  else
    launch<16>(flat, starts, scal, unit, u_span, max_rep, out, n_jobs, s);
  return static_cast<int>(cudaGetLastError());
}
