// Consensus-mode wrap-around DP on Hopper (sm_90a): the fill with its
// move codes, then the traceback into the polish tensor of
// consensus.c:931-962, one (500, 9) int32 block [consensus(5) |
// missing(4)] per job.
//
// Replaces, as one dispatch as in mtr_tpu/ops/wrap_dp_resident.py:67-90:
//   mtr_tpu/ops/wrap_dp_pallas.py:52   _fill_kernel (Pallas): the fill,
//       an (r_pad, B, u_pad) uint8 move tensor and best (B, 8);
//   mtr_tpu/ops/wrap_dp_pallas.py:301  traceback_consensus_batch_n (a
//       vmapped lax.fori_loop over the move tensor).
// The plain PyTorch statement of both is
// mtr_tpu_torch/ops/wrap_dp_consensus.py (wrap_dp_fill_plain,
// traceback_consensus_plain).
//
// Fill: one thread block per job, one thread per unit column j, the
// machinery of wrap_dp_counts.cu (rows loop, segmented warp-shuffle max
// scan for the deletion chain, rep codes read from flat[start + i]).  Like
// the counts kernel it is bound by the LATENCY of one row (two block
// barriers, a shuffle scan, shared-memory reads); throughput comes from
// many jobs in flight.  Per row:
//   A  match / diag / insertion candidates and the warp step of the scan;
//   B  close the scan across warps and publish the row, so lane 0 can
//      read the row's final value at unit_len - 1 (its `left`, the wrap
//      column the traceback walks through);
//   C  the move code with the precedence match > mismatch > deletion >
//      insertion on final values (0 stop / 1 diag / 2 del / 3 ins), one
//      byte per cell to the job's slice of the move scratch: a warp
//      stores 32 contiguous bytes, and no moves cross to the host.
// Each job's moves are rep_len x U_SPAN bytes at mv_off[job] (a prefix
// sum over the batch, no padding to a batch-wide r_pad).  The argmax is
// resolved as in the counts kernel: larger value, smaller row, smaller
// lane; best_j = lane + 1.
//
// Traceback: a second launch on the same stream, one thread per job.  A
// walk is one dependent chain: each step loads one move byte whose
// address depends on the previous move, so a step costs one global-load
// latency (an L2 hit when the batch's moves fit the 50 MB L2).  The
// design keeps the chain short: the step is a byte load, one rep-code
// load off the chain, and an add into the job's output rows that no
// later step waits for; the walks of all jobs run side by side.  Steps
// are bounded by rep_len * factor + 2 * 500 (factor >= 1 + ceil(mg/ip)
// bounds the path: mtr_tpu/ops/wrap_dp_pallas.py:207-216); a walk that
// reaches the bound without stopping leaves done[job] = 0 and the
// wrapper raises.  Updates at a column index j >= 500 are dropped, as
// JAX's scatter drops them (only unit_len > 499 reaches them).
//
// Bounds (checked by the dispatcher): rep_len <= 2^20, unit_len <= U_SPAN,
// rep_len*mg + ip*U_SPAN < 2^31, start + rep_len <= len(flat), ip >= 1.
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wrap_dp_rows.cuh"

namespace {

constexpr int kMaxPeriod = 500;
constexpr int kCols = 9;  // consensus A C G T gap | missing A C G T

template <int U_SPAN>
__global__ void __launch_bounds__(U_SPAN)
consensus_fill_kernel(const int8_t* __restrict__ flat,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ scal,
                      const int8_t* __restrict__ unit,
                      const int64_t* __restrict__ mv_off,
                      const int32_t* __restrict__ max_rep,
                      uint8_t* __restrict__ moves,
                      int32_t* __restrict__ best) {
  constexpr int NW = U_SPAN / 32;
  __shared__ int8_t s_rep[U_SPAN];
  __shared__ int s_val[2][U_SPAN];  // DP rows, double-buffered
  __shared__ int s_wv[NW];          // per-warp scan tail value
  __shared__ int s_wf[NW];          // per-warp "has a segment start"
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
  uint8_t* mv = moves + mv_off[job] + j;

  int prev = 0, bv = 0, bi = 0;  // this cell's previous row, its argmax
  s_val[0][j] = 0;
  __syncthreads();

  for (int r = 0; r < rep_len; ++r) {
    const int cur = r & 1, nxt = cur ^ 1;
    const int tr = r % U_SPAN;
    if (tr == 0) {
      const int rr = r + j;
      s_rep[j] = rr < rep_len ? flat[start + rr] : (int8_t)-1;
      __syncthreads();
    }
    // ---- A: candidates, warp step of the deletion-chain scan ----
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
    __syncthreads();
    // ---- C: move code on final values ----
    const int left = j0 ? s_val[nxt][ulm1] : s_val[nxt][j - 1];
    int code = 0;
    if (row > 0) {
      code = (mi || row == dmp) ? 1
           : row == left - ip   ? 2
           : row == prev - ip   ? 3
                                : 0;
    }
    mv[(int64_t)r * U_SPAN] = (uint8_t)code;
    if (row > bv) {
      bv = row;
      bi = r + 1;
    }
    prev = row;
  }

  int kv = bv, ki = bi, kj = j;
  mtr::argmax_warp(kv, ki, kj);
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
    int32_t* o = best + (int64_t)job * 8;
    // the wrap column of the batch's final row, as in the counts kernel
    o[0] = rep_len == *max_rep ? s_val[rep_len & 1][ulm1] : 0;
    o[1] = found ? kv : 0;
    o[2] = found ? ki : 0;
    o[3] = found ? kj + 1 : 0;
    o[4] = 0;
    o[5] = 0;
    o[6] = 0;
    o[7] = 0;
  }
}

__global__ void consensus_traceback_kernel(
    const int8_t* __restrict__ flat, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ scal, const int64_t* __restrict__ mv_off,
    const uint8_t* __restrict__ moves, const int32_t* __restrict__ best,
    int u_span, int factor, int n_jobs, int32_t* __restrict__ out,
    int32_t* __restrict__ done) {
  const int job = blockIdx.x * blockDim.x + threadIdx.x;
  if (job >= n_jobs) return;
  const int32_t* sc = scal + (int64_t)job * 8;
  const int rep_len = sc[0];
  const int unit_len = sc[1];
  const uint8_t* mv = moves + mv_off[job];
  const int8_t* rep = flat + starts[job];
  int32_t* o = out + (int64_t)job * kMaxPeriod * kCols;
  int i = best[(int64_t)job * 8 + 2];
  int j = best[(int64_t)job * 8 + 3];
  if (j == 0) j = unit_len;
  const int64_t guard = (int64_t)rep_len * factor + 2 * kMaxPeriod;
  bool fin = i <= 0;
  for (int64_t s = 0; s < guard && !fin; ++s) {
    const int code = mv[(int64_t)(i - 1) * u_span + (j - 1)];
    if (code == 0) {
      fin = true;
      break;
    }
    const int base = rep[i - 1];
    if (j < kMaxPeriod) {
      const int col = code == 1 ? base : code == 2 ? 4 : 5 + base;
      o[j * kCols + col] += 1;
    }
    if (code != 2) --i;  // diag and ins consume a read base
    if (code != 3) {     // diag and del consume a unit column
      if (--j == 0) j = unit_len;
    }
    fin = i <= 0;
  }
  done[job] = fin ? 1 : 0;
}

template <int U_SPAN>
void launch_fill(const void* flat, const void* starts, const void* scal,
                 const void* unit, const void* mv_off, const void* max_rep,
                 void* moves, void* best, int n_jobs, cudaStream_t stream) {
  consensus_fill_kernel<U_SPAN><<<n_jobs, U_SPAN, 0, stream>>>(
      static_cast<const int8_t*>(flat), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(scal), static_cast<const int8_t*>(unit),
      static_cast<const int64_t*>(mv_off),
      static_cast<const int32_t*>(max_rep), static_cast<uint8_t*>(moves),
      static_cast<int32_t*>(best));
}

}  // namespace

// C entry points for ctypes.  Each returns the cudaError_t of its launch
// (0 on success); an unsupported u_span returns cudaErrorInvalidValue.
extern "C" int mtr_wrap_dp_consensus_fill(int u_span, const void* flat,
                                          const void* starts,
                                          const void* scal, const void* unit,
                                          const void* mv_off,
                                          const void* max_rep, void* moves,
                                          void* best, int n_jobs,
                                          void* stream) {
  if (n_jobs <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (u_span) {
    case 128: launch_fill<128>(flat, starts, scal, unit, mv_off, max_rep, moves, best, n_jobs, s); break;
    case 256: launch_fill<256>(flat, starts, scal, unit, mv_off, max_rep, moves, best, n_jobs, s); break;
    case 512: launch_fill<512>(flat, starts, scal, unit, mv_off, max_rep, moves, best, n_jobs, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mtr_wrap_dp_consensus_traceback(
    int u_span, const void* flat, const void* starts, const void* scal,
    const void* mv_off, const void* moves, const void* best, int factor,
    void* out, void* done, int n_jobs, void* stream) {
  if (n_jobs <= 0) return 0;
  constexpr int kThreads = 32;  // spread the walks over many SMs
  consensus_traceback_kernel<<<(n_jobs + kThreads - 1) / kThreads, kThreads,
                               0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(flat), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(scal), static_cast<const int64_t*>(mv_off),
      static_cast<const uint8_t*>(moves), static_cast<const int32_t*>(best),
      u_span, factor, n_jobs, static_cast<int32_t*>(out),
      static_cast<int32_t*>(done));
  return static_cast<int>(cudaGetLastError());
}
