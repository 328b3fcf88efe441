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
// traceback_consensus_plain; pack_moves states the move layout below).
// The first design (a block per job, a thread per column, then a thread
// per job for the traceback) is csrc/wrap_dp_consensus_v1.cu, kept as a
// yardstick.
//
// What bounds it: latency.  A polish launch holds a handful of jobs of a
// few thousand rows each (the bench set: ~6 jobs, rep_len up to 4,167), so
// the card is nearly empty and a launch lasts its longest job's rows times
// the latency of one row, then its traceback's steps times the latency of
// one step.
//
// Design: two warps per job, fill and traceback in one kernel, one launch
// for every unit width (three register tiers, as the counts kernel).
//   Fill, warp 0: the counts kernel's structure.  Lane l holds columns
//   l*C .. l*C+C-1 in registers, C = ceil(unit_len/32) chosen per job; the
//   row's values come from mtr_warp::row_values (wrap_dp_warp.cuh, the row
//   step shared with csrc/wrap_dp_counts.cu), no barrier inside a row.
//   Warp 0 computes the values only and hands each row to warp 1 through a
//   ring of two 8-row batches in shared memory (one named barrier a batch).
//   With a handful of jobs a launch an SM holds one warp and nothing
//   hides a row's latency: on one warp the move codes and argmax more
//   than doubled it (~0.8 us a row at unit 203 on an H100), so they go to
//   a warp of their own, computed with selects only (kernel_ab.py
//   consensus-split times each warp alone).
//   Fill, warp 1: the move codes from the ring with the precedence match >
//   mismatch > deletion > insertion on final values (0 stop / 1 diag /
//   2 del / 3 ins), packed 2 bits a cell: lane l's C codes are one word of
//   WB = 1, 2 or 4 bytes (C <= 4, 8, 16), and a row is 32 * WB contiguous
//   bytes, one coalesced store.  Row r of job b lies at byte mv_off[b] +
//   r * 32 * WB; cell (r, j) is bits 2c..2c+1 of word j / C, c = j % C.
//   The argmax (larger value, smaller row, smaller column) is a max tree
//   over the lane's row, kept per lane and reduced across the warp at the
//   end.  A batch's 8 rows are unrolled: they share no chain but prev and
//   the argmax, so their loads, codes and stores overlap.
//   Traceback, warp 1: the walk's row index never increases, so the warp
//   stages the job's move rows into shared memory a tile (4 KB) at a time,
//   two tiles in flight with cp.async, and lane 0 walks the tile it has: a
//   step is one shared load and a few operations.  Lane 0 logs each step (row,
//   column, code: one 32-bit word) and the whole warp then adds the log
//   into the job's (500, 9) block in shared memory (the rep code loads and
//   the adds off the walk's chain); the block is written out once.
// Steps are bounded by rep_len * factor + 2 * 500 (factor >= 1 +
// ceil(mg/ip) bounds the path: mtr_tpu/ops/wrap_dp_pallas.py:207-216); a
// walk that reaches the bound without stopping leaves done[job] = 0 and
// the wrapper raises.  Updates at a column index j >= 500 are dropped, as
// JAX's scatter drops them (only unit_len > 499 reaches them).
//
// Bounds (checked by the dispatcher): rep_len <= 2^20 (a log word holds a
// 20-bit row), unit_len <= 32*C <= 512 (10-bit column), rep_len*mg +
// ip*32*C < 2^31 (the scan carries D[j] + ip*j), start + rep_len <=
// len(flat), ip >= 1, mv_off 16-byte aligned.  The kernel allocates
// nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wrap_dp_warp.cuh"

namespace {

using mtr_warp::kFull;
using mtr_warp::pick;

constexpr int kMaxPeriod = 500;
constexpr int kCols = 9;  // consensus A C G T gap | missing A C G T
constexpr int kTileBytes = 4096;
constexpr int kLog = 512;     // traceback steps logged between adds
constexpr int kBatch = 8;     // fill rows the two warps hand over at once
constexpr int kMaxC = 16;

// The fill's ring: two batches of rows, row slot s holding column l*C + c
// at vals[s][c * 32 + l] (conflict-free for both warps), and each row's
// rep code.  The traceback's tiles, polish block and step log reuse the
// same memory once the fill is done.
struct FillRing {
  int vals[2 * kBatch][kMaxC * 32];
  int code[2 * kBatch];
};
struct TraceShared {
  alignas(16) uint8_t tile[2][kTileBytes];
  alignas(16) int out[kMaxPeriod * kCols];
  uint32_t log[kLog];
};
union Shared {
  FillRing ring;
  TraceShared tb;
};

__device__ __forceinline__ void batch_barrier() {  // both warps of a block
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
}

template <int C>
__device__ __forceinline__ int max_tree(const int (&a)[C]) {
  int t[C];
#pragma unroll
  for (int c = 0; c < C; ++c) t[c] = a[c];
#pragma unroll
  for (int w = 1; w < C; w <<= 1)
#pragma unroll
    for (int c = 0; c + w < C; c += 2 * w) t[c] = max(t[c], t[c + w]);
  return t[0];
}

template <int C>
__device__ __forceinline__ uint32_t or_tree(const uint32_t (&a)[C]) {
  uint32_t t[C];
#pragma unroll
  for (int c = 0; c < C; ++c) t[c] = a[c];
#pragma unroll
  for (int w = 1; w < C; w <<= 1)
#pragma unroll
    for (int c = 0; c + w < C; c += 2 * w) t[c] |= t[c + w];
  return t[0];
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Move rows [hi - T, hi) of a job (rows below 0 skipped) into a tile.
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* mv,
                                          int hi, int rows, int row_bytes,
                                          int lane) {
  const int lo = hi - rows;
#pragma unroll
  for (int e = lane; e < kTileBytes / 16; e += 32) {
    const int r = lo + e * 16 / row_bytes;
    if (r >= 0 && r < hi)
      cp_async16(tile + e * 16, mv + (int64_t)lo * row_bytes + e * 16);
  }
  cp_async_commit();
}

template <int C>
__device__ __forceinline__ void consensus_job(
    const int job, const int8_t* __restrict__ flat,
    const int32_t* __restrict__ starts, const int32_t* __restrict__ scal,
    const int8_t* __restrict__ unit, const int u_span,
    const int64_t* __restrict__ mv_off, const int32_t* __restrict__ max_rep,
    uint8_t* __restrict__ moves, const int factor,
    int32_t* __restrict__ best, int32_t* __restrict__ out,
    int32_t* __restrict__ done, Shared& shm) {
  constexpr int WB = C <= 4 ? 1 : C <= 8 ? 2 : 4;  // bytes of a lane's codes
  constexpr int RB = 32 * WB;                      // bytes of a move row
  constexpr int T = kTileBytes / RB;               // rows of a tile
  using Word = typename std::conditional<
      WB == 1, uint8_t,
      typename std::conditional<WB == 2, uint16_t, uint32_t>::type>::type;
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x < 32;

  const int32_t* sc = scal + (int64_t)job * 8;
  const int rep_len = sc[0];
  const int unit_len = sc[1];
  const int mg = sc[2], mp = sc[3], ip = sc[4];
  const int64_t start = starts[job];
  const int base_j = lane * C;
  const int ulm1 = max(unit_len - 1, 0);
  const int lane_w = ulm1 / C;          // the lane holding column U-1
  const int col_w = ulm1 - lane_w * C;  // ... and its column there
  const int n_valid = unit_len - base_j;
  uint8_t* mv = moves + mv_off[job];
  Word* mvw = reinterpret_cast<Word*>(mv);

  int u[C], prev[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    u[c] = unit[(int64_t)job * u_span + base_j + c];
    prev[c] = 0;
  }
  int wrow = 0;  // column U-1 of the previous row
  FillRing& ring = shm.ring;

  // ---------------- fill, warp 0: the values ----------------
  if (producer) {
    int code_buf = -1;
    for (int r = 0; r < rep_len; ++r) {
      if ((r & 31) == 0) {
        const int rr = r + lane;
        code_buf = rr < rep_len ? flat[start + rr] : -1;
      }
      const int code = __shfl_sync(kFull, code_buf, r & 31);
      int up_v = __shfl_up_sync(kFull, prev[C - 1], 1);
      if (lane == 0) up_v = wrow;
      int d[C];
      mtr_warp::row_values<C>(u, code, prev, up_v, mg, mp, ip, lane, base_j,
                              n_valid, d);
      wrow = __shfl_sync(kFull, pick<C>(d, col_w), lane_w);
      const int slot = r % (2 * kBatch);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        ring.vals[slot][c * 32 + lane] = d[c];
        prev[c] = d[c];
      }
      if (lane == 0) ring.code[slot] = code;
      if ((r + 1) % kBatch == 0 || r + 1 == rep_len) batch_barrier();
    }
    return;
  }

  // ---------------- fill, warp 1: move codes and argmax ----------------
  int bv = 0, bic = 0;  // the lane's argmax, bic = row << 4 | c
  // one row's codes, store and argmax; rows depend on each other only
  // through prev, wrow and the argmax, so a batch's rows unrolled overlap
  auto consume = [&](const int r) {
    const int slot = r % (2 * kBatch);
    const int* row_s = ring.vals[slot];
    int cur[C];
#pragma unroll
    for (int c = 0; c < C; ++c) cur[c] = row_s[c * 32 + lane];
    const int code = ring.code[slot];
    const int r_u1 = row_s[col_w * 32 + lane_w];
    const int left0 = lane ? row_s[(C - 1) * 32 + lane - 1] : r_u1;
    int up = __shfl_up_sync(kFull, prev[C - 1], 1);
    if (lane == 0) up = wrow;
    uint32_t bits[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int row = cur[c];
      const int diag = c ? prev[c - 1] : up;
      const int left = c ? cur[c - 1] : left0;
      // every test taken, then selects: no branch per cell
      const bool e1 = (u[c] == code) | (row == diag - mp);
      const bool e2 = row == left - ip;
      const bool e3 = row == prev[c] - ip;
      const uint32_t mvc = e1 ? 1u : e2 ? 2u : e3 ? 3u : 0u;
      bits[c] = row > 0 ? mvc << (2 * c) : 0u;
    }
    mvw[(int64_t)r * 32 + lane] = static_cast<Word>(or_tree<C>(bits));
    const int rmax = max_tree<C>(cur);
    int cc = C - 1;  // the row's first column at its max
#pragma unroll
    for (int c = C - 2; c >= 0; --c) cc = cur[c] == rmax ? c : cc;
    const bool better = rmax > bv;  // strict: the first row wins
    bv = better ? rmax : bv;
    bic = better ? (((r + 1) << 4) | cc) : bic;
#pragma unroll
    for (int c = 0; c < C; ++c) prev[c] = cur[c];
    wrow = r_u1;
  };
  for (int b0 = 0; b0 < rep_len; b0 += kBatch) {
    batch_barrier();  // warp 0 has written rows b0 .. b0 + kBatch - 1
    if (b0 + kBatch <= rep_len) {
#pragma unroll
      for (int q = 0; q < kBatch; ++q) consume(b0 + q);
    } else {
      for (int r = b0; r < rep_len; ++r) consume(r);
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
  const bool found = kv > 0;
  if (lane == 0) {
    int32_t* o = best + (int64_t)job * 8;
    // the wrap column of the batch's final row, as in the counts kernel
    o[0] = rep_len == *max_rep ? wrow : 0;
    o[1] = found ? kv : 0;
    o[2] = found ? ki : 0;
    o[3] = found ? kj + 1 : 0;
    o[4] = o[5] = o[6] = o[7] = 0;
  }

  // ---------------- traceback, warp 1 ----------------
  TraceShared& sh = shm.tb;
  for (int e = lane; e < kMaxPeriod * kCols; e += 32) sh.out[e] = 0;
  int i = found ? ki : 0;
  int j = found ? kj + 1 : unit_len;
  bool fin = i <= 0;
  const int64_t guard = (int64_t)rep_len * factor + 2 * kMaxPeriod;
  int64_t steps = 0;
  __threadfence_block();  // every row of the fill stored before the
  __syncwarp();           // tiles load
  int hi = i;    // the current tile holds rows [hi - T, hi)
  int buf = 0;
  if (!fin) {
    load_tile(sh.tile[0], mv, hi, T, RB, lane);
    load_tile(sh.tile[1], mv, hi - T, T, RB, lane);
  }
  while (!fin && steps < guard) {
    cp_async_wait_one();
    __syncwarp();
    int n_log = 0;
    if (lane == 0) {
      const uint8_t* tile = sh.tile[buf];
      const int lo = hi - T;
      while (!fin && steps < guard && i - 1 >= lo && n_log < kLog) {
        const int jj = j - 1;
        const int jl = jj / C, jc = jj - jl * C;
        const Word w =
            *reinterpret_cast<const Word*>(tile + (i - 1 - lo) * RB + jl * WB);
        const int mvc = (w >> (2 * jc)) & 3;
        if (mvc == 0) {
          fin = true;
          break;
        }
        sh.log[n_log++] = ((uint32_t)(i - 1) << 12) | ((uint32_t)j << 2) |
                          (uint32_t)mvc;
        if (mvc != 2) --i;  // diag and ins consume a read base
        if (mvc != 3) {     // diag and del consume a unit column
          if (--j == 0) j = unit_len;
        }
        ++steps;
        fin = i <= 0;
      }
    }
    n_log = __shfl_sync(kFull, n_log, 0);
    i = __shfl_sync(kFull, i, 0);
    j = __shfl_sync(kFull, j, 0);
    fin = __shfl_sync(kFull, (int)fin, 0) != 0;
    steps = __shfl_sync(kFull, steps, 0);
    __syncwarp();
    for (int e = lane; e < n_log; e += 32) {
      const uint32_t x = sh.log[e];
      const int row = x >> 12, col_j = (x >> 2) & 1023, mvc = x & 3;
      if (col_j < kMaxPeriod) {
        const int base = flat[start + row];
        const int col = mvc == 1 ? base : mvc == 2 ? 4 : 5 + base;
        atomicAdd(&sh.out[col_j * kCols + col], 1);
      }
    }
    __syncwarp();
    if (!fin && i - 1 < hi - T) {  // on to the next tile
      load_tile(sh.tile[buf], mv, hi - 2 * T, T, RB, lane);
      hi -= T;
      buf ^= 1;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncwarp();
  int4* dst = reinterpret_cast<int4*>(out + (int64_t)job * kMaxPeriod * kCols);
  const int4* src = reinterpret_cast<const int4*>(sh.out);
  for (int e = lane; e < kMaxPeriod * kCols / 4; e += 32) dst[e] = src[e];
  if (lane == 0) done[job] = fin ? 1 : 0;
  __syncwarp();  // the next job of this block reuses the shared memory
}

#define MTR_COLS_CASE(N)                                                    \
  case N:                                                                   \
    if constexpr (N <= MAX_C)                                               \
      consensus_job<N>(job, flat, starts, scal, unit, u_span, mv_off,       \
                       max_rep, moves, factor, best, out, done, shm);       \
    break;
template <int MAX_C>
__global__ void __launch_bounds__(64)
wrap_dp_consensus_kernel(const int8_t* __restrict__ flat,
                         const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ scal,
                         const int8_t* __restrict__ unit, const int u_span,
                         const int64_t* __restrict__ mv_off,
                         const int32_t* __restrict__ max_rep,
                         uint8_t* __restrict__ moves, const int factor,
                         int32_t* __restrict__ best,
                         int32_t* __restrict__ out,
                         int32_t* __restrict__ done) {
  __shared__ Shared shm;
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
            const void* unit, int u_span, const void* mv_off,
            const void* max_rep, void* moves, int factor, void* best,
            void* out, void* done, int n_jobs, cudaStream_t stream) {
  wrap_dp_consensus_kernel<MAX_C><<<n_jobs, 64, 0, stream>>>(
      static_cast<const int8_t*>(flat), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(scal), static_cast<const int8_t*>(unit),
      u_span, static_cast<const int64_t*>(mv_off),
      static_cast<const int32_t*>(max_rep), static_cast<uint8_t*>(moves),
      factor, static_cast<int32_t*>(best), static_cast<int32_t*>(out),
      static_cast<int32_t*>(done));
}

}  // namespace

// C entry point for ctypes.  Unit rows are u_span codes wide (a multiple
// of 32, at most 512; every job's unit_len <= u_span); job b's packed
// moves take rep_len * 32 * WB bytes at mv_off[b] (WB = 1, 2, 4 for
// ceil(unit_len/32) <= 4, 8, 16).  Returns the cudaError_t of the launch
// (0 on success); an unsupported u_span returns cudaErrorInvalidValue.
extern "C" int mtr_wrap_dp_consensus(int u_span, const void* flat,
                                     const void* starts, const void* scal,
                                     const void* unit, const void* mv_off,
                                     const void* max_rep, void* moves,
                                     int factor, void* best, void* out,
                                     void* done, int n_jobs, void* stream) {
  if (n_jobs <= 0) return 0;
  if (u_span < 32 || u_span > 512 || u_span % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u_span <= 128)
    launch<4>(flat, starts, scal, unit, u_span, mv_off, max_rep, moves,
              factor, best, out, done, n_jobs, s);
  else if (u_span <= 256)
    launch<8>(flat, starts, scal, unit, u_span, mv_off, max_rep, moves,
              factor, best, out, done, n_jobs, s);
  else
    launch<16>(flat, starts, scal, unit, u_span, mv_off, max_rep, moves,
               factor, best, out, done, n_jobs, s);
  return static_cast<int>(cudaGetLastError());
}
