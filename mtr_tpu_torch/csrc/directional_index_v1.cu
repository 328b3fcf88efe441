// The first design of the directional-index kernels, kept only as a
// yardstick: _build.baseline_library() builds it on request, chip_smoke.py
// times the kernels of csrc/directional_index.cu against it, and no path of
// the port launches it.  One launch per (k, w) pass.
//
//   mtr_di_sliding_l1_v1:      D[i] = sum_v |c_v(codes[i:i+w]) - c_v(codes[i+w:i+2w])|
//   mtr_di_pearson_moments_v1: with W0, W1, W2 the windows at i, i+w, i+2w,
//                              q0 = sum_v c_v(W0)^2, q1, q2 likewise,
//                              ip01 = sum_v c_v(W0) c_v(W1), ip12 likewise,
//   for i < n_out, summed over symbols v < n_sym; codes outside [0, n_sym)
//   are skipped.
//
// Design: a warp takes a tile of T positions, builds its first position's
// histograms in shared memory with shared atomics over the 2w (Pearson 3w)
// codes, all 32 lanes, and gets the first value with a warp reduction.
// Then lane 0 alone slides through the tile one position at a time, the
// other 31 lanes idle.  T = span / 32 rounded up to a multiple of 32, within
// [128, 1024] (tile_for), four warps a block: at the bench's heaviest pass
// (k 5, w 10,240, ~130k positions) about 203 warps, a warp or two an SM.
// A step costs ~370 cycles on an H100 (PERF.md), so a pass costs about one
// tile's serial chain.
//
// Bounds (checked by the entries): 1 <= n_sym <= 1024, w >= 1, w^2 < 2^31,
// n_out + span - 1 <= n_codes.  Shared memory: kWarps x n_sym ints
// (Manhattan), 3 x that (Pearson).  Launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // tiles (warps) a block
constexpr int kMaxSym = 1024;
constexpr int kTileMin = 128;
constexpr int kTileMax = 1024;
constexpr unsigned kFull = 0xffffffffu;

int tile_for(int span) {
  int t = (span / 32 + 31) / 32 * 32;
  return t < kTileMin ? kTileMin : (t > kTileMax ? kTileMax : t);
}

__device__ __forceinline__ bool live(int v, int n_sym) {
  return static_cast<unsigned>(v) < static_cast<unsigned>(n_sym);
}

__global__ void __launch_bounds__(kWarps * 32)
    sliding_l1_kernel(const int* __restrict__ codes, int n_out, int w,
                      int n_sym, int tile, int* __restrict__ D) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t0_wide =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * tile;
  if (t0_wide >= n_out) return;  // the whole warp leaves together
  const int t0 = static_cast<int>(t0_wide);
  const int t_end = min(t0 + tile, n_out);
  int* diff = smem + warp * n_sym;

  // the tile's first position: diff over its 2w codes, then sum |diff|
  for (int v = lane; v < n_sym; v += 32) diff[v] = 0;
  __syncwarp();
  const int* first = codes + t0;
  for (int j = lane; j < 2 * w; j += 32) {
    const int v = first[j];
    if (live(v, n_sym)) atomicAdd(&diff[v], j < w ? 1 : -1);
  }
  __syncwarp();
  int part = 0;
  for (int v = lane; v < n_sym; v += 32) part += abs(diff[v]);
  int d = __reduce_add_sync(kFull, part);
  __syncwarp();
  if (lane != 0) return;
  D[t0] = d;

  // the slide: position p from p - 1
#pragma unroll 4
  for (int p = t0 + 1; p < t_end; ++p) {
    const int a = codes[p - 1];
    const int b = codes[p - 1 + w];
    const int c = codes[p - 1 + 2 * w];
    const bool la = live(a, n_sym), lb = live(b, n_sym), lc = live(c, n_sym);
    const int xa = la ? diff[a] : 0;
    const int xb = lb ? diff[b] : 0;
    const int xc = lc ? diff[c] : 0;
    // each bin's whole change this step: a -1, b +2, c -1, merged where
    // the codes are equal
    const int na = xa - 1 + (b == a ? 2 : 0) - (c == a ? 1 : 0);
    const int nb = xb + 2 - (a == b ? 1 : 0) - (c == b ? 1 : 0);
    const int nc = xc - 1 - (a == c ? 1 : 0) + (b == c ? 2 : 0);
    if (la) d += abs(na) - abs(xa);
    if (lb && b != a) d += abs(nb) - abs(xb);
    if (lc && c != a && c != b) d += abs(nc) - abs(xc);
    if (la) diff[a] = na;
    if (lb) diff[b] = nb;
    if (lc) diff[c] = nc;
    D[p] = d;
  }
}

// One count update of a Pearson step: window X's count of symbol s[J]
// changes by DL.  The moments move by the square's and the products'
// change; every loaded bin of the same symbol takes the new count.
template <int X, int J, int DL>
__device__ __forceinline__ void pearson_update(const int (&s)[4],
                                               const bool (&l)[4],
                                               int (&x)[4][3], int (&m)[5]) {
  if (!l[J]) return;
  const int c = x[J][X];
  m[X] += 2 * c * DL + 1;
  if (X == 0) m[3] += DL * x[J][1];
  if (X == 1) {
    m[3] += DL * x[J][0];
    m[4] += DL * x[J][2];
  }
  if (X == 2) m[4] += DL * x[J][1];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (s[r] == s[J]) x[r][X] = c + DL;
}

__global__ void __launch_bounds__(kWarps * 32)
    pearson_moments_kernel(const int* __restrict__ codes, int n_out, int w,
                           int n_sym, int tile, int* __restrict__ q0,
                           int* __restrict__ q1, int* __restrict__ q2,
                           int* __restrict__ ip01, int* __restrict__ ip12) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t0_wide =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * tile;
  if (t0_wide >= n_out) return;
  const int t0 = static_cast<int>(t0_wide);
  const int t_end = min(t0 + tile, n_out);
  int* const hist = smem + warp * 3 * n_sym;  // W0, W1, W2 counts
  int* const h0 = hist;
  int* const h1 = hist + n_sym;
  int* const h2 = hist + 2 * n_sym;

  // the tile's first position: the three windows' counts over 3w codes
  for (int v = lane; v < 3 * n_sym; v += 32) hist[v] = 0;
  __syncwarp();
  const int* first = codes + t0;
  for (int j = lane; j < 3 * w; j += 32) {
    const int v = first[j];
    if (live(v, n_sym)) atomicAdd(&hist[(j / w) * n_sym + v], 1);
  }
  __syncwarp();
  int m[5] = {0, 0, 0, 0, 0};  // q0, q1, q2, ip01, ip12
  for (int v = lane; v < n_sym; v += 32) {
    const int c0 = h0[v], c1 = h1[v], c2 = h2[v];
    m[0] += c0 * c0;
    m[1] += c1 * c1;
    m[2] += c2 * c2;
    m[3] += c0 * c1;
    m[4] += c1 * c2;
  }
#pragma unroll
  for (int t = 0; t < 5; ++t) m[t] = __reduce_add_sync(kFull, m[t]);
  __syncwarp();
  if (lane != 0) return;
  q0[t0] = m[0];
  q1[t0] = m[1];
  q2[t0] = m[2];
  ip01[t0] = m[3];
  ip12[t0] = m[4];

  // the slide: W0 loses s[0] and gains s[1], W1 loses s[1] and gains
  // s[2], W2 loses s[2] and gains s[3]
#pragma unroll 2
  for (int p = t0 + 1; p < t_end; ++p) {
    int s[4];
    bool l[4];
    int x[4][3];  // the counts of W0, W1, W2 at s[j]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = codes[p - 1 + j * w];
      l[j] = live(s[j], n_sym);
      x[j][0] = l[j] ? h0[s[j]] : 0;
      x[j][1] = l[j] ? h1[s[j]] : 0;
      x[j][2] = l[j] ? h2[s[j]] : 0;
    }
    pearson_update<0, 0, -1>(s, l, x, m);
    pearson_update<0, 1, 1>(s, l, x, m);
    pearson_update<1, 1, -1>(s, l, x, m);
    pearson_update<1, 2, 1>(s, l, x, m);
    pearson_update<2, 2, -1>(s, l, x, m);
    pearson_update<2, 3, 1>(s, l, x, m);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (l[j]) {
        h0[s[j]] = x[j][0];
        h1[s[j]] = x[j][1];
        h2[s[j]] = x[j][2];
      }
    q0[p] = m[0];
    q1[p] = m[1];
    q2[p] = m[2];
    ip01[p] = m[3];
    ip12[p] = m[4];
  }
}

int check(int n_codes, int n_out, int w, int n_sym, int n_windows) {
  if (w < 1 || n_sym < 1 || n_sym > kMaxSym ||
      static_cast<long long>(w) * w >= (1LL << 31) ||
      static_cast<long long>(n_out) + static_cast<long long>(n_windows) * w -
              1 > n_codes)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

int grid(int n_out, int tile) {
  const int tiles = static_cast<int>((static_cast<long long>(n_out) + tile - 1) / tile);
  return (tiles + kWarps - 1) / kWarps;
}

}  // namespace

extern "C" int mtr_di_sliding_l1_v1(const void* codes, int n_codes,
                                    int n_out, int w, int n_sym, void* D,
                                    void* stream) {
  if (n_out <= 0) return 0;
  if (int err = check(n_codes, n_out, w, n_sym, 2)) return err;
  const int tile = tile_for(2 * w);
  sliding_l1_kernel<<<grid(n_out, tile), kWarps * 32,
                      kWarps * n_sym * sizeof(int),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), n_out, w, n_sym, tile,
      static_cast<int*>(D));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mtr_di_pearson_moments_v1(const void* codes, int n_codes,
                                         int n_out, int w, int n_sym,
                                         void* q0, void* q1, void* q2,
                                         void* ip01, void* ip12,
                                         void* stream) {
  if (n_out <= 0) return 0;
  if (int err = check(n_codes, n_out, w, n_sym, 3)) return err;
  const int tile = tile_for(3 * w);
  pearson_moments_kernel<<<grid(n_out, tile), kWarps * 32,
                           3 * kWarps * n_sym * sizeof(int),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), n_out, w, n_sym, tile,
      static_cast<int*>(q0), static_cast<int*>(q1), static_cast<int*>(q2),
      static_cast<int*>(ip01), static_cast<int*>(ip12));
  return static_cast<int>(cudaGetLastError());
}
