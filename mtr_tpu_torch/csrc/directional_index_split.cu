// A timing probe of the first design's slide (csrc/directional_index_v1.cu):
// the same kernels with clock64() stamps around the parts of each step of
// lane 0's chain, built only on request by `python3 kernel_ab.py di-split`.
// No path of the port launches it, and its outputs are not results.
//
// Parts of a step, in order (Manhattan; Pearson has four codes and twelve
// bins): 0 the code loads, 1 the bin loads, 2 the update, 3 the stores to
// the bins, 4 the store of D[p].  A stamp after a load waits for its value
// (a trap that can never fire reads it), so a part's cycles are its
// latency as the chain sees it; a store's part is its dispatch only, and a
// store that a later load must wait for shows up in that load's part.
// Each tile writes the sum of each part's cycles over its steps and its
// step count to prof[tile * 8 + part] (steps at 7).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxSym = 1024;
constexpr int kTileMin = 128;
constexpr int kTileMax = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNever = -2147483647 - 1;  // no code or count is INT_MIN

int tile_for(int span) {
  int t = (span / 32 + 31) / 32 * 32;
  return t < kTileMin ? kTileMin : (t > kTileMax ? kTileMax : t);
}

__device__ __forceinline__ bool live(int v, int n_sym) {
  return static_cast<unsigned>(v) < static_cast<unsigned>(n_sym);
}

__device__ __forceinline__ long long stamp() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// wait until v has arrived: the branch reads it
__device__ __forceinline__ void wait_for(int v) {
  if (v == kNever) __trap();
}

__global__ void __launch_bounds__(kWarps * 32)
    sliding_l1_split(const int* __restrict__ codes, int n_out, int w,
                     int n_sym, int tile, int* __restrict__ D,
                     long long* __restrict__ prof) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile_id = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long t0_wide = tile_id * tile;
  if (t0_wide >= n_out) return;
  const int t0 = static_cast<int>(t0_wide);
  const int t_end = min(t0 + tile, n_out);
  int* diff = smem + warp * n_sym;

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

  long long acc[5] = {0, 0, 0, 0, 0};
  for (int p = t0 + 1; p < t_end; ++p) {
    const long long s0 = stamp();
    const int a = codes[p - 1];
    const int b = codes[p - 1 + w];
    const int c = codes[p - 1 + 2 * w];
    wait_for(a + b + c);
    const long long s1 = stamp();
    const bool la = live(a, n_sym), lb = live(b, n_sym), lc = live(c, n_sym);
    const int xa = la ? diff[a] : 0;
    const int xb = lb ? diff[b] : 0;
    const int xc = lc ? diff[c] : 0;
    wait_for(xa + xb + xc);
    const long long s2 = stamp();
    const int na = xa - 1 + (b == a ? 2 : 0) - (c == a ? 1 : 0);
    const int nb = xb + 2 - (a == b ? 1 : 0) - (c == b ? 1 : 0);
    const int nc = xc - 1 - (a == c ? 1 : 0) + (b == c ? 2 : 0);
    if (la) d += abs(na) - abs(xa);
    if (lb && b != a) d += abs(nb) - abs(xb);
    if (lc && c != a && c != b) d += abs(nc) - abs(xc);
    wait_for(d + na + nb + nc);
    const long long s3 = stamp();
    if (la) diff[a] = na;
    if (lb) diff[b] = nb;
    if (lc) diff[c] = nc;
    const long long s4 = stamp();
    D[p] = d;
    const long long s5 = stamp();
    acc[0] += s1 - s0;
    acc[1] += s2 - s1;
    acc[2] += s3 - s2;
    acc[3] += s4 - s3;
    acc[4] += s5 - s4;
  }
  for (int i = 0; i < 5; ++i) prof[tile_id * 8 + i] = acc[i];
  prof[tile_id * 8 + 7] = t_end - t0 - 1;
}

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
    pearson_moments_split(const int* __restrict__ codes, int n_out, int w,
                          int n_sym, int tile, int* __restrict__ out,
                          long long* __restrict__ prof) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile_id = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long t0_wide = tile_id * tile;
  if (t0_wide >= n_out) return;
  const int t0 = static_cast<int>(t0_wide);
  const int t_end = min(t0 + tile, n_out);
  int* const h0 = smem + warp * 3 * n_sym;
  int* const h1 = h0 + n_sym;
  int* const h2 = h0 + 2 * n_sym;

  for (int v = lane; v < 3 * n_sym; v += 32) h0[v] = 0;
  __syncwarp();
  const int* first = codes + t0;
  for (int j = lane; j < 3 * w; j += 32) {
    const int v = first[j];
    if (live(v, n_sym)) atomicAdd(&h0[(j / w) * n_sym + v], 1);
  }
  __syncwarp();
  int m[5] = {0, 0, 0, 0, 0};
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
#pragma unroll
  for (int t = 0; t < 5; ++t) out[static_cast<long long>(t) * n_out + t0] = m[t];

  long long acc[5] = {0, 0, 0, 0, 0};
  for (int p = t0 + 1; p < t_end; ++p) {
    const long long s0 = stamp();
    int s[4];
    bool l[4];
    int x[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = codes[p - 1 + j * w];
    wait_for(s[0] + s[1] + s[2] + s[3]);
    const long long s1 = stamp();
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      l[j] = live(s[j], n_sym);
      x[j][0] = l[j] ? h0[s[j]] : 0;
      x[j][1] = l[j] ? h1[s[j]] : 0;
      x[j][2] = l[j] ? h2[s[j]] : 0;
      sum += x[j][0] + x[j][1] + x[j][2];
    }
    wait_for(sum);
    const long long s2 = stamp();
    pearson_update<0, 0, -1>(s, l, x, m);
    pearson_update<0, 1, 1>(s, l, x, m);
    pearson_update<1, 1, -1>(s, l, x, m);
    pearson_update<1, 2, 1>(s, l, x, m);
    pearson_update<2, 2, -1>(s, l, x, m);
    pearson_update<2, 3, 1>(s, l, x, m);
    wait_for(m[0] + m[1] + m[2] + m[3] + m[4] + x[0][0] + x[3][2]);
    const long long s3 = stamp();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (l[j]) {
        h0[s[j]] = x[j][0];
        h1[s[j]] = x[j][1];
        h2[s[j]] = x[j][2];
      }
    const long long s4 = stamp();
#pragma unroll
    for (int t = 0; t < 5; ++t)
      out[static_cast<long long>(t) * n_out + p] = m[t];
    const long long s5 = stamp();
    acc[0] += s1 - s0;
    acc[1] += s2 - s1;
    acc[2] += s3 - s2;
    acc[3] += s4 - s3;
    acc[4] += s5 - s4;
  }
  for (int i = 0; i < 5; ++i) prof[tile_id * 8 + i] = acc[i];
  prof[tile_id * 8 + 7] = t_end - t0 - 1;
}

int check(int n_codes, int n_out, int w, int n_sym, int n_windows) {
  if (n_out < 1 || w < 1 || n_sym < 1 || n_sym > kMaxSym ||
      static_cast<long long>(w) * w >= (1LL << 31) ||
      static_cast<long long>(n_out) + static_cast<long long>(n_windows) * w -
              1 > n_codes)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// The tiles of a pass (prof holds tiles * 8 long longs).
extern "C" int mtr_di_split_tiles(int n_out, int span) {
  const int tile = tile_for(span);
  return (n_out + tile - 1) / tile;
}

// kind 0: Manhattan into out (n_out,); 1: Pearson into out (5, n_out)
extern "C" int mtr_di_split(int kind, const void* codes, int n_codes,
                            int n_out, int w, int n_sym, void* out,
                            void* prof, void* stream) {
  const int span = kind ? 3 * w : 2 * w;
  if (int err = check(n_codes, n_out, w, n_sym, kind ? 3 : 2)) return err;
  const int tile = tile_for(span);
  const int blocks = (mtr_di_split_tiles(n_out, span) + kWarps - 1) / kWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  if (kind)
    pearson_moments_split<<<blocks, kWarps * 32,
                            3 * kWarps * n_sym * sizeof(int), s>>>(
        static_cast<const int*>(codes), n_out, w, n_sym, tile,
        static_cast<int*>(out), static_cast<long long*>(prof));
  else
    sliding_l1_split<<<blocks, kWarps * 32, kWarps * n_sym * sizeof(int),
                       s>>>(static_cast<const int*>(codes), n_out, w, n_sym,
                            tile, static_cast<int*>(out),
                            static_cast<long long*>(prof));
  return static_cast<int>(cudaGetLastError());
}
