// Directional-index sliding windows on Hopper (sm_90a): the numerators of
// fill_directional_index_Manhattan (fill_directional_index.c:171-295) and
// the integer moments of fill_directional_index_PCC (:298-450), one launch
// for a group of (k, w) passes over the same codes (every w of one k of a
// read: the codes do not change between them).
//
// Replaces the jitted jnp programs of mtr_tpu/ops/directional_index.py,
// _sliding_l1_device (:29-58) and _pearson_moments_device (:105-142), which
// have no Pallas kernel.  Their plain PyTorch statements are
// mtr_tpu_torch/ops/directional_index.py::_sliding_l1_device and
// ::_pearson_moments_device; the results are integers and equal them bit
// for bit.
//
//   mtr_di_sliding_l1:      D[i] = sum_v |c_v(codes[i:i+w]) - c_v(codes[i+w:i+2w])|
//   mtr_di_pearson_moments: with W0, W1, W2 the windows at i, i+w, i+2w,
//                           q0 = sum_v c_v(W0)^2, q1, q2 likewise,
//                           ip01 = sum_v c_v(W0) c_v(W1), ip12 likewise,
//   for i < n_out of each pass, summed over symbols v < n_sym; codes
//   outside [0, n_sym) are skipped (Pearson's stale tail of the arena holds
//   codes of an earlier k, which the plain version skips too).
//
// What bounds it: not memory.  A pass reads each code a few times and
// writes one int32 (five for Pearson) a position: ~1 MB at the bench's
// ~130k positions, under a microsecond of memory time.  The sliding update
// is a chain: each position's sum depends on the last one's histogram, so
// a slider's latency a step, and with many sliders in flight the
// instructions a position, bind it.  The TPU program avoids the chain with
// per-symbol prefix sums, ~1 GB of writes a pass here.
//
// The first design (csrc/directional_index_v1.cu) slid lane 0 of a
// warp through a tile while 31 lanes idled, a warp or two an SM.  Its step
// costs ~345 cycles on an H100 (kernel_ab.py di-split: the code loads ~100,
// which did not run ahead of the chain as that source said, the bin loads
// ~108, the update ~95, the stores ~42), so a pass cost one tile's serial
// chain.  With the card full, instruction slots bind as well: a warp that runs
// one chain spends its whole step's instructions on one position.  This
// design:
//
// - Puts 1 to 8 sliders in a warp.  Each slider of a pass has its own
//   histograms and its own tile of positions, and runs on 32 / sliders
//   lanes, so one warp instruction moves that many positions.  A warp
//   builds its sliders' first histograms together (shared atomics over
//   every slider's span of codes at once, eight 16-byte loads a lane in
//   flight), so sliders x span bounds the start: the host takes sliders =
//   the largest power of two with sliders x span <= kSliderSpan, sliders x
//   n_sym bins <= kWarpBins bytes and sliders <= kMaxSliders
//   (ops/directional_index.py::di_sliders): 8 at k 1 and k 3, 8 to 2 at
//   k 5 Manhattan (uint16 bins), 4 and 2 at k 5 Pearson (8-byte bins).
// - Fills the card.  One launch takes a table of passes (w, n_out, output
//   offset, tile, sliders); a warp finds its pass from its index, the last
//   passes (largest w, longest tiles) first.  The host sizes the tiles
//   (di_tiles) from the card: with R the warps resident at once
//   (mtr_di_resident_warps: the SMs times the blocks an SM holds, set by
//   the bins and the registers), every pass takes T = max(ceil(sum_p
//   ceil(n_out / sliders) / R), ceil(sliders x span / kStartDiv)) positions
//   a slider, rounded up to a multiple of 32, so a launch's warps are about
//   R and all resident.  The floor keeps a warp's start (sliders x span / 32
//   code loads and atomics a lane, and the re-read of those codes from L2)
//   below its slide.
// - Keeps the codes off the chain.  A slider's lanes load G = 32 / sliders
//   steps' codes at a time, one coalesced load a stream a lane, a chunk
//   ahead of the steps, and hand them to the chain by shuffles within the
//   slider's lanes; lane s keeps step s's value and the chunk's outputs
//   leave together.  The bins' store-to-load round trip stays on the chain:
//   with the card full, the warps in flight hide it.
// - Halves the bins.  Manhattan keeps diff_v = c_v(W1) - c_v(W2) in
//   [-w, w] as uint16 biased by 2^15 (int32 bins where w > 32,767); the
//   start's shared atomics add to the 32-bit word of a pair, and the biased
//   halves never leave [1, 65535], so no carry crosses.  Pearson packs the
//   three windows' counts of a symbol (each <= w <= 46,340 < 2^16) in one
//   64-bit word: one load and one store a code where there were three.
//
// Steps, exact in integers: Manhattan moves three codes a step (a leaves
// W1, b moves from W2 to W1, c enters W2): diff changes by -1, +2, -1 at a,
// b, c, merged where the codes are equal, and D by |new| - |old| at each
// distinct bin.  Pearson moves four codes (i-1, +w, +2w, +3w) in six count
// updates: q += 2 c delta + 1 and ip += delta c_other, every loaded copy of
// the same symbol kept in step.
//
// Bounds (checked by the entries): 2 <= n_sym <= 1024 and even (codes are
// k-mers of k <= 5), for every pass w >= 1, w^2 < 2^31 (D <= 2w, every
// moment <= w^2, so int32 outputs and sums), n_out >= 1, n_out + span - 1
// <= n_codes, sliders a power of two within the budgets above, tile a
// multiple of 32 / sliders at least the floor, its outputs inside out_len;
// at most kMaxPasses passes.  Shared memory: kWarps x the launch's most
// sliders x n_sym bins a block (2, 4 or 8 bytes a bin; up to 64 KB, past
// the 48 KB a kernel gets by default).  The kernel allocates nothing and
// launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 2;  // warps a block
constexpr int kMaxSym = 1024;
constexpr int kMaxPasses = 16;
constexpr int kStartDiv = 64;       // a tile's floor: sliders x span / kStartDiv
constexpr int kSliderSpan = 65536;  // sliders a warp: sliders x span <= this
constexpr int kWarpBins = 32768;    // bytes of bins a warp
constexpr int kMaxSliders = 8;      // a slider's G >= 4 lanes: a chunk of
                                    // G steps covers a code load
constexpr int kNarrowMaxW = 32767;  // uint16 Manhattan bins hold |diff| <= w
constexpr unsigned kFull = 0xffffffffu;

struct Pass {
  int w, n_out, out_off, tile, sliders, first_warp;
};

struct Table {
  Pass p[kMaxPasses];
  int n_passes, n_warps, max_sliders, n_codes;
};

__device__ __forceinline__ bool live(int v, int n_sym) {
  return static_cast<unsigned>(v) < static_cast<unsigned>(n_sym);
}

// The warp's pass: warps run the table backwards, so the last passes (the
// largest w, the longest tiles) start first.
__device__ __forceinline__ const Pass& pass_of(const Table& t, int g) {
  int i = 0;
  while (i + 1 < t.n_passes && t.p[i + 1].first_warp <= g) ++i;
  return t.p[i];
}

// Manhattan bins: diff in uint16 biased by 2^15, or plain int32
template <bool kWide>
struct Bins {
  using T = unsigned short;
  static __device__ __forceinline__ int get(const T* b, int v) {
    return static_cast<int>(b[v]) - 0x8000;
  }
  static __device__ __forceinline__ void put(T* b, int v, int x) {
    b[v] = static_cast<T>(x + 0x8000);
  }
  static __device__ __forceinline__ void clear(T* b, int v) { b[v] = 0x8000; }
  // the pair's 32-bit word; a biased half stays in [1, 65535], no carry
  static __device__ __forceinline__ void add(T* b, int v, int delta) {
    atomicAdd(reinterpret_cast<unsigned*>(b) + (v >> 1),
              static_cast<unsigned>(delta) << (16 * (v & 1)));
  }
};

template <>
struct Bins<true> {
  using T = int;
  static __device__ __forceinline__ int get(const T* b, int v) { return b[v]; }
  static __device__ __forceinline__ void put(T* b, int v, int x) { b[v] = x; }
  static __device__ __forceinline__ void clear(T* b, int v) { b[v] = 0; }
  static __device__ __forceinline__ void add(T* b, int v, int delta) {
    atomicAdd(b + v, delta);
  }
};

// The warp's pass over its sliders' first spans: f(j, i, v) for every code
// v = codes[t0_j + i], i < span, of slider j (t0_j = first + j * tile,
// those below n_out).  All (slider, quad) pairs at once, eight 16-byte
// loads a lane in flight, so the start waits on memory about once a
// 1,024 codes.
template <typename F>
__device__ __forceinline__ void for_span_codes(const int* __restrict__ codes,
                                               int n_codes, int first,
                                               int tile, int sliders,
                                               int n_out, int span, int lane,
                                               F f) {
  int live_sliders = 0;
  while (live_sliders < sliders && first + live_sliders * tile < n_out)
    ++live_sliders;
  const int quads = (span + 3) / 4 + 1;  // an unaligned span's quads
  const int total = live_sliders * quads;
  const int4* q4 = reinterpret_cast<const int4*>(codes);
  for (int p0 = lane; p0 < total; p0 += 8 * 32) {
    int v[8][4];
    int c[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = p0 + u * 32;
      const int j = p / quads;
      c[u] = ((first + j * tile) & ~3) + 4 * (p - j * quads);
      if (p < total && c[u] + 3 < n_codes) {
        const int4 x = __ldg(q4 + c[u] / 4);
        v[u][0] = x.x;
        v[u][1] = x.y;
        v[u][2] = x.z;
        v[u][3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[u][e] = p < total && c[u] + e < n_codes ? codes[c[u] + e] : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = p0 + u * 32;
      if (p >= total) continue;
      const int j = p / quads;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = c[u] + e - (first + j * tile);
        if (i >= 0 && i < span) f(j, i, v[u][e]);
      }
    }
  }
}

// this lane's code at offset off for the step into position q (-1: no step)
__device__ __forceinline__ int step_code(const int* codes, int q, int t0,
                                         int t_end, int off) {
  return q > t0 && q < t_end ? codes[q - 1 + off] : -1;
}

// One slider's Manhattan slide, on its G lanes: a chunk of G steps at a
// time, lane `sub` holding the codes of step `sub` (the next chunk's loads
// in flight), every lane of the group running the chain, lane `sub`
// keeping step `sub`'s D, the chunk's D stored together.
template <bool kWide, int G>
__device__ __forceinline__ void l1_slide(const int* __restrict__ codes,
                                         typename Bins<kWide>::T* bins,
                                         int n_sym, int w, int t0, int t_end,
                                         int tile, int sub, int d,
                                         int* __restrict__ D) {
  using B = Bins<kWide>;
  int ca = step_code(codes, t0 + sub, t0, t_end, 0);
  int cb = step_code(codes, t0 + sub, t0, t_end, w);
  int cc = step_code(codes, t0 + sub, t0, t_end, 2 * w);
  for (int c0 = t0; c0 < t0 + tile; c0 += G) {
    const int qn = c0 + G + sub;
    const int na_ = step_code(codes, qn, t0, t_end, 0);
    const int nb_ = step_code(codes, qn, t0, t_end, w);
    const int nc_ = step_code(codes, qn, t0, t_end, 2 * w);
    int mine = d;
#pragma unroll
    for (int s = 0; s < G; ++s) {
      const int a = __shfl_sync(kFull, ca, s, G);
      const int b = __shfl_sync(kFull, cb, s, G);
      const int c = __shfl_sync(kFull, cc, s, G);
      const bool la = live(a, n_sym), lb = live(b, n_sym), lc = live(c, n_sym);
      const int xa = la ? B::get(bins, a) : 0;
      const int xb = lb ? B::get(bins, b) : 0;
      const int xc = lc ? B::get(bins, c) : 0;
      // each bin's whole change this step: a -1, b +2, c -1, merged where
      // the codes are equal
      const int na = xa - 1 + (b == a ? 2 : 0) - (c == a ? 1 : 0);
      const int nb = xb + 2 - (a == b ? 1 : 0) - (c == b ? 1 : 0);
      const int nc = xc - 1 - (a == c ? 1 : 0) + (b == c ? 2 : 0);
      if (la) d += abs(na) - abs(xa);
      if (lb && b != a) d += abs(nb) - abs(xb);
      if (lc && c != a && c != b) d += abs(nc) - abs(xc);
      if (la) B::put(bins, a, na);
      if (lb) B::put(bins, b, nb);
      if (lc) B::put(bins, c, nc);
      if (sub == s) mine = d;
    }
    if (c0 + sub < t_end) D[c0 + sub] = mine;
    ca = na_;
    cb = nb_;
    cc = nc_;
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kWarps * 32)
    sliding_l1_kernel(const int* __restrict__ codes,
                      const __grid_constant__ Table tab, int n_sym,
                      int* __restrict__ out) {
  using B = Bins<kWide>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int idx = blockIdx.x * kWarps + warp;
  if (idx >= tab.n_warps) return;  // the whole warp leaves together
  const int g = tab.n_warps - 1 - idx;
  const Pass& ps = pass_of(tab, g);
  const int w = ps.w, n_out = ps.n_out, tile = ps.tile;
  const int first = (g - ps.first_warp) * ps.sliders * tile;
  const int G = 32 / ps.sliders;  // lanes a slider
  const int mine_slider = lane / G;
  typename B::T* const base =
      reinterpret_cast<typename B::T*>(smem) + warp * tab.max_sliders * n_sym;

  // each slider's first position, by the whole warp: diff over its 2w
  // codes, then sum |diff|; the slider's lanes keep it
  for (int v = lane; v < ps.sliders * n_sym; v += 32) B::clear(base, v);
  __syncwarp();
  for_span_codes(codes, tab.n_codes, first, tile, ps.sliders, n_out, 2 * w,
                 lane, [&](int j, int i, int v) {
                   if (live(v, n_sym)) B::add(base + j * n_sym, v,
                                              i < w ? 1 : -1);
                 });
  __syncwarp();
  int d = 0;
  for (int j = 0; j < ps.sliders; ++j) {
    int part = 0;
    for (int v = lane; v < n_sym; v += 32)
      part += abs(B::get(base + j * n_sym, v));
    part = __reduce_add_sync(kFull, part);
    if (mine_slider == j) d = part;
  }
  __syncwarp();

  const int t0 = min(first + mine_slider * tile, n_out);
  const int t_end = min(t0 + tile, n_out);
  const int sub = lane % G;
  typename B::T* bins = base + mine_slider * n_sym;
  int* D = out + ps.out_off;
  switch (G) {
    case 32: l1_slide<kWide, 32>(codes, bins, n_sym, w, t0, t_end, tile, sub, d, D); break;
    case 16: l1_slide<kWide, 16>(codes, bins, n_sym, w, t0, t_end, tile, sub, d, D); break;
    case 8: l1_slide<kWide, 8>(codes, bins, n_sym, w, t0, t_end, tile, sub, d, D); break;
    default: l1_slide<kWide, 4>(codes, bins, n_sym, w, t0, t_end, tile, sub, d, D); break;
  }
}

// Pearson bins: the counts of W0, W1, W2 in bits 0-15, 16-31, 32-47
using Packed = unsigned long long;

__device__ __forceinline__ int count(Packed x, int X) {
  return static_cast<int>((x >> (16 * X)) & 0xffffu);
}

// One count update of a Pearson step: window X's count of symbol s[J]
// changes by DL.  The moments move by the square's and the products'
// change; every copy of the same symbol takes the new counts.
template <int X, int J, int DL>
__device__ __forceinline__ void pearson_update(const int (&s)[4],
                                               const bool (&l)[4],
                                               Packed (&x)[4], int (&m)[5]) {
  if (!l[J]) return;
  const Packed xj = x[J];
  m[X] += 2 * count(xj, X) * DL + 1;
  if (X == 0) m[3] += DL * count(xj, 1);
  if (X == 1) {
    m[3] += DL * count(xj, 0);
    m[4] += DL * count(xj, 2);
  }
  if (X == 2) m[4] += DL * count(xj, 1);
  const Packed nx = xj + (static_cast<Packed>(static_cast<long long>(DL))
                          << (16 * X));
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (s[r] == s[J]) x[r] = nx;
}

// One slider's Pearson slide, as l1_slide: W0 loses s[0] and gains s[1],
// W1 loses s[1] and gains s[2], W2 loses s[2] and gains s[3]; lane `sub`
// keeps step `sub`'s five moments.  (Loading the next step's counts before
// this step's stores and forwarding them in registers was slower on an
// H100; PERF.md.)
template <int G>
__device__ __forceinline__ void pearson_slide(const int* __restrict__ codes,
                                              Packed* bins, int n_sym, int w,
                                              int n_out, int t0, int t_end,
                                              int tile, int sub, int (&m)[5],
                                              int* __restrict__ rows) {
  int cs[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    cs[j] = step_code(codes, t0 + sub, t0, t_end, j * w);
  for (int c0 = t0; c0 < t0 + tile; c0 += G) {
    int next[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      next[j] = step_code(codes, c0 + G + sub, t0, t_end, j * w);
    int mine[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) mine[t] = m[t];
#pragma unroll
    for (int st = 0; st < G; ++st) {
      int s[4];
      bool l[4];
      Packed x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = __shfl_sync(kFull, cs[j], st, G);
        l[j] = live(s[j], n_sym);
        x[j] = l[j] ? bins[s[j]] : 0;
      }
      pearson_update<0, 0, -1>(s, l, x, m);
      pearson_update<0, 1, 1>(s, l, x, m);
      pearson_update<1, 1, -1>(s, l, x, m);
      pearson_update<1, 2, 1>(s, l, x, m);
      pearson_update<2, 2, -1>(s, l, x, m);
      pearson_update<2, 3, 1>(s, l, x, m);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (l[j]) bins[s[j]] = x[j];
      if (sub == st) {
#pragma unroll
        for (int t = 0; t < 5; ++t) mine[t] = m[t];
      }
    }
    if (c0 + sub < t_end) {
#pragma unroll
      for (int t = 0; t < 5; ++t)
        rows[static_cast<long long>(t) * n_out + c0 + sub] = mine[t];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) cs[j] = next[j];
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    pearson_moments_kernel(const int* __restrict__ codes,
                           const __grid_constant__ Table tab, int n_sym,
                           int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int idx = blockIdx.x * kWarps + warp;
  if (idx >= tab.n_warps) return;
  const int g = tab.n_warps - 1 - idx;
  const Pass& ps = pass_of(tab, g);
  const int w = ps.w, n_out = ps.n_out, tile = ps.tile;
  const int first = (g - ps.first_warp) * ps.sliders * tile;
  const int G = 32 / ps.sliders;
  const int mine_slider = lane / G;
  Packed* const base =
      reinterpret_cast<Packed*>(smem) + warp * tab.max_sliders * n_sym;

  // each slider's first position: the three windows' counts over 3w codes,
  // each count a 16-bit field that only grows, so a 32-bit atomic on the
  // word holding it (W0, W1 low; W2 high) carries into no other
  for (int v = lane; v < ps.sliders * n_sym; v += 32) base[v] = 0;
  __syncwarp();
  for_span_codes(codes, tab.n_codes, first, tile, ps.sliders, n_out, 3 * w,
                 lane, [&](int j, int i, int v) {
                   if (!live(v, n_sym)) return;
                   const int X = i / w;
                   atomicAdd(reinterpret_cast<unsigned*>(base + j * n_sym + v) +
                                 (X >> 1),
                             1u << (16 * (X & 1)));
                 });
  __syncwarp();
  int m[5] = {0, 0, 0, 0, 0};  // q0, q1, q2, ip01, ip12
  for (int j = 0; j < ps.sliders; ++j) {
    Packed* bins = base + j * n_sym;
    int part[5] = {0, 0, 0, 0, 0};
    for (int v = lane; v < n_sym; v += 32) {
      const Packed x = bins[v];
      const int c0 = count(x, 0), c1 = count(x, 1), c2 = count(x, 2);
      part[0] += c0 * c0;
      part[1] += c1 * c1;
      part[2] += c2 * c2;
      part[3] += c0 * c1;
      part[4] += c1 * c2;
    }
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      part[t] = __reduce_add_sync(kFull, part[t]);
      if (mine_slider == j) m[t] = part[t];
    }
  }
  __syncwarp();

  const int t0 = min(first + mine_slider * tile, n_out);
  const int t_end = min(t0 + tile, n_out);
  const int sub = lane % G;
  Packed* bins = base + mine_slider * n_sym;
  int* rows = out + ps.out_off;  // q0, q1, q2, ip01, ip12 rows of n_out
  switch (G) {
    case 32: pearson_slide<32>(codes, bins, n_sym, w, n_out, t0, t_end, tile, sub, m, rows); break;
    case 16: pearson_slide<16>(codes, bins, n_sym, w, n_out, t0, t_end, tile, sub, m, rows); break;
    case 8: pearson_slide<8>(codes, bins, n_sym, w, n_out, t0, t_end, tile, sub, m, rows); break;
    default: pearson_slide<4>(codes, bins, n_sym, w, n_out, t0, t_end, tile, sub, m, rows); break;
  }
}

// Read and check the host table (n_passes rows of w, n_out, out_off, tile,
// sliders) into the kernel's; rows: outputs a position (1 Manhattan, 5
// Pearson); bin: bytes a bin.
int load_table(const int* table, int n_passes, int n_codes, int n_sym,
               long long out_len, int n_windows, int rows, int bin, Table* t,
               int* max_w) {
  if (n_passes < 1 || n_passes > kMaxPasses || n_sym < 2 ||
      n_sym > kMaxSym || n_sym % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  long long warps = 0;
  *max_w = 0;
  t->max_sliders = 1;
  for (int i = 0; i < n_passes; ++i) {
    const int* r = table + 5 * i;
    const int w = r[0], n_out = r[1], off = r[2], tile = r[3], sl = r[4];
    const long long span = static_cast<long long>(n_windows) * w;
    if (w < 1 || n_out < 1 || tile < 1 || off < 0 || sl < 1 ||
        sl > kMaxSliders ||
        (sl & (sl - 1)) || tile % (32 / sl) ||
        static_cast<long long>(sl) * n_sym * bin > kWarpBins ||
        (sl > 1 && sl * span > kSliderSpan) ||
        static_cast<long long>(tile) * kStartDiv < sl * span ||
        static_cast<long long>(w) * w >= (1LL << 31) ||
        static_cast<long long>(n_out) + static_cast<long long>(n_windows) * w -
                1 > n_codes ||
        off + static_cast<long long>(rows) * n_out > out_len)
      return static_cast<int>(cudaErrorInvalidValue);
    t->p[i] = Pass{w, n_out, off, tile, sl, static_cast<int>(warps)};
    const long long per_warp = static_cast<long long>(sl) * tile;
    warps += (n_out + per_warp - 1) / per_warp;
    if (warps > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
    if (w > *max_w) *max_w = w;
    if (sl > t->max_sliders) t->max_sliders = sl;
  }
  t->n_passes = n_passes;
  t->n_warps = static_cast<int>(warps);
  t->n_codes = n_codes;
  return 0;
}

// A block's bins may pass the 48 KB of shared memory a kernel gets by
// default (kWarps x kWarpBins = 64 KB): allow it.
template <typename Kernel>
cudaError_t allow_bins(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kWarps * kWarpBins);
}

template <typename Kernel>
int resident(Kernel kernel, int smem_bytes) {
  int dev = 0, sms = 0, blocks = 0;
  if (allow_bins(kernel) != cudaSuccess || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    kWarps * 32, smem_bytes) !=
          cudaSuccess)
    return -1;
  return sms * blocks * kWarps;
}

}  // namespace

// The warps the card holds at once for a launch of this kind (pearson 0 /
// 1) over n_sym symbols with windows up to max_w and at most `sliders`
// sliders a warp; -1 on a CUDA error.
extern "C" int mtr_di_resident_warps(int pearson, int n_sym, int max_w,
                                     int sliders) {
  const int bins = kWarps * sliders * n_sym;
  if (pearson)
    return resident(pearson_moments_kernel, bins * sizeof(Packed));
  if (max_w > kNarrowMaxW)
    return resident(sliding_l1_kernel<true>, bins * sizeof(int));
  return resident(sliding_l1_kernel<false>, bins * sizeof(unsigned short));
}

extern "C" int mtr_di_sliding_l1(const void* codes, int n_codes,
                                 const void* table, int n_passes, int n_sym,
                                 void* out, int out_len, void* stream) {
  // the bins' width is the launch's: int32 where a w passes kNarrowMaxW
  int max_w = 0;
  for (int i = 0; i < n_passes && i < kMaxPasses; ++i)
    max_w = max(max_w, static_cast<const int*>(table)[5 * i]);
  const bool wide = max_w > kNarrowMaxW;
  const int bin = wide ? sizeof(int) : sizeof(unsigned short);
  Table t;
  if (int err = load_table(static_cast<const int*>(table), n_passes, n_codes,
                           n_sym, out_len, 2, 1, bin, &t, &max_w))
    return err;
  const int blocks = (t.n_warps + kWarps - 1) / kWarps;
  const int smem = kWarps * t.max_sliders * n_sym * bin;
  const auto s = static_cast<cudaStream_t>(stream);
  if (wide) {
    if (cudaError_t err = allow_bins(sliding_l1_kernel<true>))
      return static_cast<int>(err);
    sliding_l1_kernel<true><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const int*>(codes), t, n_sym, static_cast<int*>(out));
  } else {
    if (cudaError_t err = allow_bins(sliding_l1_kernel<false>))
      return static_cast<int>(err);
    sliding_l1_kernel<false><<<blocks, kWarps * 32, smem, s>>>(
        static_cast<const int*>(codes), t, n_sym, static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mtr_di_pearson_moments(const void* codes, int n_codes,
                                      const void* table, int n_passes,
                                      int n_sym, void* out, int out_len,
                                      void* stream) {
  Table t;
  int max_w = 0;
  if (int err = load_table(static_cast<const int*>(table), n_passes, n_codes,
                           n_sym, out_len, 3, 5, sizeof(Packed), &t, &max_w))
    return err;
  if (cudaError_t err = allow_bins(pearson_moments_kernel))
    return static_cast<int>(err);
  pearson_moments_kernel<<<(t.n_warps + kWarps - 1) / kWarps, kWarps * 32,
                           kWarps * t.max_sliders * n_sym * sizeof(Packed),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(codes), t, n_sym, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
