"""Directional-index sliding windows on a torch device.

Manhattan: D(i) = sum_v |count_v(codes[i:i+w]) - count_v(codes[i+w:i+2w])|
for every position i (fill_directional_index.c:171-295).  Pearson: the
per-position squared sums and inner products of three adjacent windows'
k-mer count vectors over the symbols below 4^k, then the sqrt/divide
finish in host float64, so DI matches the C double math bit for bit
(fill_directional_index.c:298-450).  Both are integers.

On a CUDA device one launch of a hand-written kernel
(csrc/directional_index.cu: `sliding_l1_kernel`, `pearson_moments_kernel`;
they replace the jitted jnp programs of mtr_tpu/ops/directional_index.py,
:29-58 and :105-142) takes a group of passes over the same codes: every w
of one k of a read.  It reads a table of passes (w, n_out, output offset,
tile, sliders); a warp holds 1 to 8 sliders of one pass (`di_sliders`),
each on 32 / sliders lanes with its own histograms, sliding through a tile
of positions with the C tool's incremental update, and the tiles are sized
(`di_tiles`) so that the group's warps are about as many as the card holds
at once.  Outputs are
int32 (D <= 2w, every moment <= w^2 < 2^31); the host widens Manhattan's
to int64, and Pearson's finish converts its moments to float64 a chunk at
a time.  `_sliding_l1_device` and `_pearson_moments_device` are the plain
versions (per-symbol prefix sums over 256-symbol one-hot chunks), and a
group's plain version is the same functions over each pass: the CPU runs
them, and chip_smoke.py holds the kernels to them on the card.  Nothing is
padded: every function computes exactly the positions whose windows lie
inside the codes it is given.

`make_di_compute_k` returns the `di_compute_k` plug-in of
mtr_tpu_torch.oracle.directional_index.fill_directional_index_with_end:
every pass of one k in one launch, with one upload of the codes from
pinned memory and one copy back into pinned memory a k, on the current
stream.

The dispatchers check the kernels' bounds (codes in [0, 1024), w >= 1,
w^2 < 2^31) and raise on a violation, on every device.  On a CUDA device
they launch the kernel or raise; on the CPU they run the plain version.

Over a mesh of several slots (parallel/mesh.py) the Manhattan pass is cut
by position (`sliding_l1_sharded`, `make_di_manhattan_sharded`; the JAX
original, :173-285, is a shard_map with a ring halo exchange): one
contiguous block of positions a slot, each computed from its own codes plus
the 2w - 1 codes to its right, one launch of a one-pass table on the
slot's stream.  The sums are integers, so the blocks put together equal
the one-device pass bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mtr_tpu_torch.utils.timers import TIMERS

_CHUNK = 256
# kernel bounds, checked by the dispatchers: codes are k-mers of k <= 5,
# and every output (D <= 2w, moments <= w^2) fits int32
MAX_SYMBOLS = 1024
VALUE_LIMIT = 1 << 31
# the group table (csrc/directional_index.cu: kMaxPasses, kStartDiv,
# kSliderSpan, kWarpBins, kMaxSliders, kNarrowMaxW): passes a launch, a
# tile's floor sliders x span / START_DIV, sliders a warp up to SLIDER_SPAN
# / span, bytes of bins a warp, sliders a warp at most, and the largest w
# of uint16 Manhattan bins (int32 above)
MAX_PASSES = 16
START_DIV = 64
SLIDER_SPAN = 65536
WARP_BINS = 32768
MAX_SLIDERS = 8
NARROW_MAX_W = 32767
# positions of one pass a step of the host Pearson finish covers: its nine
# float64 rows of scratch (9 MiB) stay in the last-level cache
FINISH_CHUNK = 1 << 17

# device DI passes (the main path shows it ran here) are TIMERS.counters
# by kind, those cut over a mesh apart; the -c summary prints them
PASS_COUNTERS = ("di_manhattan_passes", "di_pearson_passes",
                 "di_sharded_passes")
# kernel launches are TIMERS.counters "launch.<kernel>": one a group of
# passes (a bench read: one a k), one a slot and pass when cut over a mesh

_RESIDENT: dict = {}


def _pow2_floor(x: int) -> int:
    return 1 << (max(x, 1).bit_length() - 1)


def wide_bins(ws, pearson: bool) -> bool:
    """Whether the group's Manhattan bins are int32: |diff| <= w leaves
    uint16 (biased) past NARROW_MAX_W.  Pearson's counts (<= w <= 46,340)
    always fit 16 bits."""
    return not pearson and max(ws) > NARROW_MAX_W


def bin_bytes(ws, pearson: bool) -> int:
    """Bytes of a symbol's bins: Pearson's three packed counts 8, Manhattan
    uint16 2 (int32 4 where wide)."""
    return 8 if pearson else 4 if wide_bins(ws, pearson) else 2


def di_sliders(spans, n_sym: int, nbytes: int) -> list:
    """Sliders a warp for each pass (each with its own histograms on 32 /
    sliders lanes): the largest power of two with sliders x span <=
    SLIDER_SPAN (the warp builds every slider's first histograms, sliders x
    span / 32 code loads and shared atomics a lane) and sliders x n_sym x
    nbytes <= WARP_BINS, within [1, MAX_SLIDERS] (a slider's 32 / sliders
    lanes load that many steps' codes at once, enough to cover a load)."""
    cap = min(MAX_SLIDERS, _pow2_floor(WARP_BINS // (n_sym * nbytes)))
    return [min(cap, _pow2_floor(SLIDER_SPAN // span)) for span in spans]


def di_tiles(n_outs, spans, sliders, resident: int) -> list:
    """The kernels' tile (positions a slider slides through) for each pass
    of a group: max(ceil(sum ceil(n_out / sliders) / resident), ceil(sliders
    x span / START_DIV)), rounded up to a multiple of 32.  The first term
    makes the group's warps about `resident`, the warps the card holds at
    once; the second keeps a warp's start (sliders x span / 32 code loads a
    lane, and the re-read of those codes) below its slide.  span: 2w
    Manhattan, 3w Pearson."""
    fill = -(-sum(-(-n // s) for n, s in zip(n_outs, sliders))
             // max(resident, 1))
    return [-(-max(fill, -(-s * span // START_DIV), 1) // 32) * 32
            for span, s in zip(spans, sliders)]


def check_pass(vals: np.ndarray, n_pos: int, w: int, k: int) -> None:
    """Raise unless a pass over vals[:n_pos] with window w and 4^k
    symbols is inside the kernels' bounds."""
    if w < 1:
        raise ValueError(f"DI window {w} < 1")
    if w * w >= VALUE_LIMIT:
        raise ValueError(f"DI window {w}: w^2 overflows int32")
    if not 1 <= k or 4**k > MAX_SYMBOLS:
        raise ValueError(f"DI k-mer size {k} outside 1..5")
    if len(vals) < n_pos:
        raise ValueError(f"DI pass needs {n_pos} codes, got {len(vals)}")
    if n_pos > 0:
        used = vals[:n_pos]
        lo, hi = int(used.min()), int(used.max())
        if lo < 0 or hi >= MAX_SYMBOLS:
            raise ValueError(f"DI codes span [{lo}, {hi}], outside "
                             f"[0, {MAX_SYMBOLS})")


def _k_for(vals: np.ndarray, n_pos: int) -> int:
    """The smallest k with every code of vals[:n_pos] below 4^k (JAX sizes
    the Manhattan alphabet so, stale tail of the arena included)."""
    vmax = int(vals[:n_pos].max()) if n_pos > 0 else 0
    k = 1
    while 4**k <= vmax:
        k += 1
    return k


def _codes(vals: np.ndarray, n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(vals[:n], np.int32)).to(
        device)


def _offsets(n_outs, rows: int) -> list:
    """Each pass's offset in a group's flat output (rows values a
    position), and the total as the last entry."""
    return np.concatenate([[0], np.cumsum([rows * n for n in n_outs])]
                          ).astype(int).tolist()


def split_group(flat, n_outs, rows: int) -> list:
    """A group's flat output -> one (n_out,) (Manhattan, rows 1) or
    (5, n_out) (Pearson) view a pass."""
    off = _offsets(n_outs, rows)
    return [flat[off[i] : off[i + 1]].reshape(
        (rows, n) if rows > 1 else (n,)) for i, n in enumerate(n_outs)]


# ------------------------------------------------------------ plain versions


def _prefix_counts(codes: torch.Tensor, lo: int, width: int) -> torch.Tensor:
    """(width, n + 1) int32: column p counts symbol lo + v in codes[:p].
    Symbol-major (the transpose of JAX's (n, width) layout): the scan runs
    along contiguous memory."""
    n = codes.shape[0]
    onehot = torch.arange(lo, lo + width,
                          device=codes.device)[:, None] == codes[None, :]
    P = torch.zeros((width, n + 1), dtype=torch.int32, device=codes.device)
    # dtype: an int32 prefix sum (the default would be int64)
    torch.cumsum(onehot, 1, dtype=torch.int32, out=P[:, 1:])
    return P


def _sliding_l1_device(codes: torch.Tensor, k: int, w: int) -> torch.Tensor:
    """codes (n,) int32 -> D (n - 2w + 1,) int64 over the symbols below
    4^k (the plain version)."""
    n_out = max(codes.shape[0] - 2 * w + 1, 0)
    D = torch.zeros(n_out, dtype=torch.int64, device=codes.device)
    if n_out == 0:
        return D
    for lo in range(0, 4**k, _CHUNK):
        P = _prefix_counts(codes, lo, min(_CHUNK, 4**k - lo))
        # diff(i) = 2*P[i+w] - P[i] - P[i+2w], in place
        diff = P[:, w : w + n_out] * 2
        diff -= P[:, :n_out]
        diff -= P[:, 2 * w : 2 * w + n_out]
        D += diff.abs_().sum(0)
    return D


def _pearson_moments_device(codes: torch.Tensor, k: int, w: int):
    """codes (n,) int32 -> [q0, q1, q2, ip01, ip12], each (n - 3w + 1,)
    int64: squared sums and inner products of the three adjacent
    w-windows' count vectors over the symbols below 4^k (the plain
    version)."""
    n_out = max(codes.shape[0] - 3 * w + 1, 0)
    acc = [torch.zeros(n_out, dtype=torch.int64, device=codes.device)
           for _ in range(5)]
    if n_out == 0:
        return acc
    for lo in range(0, 4**k, _CHUNK):
        P = _prefix_counts(codes, lo, min(_CHUNK, 4**k - lo))
        W0 = P[:, w : w + n_out] - P[:, :n_out]
        W1 = P[:, 2 * w : 2 * w + n_out] - P[:, w : w + n_out]
        W2 = P[:, 3 * w : 3 * w + n_out] - P[:, 2 * w : 2 * w + n_out]
        for a, (x, y) in zip(acc, ((W0, W0), (W1, W1), (W2, W2), (W0, W1),
                                   (W1, W2))):
            a += (x * y).sum(0)
    return acc


def plain_group(codes: torch.Tensor, n_outs, ws, n_sym: int,
                pearson: bool) -> list:
    """A group's plain version: each pass's D (n_out,) or moments (5,
    n_out), int64, over the symbols below n_sym = 4^k."""
    k = n_sym.bit_length() // 2
    if pearson:
        return [torch.stack(_pearson_moments_device(codes[: n + 3 * w - 1],
                                                    k, w))
                for n, w in zip(n_outs, ws)]
    return [_sliding_l1_device(codes[: n + 2 * w - 1], k, w)
            for n, w in zip(n_outs, ws)]


# ------------------------------------------------------------------ kernels


def _check_group(codes: torch.Tensor, n_outs, ws, n_sym: int, n_win: int):
    if not (codes.is_cuda and codes.dtype == torch.int32
            and codes.dim() == 1 and codes.is_contiguous()
            and codes.data_ptr() % 16 == 0):
        raise ValueError("DI kernel: codes must be a contiguous 1-D int32 "
                         "CUDA tensor on 16 bytes (the start's vector "
                         f"loads), got {codes.dtype} {codes.device}")
    if not 1 <= len(ws) == len(n_outs) <= MAX_PASSES:
        raise ValueError(f"DI kernel: {len(ws)} windows, {len(n_outs)} "
                         f"passes (1..{MAX_PASSES})")
    if n_sym not in (4, 16, 64, 256, 1024):
        raise ValueError(f"DI kernel: {n_sym} symbols is not 4^k, k 1..5")
    for n, w in zip(n_outs, ws):
        if n < 1 or w < 1 or codes.shape[0] < n + n_win * w - 1:
            raise ValueError(f"DI kernel: {n} positions of w {w} need "
                             f"{n + n_win * w - 1} codes, got "
                             f"{codes.shape[0]}")


def resident_warps(device, pearson: bool, n_sym: int, ws,
                   sliders: int) -> int:
    """The warps the card holds at once for this launch (the C library's
    occupancy query), cached by device and launch kind."""
    from mtr_tpu_torch.ops import _build

    wide = wide_bins(ws, pearson)
    key = (device.index, pearson, n_sym, wide, sliders)
    if key not in _RESIDENT:
        with torch.cuda.device(device):
            n = _build.library().mtr_di_resident_warps(
                int(pearson), n_sym, max(ws) if wide else 1, sliders)
        if n <= 0:
            raise RuntimeError(f"DI kernel occupancy query failed ({n})")
        _RESIDENT[key] = n
    return _RESIDENT[key]


def group_table(n_outs, ws, rows: int, tiles, sliders) -> np.ndarray:
    """(n_passes, 5) int32 rows (w, n_out, output offset, tile,
    sliders)."""
    off = _offsets(n_outs, rows)[:-1]
    return np.ascontiguousarray(np.stack(
        [ws, n_outs, off, tiles, sliders], axis=1), np.int32)


def plan_group(device, n_outs, ws, n_sym: int, pearson: bool) -> np.ndarray:
    """The launch's table on `device`: each pass's sliders, then its tile
    from the warps the card holds with that many sliders' bins."""
    n_win, rows = (3, 5) if pearson else (2, 1)
    spans = [n_win * w for w in ws]
    sliders = di_sliders(spans, n_sym, bin_bytes(ws, pearson))
    tiles = di_tiles(n_outs, spans, sliders, resident_warps(
        device, pearson, n_sym, ws, max(sliders)))
    return group_table(n_outs, ws, rows, tiles, sliders)


def _launch(codes, n_outs, ws, n_sym, pearson: bool) -> torch.Tensor:
    from mtr_tpu_torch.ops import _build

    n_win, rows = (3, 5) if pearson else (2, 1)
    _check_group(codes, n_outs, ws, n_sym, n_win)
    table = plan_group(codes.device, n_outs, ws, n_sym, pearson)
    out = torch.empty(rows * sum(n_outs), dtype=torch.int32,
                      device=codes.device)
    lib = _build.library()
    fn = lib.mtr_di_pearson_moments if pearson else lib.mtr_di_sliding_l1
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    err = fn(codes.data_ptr(), codes.shape[0], table.ctypes.data, len(ws),
             n_sym, out.data_ptr(), out.numel(), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"DI {'Pearson' if pearson else 'sliding-L1'} "
                           f"kernel launch failed: CUDA error {err} (w "
                           f"{list(ws)}, n_out {list(n_outs)}, n_sym {n_sym})")
    return out


def sliding_l1_kernel(codes: torch.Tensor, n_outs, ws,
                      n_sym: int) -> torch.Tensor:
    """The D of each pass (n_outs[i] positions of window ws[i]) over the
    same codes, by one launch of csrc/directional_index.cu on the current
    stream of codes' device: a flat int32 tensor, pass after pass
    (split_group).  Symbols outside [0, n_sym) skipped.  Counts the
    launch."""
    out = _launch(codes, n_outs, ws, n_sym, False)
    TIMERS.count("launch.di_sliding_l1")
    return out


def pearson_moments_kernel(codes: torch.Tensor, n_outs, ws,
                           n_sym: int) -> torch.Tensor:
    """The five moment rows q0, q1, q2, ip01, ip12 of each pass, as
    sliding_l1_kernel: a flat int32 tensor of (5, n_out) blocks.  Counts
    the launch."""
    out = _launch(codes, n_outs, ws, n_sym, True)
    TIMERS.count("launch.di_pearson_moments")
    return out


def _group(codes: torch.Tensor, n_outs, ws, n_sym: int, pearson: bool):
    """A group's outputs on codes' device: the kernel's flat int32 tensor
    on a CUDA device, the plain versions' concatenated on the CPU."""
    if codes.is_cuda:
        fn = pearson_moments_kernel if pearson else sliding_l1_kernel
        return fn(codes, n_outs, ws, n_sym)
    if codes.device.type != "cpu":
        raise ValueError(f"no DI kernel for {codes.device}")
    return torch.cat([r.reshape(-1) for r in plain_group(
        codes, n_outs, ws, n_sym, pearson)])


# -------------------------------------------------------------- dispatchers


def _manhattan_finish(D: np.ndarray, di_len: int, w: int,
                      n_i: int) -> np.ndarray:
    di_tmp = np.full(di_len, -1.0)
    di_tmp[w : w + n_i] = (D[:n_i] - D[w : w + n_i]) / float(2 * w)
    return di_tmp


def _pearson_finish(moments: np.ndarray, di_len: int, w: int, k: int,
                    n_i: int, work: np.ndarray | None = None) -> np.ndarray:
    """The host float64 finish of fill_directional_index_PCC from one
    pass's (5, n_i) integer moments: the C code's double operations in its
    order, element by element.  They run in place in `work`, a (9, chunk)
    float64 scratch (made here if None), a chunk of positions at a time:
    no temporary array is made, and the rows stay in the cache."""
    if work is None:
        work = np.empty((9, min(n_i, FINISH_CHUNK)))
    n4k = float(4**k)
    ss = float(w) * float(w)
    di_tmp = np.full(di_len, -1.0)
    for lo in range(0, n_i, work.shape[1]):
        hi = min(lo + work.shape[1], n_i)
        c = hi - lo
        m, sd, den = work[:5, :c], work[5:8, :c], work[8, :c]
        np.multiply(moments[:, lo:hi], n4k, out=m)
        m -= ss  # q * 4^k - s * s, ip * 4^k - s * s
        np.sqrt(m[:3], out=sd)
        # p01 = (ip01 * 4^k - s * s) / (sd0 * sd1) where sd0 * sd1 > 0,
        # else 0, into row 0; p12 likewise into row 1
        np.multiply(sd[0], sd[1], out=den)
        m[0] = 0.0
        np.divide(m[3], den, out=m[0], where=den > 0)
        np.multiply(sd[1], sd[2], out=den)
        m[1] = 0.0
        np.divide(m[4], den, out=m[1], where=den > 0)
        np.subtract(m[1], m[0], out=di_tmp[w + lo : w + hi])
    return di_tmp


def _widen(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.int64, copy=False)


def sliding_l1_device(vals: np.ndarray, w: int, n_out: int,
                      device) -> np.ndarray:
    """Drop-in for oracle.directional_index.sliding_l1 on `device`: one
    pass, a one-pass table on the current stream."""
    n_pos = n_out + 2 * w - 1
    k = _k_for(vals, n_pos)
    check_pass(vals, n_pos, w, k)
    TIMERS.count("di_manhattan_passes")
    if n_out <= 0:
        return np.zeros(0, np.int64)
    return _widen(_group(_codes(vals, n_pos, torch.device(device)), [n_out],
                         [w], 4**k, False))


def di_manhattan_device(buf: np.ndarray, di_len: int, w: int, k: int,
                        rsl: int, device) -> np.ndarray:
    """Manhattan DI pass with the oracle's bounds and placement: a one-pass
    group on the current stream."""
    return di_group_device(buf, di_len, [w], k, rsl, device, True)[0]


def di_pearson_device(buf: np.ndarray, di_len: int, w: int, k: int, rsl: int,
                      device) -> np.ndarray:
    """Pearson DI pass: moments on `device` (a one-pass group on the
    current stream), host float64 finish."""
    return di_group_device(buf, di_len, [w], k, rsl, device, False)[0]


class _Staging:
    """A plug-in's pinned host buffers, grown as needed.  Each group ends
    in a synchronize of the current stream, so a buffer is free again when
    the next group fills it."""

    def __init__(self):
        self.up = torch.empty(0, dtype=torch.int32)
        self.down = torch.empty(0, dtype=torch.int32)

    @staticmethod
    def _fit(buf: torch.Tensor, n: int) -> torch.Tensor:
        if buf.numel() >= n:
            return buf
        return torch.empty(max(n, 2 * buf.numel()), dtype=torch.int32,
                           pin_memory=True)

    def run(self, vals: np.ndarray, n_codes: int, n_outs, ws, n_sym: int,
            pearson: bool, device) -> np.ndarray:
        """Upload vals[:n_codes], launch the group, copy its flat output
        back, all on the current stream; the flat int32 output, a view of
        the pinned buffer that the next group overwrites.  Spans:
        mtr.di.stage (the codes into pinned memory), mtr.di.wait (the
        host waits for upload, launch and copy back)."""
        with TIMERS.span("mtr.di.stage"):
            self.up = self._fit(self.up, n_codes)
            self.up[:n_codes].numpy()[:] = vals[:n_codes]
        codes = self.up[:n_codes].to(device, non_blocking=True)
        flat = _group(codes, n_outs, ws, n_sym, pearson)
        self.down = self._fit(self.down, flat.numel())
        back = self.down[: flat.numel()]
        back.copy_(flat, non_blocking=True)
        with TIMERS.span("mtr.di.wait"):
            torch.cuda.current_stream(device).synchronize()
        return back.numpy()


def di_group_device(buf: np.ndarray, di_len: int, ws, k: int, rsl: int,
                    device, manhattan: bool, staging=None) -> list:
    """Every pass of one k (windows ws) over buf in one launch on
    `device`, on the current stream: the di_tmp arrays of the oracle's
    passes, in ws's order.  `staging` (a _Staging) carries a CUDA group's
    codes and outputs through pinned memory.  Counts the group's traffic
    (utils/timers.DI_COUNTERS); spans mtr.di.widen (Manhattan's int32
    outputs to int64; Pearson's finish reads its int32 moments as they
    are) and mtr.di.finish."""
    device = torch.device(device)
    passes = [(w, di_len - w - rsl - k + 1) for w in ws]
    passes = [(w, n_i) for w, n_i in passes if n_i > 0]
    done = {}
    if passes:
        # a pass reads n_i + 3w - 1 codes (Manhattan: D of n_i + w
        # positions); JAX sizes each Manhattan pass's alphabet over its own
        # codes, stale tail of the arena included, and the group's largest
        # covers every code of every pass, so each pass's D is the same
        n_codes = max(n_i + 3 * w - 1 for w, n_i in passes)
        kk = _k_for(buf, n_codes) if manhattan else k
        # the codes once, over the longest pass (it covers every other)
        check_pass(buf, n_codes, max(w for w, _ in passes), kk)
        for w, _ in passes:
            check_pass(buf, 0, w, kk)
        TIMERS.count("di_manhattan_passes" if manhattan
                     else "di_pearson_passes", len(passes))
        pws = [w for w, _ in passes]
        n_outs = [n_i + w if manhattan else n_i for w, n_i in passes]
        rows = 1 if manhattan else 5
        TIMERS.count("di_positions", sum(n_outs))
        TIMERS.count("di_up_bytes", 4 * n_codes)
        TIMERS.count("di_down_bytes", 4 * rows * sum(n_outs))
        if staging is not None and device.type == "cuda":
            flat = staging.run(buf, n_codes, n_outs, pws, 4**kk,
                               not manhattan, device)
        else:
            flat = _group(_codes(buf, n_codes, device), n_outs, pws, 4**kk,
                          not manhattan).cpu().numpy()
        if manhattan:
            with TIMERS.span("mtr.di.widen"):
                flat = flat.astype(np.int64)
        with TIMERS.span("mtr.di.finish"):
            work = (None if manhattan
                    else np.empty((9, min(max(n_outs), FINISH_CHUNK))))
            for (w, n_i), res in zip(passes, split_group(flat, n_outs, rows)):
                done[w] = (_manhattan_finish(res, di_len, w, n_i)
                           if manhattan
                           else _pearson_finish(res, di_len, w, k, n_i, work))
    return [done[w] if w in done else np.full(di_len, -1.0) for w in ws]


def sliding_l1_sharded(vals: np.ndarray, w: int, n_out: int, mesh, k: int,
                       halo: int = 20480) -> np.ndarray:
    """Drop-in for sliding_l1 with the positions cut over `mesh`: slot s
    computes D for its contiguous block [lo, hi) of the n_out positions
    (blocks differ by at most one) from codes [lo, hi + 2w - 1), on its
    own stream, reaching into as many later blocks as the window needs
    (the JAX original's ring hops).  `halo` is the longest halo the
    caller's sweep may ask for (2 * w <= halo, as in JAX, where it sizes
    the program)."""
    from mtr_tpu_torch.parallel.mesh import _run_slots, split_bounds

    if 2 * w > halo:
        raise ValueError(f"window {w} needs a halo of {2 * w} > {halo}")
    n_out = max(n_out, 0)
    check_pass(vals, n_out + 2 * w - 1, w, k)
    TIMERS.count("di_sharded_passes")

    def work(dev, lo, hi):
        return (_group(_codes(vals[lo:], hi - lo + 2 * w - 1, dev),
                       [hi - lo], [w], 4**k, False),)

    # every slot's pass is queued before the first copy back waits
    blocks = _run_slots(mesh, split_bounds(n_out, mesh.size), work)
    return np.concatenate([np.zeros(0, np.int64)] + [
        _widen(b) for b, in blocks])


def make_di_manhattan_sharded(mesh):
    """The di_compute_k plug-in of fill_directional_index_with_end that runs
    each Manhattan pass of a k cut by position over `mesh`, a pass at a
    time (counterpart of mtr_tpu/ops/directional_index.py:248-271)."""

    def di_compute_k(buf, di_len: int, ws, k: int, rsl: int):
        tmps = []
        with TIMERS.span("mtr.di.device", "di_device"):
            for w in ws:
                n_i = di_len - w - rsl - k + 1
                if n_i <= 0:
                    tmps.append(np.full(di_len, -1.0))
                    continue
                kk = _k_for(buf, n_i + 3 * w - 1)
                D = sliding_l1_sharded(buf, w, n_i + w, mesh, kk)
                tmps.append(_manhattan_finish(D, di_len, w, n_i))
        return tmps

    return di_compute_k


def make_di_compute_k(device, manhattan: bool):
    """The di_compute_k plug-in of fill_directional_index_with_end: every
    w of one k in one launch on `device` (on a CUDA device through pinned
    memory)."""
    device = torch.device(device)
    staging = _Staging() if device.type == "cuda" else None

    def di_compute_k(buf, di_len: int, ws, k: int, rsl: int):
        with TIMERS.span("mtr.di.device", "di_device"):
            return di_group_device(buf, di_len, ws, k, rsl, device,
                                   manhattan, staging)

    return di_compute_k
