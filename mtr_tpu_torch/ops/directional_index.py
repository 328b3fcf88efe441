"""Directional-index sliding windows on a torch device.

Manhattan: D(i) = sum_v |count_v(codes[i:i+w]) - count_v(codes[i+w:i+2w])|
for every position i (fill_directional_index.c:171-295).  Pearson: the
per-position squared sums and inner products of three adjacent windows'
k-mer count vectors over the symbols below 4^k, then the sqrt/divide
finish in host float64, so DI matches the C double math bit for bit
(fill_directional_index.c:298-450).  Both are integers.

On a CUDA device a pass is one launch of a hand-written kernel
(csrc/directional_index.cu: `sliding_l1_kernel`, `pearson_moments_kernel`;
they replace the jitted jnp programs of mtr_tpu/ops/directional_index.py,
:29-58 and :105-142): a warp takes a tile of positions, builds the windows'
histograms of its first position in shared memory and slides through the
rest with the C tool's incremental update.  Their outputs are int32 (D <=
2w, every moment <= w^2 < 2^31); the host widens them to int64.
`_sliding_l1_device` and `_pearson_moments_device` are the plain versions
(per-symbol prefix sums over 256-symbol one-hot chunks): the CPU runs them,
and chip_smoke.py holds the kernels to them on the card.  Nothing is
padded: every function computes exactly the positions whose windows lie
inside the codes it is given.

The dispatchers (`sliding_l1_device`, `di_pearson_device`,
`sliding_l1_sharded`) check the kernels' bounds (codes in [0, 1024), w >= 1,
w^2 < 2^31) and raise on a violation, on every device.  On a CUDA device
they launch the kernel or raise; on the CPU they run the plain version.
Every device-to-host copy is one explicit .cpu() of the positions the
caller uses.  `make_di_compute` returns the `di_compute` plug-in of
mtr_tpu_torch.oracle.directional_index.fill_directional_index_with_end.

Over a mesh of several slots (parallel/mesh.py) the Manhattan pass is cut
by position (`sliding_l1_sharded`, `make_di_manhattan_sharded`; the JAX
original, :173-285, is a shard_map with a ring halo exchange): one
contiguous block of positions a slot, each computed from its own codes plus
the 2w - 1 codes to its right, on the slot's stream.  The sums are
integers, so the blocks put together equal the one-device pass bit for bit.
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
# positions a warp slides through (csrc/directional_index.cu::tile_for)
TILE_MIN, TILE_MAX = 128, 1024

# device DI passes since the last reset (the main path shows it ran here),
# and those of them cut over a mesh; the -c summary counts them by kind
# (di_manhattan_passes, di_pearson_passes, di_sharded_passes)
CALLS = 0
SHARDED_CALLS = 0
# kernel launches since the last reset, by kernel (a sharded pass launches
# once a CUDA slot)
KERNEL_LAUNCHES = {"di_sliding_l1": 0, "di_pearson_moments": 0}


def di_tile(span: int) -> int:
    """The kernels' tile for windows spanning `span` codes (2w Manhattan,
    3w Pearson): span / 32, the start's loads a lane, rounded up to a
    multiple of 32, within [TILE_MIN, TILE_MAX]."""
    return min(max((span // 32 + 31) // 32 * 32, TILE_MIN), TILE_MAX)


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


# ------------------------------------------------------------------ kernels


def _kernel_codes(codes: torch.Tensor, n_out: int, w: int, span: int):
    if not (codes.is_cuda and codes.dtype == torch.int32
            and codes.dim() == 1 and codes.is_contiguous()):
        raise ValueError("DI kernel: codes must be a contiguous 1-D int32 "
                         f"CUDA tensor, got {codes.dtype} {codes.device}")
    if n_out < 0 or codes.shape[0] < n_out + span - 1:
        raise ValueError(f"DI kernel: {n_out} positions need "
                         f"{n_out + span - 1} codes, got {codes.shape[0]}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def sliding_l1_kernel(codes: torch.Tensor, n_out: int, w: int,
                      n_sym: int) -> torch.Tensor:
    """D (n_out,) int32 by csrc/directional_index.cu on the current
    stream of codes' device; codes (>= n_out + 2w - 1,) int32, symbols
    outside [0, n_sym) skipped.  Counts the launch."""
    from mtr_tpu_torch.ops import _build

    _kernel_codes(codes, n_out, w, 2 * w)
    D = torch.empty(n_out, dtype=torch.int32, device=codes.device)
    if n_out == 0:
        return D
    err = _build.library().mtr_di_sliding_l1(
        codes.data_ptr(), codes.shape[0], n_out, w, n_sym, D.data_ptr(),
        _stream(codes.device))
    if err != 0:
        raise RuntimeError(f"DI sliding-L1 kernel launch failed: CUDA error "
                           f"{err} (n_out {n_out}, w {w}, n_sym {n_sym})")
    KERNEL_LAUNCHES["di_sliding_l1"] += 1
    return D


def pearson_moments_kernel(codes: torch.Tensor, n_out: int, w: int,
                           n_sym: int) -> torch.Tensor:
    """(5, n_out) int32 rows q0, q1, q2, ip01, ip12 by
    csrc/directional_index.cu on the current stream of codes' device;
    codes (>= n_out + 3w - 1,) int32, symbols outside [0, n_sym) skipped.
    Counts the launch."""
    from mtr_tpu_torch.ops import _build

    _kernel_codes(codes, n_out, w, 3 * w)
    out = torch.empty((5, n_out), dtype=torch.int32, device=codes.device)
    if n_out == 0:
        return out
    err = _build.library().mtr_di_pearson_moments(
        codes.data_ptr(), codes.shape[0], n_out, w, n_sym,
        *(row.data_ptr() for row in out), _stream(codes.device))
    if err != 0:
        raise RuntimeError(f"DI Pearson kernel launch failed: CUDA error "
                           f"{err} (n_out {n_out}, w {w}, n_sym {n_sym})")
    KERNEL_LAUNCHES["di_pearson_moments"] += 1
    return out


def _l1(codes: torch.Tensor, n_out: int, w: int, k: int) -> torch.Tensor:
    """D of the first n_out positions on codes' device: the kernel on a
    CUDA device, the plain version on the CPU."""
    if codes.is_cuda:
        return sliding_l1_kernel(codes, n_out, w, 4**k)
    if codes.device.type != "cpu":
        raise ValueError(f"no DI kernel for {codes.device}")
    return _sliding_l1_device(codes[: n_out + 2 * w - 1], k, w)


def _moments(codes: torch.Tensor, n_out: int, w: int, k: int):
    """(5, n_out) Pearson moments on codes' device, as _l1."""
    if codes.is_cuda:
        return pearson_moments_kernel(codes, n_out, w, 4**k)
    if codes.device.type != "cpu":
        raise ValueError(f"no DI kernel for {codes.device}")
    return torch.stack(_pearson_moments_device(codes[: n_out + 3 * w - 1],
                                               k, w))


# -------------------------------------------------------------- dispatchers


def sliding_l1_device(vals: np.ndarray, w: int, n_out: int,
                      device) -> np.ndarray:
    """Drop-in for oracle.directional_index.sliding_l1 on `device`."""
    global CALLS
    n_pos = n_out + 2 * w - 1
    k = _k_for(vals, n_pos)
    check_pass(vals, n_pos, w, k)
    CALLS += 1
    TIMERS.count("di_manhattan_passes")
    D = _l1(_codes(vals, n_pos, torch.device(device)), n_out, w, k)
    return D.cpu().numpy().astype(np.int64, copy=False)


def di_manhattan_device(buf: np.ndarray, di_len: int, w: int, k: int,
                        rsl: int, device) -> np.ndarray:
    """Manhattan DI pass with the oracle's bounds and placement."""
    di_tmp = np.full(di_len, -1.0)
    n_i = di_len - w - rsl - k + 1
    if n_i <= 0:
        return di_tmp
    D = sliding_l1_device(buf, w, n_i + w, device)
    d01 = D[:n_i]
    d12 = D[w : w + n_i]
    di_tmp[w : w + n_i] = (d01 - d12) / float(2 * w)
    return di_tmp


def di_pearson_device(buf: np.ndarray, di_len: int, w: int, k: int, rsl: int,
                      device) -> np.ndarray:
    """Pearson DI pass: moments on `device`, host float64 finish."""
    global CALLS
    di_tmp = np.full(di_len, -1.0)
    n_i = di_len - w - rsl - k + 1
    if n_i <= 0:
        return di_tmp
    n_pos = n_i + 3 * w - 1
    check_pass(buf, n_pos, w, k)
    CALLS += 1
    TIMERS.count("di_pearson_passes")
    moments = _moments(_codes(buf, n_pos, torch.device(device)), n_i, w, k)
    q0, q1, q2, ip01, ip12 = moments.cpu().numpy().astype(np.int64,
                                                          copy=False)
    n4k = float(4**k)
    s = float(w)
    sd0 = np.sqrt(q0 * n4k - s * s)
    sd1 = np.sqrt(q1 * n4k - s * s)
    sd2 = np.sqrt(q2 * n4k - s * s)
    with np.errstate(divide="ignore", invalid="ignore"):
        p01 = np.where(sd0 * sd1 > 0, (ip01 * n4k - s * s) / (sd0 * sd1), 0.0)
        p12 = np.where(sd1 * sd2 > 0, (ip12 * n4k - s * s) / (sd1 * sd2), 0.0)
    di_tmp[w : w + n_i] = p12 - p01
    return di_tmp


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

    global CALLS, SHARDED_CALLS
    if 2 * w > halo:
        raise ValueError(f"window {w} needs a halo of {2 * w} > {halo}")
    n_out = max(n_out, 0)
    check_pass(vals, n_out + 2 * w - 1, w, k)
    CALLS += 1
    SHARDED_CALLS += 1
    TIMERS.count("di_sharded_passes")

    def work(dev, lo, hi):
        return (_l1(_codes(vals[lo:], hi - lo + 2 * w - 1, dev), hi - lo,
                    w, k),)

    # every slot's pass is queued before the first copy back waits
    blocks = _run_slots(mesh, split_bounds(n_out, mesh.size), work)
    return np.concatenate([np.zeros(0, np.int64)] + [
        b.cpu().numpy().astype(np.int64, copy=False) for b, in blocks])


def make_di_manhattan_sharded(mesh):
    """The di_compute plug-in of fill_directional_index_with_end that runs
    each Manhattan pass cut by position over `mesh` (counterpart of
    mtr_tpu/ops/directional_index.py:248-271)."""

    def di_compute(buf, di_len: int, w: int, k: int, rsl: int):
        di_tmp = np.full(di_len, -1.0)
        n_i = di_len - w - rsl - k + 1
        if n_i <= 0:
            return di_tmp
        kk = _k_for(buf, n_i + 3 * w - 1)
        with TIMERS.section("di_device"):
            D = sliding_l1_sharded(buf, w, n_i + w, mesh, kk)
        d01 = D[:n_i]
        d12 = D[w : w + n_i]
        di_tmp[w : w + n_i] = (d01 - d12) / float(2 * w)
        return di_tmp

    return di_compute


def make_di_compute(device, manhattan: bool):
    """The di_compute plug-in of
    mtr_tpu_torch.oracle.directional_index.fill_directional_index_with_end,
    running each (k, w) pass on `device`."""
    device = torch.device(device)
    fn = di_manhattan_device if manhattan else di_pearson_device

    def di_compute(buf, di_len: int, w: int, k: int, rsl: int):
        with TIMERS.section("di_device"):
            return fn(buf, di_len, w, k, rsl, device)

    return di_compute
