"""Directional-index region localization, plain NumPy
(fill_directional_index.c:137-602).

`dtype` is the precision of the floating-point steps (the DI finish and
the Jaccard index of remove_redundant_ranges): float64, as the C tool
computes them, or float32 for the benchmark's control.

At position p with window width w the DI measures how much more similar
the two windows right of p are than the two windows straddling p, using
k-mer count vectors:
  Manhattan (default): DI = (d01 - d12) / (2w)
  Pearson (-p):        DI = P12 - P01

Key exactness notes:
  * d01(i) and d12(i) are integer L1 distances of adjacent w-windows and
    d12(i) == d01(i+w), so one sliding array D(i) suffices; the final
    division by 2w is the only floating-point step, matching the C
    incremental updates bit-for-bit.
  * MT19937 is reseeded with 0 per (read, k) pass and consumes
    min(L+4*rsl, 1e6) + rsl + rsl draws (fill_directional_index.c:
    137-156); the region beyond the k-merized prefix keeps raw values
    and the sliding windows may read past the filled region into stale
    arena content (see arena.py).
"""

from __future__ import annotations

import numpy as np

from portbench.reference.arena import Arena
from portbench.reference.mt19937 import MT19937
from portbench.reference.encoding import rolling_kmer_codes


_FLANK_CACHE: dict = {}


def _flank_draws(l4: int, rsl: int):
    """The reference reseeds MT19937(0) per (read, k) pass
    (fill_directional_index.c:140), so the three draw arrays are a pure
    function of (l4, rsl) — identical across the k in {1,3,5} passes and
    across same-length reads.  Cached (bounded) to avoid regenerating."""
    key = (l4, rsl)
    hit = _FLANK_CACHE.get(key)
    if hit is None:
        mt = MT19937(0)
        hit = (mt.random_bases(l4), mt.random_bases(rsl), mt.random_bases(rsl))
        if len(_FLANK_CACHE) >= 8:
            _FLANK_CACHE.clear()
        _FLANK_CACHE[key] = hit
    return hit


def init_input_w_rand(arena: Arena, k: int, input_len: int, rsl: int) -> None:
    """fill_directional_index.c:137-169 — random flanks + in-place k-mer
    codes over the prefix [0, L + 2*rsl - k + 1)."""
    buf = arena.input_w_rand
    L = input_len
    l4 = min(L + 4 * rsl, arena.max_input_length)
    full, pre, post = _flank_draws(l4, rsl)
    buf[:l4] = full
    buf[:rsl] = pre
    buf[rsl : rsl + L] = arena.org_input[:L]
    buf[rsl + L : rsl + L + rsl] = post
    n_codes = L + 2 * rsl - k + 1
    if n_codes > 0:
        buf[:n_codes] = rolling_kmer_codes(buf[: L + 2 * rsl].copy(), k)


def sliding_l1(vals: np.ndarray, w: int, n_out: int) -> np.ndarray:
    """D[i] = sum_v |count_v(vals[i:i+w]) - count_v(vals[i+w:i+2w])|
    for i in [0, n_out), exact in integers.

    D[0] from the two windows' histograms.  From i to i + 1 only the
    difference d_v = (count in the first window) - (count in the second)
    of a = vals[i] (leaves the first window: -1), b = vals[i + w] (moves
    from the second to the first: +2) and c = vals[i + 2w] (enters the
    second: -1) changes, so D[i + 1] - D[i] sums |d_v + change| - |d_v|
    over the distinct symbols among them.  d_v(i) comes from the symbol's
    prefix counts: its rank at its own position, a search of one sorted
    array of (symbol, position) keys elsewhere."""
    if n_out <= 0:
        return np.zeros(0, dtype=np.int64)
    n_pos = n_out + 2 * w - 1
    x = vals[:n_pos].astype(np.int64)
    N = n_pos + 1
    order = np.argsort(x * N + np.arange(n_pos, dtype=np.int64), kind="stable")
    keys = (x * N + np.arange(n_pos, dtype=np.int64))[order]
    n_sym = int(x.max()) + 1
    start = np.searchsorted(keys, np.arange(n_sym, dtype=np.int64) * N)
    rank = np.empty(n_pos, dtype=np.int64)
    rank[order] = np.arange(n_pos, dtype=np.int64)
    rank -= start[x]  # occurrences of x[p] in x[:p]
    D = np.empty(n_out, dtype=np.int64)
    D[0] = np.abs(np.bincount(x[:w], minlength=n_sym)
                  - np.bincount(x[w : 2 * w], minlength=n_sym)).sum()
    if n_out == 1:
        return D

    def prefix(v, t):  # occurrences of v in x[:t]
        return np.searchsorted(keys, v * N + t) - start[v]

    i = np.arange(n_out - 1, dtype=np.int64)
    ia, ib, ic = i, i + w, i + 2 * w
    a, b, c = x[ia], x[ib], x[ic]
    d_a = 2 * prefix(a, ib) - rank[ia] - prefix(a, ic)
    d_b = 2 * rank[ib] - prefix(b, ia) - prefix(b, ic)
    d_c = 2 * prefix(c, ib) - prefix(c, ia) - rank[ic]
    ab, ac, bc = a == b, a == c, b == c
    ch_a = -1 + 2 * ab - ac
    ch_b = 2 - bc
    step = np.abs(d_a + ch_a) - np.abs(d_a)
    step += np.where(~ab, np.abs(d_b + ch_b) - np.abs(d_b), 0)
    step += np.where(~ac & ~bc, np.abs(d_c - 1) - np.abs(d_c), 0)
    D[1:] = D[0] + np.cumsum(step)
    return D


def di_manhattan(buf: np.ndarray, di_len: int, w: int, k: int, rsl: int,
                 dtype=np.float64) -> np.ndarray:
    """fill_directional_index_Manhattan (:171-295): DI values at positions
    [w, n_i + w); everything else -1."""
    di_tmp = np.full(di_len, -1.0)
    n_i = di_len - w - rsl - k + 1
    if n_i <= 0:
        return di_tmp
    D = sliding_l1(buf, w, n_i + w)
    d01 = D[:n_i]
    d12 = D[w : w + n_i]
    di_tmp[w : w + n_i] = (d01 - d12).astype(dtype) / dtype(2 * w)
    return di_tmp


def di_pearson(buf: np.ndarray, di_len: int, w: int, k: int, rsl: int,
               dtype=np.float64) -> np.ndarray:
    """fill_directional_index_PCC (:298-450): DI = P12 - P01 with the
    zero-SD guard.  Pearson terms need q (sum of squared counts) and ip
    (inner products) per position; computed exactly with integer prefix
    sums then combined in float64 as the C code does."""
    di_tmp = np.full(di_len, -1.0)
    n_i = di_len - w - rsl - k + 1
    if n_i <= 0:
        return di_tmp
    n4k = 4**k
    n_pos = n_i + 3 * w - 1
    used = buf[:n_pos]
    q = np.zeros((3, n_i), dtype=np.int64)  # per-window squared sums
    ip01 = np.zeros(n_i, dtype=np.int64)
    ip12 = np.zeros(n_i, dtype=np.int64)
    vmax = int(used.max()) + 1
    for lo in range(0, vmax, 256):
        hi = min(lo + 256, vmax)
        width = hi - lo
        onehot = np.zeros((n_pos + 1, width), dtype=np.int32)
        sel = (used >= lo) & (used < hi)
        idx = np.nonzero(sel)[0]
        onehot[idx + 1, used[idx] - lo] = 1
        P = np.cumsum(onehot, axis=0)
        W0 = (P[w : w + n_i] - P[:n_i]).astype(np.int64)
        W1 = (P[2 * w : 2 * w + n_i] - P[w : w + n_i]).astype(np.int64)
        W2 = (P[3 * w : 3 * w + n_i] - P[2 * w : 2 * w + n_i]).astype(np.int64)
        q[0] += (W0 * W0).sum(axis=1)
        q[1] += (W1 * W1).sum(axis=1)
        q[2] += (W2 * W2).sum(axis=1)
        ip01 += (W0 * W1).sum(axis=1)
        ip12 += (W1 * W2).sum(axis=1)
    s = dtype(w)
    n4 = dtype(n4k)
    q, ip01, ip12 = q.astype(dtype), ip01.astype(dtype), ip12.astype(dtype)
    sd0 = np.sqrt(q[0] * n4 - s * s)
    sd1 = np.sqrt(q[1] * n4 - s * s)
    sd2 = np.sqrt(q[2] * n4 - s * s)
    with np.errstate(divide="ignore", invalid="ignore"):
        p01 = np.where(sd0 * sd1 > 0, (ip01 * n4 - s * s) / (sd0 * sd1), 0.0)
        p12 = np.where(sd1 * sd2 > 0, (ip12 * n4 - s * s) / (sd1 * sd2), 0.0)
    di_tmp[w : w + n_i] = p12 - p01
    return di_tmp


def put_local_maximum(di_tmp, di, di_end, di_w, di_len: int, w: int) -> None:
    """put_local_maximum_into_directional_index (:467-503), literal port
    including the in-loop index jump after closing a range."""
    di_tmp = di_tmp.tolist()  # Python floats: the same values, faster scalar reads
    local_max = -1.0
    local_max_i = -1
    i = 0
    while i < di_len:
        if local_max < di_tmp[i]:
            local_max = di_tmp[i]
            local_max_i = i
        if local_max_i + w < i and di[local_max_i] < local_max and 0.0 < local_max:
            local_min = 1.0
            local_min_j = local_max_i
            for j in range(local_max_i, di_len):
                if local_min > di_tmp[j]:
                    local_min = di_tmp[j]
                    local_min_j = j
                if local_min_j + w < j:
                    di[local_max_i] = local_max
                    di_w[local_max_i] = w
                    di_end[local_max_i] = local_min_j + w
                    i = local_min_j + w
                    break
            local_max = -1.0
        i += 1


def remove_redundant_ranges(di, di_end, input_len: int, min_jaccard: float = 0.98,
                            dtype=np.float64) -> None:
    """remove_redundant_ranges (:505-546): containment and Jaccard
    evictions, with the early break when range i is evicted.

    The inner scan over j is vectorised: within one i it reads each j
    once, and evicting a j changes nothing the later j of the same scan
    read, so its first eviction of i ends it as the C loop does.  Since
    j > i, the C code's test "i inside j" can never hold."""
    pos = np.nonzero(di[:input_len] > 0.0)[0]
    for i in pos.tolist():
        i_di = di[i]
        if not (0.0 < i_di):  # evicted by an earlier i
            continue
        i_end = int(di_end[i])
        if i_end <= i:
            continue
        j = np.arange(i + 1, i_end + 1)
        j = j[di[j] > 0.0]
        if not len(j):
            continue
        j_end = di_end[j]
        j_di = di[j]
        jac = ((np.minimum(i_end, j_end) - j).astype(dtype)
               / (np.maximum(i_end, j_end) - i).astype(dtype))
        close = min_jaccard < jac
        evict_i = close & (i_di < j_di)
        evict_j = (close & ~(i_di < j_di)) | (~close & (i_end >= j_end) & (i_di > j_di))
        stop = np.nonzero(evict_i)[0]
        if len(stop):
            evict_j[stop[0]:] = False
            di[i] = -1.0
            di_end[i] = -1
        gone = j[evict_j]
        di[gone] = -1.0
        di_end[gone] = -1


def fill_directional_index_with_end(
    arena: Arena,
    input_len: int,
    rsl: int,
    manhattan: bool = True,
    dtype=np.float64,
):
    """fill_directional_index_with_end (:549-602).

    Returns (di, di_end, di_w) arrays of length di_len = L + 2*rsl with
    read-coordinate entries in [0, L) after de-shifting."""
    L = input_len
    di_len = L + 2 * rsl
    di = np.full(di_len, -1.0)
    di_end = np.full(di_len, -1, dtype=np.int64)
    di_w = np.full(di_len, -1, dtype=np.int64)

    for k in (1, 3, 5):
        max_w = {1: 20, 3: 80}.get(k, 10240)
        init_input_w_rand(arena, k, L, rsl)
        w = 5
        while w <= max_w and w < L // 2:
            if manhattan:
                di_tmp = di_manhattan(arena.input_w_rand, di_len, w, k, rsl, dtype)
            else:
                di_tmp = di_pearson(arena.input_w_rand, di_len, w, k, rsl, dtype)
            put_local_maximum(di_tmp, di, di_end, di_w, di_len, w)
            w *= 2

    # de-shift random flanks back to read coordinates (:587-597)
    di[:L] = di[rsl : rsl + L]
    di_end[:L] = di_end[rsl : rsl + L] - rsl
    di_w[:L] = di_w[rsl : rsl + L]
    di[L:] = -1.0
    di_end[L:] = -1
    di_w[L:] = -1

    remove_redundant_ranges(di, di_end, L, dtype=dtype)
    return di, di_end, di_w
