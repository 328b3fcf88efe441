"""Directional-index region localization oracle
(fill_directional_index.c:137-602).

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
    arena content (see oracle.arena).
"""

from __future__ import annotations

import math

import numpy as np

from mtr_tpu_torch.oracle.arena import Arena, MAX_INPUT_LENGTH
from mtr_tpu_torch.utils.mt19937 import MT19937
from mtr_tpu_torch.utils.encoding import rolling_kmer_codes
from mtr_tpu_torch.utils.timers import TIMERS


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


def sliding_l1(vals: np.ndarray, w: int, n_out: int, chunk: int = 256, use_native=True) -> np.ndarray:
    """D[i] = sum_v |count_v(vals[i:i+w]) - count_v(vals[i+w:i+2w])|
    for i in [0, n_out), via per-symbol prefix sums (exact, integer).
    Uses the native incremental-histogram path when available (~100x)."""
    if use_native and n_out > 0:
        from mtr_tpu_torch import native

        res = native.sliding_l1(vals, w, n_out)
        if res is not None:
            return res
    n_pos = n_out + 2 * w - 1
    used = vals[:n_pos]
    D = np.zeros(n_out, dtype=np.int64)
    vmax = int(used.max()) + 1 if n_pos > 0 else 1
    for lo in range(0, vmax, chunk):
        hi = min(lo + chunk, vmax)
        width = hi - lo
        onehot = np.zeros((n_pos + 1, width), dtype=np.int32)
        sel = (used >= lo) & (used < hi)
        idx = np.nonzero(sel)[0]
        onehot[idx + 1, used[idx] - lo] = 1
        P = np.cumsum(onehot, axis=0)
        # W(i) - W(i+w) = 2*P[i+w] - P[i] - P[i+2w]
        diff = 2 * P[w : w + n_out] - P[:n_out] - P[2 * w : 2 * w + n_out]
        D += np.abs(diff, dtype=np.int64).sum(axis=1)
    return D


def di_manhattan(buf: np.ndarray, di_len: int, w: int, k: int, rsl: int, use_native: bool = True) -> np.ndarray:
    """fill_directional_index_Manhattan (:171-295): DI values at positions
    [w, n_i + w); everything else -1."""
    di_tmp = np.full(di_len, -1.0)
    n_i = di_len - w - rsl - k + 1
    if n_i <= 0:
        return di_tmp
    D = sliding_l1(buf, w, n_i + w, use_native=use_native)
    d01 = D[:n_i]
    d12 = D[w : w + n_i]
    di_tmp[w : w + n_i] = (d01 - d12) / float(2 * w)
    return di_tmp


def di_pearson(buf: np.ndarray, di_len: int, w: int, k: int, rsl: int) -> np.ndarray:
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
    s = float(w)
    sd0 = np.sqrt(q[0] * float(n4k) - s * s)
    sd1 = np.sqrt(q[1] * float(n4k) - s * s)
    sd2 = np.sqrt(q[2] * float(n4k) - s * s)
    with np.errstate(divide="ignore", invalid="ignore"):
        p01 = np.where(sd0 * sd1 > 0, (ip01 * float(n4k) - s * s) / (sd0 * sd1), 0.0)
        p12 = np.where(sd1 * sd2 > 0, (ip12 * float(n4k) - s * s) / (sd1 * sd2), 0.0)
    di_tmp[w : w + n_i] = p12 - p01
    return di_tmp


def put_local_maximum(di_tmp, di, di_end, di_w, di_len: int, w: int, use_native=True) -> None:
    """put_local_maximum_into_directional_index (:467-503), literal port
    including the in-loop index jump after closing a range."""
    if use_native:
        from mtr_tpu_torch import native

        if native.extrema_pair(di_tmp, di, di_end, di_w, di_len, w):
            return
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


def remove_redundant_ranges(di, di_end, input_len: int, min_jaccard: float = 0.98, use_native=True) -> None:
    """remove_redundant_ranges (:505-546), literal port (cached i-values,
    containment evictions, early break when range i is evicted)."""
    if use_native:
        from mtr_tpu_torch import native

        if native.remove_redundant(di, di_end, input_len, min_jaccard):
            return
    for i in range(input_len):
        i_begin = i
        i_end = int(di_end[i])
        i_di = float(di[i])
        if not (0.0 < i_di):
            continue
        for j in range(i + 1, i_end + 1):
            j_begin = j
            j_end = int(di_end[j])
            j_di = float(di[j])
            if not (0.0 < j_di):
                continue
            jac = (min(i_end, j_end) - max(i_begin, j_begin)) / float(
                max(i_end, j_end) - min(i_begin, j_begin)
            )
            if min_jaccard < jac:
                if i_di < j_di:
                    di[i] = -1.0
                    di_end[i] = -1
                    break
                di[j] = -1.0
                di_end[j] = -1
            else:
                if i_begin >= j_begin and i_end <= j_end and i_di < j_di:
                    di[i] = -1.0
                    di_end[i] = -1
                    break
                if i_begin <= j_begin and i_end >= j_end and i_di > j_di:
                    di[j] = -1.0
                    di_end[j] = -1


def fill_directional_index_with_end(
    arena: Arena,
    input_len: int,
    rsl: int,
    manhattan: bool = True,
    di_compute_k=None,
    use_native: bool = True,
):
    """fill_directional_index_with_end (:549-602).

    Returns (di, di_end, di_w) arrays of length di_len = L + 2*rsl with
    read-coordinate entries in [0, L) after de-shifting.
    di_compute_k(buf, di_len, ws, k, rsl) optionally overrides the DI
    passes of one k (used to plug in the device kernel while keeping the
    sequential pairing logic): it returns their di_tmp arrays in ws's
    order (the codes do not change between the w of one k), which
    put_local_maximum then takes in the same order.
    """
    L = input_len
    di_len = L + 2 * rsl
    # The reference would OVERFLOW its 1 Mbp DI arrays here (it segfaults
    # on reads longer than ~833 kbp); the arena carries headroom so every
    # read the FASTA limit admits processes cleanly, with the l4
    # random-fill cap kept at the reference's array size for parity.
    if di_compute_k is None and use_native:
        from mtr_tpu_torch import native

        res = native.fill_di(arena.input_w_rand, arena.org_input, L, rsl,
                             manhattan, l4_cap=arena.max_input_length)
        if res is not None:
            return res
    di = np.full(di_len, -1.0)
    di_end = np.full(di_len, -1, dtype=np.int64)
    di_w = np.full(di_len, -1, dtype=np.int64)

    for k in (1, 3, 5):
        max_w = {1: 20, 3: 80}.get(k, 10240)
        init_input_w_rand(arena, k, L, rsl)
        ws = []
        w = 5
        while w <= max_w and w < L // 2:
            ws.append(w)
            w *= 2
        if di_compute_k is not None:
            tmps = di_compute_k(arena.input_w_rand, di_len, ws, k, rsl)
            with TIMERS.span("mtr.di.pair"):
                for w, di_tmp in zip(ws, tmps):
                    put_local_maximum(di_tmp, di, di_end, di_w, di_len, w, use_native=use_native)
            continue
        for w in ws:
            if manhattan:
                di_tmp = di_manhattan(arena.input_w_rand, di_len, w, k, rsl, use_native=use_native)
            else:
                di_tmp = di_pearson(arena.input_w_rand, di_len, w, k, rsl)
            put_local_maximum(di_tmp, di, di_end, di_w, di_len, w, use_native=use_native)

    # de-shift random flanks back to read coordinates (:587-597)
    di[:L] = di[rsl : rsl + L]
    di_end[:L] = di_end[rsl : rsl + L] - rsl
    di_w[:L] = di_w[rsl : rsl + L]
    di[L:] = -1.0
    di_end[L:] = -1
    di_w[L:] = -1

    remove_redundant_ranges(di, di_end, L, use_native=use_native)
    return di, di_end, di_w
