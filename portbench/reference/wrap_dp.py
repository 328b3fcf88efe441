"""Wrap-around DP oracle — local alignment of a read segment against a
cyclic repeat unit (wrap_around_DP.c:222-429).

The fill is vectorized per row: the in-row deletion dependency
    D[i][j] = match ? diag+MG : max(0, diag-MP, up-IP, D[i][j-1]-IP)
is a (max,+) affine scan along j that resets at match cells (which take
diag+MG unconditionally) and at j==1 (the fill skips the deletion case
there, wrap_around_DP.c:269-274), so each row reduces to a segmented
running max — exact in integer arithmetic.

The traceback replicates the fixed precedence match > mismatch >
deletion > insertion with running-score equality tests
(wrap_around_DP.c:294-333), including the wrap column
D[i][0] = D[i][unit_len].
"""

from __future__ import annotations

import numpy as np

from portbench.reference.records import RepeatRecord, ratio_less
from portbench.reference.encoding import encode_bases

_BIG = np.int64(1) << np.int64(40)


def wrap_dp_fill(rep: np.ndarray, unit: np.ndarray, mg: int, mp: int, ip: int):
    """Fill the DP matrix.

    rep: int codes of the read segment, rep[i-1] is the C rep[i] (1-origin).
    unit: int codes of the unit, unit[j-1] is the C rep_unit[j].

    Returns (D, max_wrd, max_i, max_j) where D has shape
    (rep_len+1, unit_len+1); column 0 holds the wrap value of the SAME
    row (assigned after each row — wrap_around_DP.c:284), and row 0 is 0.
    Argmax scans rows then columns with strict improvement, i.e. the
    first maximal cell in row-major order (wrap_around_DP.c:276-281).
    """
    rep_len = len(rep)
    unit_len = len(unit)
    D = np.zeros((rep_len + 1, unit_len + 1), dtype=np.int64)
    jidx = np.arange(1, unit_len + 1, dtype=np.int64)
    ip_j = ip * jidx

    max_wrd = 0
    max_i = 0
    max_j = 0
    seg_reset = np.empty(unit_len, dtype=bool)
    for i in range(1, rep_len + 1):
        prev = D[i - 1]
        diag = prev[0:unit_len]
        up = prev[1 : unit_len + 1]
        match = unit == rep[i - 1]
        m = np.where(
            match,
            diag + mg,
            np.maximum(0, np.maximum(diag - mp, up - ip)),
        )
        # segmented running max implements the deletion chain
        np.logical_or(match, False, out=seg_reset)
        seg_reset[0] = True
        seg = np.cumsum(seg_reset)
        t = m + ip_j + seg * _BIG
        row = np.maximum.accumulate(t) - ip_j - seg * _BIG
        row = np.where(match, m, row)
        D[i, 1:] = row
        D[i, 0] = row[-1]  # wrap column
        rmax = int(row.max()) if unit_len else 0
        if max_wrd < rmax:
            max_wrd = rmax
            max_i = i
            max_j = int(np.argmax(row)) + 1
    return D, max_wrd, max_i, max_j


def traceback(D, max_wrd, max_i, max_j, rep, unit, mg, mp, ip):
    """Walk the optimal path back from the argmax.

    Yields a list of (move, i, j) with move in {'M','X','D','I'} in
    traceback order (end of repeat first).  i, j are 1-origin as in C.
    """
    unit_len = len(unit)
    i, j = max_i, max_j
    if j == 0:
        j = unit_len
    v = max_wrd
    path = []
    while i > 0 and D[i, j] > 0:
        diag = D[i - 1, j - 1]
        if rep[i - 1] == unit[j - 1] and v == diag + mg:
            path.append(("M", i, j))
            v -= mg
            i -= 1
            j -= 1
        elif rep[i - 1] != unit[j - 1] and v == diag - mp:
            path.append(("X", i, j))
            v += mp
            i -= 1
            j -= 1
        elif v == D[i, j - 1] - ip:
            path.append(("D", i, j))
            v += ip
            j -= 1
        elif v == D[i - 1, j] - ip:
            path.append(("I", i, j))
            v += ip
            i -= 1
        elif v == 0:
            break
        else:
            raise AssertionError(f"fatal error in wrap-around DP max_wrd = {v}")
        if j == 0:
            j = unit_len
    return path, i


def wrap_around_dp_sub(org, query_start, query_end, rr: RepeatRecord, mg, mp, ip):
    """wrap_around_DP.c:222-354 — one scoring scheme, updates rr in place.

    org is the persistent read arena (see oracle.arena); the C code reads
    rep[i] = org[query_start + i] for i = 1..rep_len, i.e. the segment
    org[query_start+1 .. query_end+1] — one past query_end.
    """
    unit = encode_bases(rr.string)
    rep_len = query_end - query_start + 1
    rep = org[query_start + 1 : query_start + 1 + rep_len]
    D, max_wrd, max_i, max_j = wrap_dp_fill(rep, unit, mg, mp, ip)
    path, i_final = traceback(D, max_wrd, max_i, max_j, rep, unit, mg, mp, ip)

    n_m = sum(1 for mv, _, _ in path if mv == "M")
    n_x = sum(1 for mv, _, _ in path if mv == "X")
    n_i = sum(1 for mv, _, _ in path if mv == "I")
    n_d = sum(1 for mv, _, _ in path if mv == "D")
    num_scanned_unit = n_m + n_x + n_d  # insertions skip the unit base

    rr.rep_start = query_start + i_final + 1
    rr.rep_end = query_start + max_i
    rr.repeat_len = max_i - i_final
    rr.num_freq_unit = num_scanned_unit // len(unit) if len(unit) else 0
    rr.num_matches = n_m
    rr.num_mismatches = n_x
    rr.num_insertions = n_i
    rr.num_deletions = n_d
    rr.match_gain = mg
    rr.mismatch_penalty = mp
    rr.indel_penalty = ip


def wrap_around_dp(org, query_start, query_end, rr: RepeatRecord):
    """Try schemes (1,1,3) then (1,3,1), keep the higher match ratio
    (wrap_around_DP.c:357-429; the (5,1,1) scheme is commented out in the
    reference)."""
    best = None
    best_ratio = -1.0
    for mg, mp, ip in ((1, 1, 3), (1, 3, 1)):
        tmp = rr.copy()
        wrap_around_dp_sub(org, query_start, query_end, tmp, mg, mp, ip)
        r = tmp.match_ratio()
        if ratio_less(best_ratio, r):
            best = tmp
            best_ratio = r
    if best is None:
        # both schemes yielded NaN ratios; C keeps the cleared max_rr
        best = RepeatRecord()
    _assign(rr, best)


_ASSIGN_FIELDS = (
    "read_id input_len rep_start rep_end repeat_len rep_period "
    "num_freq_unit num_matches num_mismatches num_insertions "
    "num_deletions kmer match_gain mismatch_penalty indel_penalty string"
).split()


def _assign(dst: RepeatRecord, src: RepeatRecord) -> None:
    """set_rr equivalent (fill_directional_index.c:62-84)."""
    d, sdict = dst.__dict__, src.__dict__
    for f in _ASSIGN_FIELDS:
        d[f] = sdict[f]
    d["string_score"] = list(sdict["string_score"])
    d["freq_2mer"] = list(sdict["freq_2mer"])


# entries of one batched fill's matrix (int32): chunks of jobs stay under
# a quarter GiB
FILL_BATCH_ENTRIES = 1 << 26


def wrap_dp_fill_batch(rep: np.ndarray, units: list, schemes: list):
    """wrap_dp_fill for several (unit, scheme) jobs over one segment `rep`,
    each job's row computed as there, side by side: units are padded to
    the longest with a code no base matches, and a padded column feeds no
    real one (diag and up read columns left of it, the deletion chain runs
    left to right).  Returns D (rep_len + 1, jobs, U + 1) int32, with
    job j's matrix in D[:, j, :len(units[j]) + 1], and per job max_wrd,
    max_i, max_j."""
    rep_len = len(rep)
    n = len(units)
    lens = np.array([len(u) for u in units], dtype=np.int64)
    U = int(lens.max())
    unit_mat = np.full((n, U), -2, dtype=np.int64)
    for j, u in enumerate(units):
        unit_mat[j, : len(u)] = u
    mg = np.array([s[0] for s in schemes], dtype=np.int64)[:, None]
    mp = np.array([s[1] for s in schemes], dtype=np.int64)[:, None]
    ip = np.array([s[2] for s in schemes], dtype=np.int64)[:, None]
    jidx = np.arange(1, U + 1, dtype=np.int64)[None, :]
    ip_j = ip * jidx
    valid = jidx <= lens[:, None]
    last = lens - 1
    rows = np.arange(n)

    D = np.zeros((rep_len + 1, n, U + 1), dtype=np.int32)
    prev = np.zeros((n, U + 1), dtype=np.int64)
    max_wrd = np.zeros(n, dtype=np.int64)
    max_i = np.zeros(n, dtype=np.int64)
    max_j = np.zeros(n, dtype=np.int64)
    for i in range(1, rep_len + 1):
        diag = prev[:, :U]
        up = prev[:, 1:]
        match = unit_mat == rep[i - 1]
        m = np.where(match, diag + mg, np.maximum(0, np.maximum(diag - mp, up - ip)))
        seg_reset = match.copy()
        seg_reset[:, 0] = True
        seg = np.cumsum(seg_reset, axis=1) * _BIG
        row = np.maximum.accumulate(m + ip_j + seg, axis=1) - ip_j - seg
        row = np.where(match, m, row)
        cur = np.empty((n, U + 1), dtype=np.int64)
        cur[:, 1:] = row
        cur[:, 0] = row[rows, last]  # wrap column
        D[i] = cur
        prev = cur
        rowv = np.where(valid, row, -1)
        rmax = rowv.max(axis=1)
        better = max_wrd < rmax
        if better.any():
            max_wrd[better] = rmax[better]
            max_i[better] = i
            max_j[better] = np.argmax(rowv[better], axis=1) + 1
    return D, max_wrd, max_i, max_j


def traceback_counts(D, max_wrd, max_i, max_j, rep, unit, mg, mp, ip):
    """traceback on one job's matrix, counting moves as it goes: returns
    (n_m, n_x, n_i, n_d, i_final), what wrap_around_dp_sub reads of the
    path.  D is indexed [i, j] (a view of the batched matrix)."""
    unit_len = len(unit)
    unit = unit.tolist()
    item = D.item
    i, j = int(max_i), int(max_j)
    if j == 0:
        j = unit_len
    v = int(max_wrd)
    n_m = n_x = n_i = n_d = 0
    while i > 0 and item(i, j) > 0:
        diag = item(i - 1, j - 1)
        same = rep[i - 1] == unit[j - 1]
        if same and v == diag + mg:
            n_m += 1
            v -= mg
            i -= 1
            j -= 1
        elif not same and v == diag - mp:
            n_x += 1
            v += mp
            i -= 1
            j -= 1
        elif v == item(i, j - 1) - ip:
            n_d += 1
            v += ip
            j -= 1
        elif v == item(i - 1, j) - ip:
            n_i += 1
            v += ip
            i -= 1
        elif v == 0:
            break
        else:
            raise AssertionError(f"fatal error in wrap-around DP max_wrd = {v}")
        if j == 0:
            j = unit_len
    return n_m, n_x, n_i, n_d, i


def wrap_around_dp_batch(org, query_start, query_end, recs: list) -> None:
    """wrap_around_dp on each of `recs` (candidates over one range), the
    fills of every (candidate, scheme) batched: the same fields as one
    call a candidate."""
    if not recs:
        return
    schemes = ((1, 1, 3), (1, 3, 1))
    rep_len = query_end - query_start + 1
    rep = org[query_start + 1 : query_start + 1 + rep_len]
    rep_l = rep.tolist()
    jobs = [(r, encode_bases(r.string), s) for r in recs for s in schemes]
    results = []
    lo = 0
    while lo < len(jobs):
        U = max(len(u) for _, u, _ in jobs[lo:])
        per = max(1, FILL_BATCH_ENTRIES // ((rep_len + 1) * (U + 1)))
        chunk = jobs[lo : lo + per]
        D, mw, mi, mj = wrap_dp_fill_batch(rep, [u for _, u, _ in chunk],
                                           [s for _, _, s in chunk])
        for c, (r, unit, (mg, mp, ip)) in enumerate(chunk):
            n_m, n_x, n_i, n_d, i_final = traceback_counts(
                D[:, c, : len(unit) + 1], mw[c], mi[c], mj[c], rep_l, unit, mg, mp, ip)
            tmp = r.copy()
            tmp.rep_start = query_start + i_final + 1
            tmp.rep_end = query_start + int(mi[c])
            tmp.repeat_len = int(mi[c]) - i_final
            tmp.num_freq_unit = (n_m + n_x + n_d) // len(unit) if len(unit) else 0
            tmp.num_matches = n_m
            tmp.num_mismatches = n_x
            tmp.num_insertions = n_i
            tmp.num_deletions = n_d
            tmp.match_gain = mg
            tmp.mismatch_penalty = mp
            tmp.indel_penalty = ip
            results.append(tmp)
        del D
        lo += len(chunk)
    for k, r in enumerate(recs):
        best = None
        best_ratio = -1.0
        for tmp in results[2 * k : 2 * k + 2]:
            ratio = tmp.match_ratio()
            if ratio_less(best_ratio, ratio):
                best = tmp
                best_ratio = ratio
        _assign(r, best if best is not None else RepeatRecord())
