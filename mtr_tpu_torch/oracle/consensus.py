"""Repeat-unit polishing oracle (consensus.c:584-1087).

Two mechanisms refine the unit string when coverage is in [5, 20]:
  * polish_repeat — right-to-left walk over the unit replacing
    low-support ("suspicious") k-mers with better-supported neighbors,
    deciding del/sub/ins by summed look-back k-mer frequencies;
  * revise_representative_unit_sub — re-align with wrap-around DP,
    accumulate per-unit-column consensus/missing counts from the
    traceback, rebuild the unit column-major, and insert missing bases
    whose support clears the 1%-significance table min_missing_bases.
"""

from __future__ import annotations

import math

import numpy as np

from mtr_tpu_torch.records import RepeatRecord, ratio_less
from mtr_tpu_torch.oracle.wrap_dp import (
    wrap_dp_fill,
    traceback,
    wrap_around_dp_sub,
    _assign,
)
from mtr_tpu_torch.oracle.dbg import CountTable, query_kmer_values, MAX_PERIOD
from mtr_tpu_torch.utils.encoding import encode_bases, decode_bases

# 1%-significance thresholds, axes: unit-length bucket x error-rate
# bucket x coverage 1..20 (consensus.c:714-785).
MIN_MISSING_BASES = [
    # Num of hypotheses = 1600
    [
        [1,2,3,4,4,4,5,5,5,6,6,6,6,7,7,7,7,7,8,8],[1,2,3,4,4,4,5,5,5,5,6,6,6,6,7,7,7,7,7,8],
        [1,2,3,4,4,4,4,5,5,5,5,6,6,6,6,6,7,7,7,7],[1,2,3,3,4,4,4,5,5,5,5,5,6,6,6,6,6,7,7,7],
        [1,2,3,3,4,4,4,4,5,5,5,5,5,6,6,6,6,6,6,6],[1,2,3,3,3,4,4,4,4,5,5,5,5,5,5,5,6,6,6,6],
        [1,2,3,3,3,3,4,4,4,4,4,5,5,5,5,5,5,5,5,6],[1,2,3,3,3,3,3,4,4,4,4,4,4,4,4,5,5,5,5,5],
        [1,2,2,3,3,3,3,3,3,3,4,4,4,4,4,4,4,4,4,4],[1,2,2,2,2,2,2,3,3,3,3,3,3,3,3,3,3,3,3,3],
    ],
    # 1200
    [
        [1,2,3,4,4,4,5,5,5,6,6,6,6,7,7,7,7,7,8,8],[1,2,3,4,4,4,5,5,5,5,6,6,6,6,6,7,7,7,7,7],
        [1,2,3,3,4,4,4,5,5,5,5,6,6,6,6,6,7,7,7,7],[1,2,3,3,4,4,4,4,5,5,5,5,6,6,6,6,6,6,7,7],
        [1,2,3,3,4,4,4,4,4,5,5,5,5,5,6,6,6,6,6,6],[1,2,3,3,3,4,4,4,4,4,5,5,5,5,5,5,6,6,6,6],
        [1,2,3,3,3,3,4,4,4,4,4,4,5,5,5,5,5,5,5,5],[1,2,2,3,3,3,3,3,4,4,4,4,4,4,4,5,5,5,5,5],
        [1,2,2,2,3,3,3,3,3,3,3,4,4,4,4,4,4,4,4,4],[1,2,2,2,2,2,2,2,3,3,3,3,3,3,3,3,3,3,3,3],
    ],
    # 800
    [
        [1,2,3,4,4,4,5,5,5,5,6,6,6,6,7,7,7,7,7,8],[1,2,3,3,4,4,4,5,5,5,5,6,6,6,6,7,7,7,7,7],
        [1,2,3,3,4,4,4,5,5,5,5,5,6,6,6,6,6,7,7,7],[1,2,3,3,4,4,4,4,5,5,5,5,5,6,6,6,6,6,6,7],
        [1,2,3,3,3,4,4,4,4,5,5,5,5,5,5,6,6,6,6,6],[1,2,3,3,3,4,4,4,4,4,4,5,5,5,5,5,5,5,6,6],
        [1,2,3,3,3,3,4,4,4,4,4,4,4,5,5,5,5,5,5,5],[1,2,2,3,3,3,3,3,4,4,4,4,4,4,4,4,4,5,5,5],
        [1,2,2,2,3,3,3,3,3,3,3,3,4,4,4,4,4,4,4,4],[1,2,2,2,2,2,2,2,2,3,3,3,3,3,3,3,3,3,3,3],
    ],
    # 600
    [
        [1,2,3,3,4,4,5,5,5,5,6,6,6,6,6,7,7,7,7,7],[1,2,3,3,4,4,4,5,5,5,5,6,6,6,6,6,7,7,7,7],
        [1,2,3,3,4,4,4,4,5,5,5,5,6,6,6,6,6,6,7,7],[1,2,3,3,4,4,4,4,5,5,5,5,5,5,6,6,6,6,6,6],
        [1,2,3,3,3,4,4,4,4,4,5,5,5,5,5,5,6,6,6,6],[1,2,3,3,3,3,4,4,4,4,4,5,5,5,5,5,5,5,6,6],
        [1,2,2,3,3,3,3,4,4,4,4,4,4,4,5,5,5,5,5,5],[1,2,2,3,3,3,3,3,3,4,4,4,4,4,4,4,4,4,5,5],
        [1,2,2,2,3,3,3,3,3,3,3,3,3,4,4,4,4,4,4,4],[1,2,2,2,2,2,2,2,2,2,3,3,3,3,3,3,3,3,3,3],
    ],
    # 400
    [
        [1,2,3,3,4,4,4,5,5,5,5,6,6,6,6,7,7,7,7,7],[1,2,3,3,4,4,4,5,5,5,5,5,6,6,6,6,6,7,7,7],
        [1,2,3,3,4,4,4,4,5,5,5,5,5,6,6,6,6,6,6,7],[1,2,3,3,3,4,4,4,4,5,5,5,5,5,5,6,6,6,6,6],
        [1,2,3,3,3,4,4,4,4,4,5,5,5,5,5,5,5,6,6,6],[1,2,3,3,3,3,4,4,4,4,4,4,5,5,5,5,5,5,5,5],
        [1,2,2,3,3,3,3,4,4,4,4,4,4,4,4,5,5,5,5,5],[1,2,2,3,3,3,3,3,3,3,4,4,4,4,4,4,4,4,4,5],
        [1,2,2,2,2,3,3,3,3,3,3,3,3,3,4,4,4,4,4,4],[1,1,2,2,2,2,2,2,2,2,2,3,3,3,3,3,3,3,3,3],
    ],
    # 240
    [
        [1,2,3,3,4,4,4,5,5,5,5,5,6,6,6,6,6,7,7,7],[1,2,3,3,4,4,4,4,5,5,5,5,5,6,6,6,6,6,7,7],
        [1,2,3,3,3,4,4,4,4,5,5,5,5,5,6,6,6,6,6,6],[1,2,3,3,3,4,4,4,4,4,5,5,5,5,5,5,6,6,6,6],
        [1,2,3,3,3,3,4,4,4,4,4,5,5,5,5,5,5,5,6,6],[1,2,2,3,3,3,3,4,4,4,4,4,4,5,5,5,5,5,5,5],
        [1,2,2,3,3,3,3,3,4,4,4,4,4,4,4,4,5,5,5,5],[1,2,2,2,3,3,3,3,3,3,3,4,4,4,4,4,4,4,4,4],
        [1,2,2,2,2,2,3,3,3,3,3,3,3,3,3,3,4,4,4,4],[1,1,2,2,2,2,2,2,2,2,2,2,2,3,3,3,3,3,3,3],
    ],
    # 160
    [
        [1,2,3,3,4,4,4,4,5,5,5,5,6,6,6,6,6,7,7,7],[1,2,3,3,3,4,4,4,4,5,5,5,5,6,6,6,6,6,6,7],
        [1,2,3,3,3,4,4,4,4,5,5,5,5,5,5,6,6,6,6,6],[1,2,3,3,3,3,4,4,4,4,4,5,5,5,5,5,5,6,6,6],
        [1,2,2,3,3,3,4,4,4,4,4,4,5,5,5,5,5,5,5,6],[1,2,2,3,3,3,3,3,4,4,4,4,4,4,5,5,5,5,5,5],
        [1,2,2,2,3,3,3,3,3,4,4,4,4,4,4,4,4,5,5,5],[1,2,2,2,3,3,3,3,3,3,3,3,4,4,4,4,4,4,4,4],
        [1,2,2,2,2,2,3,3,3,3,3,3,3,3,3,3,3,4,4,4],[1,1,2,2,2,2,2,2,2,2,2,2,2,2,2,3,3,3,3,3],
    ],
    # 80
    [
        [1,2,3,3,3,4,4,4,4,5,5,5,5,5,6,6,6,6,6,7],[1,2,3,3,3,4,4,4,4,4,5,5,5,5,5,6,6,6,6,6],
        [1,2,3,3,3,3,4,4,4,4,4,5,5,5,5,5,5,6,6,6],[1,2,2,3,3,3,3,4,4,4,4,4,5,5,5,5,5,5,5,6],
        [1,2,2,3,3,3,3,3,4,4,4,4,4,4,5,5,5,5,5,5],[1,2,2,2,3,3,3,3,3,4,4,4,4,4,4,4,5,5,5,5],
        [1,2,2,2,3,3,3,3,3,3,3,4,4,4,4,4,4,4,4,4],[1,2,2,2,2,3,3,3,3,3,3,3,3,3,4,4,4,4,4,4],
        [1,2,2,2,2,2,2,2,3,3,3,3,3,3,3,3,3,3,3,3],[1,1,1,2,2,2,2,2,2,2,2,2,2,2,2,2,2,2,2,3],
    ],
    # 40
    [
        [1,2,2,3,3,3,4,4,4,4,5,5,5,5,5,6,6,6,6,6],[1,2,2,3,3,3,4,4,4,4,4,5,5,5,5,5,5,6,6,6],
        [1,2,2,3,3,3,3,4,4,4,4,4,5,5,5,5,5,5,5,6],[1,2,2,3,3,3,3,3,4,4,4,4,4,4,5,5,5,5,5,5],
        [1,2,2,2,3,3,3,3,3,4,4,4,4,4,4,4,5,5,5,5],[1,2,2,2,3,3,3,3,3,3,4,4,4,4,4,4,4,4,4,5],
        [1,2,2,2,2,3,3,3,3,3,3,3,3,4,4,4,4,4,4,4],[1,2,2,2,2,2,2,3,3,3,3,3,3,3,3,3,3,4,4,4],
        [1,1,2,2,2,2,2,2,2,2,3,3,3,3,3,3,3,3,3,3],[1,1,1,1,1,2,2,2,2,2,2,2,2,2,2,2,2,2,2,2],
    ],
    # 16
    [
        [1,2,2,3,3,3,3,4,4,4,4,4,5,5,5,5,5,5,6,6],[1,2,2,3,3,3,3,3,4,4,4,4,4,5,5,5,5,5,5,5],
        [1,2,2,2,3,3,3,3,4,4,4,4,4,4,4,5,5,5,5,5],[1,2,2,2,3,3,3,3,3,3,4,4,4,4,4,4,5,5,5,5],
        [1,2,2,2,2,3,3,3,3,3,3,4,4,4,4,4,4,4,4,5],[1,2,2,2,2,2,3,3,3,3,3,3,3,4,4,4,4,4,4,4],
        [1,2,2,2,2,2,2,3,3,3,3,3,3,3,3,3,4,4,4,4],[1,1,2,2,2,2,2,2,2,3,3,3,3,3,3,3,3,3,3,3],
        [1,1,1,2,2,2,2,2,2,2,2,2,2,3,3,3,3,3,3,3],[1,1,1,1,1,1,1,2,2,2,2,2,2,2,2,2,2,2,2,2],
    ],
]


def min_missing(rep_period: int, error: float, coverage: int) -> int:
    """consensus.c:787-820."""
    for i, t in enumerate((200, 150, 100, 75, 50, 30, 20, 10, 5)):
        if rep_period > t:
            break
    else:
        i = 9
    for j, t in enumerate((0.25, 0.225, 0.2, 0.175, 0.15, 0.125, 0.1, 0.075, 0.05)):
        if error > t:
            break
    else:
        j = 9
    if coverage <= 1:
        kk = 0
    elif coverage >= 20:
        kk = 19
    else:
        kk = coverage - 1
    return MIN_MISSING_BASES[i][j][kk]


def suspicious(rr: RepeatRecord, j: int) -> bool:
    """consensus.c:597-608 — >80% of the preceding k-1 scores are < 2."""
    cnt = 0
    i = 0
    while i < rr.kmer - 1 and 0 <= j - i:
        if rr.string_score[j - i] < 2:
            cnt += 1
        i += 1
    return (rr.kmer - 1) * 0.8 < cnt


def score_for_alignment(start, k, best_node, rep_period, int_unit, table) -> int:
    """consensus.c:584-595 — summed look-back k-mer frequencies."""
    pow4k1 = 4 ** (k - 1)
    tmp_node = best_node
    s = 0
    j = start
    while 0 <= j and start - k < j:
        tmp_node = int_unit[j % rep_period] * pow4k1 + tmp_node // 4
        s += table.freq(tmp_node)
        j -= 1
    return s


def polish_repeat(org, input_len, rr: RepeatRecord, use_native=True) -> None:
    """consensus.c:610-704 — right-to-left unit polishing.

    Known edge: when the walk reaches j == 0 on a suspicious position,
    the reference evaluates int_unit[-1] (out-of-bounds stack read,
    consensus.c:669); we deterministically read the last unit base
    instead, which may diverge from a given C build on such inputs.
    """
    k = rr.kmer
    if rr.rep_period <= k:
        return
    if use_native:
        from mtr_tpu_torch import native

        revised = native.polish(
            org, input_len, rr.rep_start, rr.rep_end, k,
            encode_bases(rr.string), rr.string_score[: rr.rep_period],
        )
        if revised is not None:
            rr.rep_period = len(revised)
            rr.string = decode_bases(revised)
            return
    table = CountTable(query_kmer_values(org, input_len, k, rr.rep_start, rr.rep_end))
    int_unit = encode_bases(rr.string).tolist()
    rep_period = rr.rep_period
    pow4 = [4**i for i in range(k + 1)]

    revised = [0] * MAX_PERIOD
    j_revised = MAX_PERIOD - 1

    ref_node = 0
    for i in range(k):
        ref_node = int_unit[i] * pow4[k - 1 - i] + ref_node
    best_node = ref_node

    j = rep_period - 1
    while 0 <= j:
        ref_node = int_unit[j] * pow4[k - 1] + best_node // 4
        tmp_best_freq = table.freq(ref_node)
        best_node = ref_node
        if rr.string_score[j] == 1 and suspicious(rr, j):
            for l in range(4):
                alt = (ref_node + (l - int_unit[j]) * pow4[k - 1]) % pow4[k]
                if tmp_best_freq < table.freq(alt):
                    tmp_best_freq = table.freq(alt)
                    best_node = alt
            if best_node == ref_node:
                revised[j_revised] = int_unit[j]
                j_revised -= 1
                j -= 1
            else:
                score_del = score_for_alignment(j, k, best_node, rep_period, int_unit, table)
                score_sub = score_for_alignment(j - 1, k, best_node, rep_period, int_unit, table)
                score_ins = -1
                if best_node // pow4[k - 1] == int_unit[(j - 1) % rep_period]:
                    score_ins = score_for_alignment(j - 2, k, best_node, rep_period, int_unit, table)
                revised[j_revised] = best_node // pow4[k - 1]
                j_revised -= 1
                max_score = max(score_del, score_sub, score_ins)
                if max_score == score_del:
                    pass  # reuse int_unit[j] in the next step
                elif max_score == score_sub:
                    j -= 1
                else:
                    j -= 2
        else:
            revised[j_revised] = int_unit[j]
            j_revised -= 1
            j -= 1
        if j_revised < 0:  # fails to revise
            return
    rr.rep_period = (MAX_PERIOD - 1) - j_revised
    rr.string = decode_bases(revised[j_revised + 1 : MAX_PERIOD])


def rebuild_unit_from_consensus(rr: RepeatRecord, consensus, missing) -> None:
    """The rebuild half of revise_representative_unit_sub
    (consensus.c:964-1012): column-max base per unit column (gap drops
    the column), plus insertion of significantly-supported missing
    bases.  Shared by the oracle and the device pipeline."""
    unit_len = rr.rep_period
    coverage = rr.repeat_len // rr.rep_period
    mismatch_ratio = (
        rr.num_mismatches + rr.num_insertions + rr.num_deletions
    ) / rr.repeat_len
    cons = np.asarray(consensus[1 : unit_len + 1])
    miss = np.asarray(missing[1 : unit_len + 1])
    max_bases = np.argmax(cons, axis=1)            # first max (ties -> smaller base)
    max_vs = miss.max(axis=1)
    max_missings = np.argmax(miss, axis=1)
    insert_ok = np.zeros(unit_len, dtype=bool)
    if 5 <= coverage <= 20:
        thr = min_missing(rr.rep_period, mismatch_ratio, coverage)
        insert_ok = max_vs >= thr                  # max_missing is always in 0..3
    revised: list[int] = []
    for j in range(unit_len):
        if max_bases[j] < 4:
            revised.append(int(max_bases[j]))
        if insert_ok[j]:
            revised.append(int(max_missings[j]))
    rr.rep_period = len(revised)
    rr.string = decode_bases(revised)


def rebuild_units_batch(tmps, results) -> None:
    """Batched rebuild_unit_from_consensus over many records: one argmax
    pass over padded (n, U, 5)/(n, U, 4) stacks replaces ~8 small numpy
    calls per record.  Semantics per record are identical (first-max
    ties, gap drops the column, min_missing-gated insertions)."""
    if not tmps:
        return
    n = len(tmps)
    U = max(t.rep_period for t in tmps)
    C = np.zeros((n, U, 5), np.int64)
    M = np.zeros((n, U, 4), np.int64)
    for q, (t, res) in enumerate(zip(tmps, results)):
        ul = t.rep_period
        C[q, :ul] = res[0][1 : ul + 1]
        M[q, :ul] = res[1][1 : ul + 1]
    mb_all = np.argmax(C, axis=2).tolist()   # first max: ties -> smaller base
    mv_all = M.max(axis=2).tolist()
    mm_all = np.argmax(M, axis=2).tolist()
    for q, t in enumerate(tmps):
        ul = t.rep_period
        coverage = t.repeat_len // t.rep_period
        thr = None
        if 5 <= coverage <= 20:
            mismatch_ratio = (
                t.num_mismatches + t.num_insertions + t.num_deletions
            ) / t.repeat_len
            thr = min_missing(t.rep_period, mismatch_ratio, coverage)
        mb, mv, mm = mb_all[q], mv_all[q], mm_all[q]
        revised: list[int] = []
        for j in range(ul):
            if mb[j] < 4:
                revised.append(mb[j])
            if thr is not None and mv[j] >= thr:
                revised.append(mm[j])
        t.rep_period = len(revised)
        t.string = decode_bases(revised)


def revise_representative_unit_sub(org, rr: RepeatRecord, mg, mp, ip) -> None:
    """consensus.c:851-1046 — re-align, build column consensus, rebuild
    the unit, and insert significantly-supported missing bases."""
    unit = encode_bases(rr.string)
    qs, qe = rr.rep_start, rr.rep_end
    rr.match_gain = mg
    rr.mismatch_penalty = mp
    rr.indel_penalty = ip

    rep_len = qe - qs + 1
    rep = org[qs + 1 : qs + 1 + rep_len]
    D, max_wrd, max_i, max_j = wrap_dp_fill(rep, unit, mg, mp, ip)
    path, _ = traceback(D, max_wrd, max_i, max_j, rep, unit, mg, mp, ip)

    consensus = np.zeros((MAX_PERIOD, 5), dtype=np.int64)
    missing = np.zeros((MAX_PERIOD, 4), dtype=np.int64)
    for mv, i, j in path:
        if mv in ("M", "X"):
            consensus[j][rep[i - 1]] += 1
        elif mv == "D":
            consensus[j][4] += 1
        else:  # insertion
            missing[j][rep[i - 1]] += 1

    rebuild_unit_from_consensus(rr, consensus, missing)


def revise_representative_unit(org, rr: RepeatRecord, input_len: int) -> None:
    """consensus.c:1048-1087 — polish, then two revision rounds with
    schemes (5,1,1) and (1,1,3); each kept only if it beats the
    PRE-revision match ratio (computed once, before both rounds)."""
    polish_repeat(org, input_len, rr)
    rr_ratio = rr.match_ratio()
    for mg, mp, ip in ((5, 1, 1), (1, 1, 3)):
        tmp = rr.copy()
        revise_representative_unit_sub(org, tmp, mg, mp, ip)
        if tmp.rep_period < MAX_PERIOD:
            wrap_around_dp_sub(org, tmp.rep_start, tmp.rep_end, tmp, mg, mp, ip)
            if ratio_less(rr_ratio, tmp.match_ratio()):
                _assign(rr, tmp)
