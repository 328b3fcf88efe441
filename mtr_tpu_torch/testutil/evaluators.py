"""Accuracy evaluators — ports of test_single_TR/util/count_match.cpp
and comp_mTR_DP.cpp.

count_match: number of reads whose predicted unit equals the truth unit
exactly as a cyclic string (count_match.cpp:81-119).

comp_dp: per-record cyclic-alignment match ratio — global DP of the
prediction against the cyclic truth unit with match/mis/gap = 1/-1/-1
(comp_mTR_DP.cpp:63-268); the harness buckets the ratios at
1/0.99/0.98/0.96/0.94 (test.sh:51-61).
"""

from __future__ import annotations

import numpy as np


def parse_records(lines) -> list[tuple[int, str]]:
    """(read_id, predicted_unit) per record line (13-field TSV)."""
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            break
        parts = line.replace("\t", " ").replace(",", " ").replace(")", " ").split()
        if len(parts) < 13:
            continue
        out.append((int(parts[0]), parts[12]))
    return out


def count_match(record_lines, truth_units: list[str]) -> int:
    perfect = [0] * len(truth_units)
    for rid, seq in parse_records(record_lines):
        truth = truth_units[rid]
        if len(truth) == len(seq):
            n = len(truth)
            for i in range(n):
                if truth[i:] + truth[:i] == seq:
                    perfect[rid] = 1
                    break
    return sum(perfect)


def cal_dp(a: str, b: str) -> float:
    """comp_mTR_DP.cpp:63-268 — global alignment of a against cyclic b,
    returning match_num / alignment_length.

    Row 0 of the matrix is tied to row |b|-1 of the previous column (the
    wrap); fill order is column-major with an in-column gap chain, which
    reduces to a running max per column.
    """
    match, miss, gap = 1, -1, -1
    nb, na = len(b), len(a)
    NEGINF = -999999
    M = np.full((nb + 1, na + 1), NEGINF, dtype=np.int64)
    M[:, 0] = 0
    a_codes = np.frombuffer(a.encode(), dtype=np.uint8)
    b_codes = np.frombuffer(b.encode(), dtype=np.uint8)
    ii = np.arange(nb + 1)
    for j in range(1, na + 1):
        prev = M[:, j - 1]
        base = np.full(nb + 1, NEGINF, dtype=np.int64)
        # rows i>=1: diagonal from prev col
        eq = b_codes == a_codes[j - 1]
        base[1:] = prev[:-1] + np.where(eq, match, miss)
        # row 0: wrap diagonal from prev col row nb-1
        base[0] = prev[nb - 1] + (match if a_codes[j - 1] == b_codes[nb - 1] else miss)
        # left gap from prev col (all rows)
        base = np.maximum(base, prev + gap)
        # in-column up-gap chain: M[i][j] = max(base[i], M[i-1][j]+gap),
        # except row 0 has no up-gap -> plain running max with offset
        t = base + ii  # gap = -1 per row step
        col = np.maximum.accumulate(t) - ii
        col[0] = base[0]
        M[:, j] = col

    x = nb
    y = na
    best = M[x, y]
    for i in range(nb + 1):
        if M[i, y] > best:
            best = M[i, y]
            x = i
    match_num = 0
    aln_len = 0
    while True:
        update = False
        if x == 0 and y > 0:
            last = nb - 1
            if a[y - 1] == b[last] and M[x, y] - match == M[nb - 1, y - 1]:
                x = nb - 1
                y -= 1
                update = True
                match_num += 1
                aln_len += 1
            elif a[y - 1] != b[last] and M[x, y] - miss == M[nb - 1, y - 1]:
                x = nb - 1
                y -= 1
                update = True
                aln_len += 1
        if x > 0 and y > 0 and not update:
            if a[y - 1] == b[x - 1] and M[x, y] - match == M[x - 1, y - 1]:
                x -= 1
                y -= 1
                update = True
                match_num += 1
                aln_len += 1
            elif a[y - 1] != b[x - 1] and M[x, y] - miss == M[x - 1, y - 1]:
                x -= 1
                y -= 1
                update = True
                aln_len += 1
        if x > 0 and not update:
            if M[x, y] - gap == M[x - 1, y]:
                x -= 1
                update = True
                aln_len += 1
        if y > 0 and not update:
            if M[x, y] - gap == M[x, y - 1]:
                y -= 1
                aln_len += 1
        if y == 0:
            break
    return match_num / aln_len if aln_len else 0.0


def comp_dp(record_lines, truth_units: list[str]) -> list[float]:
    out = []
    for rid, seq in parse_records(record_lines):
        truth = truth_units[rid]
        if len(truth) >= len(seq):
            a, b = truth, seq
        else:
            a, b = seq, truth
        out.append(cal_dp(a, b))
    return out
