"""k-mer counting and greedy De Bruijn unit inference oracle
(consensus.c:37-582).

Counting behavior that matters for parity:
  * init_inputString k-merizes positions [qs, min(qe, L-k+1)) only; the
    tail positions up to qe keep raw base values 0..3 and ARE counted as
    "k-mer codes" (consensus.c:42-57 vs the count loops at :146,:174).
  * The max-node list is built in read order, deduped by decrementing
    counts, capped at 100 (generate_freqNode_return_list_maxNodes).
    Dense table (k<=6) and hash (k>=7) produce identical observable
    results, so a plain dict suffices.

Walk behavior (search_De_Bruijn_graph_{forward,backward}, :269-505):
  * lookahead m grows 1..max_lookahead (1 while l<10, else k) while ties
    persist; tie lists are capped at 1024;
  * the forward walk's next-base extraction max_lsd / 4^(m-1) uses the
    POST-LOOP value of m — on natural loop exit m = max_lookahead+1 and
    the chosen base is always 0 ('A') (consensus.c:335, a C quirk);
  * forward breaks the lookahead loop on tiebreaks == 1, backward on
    tiebreaks <= 1 (:326 vs :413);
  * the caller tries up to 100 start nodes per direction and stops each
    direction at the first node that closes a loop; the function's
    return value is the backward direction's foundLoop — if the backward
    search finds no loop the whole call reports failure even when the
    forward one succeeded (consensus.c:534-581).
"""

from __future__ import annotations

import numpy as np

from mtr_tpu_torch.records import RepeatRecord, ratio_less
from mtr_tpu_torch.oracle.wrap_dp import wrap_around_dp, _assign
from mtr_tpu_torch.utils.encoding import rolling_kmer_codes, decode_bases

MAX_PERIOD = 500
MIN_PERIOD = 2
MIN_NUM_FREQ_UNIT = 5
MAX_TIEBREAKS = 1024
MAX_NUM_MAXNODES = 100


def query_kmer_values(org: np.ndarray, input_len: int, k: int, qs: int, qe: int) -> np.ndarray:
    """The multiset counted by the reference for range [qs, qe]:
    k-mer codes at positions [qs, min(qe, L-k+1)) followed by raw bases
    at the remaining positions up to qe (inclusive)."""
    km_end = min(qe, input_len - k + 1)
    vals = np.empty(qe - qs + 1, dtype=np.int64)
    if km_end > qs:
        seg = org[qs : min(qe + k - 1, input_len)].astype(np.int64)
        codes = rolling_kmer_codes(seg, k)
        vals[: km_end - qs] = codes[: km_end - qs]
    if km_end < qs:
        km_end = qs
    vals[km_end - qs :] = org[km_end : qe + 1]
    return vals


class CountTable:
    """Exact k-mer multiset counts for a query range (order-preserving)."""

    def __init__(self, vals: np.ndarray):
        self.vals = vals
        uniq, counts = np.unique(vals, return_counts=True)
        self.counts = dict(zip(uniq.tolist(), counts.tolist()))

    def freq(self, node: int) -> int:
        return self.counts.get(node, 0)

    def max_freq(self) -> int:
        return max(self.counts.values()) if self.counts else -1

    def list_max_nodes(self) -> tuple[list[int], int]:
        """Max-frequency nodes in first-occurrence order, capped at 100.

        IMPORTANT: the reference decrements each listed node's count in
        the live table to dedupe the scan and never restores it
        (consensus.c:156-164, 199-222), so the subsequent DBG walk sees
        maxFreq-1 for every listed node.  We mutate self.counts the same
        way."""
        max_freq = self.max_freq()
        out: list[int] = []
        for v in self.vals.tolist():
            if self.counts[v] == max_freq:
                out.append(v)
                self.counts[v] -= 1
                if len(out) >= MAX_NUM_MAXNODES:
                    break
        return out, max_freq


def _lookahead_step(table: CountTable, node: int, k: int, forward: bool, max_lookahead: int):
    """Shared tie-break lookahead; returns (chosen_digits, m_after_loop).

    chosen_digits is max_lsd (forward) or max_msd (backward) from the
    last executed lookahead iteration; m_after_loop is C's value of m
    after the loop (== break iteration, or max_lookahead+1 on natural
    exit)."""
    pow4 = [4**i for i in range(k + 1)]
    list_tiebreaks = [0]
    max_digits = 0
    m = 1
    while m <= max_lookahead:
        max_count = -1
        max_digits = 0
        ties: list[int] = []
        for prev in list_tiebreaks:
            for j in range(4):
                if forward:
                    lsd = 4 * prev + j
                    tmp_node = pow4[m] * (node % pow4[k - m]) + lsd
                    cand = lsd
                else:
                    msd = j * pow4[m - 1] + prev
                    tmp_node = msd * pow4[k - m] + node // pow4[m]
                    cand = msd
                c = table.freq(tmp_node)
                if max_count < c:
                    max_count = c
                    max_digits = cand
                    ties = [cand]
                elif max_count == c and len(ties) < MAX_TIEBREAKS:
                    ties.append(cand)
        if (len(ties) == 1) if forward else (len(ties) <= 1):
            break
        list_tiebreaks = ties
        m += 1
    else:
        m = max_lookahead + 1
    return max_digits, m


def search_forward(table, qs, qe, initial_node, end_node, rr: RepeatRecord) -> int:
    k = rr.kmer
    pow4 = [4**i for i in range(k + 1)]
    node = initial_node
    unit: list[int] = []
    scores: list[int] = []
    actual_rep_period = 0
    lmax = min(MAX_PERIOD, (qe - qs) // MIN_NUM_FREQ_UNIT)
    for l in range(lmax):
        unit.append(node // pow4[k - 1])
        scores.append(table.freq(node))
        max_lookahead = 1 if l < 10 else k
        max_lsd, m = _lookahead_step(table, node, k, True, max_lookahead)
        node = 4 * (node % pow4[k - 1]) + (max_lsd // pow4[m - 1])
        if node == end_node:
            actual_rep_period = l + 1
            if actual_rep_period >= MAX_PERIOD:
                actual_rep_period = 0
            break
    rr.rep_period = actual_rep_period
    if actual_rep_period == 0:
        return 0
    rr.string = decode_bases(unit[:actual_rep_period])
    rr.string_score = scores[:actual_rep_period]
    rr.freq_2mer = freq_2mer_array(unit[:actual_rep_period])
    return 1


def search_backward(table, qs, qe, initial_node, end_node, rr: RepeatRecord) -> int:
    k = rr.kmer
    pow4 = [4**i for i in range(k + 1)]
    node = initial_node
    unit: list[int] = []
    scores: list[int] = []
    actual_rep_period = 0
    lmax = min(MAX_PERIOD, (qe - qs) // MIN_NUM_FREQ_UNIT)
    for l in range(lmax):
        max_lookahead = 1 if l < 10 else k
        max_msd, _m = _lookahead_step(table, node, k, False, max_lookahead)
        node = (max_msd % 4) * pow4[k - 1] + node // 4
        unit.append(node // pow4[k - 1])
        scores.append(table.freq(node))
        if node == end_node:
            actual_rep_period = l + 1
            if actual_rep_period >= MAX_PERIOD:
                actual_rep_period = 0
            break
    if actual_rep_period == 0:
        # Subgoal branch (consensus.c:441-476): computes an unused prefix;
        # rr->rep_period is set to the truncated length but the caller
        # discards the record because foundLoop == 0.
        tmp_len = 0
        for i in range(1, MAX_PERIOD):
            if (
                i < len(scores)
                and scores[i] > initial_node * 0.8
                and 0 <= unit[i] <= 3
            ):
                tmp_len += 1
            else:
                break
        rr.rep_period = 0 if tmp_len >= MAX_PERIOD else tmp_len
        return 0
    unit = unit[:actual_rep_period][::-1]
    scores = scores[:actual_rep_period][::-1]
    found = 1
    tmp_len = actual_rep_period
    rr.string = decode_bases(unit)
    rr.string_score = list(scores)
    rr.freq_2mer = freq_2mer_array(unit)
    if tmp_len >= MAX_PERIOD:
        tmp_len = 0
        found = 0
    rr.rep_period = tmp_len
    return found


def freq_2mer_array(unit: list[int]) -> list[int]:
    """Cyclic 2-mer histogram of the unit (handle_one_read.c:63-72)."""
    out = [0] * 16
    for a, b in zip(unit[:-1], unit[1:]):
        out[a * 4 + b] += 1
    out[unit[-1] * 4 + unit[0]] += 1
    return out


def walk_candidates(org, input_len, qs, qe, rr: RepeatRecord):
    """The walk half of search_De_Bruijn_graph (consensus.c:507-576):
    up to one candidate per direction — the first start node whose
    greedy traversal closes a loop — plus the return-value semantics.

    Returns (candidates, found_last) where candidates is a list of
    records with unit string/scores filled (forward first if both), and
    found_last is the foundLoop value of the LAST attempt overall (the
    backward direction's outcome — if the backward search never loops,
    the whole call reports failure even when forward succeeded).
    """
    k = rr.kmer
    vals = query_kmer_values(org, input_len, k, qs, qe)
    table = CountTable(vals)
    max_nodes, max_freq = table.list_max_nodes()

    found = 0
    candidates: list[RepeatRecord] = []
    if max_freq > MIN_NUM_FREQ_UNIT:
        for direction in (True, False):  # forward then backward
            for node in max_nodes:
                tmp = rr.copy()
                if direction:
                    found = search_forward(table, qs, qe, node, node, tmp)
                else:
                    found = search_backward(table, qs, qe, node, node, tmp)
                if tmp.rep_period >= MAX_PERIOD:
                    found = 0
                if found == 1:
                    candidates.append(tmp)
                    break  # first loop found ends this direction
    return candidates, found


def select_dp_candidate(
    rr: RepeatRecord, scored: list[RepeatRecord], min_match_ratio: float
) -> None:
    """The selection half of search_De_Bruijn_graph (consensus.c:562-578):
    each scored record already carries its best-scheme DP result."""
    max_ratio = -1.0
    best: RepeatRecord | None = None
    for tmp in scored:
        r = tmp.match_ratio()
        # NaN ratios fail every comparison, as in C float math
        if (
            ratio_less(max_ratio, r)
            and min_match_ratio <= r
            and tmp.num_freq_unit > MIN_NUM_FREQ_UNIT
            and MIN_PERIOD <= tmp.rep_period < MAX_PERIOD
        ):
            max_ratio = r
            best = tmp
    if best is not None:
        _assign(rr, best)
    else:
        _assign(rr, RepeatRecord())


def search_de_bruijn_graph(
    org, input_len, qs, qe, rr: RepeatRecord, min_match_ratio: float
) -> tuple[int, None]:
    """consensus.c:507-582.  Returns (foundLoop-of-last-direction, None)."""
    candidates, found = walk_candidates(org, input_len, qs, qe, rr)
    for tmp in candidates:
        wrap_around_dp(org, qs, qe, tmp)
    select_dp_candidate(rr, candidates, min_match_ratio)
    return found, None
