"""One read through mTR's per-read steps (handle_one_read.c:77-266).

find_tandem_repeat sweeps k over a width-dependent range and keeps the
best match ratio subject to the acceptance filters; handle_one_read walks
the candidate ranges in position order, suppresses ranges that end inside
an accepted repeat, and chains the accepted records.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.arena import Arena
from portbench.reference.chaining import chain_records
from portbench.reference.consensus import revise_representative_unit
from portbench.reference.dbg import (
    MIN_NUM_FREQ_UNIT,
    MIN_PERIOD,
    select_dp_candidate,
    walk_candidates,
)
from portbench.reference.directional_index import fill_directional_index_with_end
from portbench.reference.records import RepeatRecord, ratio_less
from portbench.reference.wrap_dp import _assign, wrap_around_dp_batch

# mTR.h: WrapDPsize, minKmer, maxKmer, MIN_MATCH_RATIO
WRAP_DP_SIZE = 200_000_000
MIN_KMER = 5
MAX_KMER = 15


def k_sweep(w: int) -> range:
    """handle_one_read.c:104-118: the k range by detected window width."""
    if w < 100:
        return range(MIN_KMER - 3, MAX_KMER - 5 + 1)
    if w < 1000:
        return range(MIN_KMER - 3, MAX_KMER - 3 + 1)
    return range(MIN_KMER, MAX_KMER + 1)


def find_tandem_repeat(arena, qs, qe, w, read_id, input_len, rr,
                       min_match_ratio) -> None:
    """handle_one_read.c:102-154, the k sweep, with find_tandem_repeat_sub
    (:77-100) and search_De_Bruijn_graph (consensus.c:507-582) inlined.
    Every k's walks come first, then the wrap-around DP of every k's
    candidates over the one range in a batch, then each k in order as the
    C code takes it: the walks read nothing the DP writes, and a k whose
    backward walk found no loop is cleared whatever its DP gives, so its
    DP is skipped."""
    org = arena.org_input
    sweep = []
    for k in k_sweep(w):
        tmp = RepeatRecord()
        tmp.read_id = read_id
        tmp.input_len = input_len
        tmp.kmer = k
        candidates, found = walk_candidates(org, input_len, qs, qe, tmp)
        sweep.append((tmp, candidates, found))
    wrap_around_dp_batch(org, qs, qe,
                         [c for _t, cands, found in sweep if found for c in cands])
    max_ratio = -1.0
    for tmp, candidates, found in sweep:
        select_dp_candidate(tmp, candidates, min_match_ratio)
        if found == 0 or tmp.rep_period * (qe - qs + 1) > WRAP_DP_SIZE:
            _assign(tmp, RepeatRecord())
        else:
            coverage = tmp.repeat_len // tmp.rep_period
            if 5 <= coverage <= 20 and tmp.rep_period > 5:
                revise_representative_unit(org, tmp, input_len)
        r = tmp.match_ratio()
        if (ratio_less(max_ratio, r) and min_match_ratio <= r
                and tmp.num_freq_unit > MIN_NUM_FREQ_UNIT
                and MIN_PERIOD <= tmp.rep_period):
            max_ratio = r
            _assign(rr, tmp)


def handle_one_read(arena: Arena, read_id: str, input_len: int,
                    min_match_ratio: float = 0.6, manhattan: bool = True,
                    dtype=np.float64, on_ranges=None) -> list[RepeatRecord]:
    """handle_one_read.c:190-266: the chained records of the read whose
    codes `arena` holds.  `dtype` is the DI's floating-point precision;
    `on_ranges(di, di_end, di_w)`, if given, sees the candidate ranges
    before the sweep suppresses any."""
    min_rsl = 100
    rsl = min_rsl if input_len < min_rsl * 10 else input_len // 10
    di, di_end, di_w = fill_directional_index_with_end(
        arena, input_len, rsl, manhattan=manhattan, dtype=dtype)
    if on_ranges is not None:
        on_ranges(di, di_end, di_w)

    accepted: list[RepeatRecord] = []
    for qs in np.nonzero(di_end[:input_len] > -1)[0].tolist():
        qe = int(di_end[qs])
        if not (-1 < qe < input_len):
            continue
        rr = RepeatRecord()
        find_tandem_repeat(arena, qs, qe, int(di_w[qs]), read_id, input_len,
                           rr, min_match_ratio)
        if rr.repeat_len > 0 and rr.rep_start + MIN_PERIOD * MIN_NUM_FREQ_UNIT < rr.rep_end:
            accepted.append(rr)
            # suppress pending ranges ending inside the accepted repeat
            for i in range(rr.rep_start, rr.rep_end):
                if di[i] != -1 and di_end[i] < rr.rep_end:
                    di[i] = -1.0
                    di_end[i] = -1
                    di_w[i] = -1
    return chain_records(accepted)
