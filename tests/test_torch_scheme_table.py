"""The wave loop's scheme phase as one job table: the vectorised scheme
and direction selection against the scalar rules (ratio_less,
select_dp_candidate) on synthetic counts rows, and one long read through
run_file under the host, the torch and the hybrid batcher, each
byte-identical to the golden written by mtr_tpu's host backend."""

import io
import math

import numpy as np
import pytest
import torch

from mtr_tpu_torch import pipeline as tp
from mtr_tpu_torch.config import MTRConfig
from mtr_tpu_torch.oracle.dbg import (
    MAX_PERIOD,
    MIN_NUM_FREQ_UNIT,
    MIN_PERIOD,
    select_dp_candidate,
)
from mtr_tpu_torch.oracle.wrap_dp import _assign
from mtr_tpu_torch.records import RepeatRecord, ratio_less
from mtr_tpu_torch.testutil.golden_sets import read_golden, write_set
from mtr_tpu_torch.utils.timers import TIMERS

MIN_MATCH_RATIO = 0.6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def row(m, x=0, i=0, d=0, scanned=None, period=10):
    """A counts row (m, x, ins, del, scanned, i_final, max_i); scanned
    defaults to 7 units."""
    scanned = 7 * period if scanned is None else scanned
    return (m, x, i, d, scanned, 3, 3 + m + x + i)


Z = (0, 0, 0, 0, 0, 0, 0)  # 0/0

# a case: queries, each a list of candidates (period, row 113, row 131)
CASES = {
    "nan_113": [[(10, Z, row(8, 2))]],
    "nan_131": [[(10, row(8, 2), Z)]],
    "nan_both": [[(10, Z, Z)]],
    "nan_both_then_good": [[(10, Z, Z), (12, row(9, 1, period=12),
                                          row(7, 3, period=12))]],
    "schemes_tie": [[(10, row(8, 2), row(4, 1))]],
    "schemes_131_better": [[(10, row(7, 3), row(9, 1))]],
    "directions_tie": [[(10, row(8, 2), row(8, 2)),
                        (11, row(8, 2, period=11), row(4, 1, period=11))]],
    "backward_better": [[(10, row(7, 3), Z), (11, row(9, 1, period=11), Z)]],
    "backward_worse": [[(10, row(9, 1), Z), (11, row(7, 3, period=11), Z)]],
    "nfu_at_min": [[(10, row(9, 1, scanned=10 * MIN_NUM_FREQ_UNIT + 9), Z)],
                   [(10, row(9, 1, scanned=10 * (MIN_NUM_FREQ_UNIT + 1)),
                     Z)]],
    "period_at_min": [[(MIN_PERIOD, row(9, 1, period=MIN_PERIOD), Z)],
                      [(MIN_PERIOD - 1, row(9, 1, period=MIN_PERIOD - 1),
                        Z)]],
    "period_at_max": [[(MAX_PERIOD, row(9, 1, period=MAX_PERIOD), Z)],
                      [(MAX_PERIOD - 1, row(9, 1, period=MAX_PERIOD - 1),
                        Z)]],
    "ratio_at_min": [[(10, row(3, 2), Z)], [(10, row(5, 4), row(1, 1))]],
    "ratio_zero": [[(10, row(0, 10), Z)]],
    "only_candidate_fails": [[(10, row(5, 5), row(4, 6))]],
    "failed_first_then_worse": [[(10, row(9, 1, scanned=20), Z),
                                 (11, row(7, 3, period=11), Z)]],
    "shared_pair": [[(10, row(8, 2), row(9, 1))], [(10, row(8, 2),
                                                    row(9, 1))]],
}
CASES["all"] = [q for name in sorted(CASES) for q in CASES[name]]


def _queries(case):
    """RangeQuery objects with walk candidates: a query a list; the
    queries of shared_pair share (read, range) and their unit, so their
    candidates fold into one job pair."""
    queries, specs = [], []
    for qi, cands in enumerate(case):
        shared = cands == case[0] and qi == 1 and len(case) == 2
        q = tp.RangeQuery(0, 100 if shared else 100 + qi, 5000, 64, 7 + qi)
        q.found = 1
        for ci, (period, r113, r131) in enumerate(cands):
            c = RepeatRecord(kmer=q.k, rep_period=period)
            c.string = "ACGT"[ci] + "ACGT"[q.qs % 4] * (period - 1)
            c.string_score = [1] * period
            q.candidates.append(c)
            specs.append((period, r113, r131))
        queries.append(q)
    return queries, specs


def _scalar(queries, specs, mmr):
    """The scalar rules: the scheme loop over ratio_less, apply_counts
    (or the cleared record) on each candidate, then select_dp_candidate.
    Returns the kept scheme a candidate and the winning string a query."""
    picks, wins, ci = [], [], 0
    for q in queries:
        cands = []
        for cand in q.candidates:
            period, *rows = specs[ci]
            ci += 1
            best, max_ratio = -1, -1.0
            for s, r in enumerate(rows):
                denom = sum(r[:4])
                ratio = (float(np.float32(r[0]) / np.float32(denom))
                         if denom else math.nan)
                if ratio_less(max_ratio, ratio):
                    best, max_ratio = s, ratio
            picks.append(best)
            c = cand.copy()
            if best >= 0:
                tp.apply_counts(c, q.qs, period, tp.SCHEMES[best], rows[best])
            else:
                _assign(c, RepeatRecord())
            cands.append(c)
        rr = RepeatRecord()
        select_dp_candidate(rr, cands, mmr)
        wins.append(rr.string if rr.rep_period != -1 else None)
    return picks, wins


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mmr", [MIN_MATCH_RATIO, 0.0])
def test_selection_matches_scalar_rules(name, mmr):
    queries, specs = _queries(CASES[name])
    sj = tp.scheme_jobs(queries)
    counts = np.zeros((len(sj.jobs), 7), np.int64)
    for c, pair in enumerate(sj.cand_pair):
        counts[2 * pair : 2 * pair + 2] = specs[c][1:]
    pick = tp.select_schemes(counts)
    win = tp.select_directions(sj, counts, pick, len(queries), mmr)

    picks, wins = _scalar(queries, specs, mmr)
    job = pick[sj.cand_pair]
    assert [j % 2 if j >= 0 else -1 for j in job.tolist()] == picks
    got = [queries[qi].candidates[sj.cand_pos[c]].string if c >= 0 else None
           for qi, c in enumerate(win.tolist())]
    assert got == wins
    if name == "shared_pair":
        assert len(sj.jobs) == 2 and list(sj.cand_pair) == [0, 0]


BATCHERS = {
    "host": lambda: tp.HostDPBatcher(),
    "torch": lambda: tp.TorchDPBatcher(torch.device("cpu")),
    # a threshold that sends the read's largest jobs to the device leg
    # and the rest to the host leg
    "hybrid": lambda: tp.TorchHybridDPBatcher(
        torch.device("cpu"), cell_threshold=1 << 18, min_device_cells=0),
}


@pytest.mark.parametrize("name", list(BATCHERS))
def test_long_read_through_the_table(tmp_path, name):
    """unit 200 x 40 copies at long-200x200's error rates, flanks 2,000 +
    2,000: every batcher writes the golden's records byte for byte (written
    by mtr_tpu's host backend), and the table folds candidates into fewer
    job pairs."""
    batcher = BATCHERS[name]()
    before = dict(TIMERS.counters)
    out = io.StringIO()
    tp.run_file(write_set("single_tr_200x40", str(tmp_path)),
                MTRConfig(backend="host"), out, batcher=batcher)
    assert out.getvalue() == read_golden("single_tr_200x40")
    cands = TIMERS.counters["scheme_candidates"] - before.get(
        "scheme_candidates", 0)
    pairs = TIMERS.counters["scheme_pairs"] - before.get("scheme_pairs", 0)
    assert 0 < pairs <= cands
    if name == "hybrid":
        assert batcher.device.cells > 0 and batcher.host_cells > 0
