"""The port's walk pre-filter (ops/mf_filter.py) against mtr_tpu's
walked_mask (with its query chunks shrunk, as tests/test_mf_filter.py
does) and against the oracle multiset, at the bucket edges 64 / 256 /
1,024 / 1,025; and no stale upload across batches whose arrays are
recycled.  The mask is exact: a wrong "unwalked" would change output."""

import numpy as np
import pytest
import torch

import mtr_tpu.ops.mf_filter as jmf
from mtr_tpu.oracle.dbg import query_kmer_values
from mtr_tpu_torch.ops import mf_filter as tmf

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(jmf, "_Q_CHUNK", {64: 512, 256: 512, 1024: 512})
    # mtr_tpu keys its upload cache by id(): an earlier test's freed
    # array at the same address would hit it (the fault the port avoids)
    monkeypatch.setattr(jmf._FlatCache, "key", None)


def oracle_walked(org, L, qs, qe, k):
    vals = query_kmer_values(org, L, k, qs, qe)
    _, counts = np.unique(vals, return_counts=True)
    return int(counts.max()) > tmf.MIN_NUM_FREQ_UNIT


def _check(orgs, lens, ridx, qs, qe, k):
    got = tmf.walked_mask(orgs, lens, ridx, qs, qe, k, CPU)
    np.testing.assert_array_equal(
        got, jmf.walked_mask(orgs, lens, ridx, qs, qe, k))
    for i in range(len(ridx)):
        if qe[i] - qs[i] + 1 > tmf.FILTER_V_MAX:
            assert got[i], "wide queries stay host-routed"
        else:
            assert got[i] == oracle_walked(orgs[ridx[i]], lens[ridx[i]],
                                           int(qs[i]), int(qe[i]), int(k[i]))
    return got


def _i32(*arrays):
    return [np.asarray(a, np.int32) for a in arrays]


def test_random_queries():
    rng = np.random.default_rng(7)
    r0 = rng.integers(0, 4, 3000).astype(np.int32)
    unit = rng.integers(0, 4, 11)
    r1 = np.concatenate([rng.integers(0, 4, 200), np.tile(unit, 120)[:1300],
                         rng.integers(0, 4, 500)]).astype(np.int32)
    orgs, lens = [r0, r1], [len(r0), len(r1)]
    n = 300
    ridx = rng.integers(0, 2, n)
    L = np.asarray(lens)[ridx]
    qs = (rng.random(n) * (L - 40)).astype(np.int64)
    qe = np.minimum(qs + rng.integers(8, 200, n), L - 1)
    got = _check(orgs, lens, *_i32(ridx, qs, qe, rng.integers(2, 16, n)))
    assert 0 < got.sum() < n


def test_read_edge_tail():
    # ranges hugging the read end: the raw tail grows with k and collides
    # with A^(k-1)X codes on an all-A read
    rng = np.random.default_rng(8)
    r = np.zeros(400, np.int32)
    r[150:340] = rng.integers(0, 4, 190)
    q = [(end - 60, end, k) for k in range(2, 16) for end in (399, 395, 390)]
    qs, qe, ks = zip(*q)
    _check([r], [400], *_i32(np.zeros(len(q)), qs, qe, ks))


@pytest.mark.parametrize("edge", [64, 256, 1024, 1025])
def test_bucket_edges(edge):
    rng = np.random.default_rng(edge)
    r = np.tile(rng.integers(0, 4, 7), 400).astype(np.int32)[:2600]
    noise = rng.integers(0, 2600, 400)
    r[noise] = rng.integers(0, 4, 400)
    widths = (edge - 1, edge, edge + 1)
    q = [(10 + s, 10 + s + v - 1, k) for v in widths for s in (0, 300)
         for k in (3, 9, 15)]
    qs, qe, ks = zip(*q)
    got = _check([r], [len(r)], *_i32(np.zeros(len(q)), qs, qe, ks))
    if edge == 1025:
        assert got[-6:].all()  # wider than 1,024: the host walks them


def test_recycled_arrays_never_reuse_a_stale_upload():
    """Two batches through the same list of arrays, refilled in place (the
    same ids, as a recycled buffer would have): the second batch's mask
    follows the new contents."""
    rng = np.random.default_rng(3)
    reads = [np.tile(rng.integers(0, 4, 5), 200).astype(np.int32)[:900]
             for _ in range(2)]
    q = _i32(np.array([0, 1, 0]), [10, 20, 400], [300, 400, 800], [4, 6, 8])
    first = tmf.walked_mask(reads, [900, 900], *q, CPU)
    assert first.all()
    for r in reads:
        r[:] = rng.integers(0, 4, 900)  # same arrays, new contents
    second = tmf.walked_mask(reads, [900, 900], *q, CPU)
    assert not second.any()
    _check(reads, [900, 900], *q)


def test_wide_only_batch_needs_no_upload():
    r = np.zeros(3000, np.int32)
    got = tmf.walked_mask([r], [3000], *_i32([0], [0], [2000], [5]), CPU)
    assert got.tolist() == [True]
