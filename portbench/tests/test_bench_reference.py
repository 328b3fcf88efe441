"""The plain reference against mTR's own output (the repo's goldens, from
the JAX package's host backend, itself held to mTR), the arena replay,
the sample, and the control at a size a test run holds."""

import os

import numpy as np
import pytest

from portbench import check, control

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def golden_records(name):
    recs = []
    for line in open(os.path.join(GOLDEN, name + ".fasta"), "rb"):
        if line.startswith(b">"):
            recs.append([line])
        else:
            recs[-1].append(line.strip())
    return [r[0] + b"".join(r[1:]) + b"\n" for r in recs]


@pytest.mark.parametrize("name, reads", [("multi20_100x10", 6), ("multitr_gen_2_5_10_20", 1)])
def test_reference_reproduces_mtr(name, reads):
    recs = golden_records(name)[:reads]
    out = check.reference_pool([(check.replay_records(recs.__getitem__, i), True, "float64")
                                for i in range(reads)], workers=3)
    ids = {r.split(b"\n")[0][1:].decode() for r in recs}
    gold = [ln for ln in open(os.path.join(GOLDEN, name + ".out")).read().splitlines()
            if ln.split("\t")[0] in ids]
    assert [ln for lines, _ranges in out for ln in lines] == gold


def test_replay_keeps_the_writes_that_still_show():
    lens = [50, 30, 40, 40, 20, 35, 10]
    recs = [b">r%d\n%s\n" % (i, b"A" * n) for i, n in enumerate(lens)]
    # before read 6: read 5 (35) shows, 4 (20) is covered by 5, 3 (40)
    # shows past 35, 2 (40) is covered by 3, 1 (30) by 3, 0 (50) shows
    assert check.replay_records(recs.__getitem__, 6) == [recs[0], recs[3], recs[5], recs[6]]
    assert check.replay_records(recs.__getitem__, 0) == [recs[0]]


def test_sample_is_drawn_from_the_seed_with_the_longest():
    lengths = [10] * 50
    lengths[17] = 12
    a = check.sample_reads(50, lengths, 5, 2**31 + 9)
    assert a == check.sample_reads(50, lengths, 5, 2**31 + 9)
    assert 17 in a and len(a) == 5 == len(set(a))
    assert a != check.sample_reads(50, lengths, 5, 2**31 + 10)
    assert check.sample_reads(3, [1, 1, 1], 8, 1) == [0, 1, 2]
    assert check.sample_reads(0, [], 8, 1) == []


def test_ranges_compare_bit_for_bit():
    di = np.full(10, -1.0)
    di[[2, 5]] = [0.3, 0.25]
    end = np.full(10, -1)
    end[[2, 5]] = [7, 9]
    w = np.full(10, -1)
    w[[2, 5]] = [5, 5]
    a = check.di_ranges(di, end, w, 8)
    b = check.di_ranges(np.where(di > 0, di.astype(np.float32).astype(np.float64), di), end, w, 8)
    assert check.same_ranges(a, a) and not check.same_ranges(a, b)
    assert not check.same_ranges(a, None)


def test_control_fails_the_check_at_test_size():
    """The reference with a float32 DI finish, in the port's place, on a
    few reads of the short traffic: its DI ranges differ from the float64
    reference's on every read (its records happen not to)."""
    r = control.control_reading("device.short-100x10", 5, 40, root=ROOT, workers=4,
                                n_sample=4)
    assert r["mismatched_di_reads"] == len(r["sample"]) > 0
    assert r["mismatched_di_reads"] > check.LIMITS["mismatched_di_reads"]
