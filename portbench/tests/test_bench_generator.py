"""The read generator at small sizes: rand_seq.cpp's semantics."""

import numpy as np
import pytest

from portbench.generators import single_tr

P = dict(unit=12, copies=9, sub_pct=9.7, ins_pct=2.9, del_pct=7.5, pre=50, post=40)


def rebuild_tract(unit, copies, sub, ins, dele, read_tract):
    """The tract rand_seq.cpp writes for this plan, position by position,
    taking the random bases (a substitution's, an insertion's) from the
    read; checks that a substitution differs from the unit's base."""
    sub, ins, dele = set(sub.tolist()), set(ins.tolist()), set(dele.tolist())
    out, k = [], 0
    for t in range(len(unit) * copies):
        base = int(unit[t % len(unit)])
        if t in dele:
            continue
        if t in sub:
            assert read_tract[k] != base
            out.append(int(read_tract[k]))
            k += 1
        elif t in ins:
            out += [base, int(read_tract[k + 1])]
            k += 2
        else:
            out.append(base)
            k += 1
    return np.array(out, dtype=np.uint8)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_read_follows_the_plan(seed):
    rng = np.random.default_rng([seed, 0])
    for _ in range(20):
        plan = {}
        codes = single_tr.one_read(rng, P, plan)
        assert len(codes) == single_tr.read_length(P)
        n_sub, n_ins, n_del = single_tr.error_counts(P)
        assert (len(plan["sub"]), len(plan["ins"]), len(plan["dele"])) == (n_sub, n_ins, n_del)
        every = np.concatenate([plan["sub"], plan["ins"], plan["dele"]])
        assert len(set(every.tolist())) == len(every)  # distinct positions
        assert not single_tr.is_periodic(plan["unit"])
        tract = codes[P["pre"] : len(codes) - P["post"]]
        assert np.array_equal(tract, rebuild_tract(plan["unit"], P["copies"], plan["sub"],
                                                   plan["ins"], plan["dele"], tract))


def test_counts_round_as_c():
    assert single_tr.c_round(2.5) == 3 and single_tr.c_round(-2.5) == -3
    # 200 x 200 at 9.7 / 2.9 / 7.5 %
    p = dict(unit=200, copies=200, sub_pct=9.7, ins_pct=2.9, del_pct=7.5, pre=0, post=0)
    assert single_tr.error_counts(p) == (3880, 1160, 3000)
    assert single_tr.read_length(dict(p, pre=40000, post=40000)) == 118160


def test_periodic_units():
    assert single_tr.is_periodic(np.array([0, 1, 0, 1], np.uint8))
    assert single_tr.is_periodic(np.array([2, 2, 2], np.uint8))
    assert not single_tr.is_periodic(np.array([0, 1, 2, 0, 1, 3], np.uint8))


def test_same_seed_same_bytes():
    a = single_tr.fasta_records(P, 2**31 + 5, 6, 0, "r")
    b = single_tr.fasta_records(P, 2**31 + 5, 6, 0, "r")
    c = single_tr.fasta_records(P, 2**31 + 6, 6, 0, "r")
    w = single_tr.fasta_records(P, 2**31 + 5, 6, 2, "w")
    assert a == b and a != c
    assert [x.split(b"\n")[1] for x in a] != [x.split(b"\n")[1] for x in w]
    assert all(r.startswith(b">r%d\n" % i) and r.endswith(b"\n") for i, r in enumerate(a))
    assert all(set(r.split(b"\n")[1]) <= set(b"ACGT") for r in a)
