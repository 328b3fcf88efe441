"""Reads that each hold one tandem repeat: mTR's test_single_TR/util/rand_seq.cpp
in NumPy.

A read is `pre` random bases, then `copies` copies of a random unit of
`unit` bases with exactly counted substitutions, insertions and
deletions at distinct positions of the tract (`sub_pct`, `ins_pct` and
`del_pct` of its unit * copies positions, rounded half away from zero as
C's round), then `post` random bases.  A unit that is itself periodic is
drawn again.  A substitution is a base other than the unit's; an
insertion follows the unit's base with a random one; a deletion drops
the base.  Every read of one parameter set therefore has the same length.
The bytes need not equal rand_seq.cpp's: the generator and the draw order
differ.
"""

from __future__ import annotations

import math

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def c_round(x: float) -> int:
    """C round(): half away from zero."""
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def is_periodic(unit: np.ndarray) -> bool:
    """rand_seq.cpp:135-170: the unit is a repeat of a proper divisor-length prefix."""
    n = len(unit)
    for p in range(1, n):
        if n % p == 0 and np.array_equal(unit, np.tile(unit[:p], n // p)):
            return True
    return False


def error_counts(p: dict) -> tuple[int, int, int]:
    tract = p["unit"] * p["copies"]
    return tuple(c_round(tract * p[key] / 100) for key in ("sub_pct", "ins_pct", "del_pct"))


def read_length(p: dict) -> int:
    _sub, ins, dele = error_counts(p)
    return p["pre"] + p["unit"] * p["copies"] + ins - dele + p["post"]


def one_read(rng: np.random.Generator, p: dict, plan: dict | None = None) -> np.ndarray:
    """One read as base codes 0..3; `plan`, if given, receives the unit and
    the tract positions of the substitutions, insertions and deletions."""
    unit_len, copies = p["unit"], p["copies"]
    while True:
        unit = rng.integers(0, 4, unit_len, dtype=np.uint8)
        if not is_periodic(unit):
            break
    tract = np.tile(unit, copies)
    n_sub, n_ins, n_del = error_counts(p)
    if n_sub + n_ins + n_del > len(tract):
        raise ValueError("more planted errors than tract positions")
    pos = rng.permutation(len(tract))[: n_sub + n_ins + n_del]
    sub, ins, dele = pos[:n_sub], pos[n_sub : n_sub + n_ins], pos[n_sub + n_ins :]
    tract[sub] = (tract[sub] + rng.integers(1, 4, n_sub, dtype=np.uint8)) % 4
    reps = np.ones(len(tract), dtype=np.int64)
    reps[ins] = 2
    reps[dele] = 0
    out = np.repeat(tract, reps)
    # the second copy of each inserted position becomes a random base
    ins_sorted = np.sort(ins)
    at = np.cumsum(reps)[ins_sorted] - 1
    out[at] = rng.integers(0, 4, n_ins, dtype=np.uint8)
    if plan is not None:
        plan.update(unit=unit, sub=sub, ins=ins, dele=dele)
    pre = rng.integers(0, 4, p["pre"], dtype=np.uint8)
    post = rng.integers(0, 4, p["post"], dtype=np.uint8)
    return np.concatenate([pre, out, post])


def fasta_records(p: dict, seed: int, n_reads: int, stream: int, prefix: str) -> list[bytes]:
    """`n_reads` FASTA records (header and one sequence line each), drawn
    from (seed, stream): the same arguments give the same bytes."""
    rng = np.random.default_rng([seed % (1 << 64), stream])
    return [b">%s%d\n%s\n" % (prefix.encode(), i, BASES[one_read(rng, p)].tobytes())
            for i in range(n_reads)]
