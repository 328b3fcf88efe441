"""Synthetic single-TR read generator — reimplementation of
test_single_TR/util/rand_seq.cpp.

Each read is: `pre` random bases + `block` copies of a random unit of
length `rep_length` with exactly-counted planted errors at distinct
positions + `post` random bases.  Units that are themselves periodic
are rejected (rand_seq.cpp:135-170).  The error plan marks each unit
tract position 0 (none) / 1 (substitution) / 2 (insertion after) /
3 (deletion).

The reference seeds std::mt19937 from random_device; we take an
explicit seed for reproducibility and use the same MT19937 stream with
the reference's base mapping mt()%4 -> A,T,C,G (rand_seq.cpp:21-46 —
note this differs from mTR's own A,C,G,T coding).
"""

from __future__ import annotations

from mtr_tpu_torch.utils.mt19937 import MT19937


def _c_round(x: float) -> int:
    """C round(): half away from zero (Python's round is half-to-even)."""
    import math

    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


_MAP = "ATCG"


class RandSeq:
    def __init__(self, seed: int):
        self.mt = MT19937(seed)

    def rand_base(self) -> str:
        return _MAP[self.mt.genrand_int32() % 4]

    def _rand_unit(self, rep_length: int) -> str:
        while True:
            line = "".join(self.rand_base() for _ in range(rep_length))
            all_dif = True
            for i in range(1, rep_length):
                if rep_length % i == 0:
                    sub = line[:i]
                    if all(line[j * i : (j + 1) * i] == sub for j in range(1, rep_length // i)):
                        all_dif = False
                        break
            if all_dif:
                return line

    def _plant_errors(self, rep_len: int, n: int, code: int, row: list[int]) -> None:
        for _ in range(n):
            while True:
                p = self.mt.genrand_int32() % rep_len
                if row[p] == 0:
                    row[p] = code
                    break

    def one_read(
        self, rep_length: int, block: int, mis_rate: float, ins_rate: float,
        del_rate: float, pre: int, post: int
    ) -> tuple[str, str]:
        """Returns (sequence, truth_unit)."""
        rep_len = rep_length * block
        mis_n = _c_round(rep_len * mis_rate / 100)
        ins_n = _c_round(rep_len * ins_rate / 100)
        del_n = _c_round(rep_len * del_rate / 100)

        seq = [self.rand_base() for _ in range(pre)]
        row = [0] * rep_len
        self._plant_errors(rep_len, mis_n, 1, row)
        self._plant_errors(rep_len, ins_n, 2, row)
        self._plant_errors(rep_len, del_n, 3, row)
        unit = self._rand_unit(rep_length)

        t = 0
        for _b in range(block):
            for j in range(rep_length):
                e = row[t]
                if e == 1:
                    while True:
                        mis = self.rand_base()
                        if mis != unit[j]:
                            break
                    seq.append(mis)
                elif e == 2:
                    seq.append(unit[j])
                    seq.append(self.rand_base())
                elif e == 3:
                    pass
                else:
                    seq.append(unit[j])
                t += 1
        seq.extend(self.rand_base() for _ in range(post))
        return "".join(seq), unit


def write_fasta(
    out_fasta: str, out_units: str, rep_length: int, block: int,
    mis_rate: float, ins_rate: float, del_rate: float,
    pre: int, post: int, loop: int, seed: int = 12345,
) -> None:
    """rand_fasta equivalent (rand_seq.cpp:48-222)."""
    g = RandSeq(seed)
    with open(out_fasta, "w") as fa, open(out_units, "w") as fu:
        for i in range(loop):
            seq, unit = g.one_read(
                rep_length, block, mis_rate, ins_rate, del_rate, pre, post
            )
            fa.write(f">{i}\n{seq}\n")
            fu.write(unit + "\n")


def main(argv=None):
    import sys

    a = argv or sys.argv[1:]
    write_fasta(
        a[0], a[1], int(a[2]), int(a[3]), float(a[4]), float(a[5]),
        float(a[6]), int(a[7]), int(a[8]), int(a[9]),
        seed=int(a[10]) if len(a) > 10 else 12345,
    )


if __name__ == "__main__":
    main()
