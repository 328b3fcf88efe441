"""Multi-TR read generator — reimplementation of the unshipped
`rand_multi_seq` referenced by test_multiple_TRs/data/gen.sh:7.

Set-file format (reverse-engineered from the bundled *_set.txt fixtures
and their read lengths, e.g. 3_50_set.txt: header "10 3 8 1000 1000 1"
= sub% ins% del%, pre, post, num_reads; then one "unit_len freq" pair
per planted TR; TR tracts are adjacent, flanked by pre/post random
bases; error counts are exact per tract as in rand_seq).

Writes the fixture triple: FASTA, unit table (readIdx trIdx unit), and
echoes the set config.
"""

from __future__ import annotations

from mtr_tpu_torch.testutil.rand_seq import RandSeq


def _c_round(x: float) -> int:
    """C round(): half away from zero (Python's round is half-to-even)."""
    import math

    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))



def parse_set_file(path: str):
    with open(path) as f:
        rows = [ln.split() for ln in f if ln.strip()]
    sub, ins, dele, pre, post, nreads = (float(rows[0][0]), float(rows[0][1]),
                                         float(rows[0][2]), int(rows[0][3]),
                                         int(rows[0][4]), int(rows[0][5]))
    trs = [(int(r[0]), int(r[1])) for r in rows[1:]]
    return sub, ins, dele, pre, post, nreads, trs


def generate(set_path: str, out_fasta: str, out_units: str, seed: int = 12345):
    sub, ins, dele, pre, post, nreads, trs = parse_set_file(set_path)
    g = RandSeq(seed)
    with open(out_fasta, "w") as fa, open(out_units, "w") as fu:
        for r in range(nreads):
            seq = [g.rand_base() for _ in range(pre)]
            for tr_idx, (ulen, freq) in enumerate(trs):
                rep_len = ulen * freq
                mis_n = _c_round(rep_len * sub / 100)
                ins_n = _c_round(rep_len * ins / 100)
                del_n = _c_round(rep_len * dele / 100)
                row = [0] * rep_len
                g._plant_errors(rep_len, mis_n, 1, row)
                g._plant_errors(rep_len, ins_n, 2, row)
                g._plant_errors(rep_len, del_n, 3, row)
                unit = g._rand_unit(ulen)
                fu.write(f"{r}\t{tr_idx}\t{unit}\n")
                t = 0
                for _b in range(freq):
                    for j in range(ulen):
                        e = row[t]
                        if e == 1:
                            while True:
                                m = g.rand_base()
                                if m != unit[j]:
                                    break
                            seq.append(m)
                        elif e == 2:
                            seq.append(unit[j])
                            seq.append(g.rand_base())
                        elif e == 3:
                            pass
                        else:
                            seq.append(unit[j])
                        t += 1
            seq.extend(g.rand_base() for _ in range(post))
            fa.write(f">{r}\n{''.join(seq)}\n")


def main(argv=None):
    import sys

    a = argv or sys.argv[1:]
    generate(a[0], a[1], a[2], seed=int(a[3]) if len(a) > 3 else 12345)


if __name__ == "__main__":
    main()
