"""Badread-style structured-error read generator.

The reference's real-read evaluation sets (PacBio_Nanopore_read/Readme)
were produced with Badread, whose error process differs from rand_seq's
independently-planted errors (test_single_TR/util/rand_seq.cpp:48-222)
in three structured ways this generator models:

  * read-level identity variation: each read draws its own error rate
    from a beta-like distribution (some reads are much worse than the
    profile mean);
  * error BURSTS (Badread "glitches"): occasional multi-base
    insert/delete/garble events rather than isolated single-base edits;
  * homopolymer bias: runs >= 3 of one base preferentially gain/lose a
    copy (the dominant Nanopore error mode).

Reads carry one planted tandem repeat (unit x freq) with random flanks,
truth units written one per line like rand_seq (test.sh contract), so
count_match / comp_mTR_DP evaluate accuracy unchanged.
"""

from __future__ import annotations

import numpy as np

_BASES = "ACGT"


def _rand_unit(rng: np.random.Generator, unit_len: int) -> np.ndarray:
    """Non-periodic unit, like rand_seq.cpp:135-170 rejects periodic
    units (a periodic 'unit' would make the truth period ambiguous)."""
    while True:
        u = rng.integers(0, 4, unit_len)
        for p in range(1, unit_len):
            if unit_len % p:
                continue
            if (u == np.tile(u[:p], unit_len // p)).all():
                break
        else:
            return u


def _apply_structured_errors(seq: np.ndarray, rng: np.random.Generator,
                             mean_err: float) -> np.ndarray:
    """Substitutions + bursts + homopolymer slips at a read-level rate
    drawn around mean_err."""
    # read-level identity: beta-ish spread (Badread's identity model)
    rate = float(mean_err * rng.gamma(4.0, 0.25))
    out: list[int] = []
    n = len(seq)
    i = 0
    while i < n:
        b = int(seq[i])
        # homopolymer slip: at the start of a run >= 3, +/- one copy
        run = 1
        while i + run < n and seq[i + run] == b:
            run += 1
        if run >= 3 and rng.random() < rate * run:
            if rng.random() < 0.5:
                out.extend([b] * (run + 1))  # lengthen
            else:
                out.extend([b] * (run - 1))  # shorten
            i += run
            continue
        r = rng.random()
        if r < rate * 0.4:  # substitution
            out.append(int((b + 1 + rng.integers(0, 3)) % 4))
            i += 1
        elif r < rate * 0.55:  # burst insertion (glitch), 1-8 random bases
            out.extend(rng.integers(0, 4, int(rng.integers(1, 9))).tolist())
            out.append(b)
            i += 1
        elif r < rate * 0.7:  # burst deletion, 1-8 bases
            i += int(rng.integers(1, 9))
        else:
            out.append(b)
            i += 1
    return np.array(out if out else [0], dtype=np.int64)


# Badread's default ligation adapters (Wick 2019, public defaults): the
# start adapter is prepended and the end adapter appended, both with a
# couple of structured errors, mimicking --start_adapter/--end_adapter.
ADAPTER_START = "AATGTACTTCGTTCAGTTACGTATTGCT"
ADAPTER_END = "GCAATACGTAACTGAACGAAGT"


def _encode_str(s: str) -> np.ndarray:
    return np.array([_BASES.index(c) for c in s], dtype=np.int64)


def _junk_read(rng: np.random.Generator, length: int,
               mean_err: float) -> np.ndarray:
    """Badread 'junk read': a very short motif (1-5 bp) repeated for the
    whole read length, with the usual noise — low-complexity garbage
    that real flow cells emit."""
    motif = rng.integers(0, 4, int(rng.integers(1, 6)))
    tract = np.tile(motif, length // len(motif) + 1)[:length]
    return _apply_structured_errors(tract, rng, mean_err)


def _tr_read(rng, unit_len, freq, mean_err, flank):
    unit = _rand_unit(rng, unit_len)
    tract = np.tile(unit, freq)
    noisy = _apply_structured_errors(tract, rng, mean_err)
    pre = rng.integers(0, 4, flank)
    post = rng.integers(0, 4, flank)
    return unit, np.concatenate([pre, noisy, post])


def write_structured_fasta(path: str, units_path: str, unit_len: int,
                           freq: int, mean_err: float, flank: int,
                           n_reads: int, seed: int = 0,
                           junk_frac: float = 0.0,
                           random_frac: float = 0.0,
                           chimera_frac: float = 0.0,
                           adapters: bool = False) -> None:
    """n_reads reads, each = flank + (unit x freq with structured
    errors) + flank; truth units to units_path (one per line).

    Badread artifact classes (PacBio_Nanopore_read/Readme's generator;
    fractions of n_reads, drawn per read in this order):
      junk_frac    low-complexity junk reads (1-5 bp motif repeated);
                   truth line "junk"
      random_frac  uniform random reads with no repeat; truth "random"
      chimera_frac two TR reads fused end-to-end (adapter in between
                   when adapters=True); truth "chimera <unitA> <unitB>"
      adapters     prepend/append Badread's default ligation adapters
                   (with structured errors) on every non-junk/random
                   read
    """
    rng = np.random.default_rng(seed)

    def dec(arr) -> str:
        return "".join(_BASES[int(c)] for c in arr)

    with open(path, "w") as f, open(units_path, "w") as uf:
        for ridx in range(n_reads):
            roll = rng.random()
            if roll < junk_frac:
                read = _junk_read(rng, 2 * flank + unit_len * freq,
                                  mean_err)
                truth = "junk"
            elif roll < junk_frac + random_frac:
                read = rng.integers(0, 4, 2 * flank + unit_len * freq)
                truth = "random"
            elif roll < junk_frac + random_frac + chimera_frac:
                ua, ra = _tr_read(rng, unit_len, freq, mean_err, flank)
                ub, rb = _tr_read(rng, unit_len, freq, mean_err, flank)
                mid = []
                if adapters:
                    mid = [
                        _apply_structured_errors(
                            _encode_str(ADAPTER_END), rng, mean_err),
                        _apply_structured_errors(
                            _encode_str(ADAPTER_START), rng, mean_err),
                    ]
                read = np.concatenate([ra] + mid + [rb])
                truth = f"chimera {dec(ua)} {dec(ub)}"
            else:
                unit, read = _tr_read(rng, unit_len, freq, mean_err,
                                      flank)
                truth = dec(unit)
            if adapters and truth not in ("junk", "random"):
                read = np.concatenate([
                    _apply_structured_errors(
                        _encode_str(ADAPTER_START), rng, mean_err),
                    read,
                    _apply_structured_errors(
                        _encode_str(ADAPTER_END), rng, mean_err),
                ])
            f.write(f">{ridx}\n")  # numeric IDs, like rand_seq (the
            # evaluators key records by int(readID))
            s = dec(read)
            for lo in range(0, len(s), 80):
                f.write(s[lo : lo + 80] + "\n")
            uf.write(truth + "\n")
