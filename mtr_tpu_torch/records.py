"""The per-repeat record — equivalent of `repeat_in_read` (mTR.h:99-119).

Sentinel state (all -1 / empty) mirrors clear_rr
(fill_directional_index.c:40-60).  Ratio comparisons replicate C float
semantics: (float)m / (m+mm+ins+del) evaluated in float32, with 0/0
producing NaN whose comparisons are always False.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class RepeatRecord:
    read_id: str = ""
    input_len: int = -1
    rep_start: int = -1
    rep_end: int = -1
    repeat_len: int = -1
    rep_period: int = -1
    num_freq_unit: int = -1
    num_matches: int = -1
    num_mismatches: int = -1
    num_insertions: int = -1
    num_deletions: int = -1
    kmer: int = -1
    match_gain: int = -1
    mismatch_penalty: int = -1
    indel_penalty: int = -1
    string: str = ""
    string_score: list = dataclasses.field(default_factory=list)
    freq_2mer: list = dataclasses.field(default_factory=lambda: [-1] * 16)

    def copy(self) -> "RepeatRecord":
        c = RepeatRecord.__new__(RepeatRecord)
        c.__dict__.update(self.__dict__)
        c.string_score = list(self.string_score)
        c.freq_2mer = list(self.freq_2mer)
        return c

    def match_ratio(self) -> float:
        """C expression: (float)Num_matches / (sum of counts), in float32.

        Returns NaN on a zero denominator (C float 0/0), so every ordered
        comparison against it is False — exactly the reference behavior in
        the max-ratio selection loops (handle_one_read.c:137-146).

        The value is cached keyed by (m, denom): numpy float32 scalar
        ops cost ~3 us each and the selection loops call this several
        times per record; bulk producers (the batched scheme selection)
        pre-fill the cache from one vectorized division — identical
        bits, since f32 division of exactly-representable ints is
        correctly rounded either way.
        """
        denom = (
            self.num_matches
            + self.num_mismatches
            + self.num_insertions
            + self.num_deletions
        )
        if denom == 0:
            return math.nan
        cached = self.__dict__.get("_rk")
        if cached is not None and cached[0] == denom and cached[1] == self.num_matches:
            return cached[2]
        v = float(np.float32(self.num_matches) / np.float32(denom))
        self._rk = (denom, self.num_matches, v)
        return v

    def format_record(self) -> str:
        """13-field TSV line — Alignment::print_one_TR (chaining.cpp:125-143).

        Positions are printed 1-origin; the ratio field is float32
        Num_matches/repeat_len formatted with C's %f (6 decimals).
        """
        ratio = float(np.float32(self.num_matches) / np.float32(self.repeat_len))
        return (
            f"{self.read_id}\t{self.input_len}\t{self.rep_start + 1}\t"
            f"{self.rep_end + 1}\t{self.repeat_len}\t{self.rep_period}\t"
            f"{self.num_freq_unit}\t{self.num_matches}\t{ratio:.6f}\t"
            f"{self.num_mismatches}\t{self.num_insertions}\t"
            f"{self.num_deletions}\t{self.string}"
        )


def ratio_less(a: float, b: float) -> bool:
    """a < b with C NaN semantics (NaN comparisons are False)."""
    if math.isnan(a) or math.isnan(b):
        return False
    return a < b
