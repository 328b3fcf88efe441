"""Persistent per-file buffers ("the arena").

The reference allocates its working arrays once per file and reuses them
across reads (handle_one_file.c:71-136).  Two of its loops read past the
freshly-written region, observing either zero-initialized memory (first
read) or stale content from an earlier, longer read:

  * the DI sliding windows read inputString_w_rand up to i+3w-1 which can
    exceed the filled length inputLen+4*rsl (fill_directional_index.c:
    185-232 vs the fill at :143-156);
  * wrap_around_DP_sub reads rep[i]=orgInputString[query_start+i] for
    i=1..rep_len, i.e. one cell past query_end (wrap_around_DP.c:244-264).

Bit-identical output therefore requires modeling the buffers as
process-lifetime arrays.  fill() only overwrites the prefix.
"""

from __future__ import annotations

import numpy as np

MAX_INPUT_LENGTH = 1_000_000


class Arena:
    def __init__(self, max_input_length: int = MAX_INPUT_LENGTH):
        self.max_input_length = max_input_length
        # malloc'd fresh per file; first touch reads OS-zeroed pages
        self.org_input = np.zeros(max_input_length, dtype=np.int32)
        # Headroom beyond the reference's 1 Mbp array: the DI pass for a
        # read of length L touches indices up to ~L + 2*rsl + 3*MAX_WINDOW
        # (rsl = L/10).  The reference OVERFLOWS (segfaults) for reads
        # longer than ~833 kbp; with headroom we process every read the
        # FASTA limit admits.  The l4 random-fill cap stays at
        # max_input_length so output is bit-identical to the reference
        # wherever the reference is well-defined.
        headroom = 2 * (max_input_length // 10) + 4 * 10240
        self.input_w_rand = np.zeros(max_input_length + headroom, dtype=np.int32)

    def load_read(self, codes: np.ndarray) -> None:
        """handle_one_file.c:284-285 — copy codes into the prefix only."""
        self.org_input[: len(codes)] = codes
