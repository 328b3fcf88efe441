"""Base/k-mer encodings shared by every stage.

A,C,G,T -> 0,1,2,3 as in handle_one_file.c:169-188; rolling k-mer codes
as in consensus.c:37-60 and fill_directional_index.c:157-168.
"""

from __future__ import annotations

import numpy as np

_BASES = "ACGT"

# 256-wide lookup, -1 marks invalid characters (reference treats any
# non-ACGTacgt byte, including N, as fatal — handle_one_file.c:184-186).
_CHAR2INT = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(_BASES):
    _CHAR2INT[ord(_c)] = _i
    _CHAR2INT[ord(_c.lower())] = _i


class InvalidBaseError(ValueError):
    pass


def encode_bases(seq: bytes | str) -> np.ndarray:
    """Encode an ACGT string to int32 codes 0..3; invalid bases raise."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8)
    codes = _CHAR2INT[arr]
    if (codes < 0).any():
        bad = chr(arr[int(np.argmax(codes < 0))])
        raise InvalidBaseError(f"Invalid character: {bad}")
    return codes.astype(np.int32)


def decode_bases(codes) -> str:
    return "".join(_BASES[c] for c in codes)


def rolling_kmer_codes(bases: np.ndarray, k: int, pow4: np.ndarray | None = None) -> np.ndarray:
    """Codes c[i] = sum_j bases[i+j] * 4^(k-1-j) for i in [0, len-k+1).

    Vectorized equivalent of the reference's in-place rolling encoders
    (consensus.c:45-57).  Returns int64 when 4^k would overflow int32
    (never for the reference's k <= 15: 4^15 < 2^31, so int32 is safe).
    """
    n = len(bases) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int32)
    acc = np.zeros(n, dtype=np.int64)
    for j in range(k):
        acc = acc * 4 + bases[j : j + n]
    return acc.astype(np.int32)


def kmer_to_string(code: int, k: int) -> str:
    out = []
    for i in range(k - 1, -1, -1):
        out.append(_BASES[(code >> (2 * i)) & 3])
    return "".join(out)


POW4 = np.array([4**i for i in range(16)], dtype=np.int64)
