"""Exact MT19937 (Mersenne Twister) random number generator.

The reference surrounds each read with pseudo-random flanking sequence
drawn from MT19937 re-seeded with 0 before every directional-index pass
(fill_directional_index.c:137-169, MT.h:65-145).  Bit-identical repeat
coordinates therefore require a bit-identical generator and an identical
draw-consumption order.  This is a from-scratch vectorized NumPy
implementation of the standard MT19937 algorithm (Matsumoto & Nishimura
1998); blocks of 624 words are produced at once so flank generation for
megabase reads stays fast.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER_MASK = np.uint32(0x80000000)
_LOWER_MASK = np.uint32(0x7FFFFFFF)


class MT19937:
    """MT19937 with the standard init_genrand seeding."""

    def __init__(self, seed: int = 5489):
        self.mt = np.empty(_N, dtype=np.uint32)
        self.mti = _N
        self.seed(seed)

    def seed(self, s: int) -> None:
        mt = self.mt
        mt[0] = np.uint32(s)
        # Knuth multiplicative seeding; inherently sequential but only 624
        # steps, done in Python ints to avoid overflow pitfalls.
        prev = int(mt[0])
        for i in range(1, _N):
            prev = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF
            mt[i] = prev
        self.mti = _N

    @staticmethod
    def _twist(y: np.ndarray) -> np.ndarray:
        mag = np.where((y & np.uint32(1)).astype(bool), _MATRIX_A, np.uint32(0))
        return (y >> np.uint32(1)) ^ mag

    def _generate_block(self) -> None:
        """Regenerate all 624 state words.

        The twist must respect in-place update order: words kk >= N-M xor
        against *already updated* words kk+M-N, and the final word reads
        the updated mt[0]; hence three vectorized stages.
        """
        old = self.mt
        new = np.empty(_N, dtype=np.uint32)
        # new[kk] = src[kk+M mod N] ^ twist(y[kk]) where src is `old` while
        # kk+M < N and `new` once kk+M wraps (those words were written
        # earlier in the in-place loop).  The write→read distance of the
        # wrapped reads is exactly N-M, so chunks of N-M vectorize safely.
        step = _N - _M
        for lo in range(0, _N - 1, step):
            hi = min(lo + step, _N - 1)
            y = (old[lo:hi] & _UPPER_MASK) | (old[lo + 1 : hi + 1] & _LOWER_MASK)
            if hi + _M <= _N:
                src = old[lo + _M : hi + _M]
            elif lo + _M >= _N:
                src = new[lo + _M - _N : hi + _M - _N]
            else:
                src = np.concatenate([old[lo + _M :], new[: hi + _M - _N]])
            new[lo:hi] = src ^ self._twist(y)
        # final word kk = N-1 reads updated mt[M-1] and updated mt[0]
        y = (old[_N - 1] & _UPPER_MASK) | (new[0] & _LOWER_MASK)
        new[_N - 1] = new[_M - 1] ^ self._twist(np.atleast_1d(y))[0]
        self.mt = new
        self.mti = 0

    def genrand_int32(self) -> int:
        if self.mti >= _N:
            self._generate_block()
        y = int(self.mt[self.mti])
        self.mti += 1
        y ^= y >> 11
        y = (y ^ ((y << 7) & 0x9D2C5680)) & 0xFFFFFFFF
        y = (y ^ ((y << 15) & 0xEFC60000)) & 0xFFFFFFFF
        y ^= y >> 18
        return y

    def random_uint32(self, n: int) -> np.ndarray:
        """Return the next n draws as a uint32 array (vectorized)."""
        out = np.empty(n, dtype=np.uint32)
        filled = 0
        while filled < n:
            if self.mti >= _N:
                self._generate_block()
            take = min(n - filled, _N - self.mti)
            chunk = self.mt[self.mti : self.mti + take].copy()
            self.mti += take
            # tempering (vectorized)
            chunk ^= chunk >> np.uint32(11)
            chunk ^= (chunk << np.uint32(7)) & np.uint32(0x9D2C5680)
            chunk ^= (chunk << np.uint32(15)) & np.uint32(0xEFC60000)
            chunk ^= chunk >> np.uint32(18)
            out[filled : filled + take] = chunk
            filled += take
        return out

    def random_bases(self, n: int) -> np.ndarray:
        """n draws of genrand_int32() % 4 — the reference's random_base()
        (fill_directional_index.c:131)."""
        return (self.random_uint32(n) & np.uint32(3)).astype(np.int32)
