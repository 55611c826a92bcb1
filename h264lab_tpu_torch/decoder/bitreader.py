"""MSB-first bit reader for RBSP payloads (the decoder's)."""

from __future__ import annotations

import numpy as np


class BitReader:
    def __init__(self, data: bytes):
        self._bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for b in self._bits[self.pos:self.pos + n]:
            v = (v << 1) | int(b)
        self.pos += n
        return v

    def u1(self) -> int:
        v = int(self._bits[self.pos])
        self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self._bits[self.pos] == 0:
            zeros += 1
            self.pos += 1
        self.pos += 1
        return (1 << zeros) - 1 + self.u(zeros) if zeros else 0

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def more_rbsp_data(self) -> bool:
        """True if there is payload beyond the rbsp_stop_one_bit."""
        rest = self._bits[self.pos:]
        if len(rest) == 0:
            return False
        nz = np.flatnonzero(rest)
        if len(nz) == 0:
            return False
        # last 1-bit is the stop bit; data remains iff pos < that bit
        return nz[-1] > 0

    def byte_aligned(self) -> bool:
        return self.pos % 8 == 0
