"""Symbol-buffered bit writer with vectorized packing.

Design: unlike the reference's streaming 32-bit big-endian bit cache
(`src/h264-lab.h:2688-2772`), this writer *records* (value, nbits) symbol
pairs into growable numpy arrays, and runs of already-packed 32-bit words
(the device bit-packer's output) beside them, and packs both into bytes in
one vectorized pass at the end. That matches the batched encoder's shape:
the slice header is a few dozen symbols, the macroblock data one word run.

`to_bytes` works on 32-bit words: `pack_bits` places each symbol in the
one or two words it touches (an exclusive cumsum of the lengths gives its
bit offset), and a word run is funnel-shifted to its bit offset. The
per-bit packer `pack_symbols_to_bits` (one byte per bit) stays as the plain
version that the word-level path is held against.

All H.264 bit fields are MSB-first; symbols longer than 32 bits must be
split by the caller (the longest baseline syntax element is 32 bits).
"""

from __future__ import annotations

import numpy as np


def bit_length(v: np.ndarray) -> np.ndarray:
    """Elementwise bit length for non-negative int64 arrays."""
    v = np.asarray(v, dtype=np.int64)
    b = np.zeros_like(v)
    x = v.copy()
    while np.any(x):
        b += x > 0
        x >>= 1
    return b


def ue_code(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized unsigned Exp-Golomb: returns (code_value, nbits)."""
    v1 = np.asarray(v, dtype=np.int64) + 1
    return v1, 2 * bit_length(v1) - 1


def se_code(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized signed Exp-Golomb (spec 9.1.1)."""
    v = np.asarray(v, dtype=np.int64)
    return ue_code(np.where(v > 0, 2 * v - 1, -2 * v))


class BitWriter:
    """Growable MSB-first bit writer: symbols, and word runs between them."""

    def __init__(self, capacity: int = 1024):
        self._vals = np.zeros(capacity, dtype=np.uint32)
        self._lens = np.zeros(capacity, dtype=np.uint8)
        self._n = 0
        # word runs: (symbols written before the run, uint32 words, nbits)
        self._runs: list[tuple[int, np.ndarray, int]] = []
        self._run_bits = 0

    # -- low level ---------------------------------------------------------
    def _grow(self, need: int):
        cap = len(self._vals)
        if self._n + need > cap:
            new_cap = max(cap * 2, self._n + need)
            self._vals = np.resize(self._vals, new_cap)
            self._lens = np.resize(self._lens, new_cap)

    def u(self, nbits: int, value: int):
        """Write fixed-width unsigned field, MSB first."""
        assert 0 < nbits <= 32
        self._grow(1)
        self._vals[self._n] = value & (0xFFFFFFFF >> (32 - nbits))
        self._lens[self._n] = nbits
        self._n += 1

    def u1(self, bit: int):
        self.u(1, bit)

    def ue(self, v: int):
        """Unsigned Exp-Golomb (spec 9.1)."""
        assert v >= 0
        code = v + 1
        self.u(2 * code.bit_length() - 1, code)

    def se(self, v: int):
        """Signed Exp-Golomb (spec 9.1.1)."""
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, v: int, max_val: int):
        """Truncated Exp-Golomb (spec 9.1.1): 1-bit inverted when max==1."""
        if max_val == 1:
            self.u1(1 - v)
        else:
            self.ue(v)

    # -- bulk appends (device-produced symbol streams) ---------------------
    def append_symbols(self, vals: np.ndarray, lens: np.ndarray):
        """Append arrays of (value, nbits) symbols; entries with nbits==0
        are skipped. This is the fast path for CAVLC output."""
        lens = np.asarray(lens).ravel()
        vals = np.asarray(vals).ravel()
        keep = lens > 0
        vals = vals[keep].astype(np.uint32)
        lens = lens[keep].astype(np.uint8)
        k = len(vals)
        self._grow(k)
        self._vals[self._n:self._n + k] = vals
        self._lens[self._n:self._n + k] = lens
        self._n += k

    def append_words(self, words: np.ndarray, nbits: int):
        """Append an MSB-first run of `nbits` bits packed in 32-bit words
        (uint32, or int32 bit patterns) at the current bit position. Only
        the ceil(nbits / 32) words that hold the run are kept, and the
        bits past `nbits` in the last one are cleared."""
        nbits = int(nbits)
        if nbits == 0:
            return
        w = np.asarray(words).ravel()
        k = (nbits + 31) // 32
        if len(w) < k:
            raise ValueError(f"{len(w)} words cannot hold {nbits} bits")
        w = w[:k].astype(np.uint32)         # a copy; int32 patterns wrap
        if nbits % 32:
            w[-1] &= np.uint32(0xFFFFFFFF << (32 - nbits % 32) & 0xFFFFFFFF)
        self._runs.append((self._n, w, nbits))
        self._run_bits += nbits

    def append_bits_bytes(self, data: bytes, nbits: int):
        """Append a pre-packed MSB-first bit payload of `nbits` bits
        (e.g. device-packed CAVLC words) at the current bit position."""
        if nbits == 0:
            return
        pad = (-len(data)) % 4
        self.append_words(np.frombuffer(data + b"\x00" * pad, dtype=">u4"),
                          nbits)

    def append_writer(self, other: "BitWriter"):
        self._runs += [(self._n + at, w, nb) for at, w, nb in other._runs]
        self._run_bits += other._run_bits
        self._grow(other._n)
        self._vals[self._n:self._n + other._n] = other._vals[:other._n]
        self._lens[self._n:self._n + other._n] = other._lens[:other._n]
        self._n += other._n

    # -- queries -----------------------------------------------------------
    @property
    def bit_length(self) -> int:
        return int(self._lens[:self._n].sum(dtype=np.int64)) + self._run_bits

    def byte_align(self, bit: int = 0):
        """Pad with `bit` up to a byte boundary."""
        rem = (-self.bit_length) % 8
        if rem:
            self.u(rem, 0 if bit == 0 else (1 << rem) - 1)

    def rbsp_trailing_bits(self):
        """rbsp_stop_one_bit + zero padding to byte boundary (spec 7.3.2.11)."""
        self.u1(1)
        self.byte_align(0)

    # -- packing -----------------------------------------------------------
    def _symbols(self) -> tuple[np.ndarray, np.ndarray]:
        """Every field as (value, nbits) symbols, word runs split into
        32-bit symbols (the last one right-aligned)."""
        vals, lens, start = [], [], 0
        for at, w, nbits in self._runs:
            vals += [self._vals[start:at], w.copy()]
            lens += [self._lens[start:at], np.full(len(w), 32, np.uint8)]
            if nbits % 32:
                vals[-1][-1] >>= 32 - nbits % 32
                lens[-1][-1] = nbits % 32
            start = at
        vals.append(self._vals[start:self._n])
        lens.append(self._lens[start:self._n])
        return np.concatenate(vals), np.concatenate(lens)

    def to_bits(self) -> np.ndarray:
        """Unpacked bit array (uint8 of 0/1), MSB-first order: the per-bit
        plain version of `to_bytes`."""
        return pack_symbols_to_bits(*self._symbols())

    def to_bytes(self) -> bytes:
        """Pack to bytes; total bit length must be a byte multiple
        (call rbsp_trailing_bits / byte_align first)."""
        total = self.bit_length
        assert total % 8 == 0, "bitstream not byte aligned"
        lens = self._lens[:self._n].astype(np.int64)
        start = np.zeros(self._n + 1, np.int64)   # symbol bits before each
        np.cumsum(lens, out=start[1:])
        acc = np.zeros((total + 31) // 32 + 1, np.uint32)
        shift = np.zeros(self._n + 1, np.int64)   # run bits before each
        before = 0
        for at, w, nbits in self._runs:
            _place_words(acc, w, int(start[at]) + before)
            shift[at] += nbits
            before += nbits
        _place_symbols(acc, self._vals[:self._n], lens,
                       start[:-1] + np.cumsum(shift)[:-1])
        return _words_to_bytes(acc, total)


def _place_symbols(acc: np.ndarray, vals: np.ndarray, lens: np.ndarray,
                   offs: np.ndarray):
    """Add MSB-first (value, nbits) symbols at bit offsets `offs` into the
    uint32 word array `acc` (one word past the last bit). A symbol of at
    most 32 bits touches word off >> 5 and perhaps the next: it is shifted
    into a 64-bit window, whose high half goes to the first word and low
    half to the second. The fields never overlap, so a sum is an OR; the
    sums run in float64, exact since each word's sum is below 2^32."""
    keep = lens > 0
    if not keep.all():
        vals, lens, offs = vals[keep], lens[keep], offs[keep]
    if len(lens) == 0:
        return
    lens = lens.astype(np.uint64)
    v = np.asarray(vals).astype(np.uint64) & ((np.uint64(1) << lens)
                                               - np.uint64(1))
    w = v << (np.uint64(64) - (offs & 31).astype(np.uint64) - lens)
    k = offs >> 5
    acc += np.bincount(
        np.concatenate([k, k + 1]),
        weights=np.concatenate([w >> np.uint64(32),
                                w & np.uint64(0xFFFFFFFF)]).astype(np.float64),
        minlength=len(acc)).astype(np.uint32)


def _place_words(acc: np.ndarray, words: np.ndarray, bit: int):
    """OR MSB-first uint32 `words` (bits past the run already cleared) into
    `acc` at bit offset `bit`: a funnel shift, word i of the output being
    ((words[i - 1] << 32) | words[i]) >> s, done as the two halves."""
    k, s, n = bit >> 5, bit & 31, len(words)
    if s == 0:
        acc[k:k + n] |= words
    else:
        acc[k:k + n] |= words >> np.uint32(s)
        acc[k + 1:k + n + 1] |= words << np.uint32(32 - s)


def _words_to_bytes(acc: np.ndarray, total: int) -> bytes:
    """The first ceil(total / 8) bytes of MSB-first uint32 words."""
    return acc[:(total + 31) // 32].astype(">u4").tobytes()[:(total + 7) // 8]


def pack_bits(vals: np.ndarray, lens: np.ndarray) -> tuple[bytes, int]:
    """Pack (value, nbits) symbols MSB first into bytes; returns (bytes,
    total_bits). Entries with nbits == 0 are skipped, each value is masked
    to its length (int32 bit patterns may have bits above it set), and
    the tail is zero-padded to a byte."""
    lens = np.asarray(lens).ravel().astype(np.int64)
    total = int(lens.sum())
    acc = np.zeros((total + 31) // 32 + 1, np.uint32)
    _place_symbols(acc, np.asarray(vals).ravel(), lens, np.cumsum(lens) - lens)
    return _words_to_bytes(acc, total), total


def pack_symbols_to_bits(vals: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized (value,len) symbol list → flat 0/1 bit array (MSB first).

    Right-align each symbol in a (n, maxlen) matrix: column c holds the bit
    with shift (maxlen-1-c); a symbol of length L occupies the last L
    columns. Masked flatten preserves stream order.
    """
    if len(vals) == 0:
        return np.zeros(0, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.uint64)
    maxlen = int(lens.max()) if len(lens) else 0
    if maxlen == 0:
        return np.zeros(0, dtype=np.uint8)
    cols = np.arange(maxlen, dtype=np.int64)[None, :]
    shift = (maxlen - 1 - cols).astype(np.uint64)
    bitmat = ((vals[:, None] >> shift) & 1).astype(np.uint8)
    mask = cols >= (maxlen - lens[:, None])
    return bitmat[mask]


def pack_symbols_to_bytes(vals: np.ndarray, lens: np.ndarray) -> tuple[bytes, int]:
    """Pack symbols to bytes (zero-padded at the tail); returns (data, nbits)."""
    bits = pack_symbols_to_bits(vals, lens)
    nbits = len(bits)
    if nbits % 8:
        bits = np.concatenate([bits, np.zeros((-nbits) % 8, dtype=np.uint8)])
    return np.packbits(bits).tobytes(), nbits
