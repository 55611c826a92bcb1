"""The port's word-level bit packer against per-bit packers and JAX's.

- `bitstream/bitwriter.pack_bits` (the counterpart of the JAX package's
  native `pack_bits`) on hypothesis symbol streams (lengths 0 to 32,
  values with bits set above their length) and on fixed streams (empty,
  one symbol, all 32-bit symbols, byte-aligned and unaligned totals):
  the bytes and bit counts of JAX's `pack_symbols_to_bytes`, of the
  port's per-bit `pack_symbols_to_bytes` and of the byte-serial loop kept
  below (a copy of `h264lab_pack_bits`);
- `BitWriter` word runs (`append_words`, `append_bits_bytes`) placed by
  a funnel shift: header symbols, int32 words with negative bit patterns
  at every start offset 0 to 31, `nbits` not a multiple of 32 with
  garbage past it, a tail symbol and the trailing bits; two runs;
  `append_writer` of a writer that holds a run; random call sequences.
  `to_bytes` equals the per-bit `to_bits` and JAX's `BitWriter.to_bytes`
  on the same calls.
No encode runs. Tolerance: exact equality.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from h264lab_tpu.bitstream import bitwriter as jbw
from h264lab_tpu_torch.bitstream import bitwriter as tbw

SETTINGS = settings(max_examples=300, deadline=None, database=None)


def pack_bits_loop(vals, lens) -> tuple[bytes, int]:
    """`h264lab_pack_bits` byte by byte: MSB first, nbits == 0 skipped,
    each value masked to its length, the tail zero-padded to a byte."""
    out, acc, acc_bits, total = bytearray(), 0, 0, 0
    for v, nb in zip(vals, lens):
        nb = int(nb)
        if nb == 0:
            continue
        acc = (acc << nb) | (int(v) & ((1 << nb) - 1))
        acc_bits += nb
        total += nb
        while acc_bits >= 8:
            out.append((acc >> (acc_bits - 8)) & 0xFF)
            acc_bits -= 8
        acc &= (1 << acc_bits) - 1
    if acc_bits:
        out.append((acc << (8 - acc_bits)) & 0xFF)
    return bytes(out), total


def check_pack_bits(vals, lens):
    """The port's `pack_bits` on int32 bit patterns against the three
    oracles on the same symbols as uint32."""
    vals = np.asarray(vals, np.int64)
    lens = np.asarray(lens, np.uint8)
    v32 = vals.astype(np.uint32)
    got = tbw.pack_bits(vals.astype(np.int32), lens)
    assert got == pack_bits_loop(v32, lens)
    assert got == tbw.pack_symbols_to_bytes(v32, lens)
    assert got == jbw.pack_symbols_to_bytes(v32, lens)
    assert tbw.pack_bits(v32, lens) == got
    return got


symbol = st.tuples(st.integers(-2**31, 2**31 - 1), st.integers(0, 32))


@SETTINGS
@given(st.lists(symbol, max_size=80))
def test_pack_bits_random_streams(syms):
    vals = [v for v, _ in syms]
    lens = [n for _, n in syms]
    check_pack_bits(vals, lens)


FIXED_STREAMS = {
    "empty": ([], []),
    "one symbol": ([0x5], [3]),
    "one 32-bit symbol": ([-0x12345679], [32]),
    "only zero lengths": ([7, -1, 3], [0, 0, 0]),
    "all 32-bit symbols": ([-1, 0x01234567, -0x7F00FF01, 0, 1], [32] * 5),
    "byte-aligned total": ([-1, 3, 0x1F, 0], [5, 3, 16, 8]),
    "unaligned total": ([-1, -1, -1], [7, 31, 1]),
    "bits above the length": ([-1, 0xFFFFFFF0, 0x80000001], [1, 4, 31]),
    "lengths 0 to 32": (list(range(-33, 0)), list(range(33))),
}


@pytest.mark.parametrize("name", list(FIXED_STREAMS))
def test_pack_bits_fixed_streams(name):
    vals, lens = FIXED_STREAMS[name]
    data, total = check_pack_bits(vals, lens)
    assert total == sum(lens) and len(data) == (total + 7) // 8


def run_words(rng, nbits, extra=2):
    """int32 words of a run of `nbits` bits: random patterns (negative
    ones included) and random garbage past the run, in the last word and
    in `extra` words after it."""
    n = (nbits + 31) // 32 + extra
    return rng.integers(-2**31, 2**31, n).astype(np.int32)


def words_bytes(words):
    return words.view(np.uint32).astype(">u4").tobytes()


class Pair:
    """The same calls on the port's and JAX's BitWriter."""

    def __init__(self):
        self.t, self.j = tbw.BitWriter(capacity=4), jbw.BitWriter(capacity=4)

    def u(self, n, v):
        self.t.u(n, v)
        self.j.u(n, v)

    def ue(self, v):
        self.t.ue(v)
        self.j.ue(v)

    def words(self, words, nbits, as_bytes=False):
        if as_bytes:
            self.t.append_bits_bytes(words_bytes(words), nbits)
        else:
            self.t.append_words(words, nbits)
        self.j.append_bits_bytes(words_bytes(words), nbits)

    def finish(self):
        self.t.rbsp_trailing_bits()
        self.j.rbsp_trailing_bits()
        assert self.t.bit_length == self.j.bit_length
        got = self.t.to_bytes()
        assert got == np.packbits(self.t.to_bits()).tobytes()
        assert got == self.j.to_bytes()
        return got


@pytest.mark.parametrize("offset", range(32))
def test_word_run_at_every_offset(offset):
    rng = np.random.default_rng(offset)
    w = Pair()
    if offset:                              # header fields of `offset` bits
        w.u(1, 1)
    if offset > 1:
        w.u(offset - 1, int(rng.integers(0, 2**32)))
    assert w.t.bit_length == offset
    nbits = 32 * 5 + 1 + offset % 31        # never a multiple of 32
    words = run_words(rng, nbits)
    assert (words < 0).any()
    w.words(words, nbits)
    assert w.t.bit_length == offset + nbits
    w.u(9, 0x155)                           # the tail symbol
    w.finish()


@pytest.mark.parametrize("nbits", [1, 31, 32, 33, 64, 95, 4096 + 7])
@pytest.mark.parametrize("as_bytes", [False, True])
def test_word_run_lengths(nbits, as_bytes):
    rng = np.random.default_rng(nbits)
    w = Pair()
    w.u(13, 0x1ABC)
    w.words(run_words(rng, nbits), nbits, as_bytes)
    w.finish()


def test_two_word_runs_and_empty_run():
    rng = np.random.default_rng(5)
    w = Pair()
    w.u(3, 5)
    w.words(run_words(rng, 70), 70)
    w.words(run_words(rng, 45), 45)          # back to back
    w.words(run_words(rng, 0), 0)            # nothing
    w.ue(17)
    w.words(run_words(rng, 33), 33)
    w.finish()


def test_append_writer_carries_runs():
    rng = np.random.default_rng(6)
    inner = Pair()
    inner.u(5, 0x1B)
    inner.words(run_words(rng, 77), 77)
    inner.u(2, 1)
    outer = Pair()
    outer.u(11, 0x3FF)
    outer.words(run_words(rng, 40), 40)
    outer.t.append_writer(inner.t)
    outer.j.append_writer(inner.j)
    assert outer.t.bit_length == 11 + 40 + 5 + 77 + 2
    outer.u(4, 9)
    outer.t.byte_align(1)
    outer.j.byte_align(1)
    outer.finish()


op = st.one_of(
    st.tuples(st.just("u"), st.integers(1, 32), st.integers(0, 2**32 - 1)),
    st.tuples(st.just("ue"), st.integers(0, 5000), st.just(0)),
    st.tuples(st.just("words"), st.integers(0, 200), st.integers(0, 2**16)),
)


@SETTINGS
@given(st.lists(op, max_size=12))
def test_writer_random_calls(ops):
    w = Pair()
    for kind, a, b in ops:
        if kind == "u":
            w.u(a, b)
        elif kind == "ue":
            w.ue(a)
        else:
            words = run_words(np.random.default_rng(b), a)
            w.words(words, a, as_bytes=bool(b & 1))
    w.finish()
