"""The port's host-side helpers against a per-byte loop and the JAX package.

- `bitstream/nal.py`: `escape_rbsp` and `unescape_rbsp` are numpy passes
  in the port; on hypothesis payloads (random bytes, zero-heavy bytes, all
  zeros, and `00 00 0x` across the start and the end) they give the bytes
  of the byte-serial loop kept below and of `h264lab_tpu.bitstream.nal`,
  and escaping then unescaping gives the payload back;
- `utils/synthetic.py`: `noise_pan_sequence` frames equal the JAX
  package's at two sizes and a nonzero start, and the filtered texture is
  cached per size in a bounded cache.
Tolerance: exact equality.
"""

import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from h264lab_tpu.bitstream import nal as jnal
from h264lab_tpu.utils import synthetic as jsyn
from h264lab_tpu_torch.bitstream import nal as tnal
from h264lab_tpu_torch.utils import synthetic as tsyn

SETTINGS = settings(max_examples=300, deadline=None, database=None)


def escape_loop(rbsp: bytes) -> bytes:
    """Spec 7.4.1.1 byte by byte: after two zeros, 0x03 goes before any
    byte <= 3, and the zero count restarts."""
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def unescape_loop(ebsp: bytes) -> bytes:
    out, zeros = bytearray(), 0
    for b in ebsp:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


small = st.integers(0, 4)
payloads = st.one_of(
    st.binary(max_size=64),                                   # random
    st.lists(st.sampled_from([0, 0, 0, 1, 2, 3, 4, 0xFF]),    # zero-heavy
             max_size=96).map(bytes),
    st.integers(0, 40).map(lambda n: bytes(n)),               # all zeros
    st.tuples(small, st.binary(max_size=24), small).map(      # 00 00 0x at
        lambda t: b"\x00\x00" + bytes([t[0]]) + t[1]          # both ends
        + b"\x00\x00" + bytes([t[2]])),
)


@SETTINGS
@given(payloads)
def test_escape_equals_the_loop_and_jax(rbsp):
    got = tnal.escape_rbsp(rbsp)
    assert got == escape_loop(rbsp) == jnal.escape_rbsp(rbsp)
    assert tnal.unescape_rbsp(got) == rbsp


@SETTINGS
@given(payloads)
def test_unescape_equals_the_loop_and_jax(ebsp):
    assert tnal.unescape_rbsp(ebsp) == unescape_loop(ebsp) \
        == jnal.unescape_rbsp(ebsp)


def test_escape_cases():
    # a run's odd places from the third on, and a byte 1..3 after a run of
    # even length, take the 0x03
    assert tnal.escape_rbsp(bytes(5)) == b"\x00\x00\x03\x00\x00\x03\x00"
    assert tnal.escape_rbsp(b"\x00\x00\x01\x00\x00\x00\x02") == \
        b"\x00\x00\x03\x01\x00\x00\x03\x00\x02"
    assert tnal.escape_rbsp(b"\x00\x00\x04") == b"\x00\x00\x04"
    assert tnal.unescape_rbsp(b"\x00\x00\x03\x03") == b"\x00\x00\x03"


def test_noise_pan_frames_equal_jax_and_the_cache_is_bounded():
    tsyn._noise_texture.cache_clear()
    for w, h, start, n in ((64, 48, 0, 3), (100, 72, 37, 4)):
        got = list(tsyn.noise_pan_sequence(w, h, n, start))
        want = list(jsyn.noise_pan_sequence(w, h, n, start))
        assert len(got) == n
        for t, (a, b) in enumerate(zip(got, want)):
            for pa, pb in zip(a, b):
                np.testing.assert_array_equal(pa, pb,
                                              err_msg=f"{w}x{h} frame {t}")
    assert tsyn._noise_texture.cache_info().currsize == 2
    for w in range(16, 112, 16):                    # six more sizes
        next(tsyn.noise_pan_sequence(w, 16, 1))
    info = tsyn._noise_texture.cache_info()
    assert info.currsize == info.maxsize == 4
