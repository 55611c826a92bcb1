"""NAL unit framing: Annex-B start codes and emulation-prevention escaping.

Reference equivalents: `nal_start`/`nal_end` + escape insertion
(`src/h264-lab.h:3926-4022`). Numpy only: this package loads no native
extension.
"""

from __future__ import annotations

import numpy as np


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (0x03) so the payload never
    contains 0x000000..0x000003 sequences (spec 7.4.1.1).

    The byte-serial rule (after two zeros, put 0x03 before any byte <= 3
    and restart the zero count) in closed form over the runs of two or
    more zeros, found from the rare `00 00` pairs: in a run of L zeros
    starting at s, 0x03 goes before the zeros at s + 2, s + 4, ... (its
    3rd, 5th, ... zero), and before the byte after the run when L is even
    and that byte is 1..3; the restart after each insertion is what makes
    parity decide."""
    data = np.frombuffer(rbsp, dtype=np.uint8)
    # Fast path: no 00 00 0x pattern anywhere → nothing to escape.
    cand = (data[2:] <= 3) & (data[1:-1] == 0) & (data[:-2] == 0)
    if not cand.any():
        return rbsp
    pair = np.flatnonzero((data[:-1] == 0) & (data[1:] == 0))
    cut = np.flatnonzero(np.diff(pair) != 1) + 1
    start = pair[np.r_[0, cut]]
    length = np.diff(np.r_[0, cut, len(pair)]) + 1        # zeros per run
    n_mid = (length - 1) // 2                 # zeros at places 3, 5, ...
    first = np.repeat(np.cumsum(n_mid) - n_mid, n_mid)
    mid = np.repeat(start, n_mid) + 2 * (np.arange(len(first)) - first + 1)
    end = start + length
    after = end[(length % 2 == 0) & (end < len(data))]
    after = after[data[after] <= 3]           # nonzero: the run ended
    bounds = [0, *np.sort(np.r_[mid, after]).tolist(), len(data)]
    return b"\x03".join(rbsp[a:b] for a, b in zip(bounds[:-1], bounds[1:]))


def unescape_rbsp(ebsp: bytes) -> bytes:
    """Remove emulation-prevention 0x03 bytes (decoder side): every 0x03
    after two zeros. A removed 0x03 is not a zero, so the zero count that
    the byte-serial rule restarts never spans it."""
    data = np.frombuffer(ebsp, dtype=np.uint8)
    drop = (data[2:] == 3) & (data[1:-1] == 0) & (data[:-2] == 0)
    if not drop.any():
        return ebsp
    keep = np.concatenate(([True, True], ~drop))
    return data[keep].tobytes()


def annexb_nal(nal_ref_idc: int, nal_unit_type: int, rbsp: bytes,
               long_start: bool = True) -> bytes:
    """Wrap an RBSP payload into an Annex-B NAL unit.

    The reference always uses 4-byte start codes (`src/h264-lab.h:3980-3989`).
    """
    start = b"\x00\x00\x00\x01" if long_start else b"\x00\x00\x01"
    header = bytes([(nal_ref_idc << 5) | nal_unit_type])
    return start + header + escape_rbsp(rbsp)


def split_annexb(stream: bytes) -> list[bytes]:
    """Split an Annex-B byte stream into NAL units (start codes stripped,
    NAL header byte kept)."""
    data = np.frombuffer(stream, dtype=np.uint8)
    n = len(data)
    if n < 4:
        return []
    hits = np.flatnonzero((data[:-2] == 0) & (data[1:-1] == 0) & (data[2:] == 1))
    starts = [int(s) + 3 for s in hits]
    units = []
    for idx, s in enumerate(starts):
        e = starts[idx + 1] - 3 if idx + 1 < len(starts) else n
        # a following 4-byte start code owns one extra leading zero
        if idx + 1 < len(starts) and e > s and data[e - 1] == 0:
            e -= 1
        if e > s:
            units.append(data[s:e].tobytes())
    return units
