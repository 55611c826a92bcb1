"""NAL unit framing: Annex-B start codes and emulation-prevention escaping.

Reference equivalents: `nal_start`/`nal_end` + escape insertion
(`src/h264-lab.h:3926-4022`). Numpy only: this package loads no native
extension.
"""

from __future__ import annotations

import numpy as np


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (0x03) so the payload never
    contains 0x000000..0x000003 sequences (spec 7.4.1.1)."""
    data = np.frombuffer(rbsp, dtype=np.uint8)
    if len(data) < 3:
        return rbsp
    # Fast path: no 00 00 0x pattern anywhere → nothing to escape.
    cand = (data[2:] <= 3) & (data[1:-1] == 0) & (data[:-2] == 0)
    if not cand.any():
        return rbsp
    # Insertions reset the zero run, so evaluate left to right.
    result = bytearray()
    zeros = 0
    for b in data:
        b = int(b)
        if zeros >= 2 and b <= 3:
            result.append(3)
            zeros = 0
        result.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(result)


def unescape_rbsp(ebsp: bytes) -> bytes:
    """Remove emulation-prevention 0x03 bytes (decoder side)."""
    data = np.frombuffer(ebsp, dtype=np.uint8)
    if len(data) < 3:
        return ebsp
    maybe = (data[2:] == 3) & (data[1:-1] == 0) & (data[:-2] == 0)
    if not maybe.any():
        return ebsp
    keep = np.ones(len(data), dtype=bool)
    zeros = 0
    for i in range(len(data)):
        b = int(data[i])
        if zeros >= 2 and b == 3:
            keep[i] = False
            zeros = 0
            continue
        zeros = zeros + 1 if b == 0 else 0
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
