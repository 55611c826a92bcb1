"""CAVLC residual decoding (spec 9.2) — scalar numpy, test infrastructure.

Decode LUTs are derived from the canonical encode tables so that any
transcription error in those tables breaks round-trip tests against the
independently-built C reference encoder's streams.
"""

from __future__ import annotations

import functools

from h264lab_tpu_torch.ops import tables_cavlc as tc
from h264lab_tpu_torch.ops.tables import ZIGZAG_4x4
from h264lab_tpu_torch.decoder.bitreader import BitReader


@functools.lru_cache(maxsize=None)
def _coeff_token_lut(ctx: int):
    lut = {}
    for total in range(17):
        for t1 in range(4):
            ln = int(tc.COEFF_TOKEN_LEN[ctx, total, t1])
            vl = int(tc.COEFF_TOKEN_VAL[ctx, total, t1])
            if ln > 0 and (total > 0 or t1 == 0) and t1 <= total:
                lut[(ln, vl)] = (total, t1)
    # (0,0) entry: total=0 has only t1=0
    return lut


@functools.lru_cache(maxsize=None)
def _total_zeros_lut(total: int, chroma_dc: bool):
    lut = {}
    if chroma_dc:
        for tz in range(4):
            ln = int(tc.TOTAL_ZEROS_CDC_LEN[total, tz])
            if ln > 0 or (ln == 0 and False):
                if ln > 0:
                    lut[(ln, int(tc.TOTAL_ZEROS_CDC_VAL[total, tz]))] = tz
    else:
        for tz in range(16):
            ln = int(tc.TOTAL_ZEROS_LEN[total, tz])
            if ln > 0:
                lut[(ln, int(tc.TOTAL_ZEROS_VAL[total, tz]))] = tz
    return lut


@functools.lru_cache(maxsize=None)
def _run_before_lut(zl: int):
    lut = {}
    for run in range(15):
        ln = int(tc.RUN_BEFORE_LEN[zl, run])
        if ln > 0:
            lut[(ln, int(tc.RUN_BEFORE_VAL[zl, run]))] = run
    return lut


def _read_vlc(br: BitReader, lut: dict, max_len: int = 32):
    ln, vl = 0, 0
    while ln < max_len:
        vl = (vl << 1) | br.u1()
        ln += 1
        if (ln, vl) in lut:
            return lut[(ln, vl)]
    raise ValueError(f"VLC decode failure at bit {br.pos}")


def decode_block(br: BitReader, nc: int, max_coeff: int):
    """Decode one residual block; returns levels in zig-zag scan order
    (length max_coeff) and TotalCoeff."""
    ctx = 4 if nc < 0 else (0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3)
    if ctx == 3:
        code = br.u(6)
        if code == 3:
            total, t1 = 0, 0
        else:
            total, t1 = (code >> 2) + 1, code & 3
            if t1 > total:
                raise ValueError("bad FLC coeff_token")
    else:
        total, t1 = _read_vlc(br, _coeff_token_lut(ctx))

    levels = [0] * max_coeff
    if total == 0:
        return levels, 0

    # trailing one signs (reverse scan order)
    vals = []
    for _ in range(t1):
        vals.append(-1 if br.u1() else 1)

    sl = 1 if (total > 10 and t1 < 3) else 0
    for i in range(total - t1):
        # level_prefix
        prefix = 0
        while br.u1() == 0:
            prefix += 1
        if sl == 0:
            if prefix < 14:
                lc = prefix
            elif prefix == 14:
                lc = 14 + br.u(4)
            else:
                lc = 30 + br.u(12) if prefix == 15 else None
                if prefix >= 16:
                    lc = 30 + br.u(prefix - 3) + (1 << (prefix - 3)) - 4096
        else:
            if prefix < 15:
                lc = (prefix << sl) + br.u(sl)
            elif prefix == 15:
                lc = (15 << sl) + br.u(12)
            else:
                lc = (15 << sl) + br.u(prefix - 3) + (1 << (prefix - 3)) - 4096
        if i == 0 and t1 < 3:
            lc += 2
        level = (lc + 2) >> 1 if (lc & 1) == 0 else -((lc + 1) >> 1)
        vals.append(level)
        if sl == 0:
            sl = 1
        if abs(level) > (3 << (sl - 1)) and sl < 6:
            sl += 1

    # total_zeros
    if total < max_coeff:
        if max_coeff == 4:
            tz = _read_vlc(br, _total_zeros_lut(total, True))
        else:
            tz = _read_vlc(br, _total_zeros_lut(total, False))
    else:
        tz = 0

    # runs (reverse scan order placement)
    zeros_left = tz
    pos = total - 1 + tz  # scan index of highest-frequency coeff
    idx = pos
    for k in range(total):
        levels[idx] = vals[k]
        if k == total - 1:
            break
        if zeros_left > 0:
            run = _read_vlc(br, _run_before_lut(min(zeros_left, 7)))
        else:
            run = 0
        zeros_left -= run
        idx -= run + 1
    return levels, total


_TRANSPOSED_RASTER = [(i % 4) * 4 + i // 4 for i in range(16)]


def scan_to_raster4x4(levels_scan, scan="zigzag"):
    """Coded-order levels -> 4x4 raster array (list of 16).

    scan="zigzag" is the normative H.264 scan. scan="transposed_raster"
    matches the reference fork's non-standard coefficient order (its
    quantizer skips the zig-zag and stores blocks transposed:
    `src/h264-lab.h:2253-2254` UNZIGSAG_IN_QUANT=0 + TRANSPOSE_BLOCK=1),
    used to cross-validate this decoder against that encoder's recon.
    """
    order = ZIGZAG_4x4 if scan == "zigzag" else _TRANSPOSED_RASTER
    out = [0] * 16
    for i, v in enumerate(levels_scan):
        out[int(order[i])] = v
    return out
