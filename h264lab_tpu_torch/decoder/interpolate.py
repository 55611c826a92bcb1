"""Scalar/numpy sub-pel interpolation for the test decoder (spec 8.4.2.2).

Independent implementation from the spec text: full half-pel planes are
computed per reference frame with numpy stencils, quarter-pel samples by
averaging, chroma by 1/8-pel bilinear.
"""

from __future__ import annotations

import numpy as np

# Must cover the encoder's maximum MV reach (ops/me.py MAX_CAND_FP +
# sub-pel + 6-tap support); too small a guard would silently wrap
# numpy's negative indices into garbage predictions.
GUARD = 80


def pad(plane: np.ndarray, g: int) -> np.ndarray:
    return np.pad(plane, ((g, g), (g, g)), mode="edge")


def _filt6(x: np.ndarray, axis: int) -> np.ndarray:
    taps = (1, -5, 20, 20, -5, 1)
    x = x.astype(np.int32)
    n = x.shape[axis] - 5
    sl = [slice(None)] * x.ndim

    def take(i):
        sl2 = list(sl)
        sl2[axis] = slice(i, i + n)
        return x[tuple(sl2)]

    return sum(t * take(i) for i, t in enumerate(taps))


def half_planes(ref_pad: np.ndarray):
    """Return clipped (b, h, j) planes aligned with ref_pad."""
    p = ref_pad.astype(np.int32)
    ph = np.pad(p, ((0, 0), (2, 3)), mode="edge")
    b_raw = _filt6(ph, 1)
    b = np.clip((b_raw + 16) >> 5, 0, 255).astype(np.uint8)
    pv = np.pad(p, ((2, 3), (0, 0)), mode="edge")
    h_raw = _filt6(pv, 0)
    h = np.clip((h_raw + 16) >> 5, 0, 255).astype(np.uint8)
    hp = np.pad(h_raw, ((0, 0), (2, 3)), mode="edge")
    j_raw = _filt6(hp, 1)
    j = np.clip((j_raw + 512) >> 10, 0, 255).astype(np.uint8)
    return b, h, j


def mc_luma_block(planes, y0: int, x0: int, mvy: int, mvx: int,
                  bh: int = 16, bw: int = 16) -> np.ndarray:
    """Predict one luma block; (y0,x0) top-left in padded coords."""
    full, b, h, j = planes
    iy = y0 + (mvy >> 2)
    ix = x0 + (mvx >> 2)
    fy, fx = mvy & 3, mvx & 3

    def g(plane, oy=0, ox=0):
        return plane[iy + oy:iy + oy + bh, ix + ox:ix + ox + bw].astype(np.int32)

    def avg(p, q):
        return (p + q + 1) >> 1

    G = g(full)
    if (fy, fx) == (0, 0):
        out = G
    elif (fy, fx) == (0, 2):
        out = g(b)
    elif (fy, fx) == (2, 0):
        out = g(h)
    elif (fy, fx) == (2, 2):
        out = g(j)
    elif (fy, fx) == (0, 1):
        out = avg(G, g(b))
    elif (fy, fx) == (0, 3):
        out = avg(g(b), g(full, 0, 1))
    elif (fy, fx) == (1, 0):
        out = avg(G, g(h))
    elif (fy, fx) == (3, 0):
        out = avg(g(h), g(full, 1, 0))
    elif (fy, fx) == (1, 1):
        out = avg(g(b), g(h))
    elif (fy, fx) == (1, 2):
        out = avg(g(b), g(j))
    elif (fy, fx) == (1, 3):
        out = avg(g(b), g(h, 0, 1))
    elif (fy, fx) == (2, 1):
        out = avg(g(h), g(j))
    elif (fy, fx) == (2, 3):
        out = avg(g(j), g(h, 0, 1))
    elif (fy, fx) == (3, 1):
        out = avg(g(h), g(b, 1, 0))
    elif (fy, fx) == (3, 2):
        out = avg(g(j), g(b, 1, 0))
    else:  # (3, 3)
        out = avg(g(h, 0, 1), g(b, 1, 0))
    return out.astype(np.uint8)


def mc_chroma_block(plane_pad: np.ndarray, y0: int, x0: int,
                    mvy: int, mvx: int, bh: int = 8, bw: int = 8):
    iy = y0 + (mvy >> 3)
    ix = x0 + (mvx >> 3)
    fy, fx = mvy & 7, mvx & 7
    A = plane_pad[iy:iy + bh, ix:ix + bw].astype(np.int32)
    B = plane_pad[iy:iy + bh, ix + 1:ix + 1 + bw].astype(np.int32)
    C = plane_pad[iy + 1:iy + 1 + bh, ix:ix + bw].astype(np.int32)
    D = plane_pad[iy + 1:iy + 1 + bh, ix + 1:ix + 1 + bw].astype(np.int32)
    out = ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B
           + (8 - fx) * fy * C + fx * fy * D + 32) >> 6
    return out.astype(np.uint8)
