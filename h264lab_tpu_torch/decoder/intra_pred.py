"""Scalar intra-4x4 predictors (spec 8.3.1.2) in explicit per-sample
form — the decoder-side independent formulation, also serving as the
golden model for the batched ops/intra4.py kernels."""

from __future__ import annotations

import numpy as np


def pred4(mode: int, t, l, tl, tr):
    """t, l: arrays of 4; tl: scalar; tr: 4 (already replicated when the
    true top-right is unavailable). Returns 4x4 int array indexed [y][x]."""
    t0, t1, t2, t3 = (int(x) for x in t)
    l0, l1, l2, l3 = (int(x) for x in l)
    t4, t5, t6, t7 = (int(x) for x in tr)
    lt = int(tl)
    o = np.zeros((4, 4), int)

    if mode == 0:  # V
        o[:] = [t0, t1, t2, t3]
    elif mode == 1:  # H
        for y, lv in enumerate((l0, l1, l2, l3)):
            o[y, :] = lv
    elif mode == 2:  # DC (both-available variant; caller masks others)
        o[:] = (t0 + t1 + t2 + t3 + l0 + l1 + l2 + l3 + 4) >> 3
    elif mode == 3:  # DDL
        tt = [t0, t1, t2, t3, t4, t5, t6, t7]
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    o[y][x] = (t6 + 3 * t7 + 2) >> 2
                else:
                    o[y][x] = (tt[x + y] + 2 * tt[x + y + 1]
                               + tt[x + y + 2] + 2) >> 2
    elif mode == 4:  # DDR
        tt = {-1: lt, 0: t0, 1: t1, 2: t2, 3: t3}
        ll = {-1: lt, 0: l0, 1: l1, 2: l2, 3: l3}
        for y in range(4):
            for x in range(4):
                if x > y:
                    o[y][x] = (tt[x - y - 2] + 2 * tt[x - y - 1]
                               + tt[x - y] + 2) >> 2
                elif x < y:
                    o[y][x] = (ll[y - x - 2] + 2 * ll[y - x - 1]
                               + ll[y - x] + 2) >> 2
                else:
                    o[y][x] = (t0 + 2 * lt + l0 + 2) >> 2
    elif mode == 5:  # VR (ffmpeg-style explicit table)
        o[0][0] = o[2][1] = (lt + t0 + 1) >> 1
        o[0][1] = o[2][2] = (t0 + t1 + 1) >> 1
        o[0][2] = o[2][3] = (t1 + t2 + 1) >> 1
        o[0][3] = (t2 + t3 + 1) >> 1
        o[1][0] = o[3][1] = (l0 + 2 * lt + t0 + 2) >> 2
        o[1][1] = o[3][2] = (lt + 2 * t0 + t1 + 2) >> 2
        o[1][2] = o[3][3] = (t0 + 2 * t1 + t2 + 2) >> 2
        o[1][3] = (t1 + 2 * t2 + t3 + 2) >> 2
        o[2][0] = (lt + 2 * l0 + l1 + 2) >> 2
        o[3][0] = (l0 + 2 * l1 + l2 + 2) >> 2
    elif mode == 6:  # HD
        o[0][0] = o[1][2] = (lt + l0 + 1) >> 1
        o[0][1] = o[1][3] = (l0 + 2 * lt + t0 + 2) >> 2
        o[0][2] = (lt + 2 * t0 + t1 + 2) >> 2
        o[0][3] = (t0 + 2 * t1 + t2 + 2) >> 2
        o[1][0] = o[2][2] = (l0 + l1 + 1) >> 1
        o[1][1] = o[2][3] = (lt + 2 * l0 + l1 + 2) >> 2
        o[2][0] = o[3][2] = (l1 + l2 + 1) >> 1
        o[2][1] = o[3][3] = (l0 + 2 * l1 + l2 + 2) >> 2
        o[3][0] = (l2 + l3 + 1) >> 1
        o[3][1] = (l1 + 2 * l2 + l3 + 2) >> 2
    elif mode == 7:  # VL
        tt = [t0, t1, t2, t3, t4, t5, t6, t7]
        for y in range(4):
            for x in range(4):
                xv = x + (y >> 1)
                if y % 2 == 0:
                    o[y][x] = (tt[xv] + tt[xv + 1] + 1) >> 1
                else:
                    o[y][x] = (tt[xv] + 2 * tt[xv + 1] + tt[xv + 2] + 2) >> 2
    elif mode == 8:  # HU
        ll = [l0, l1, l2, l3]
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                yu = y + (x >> 1)
                if z > 5:
                    o[y][x] = l3
                elif z == 5:
                    o[y][x] = (l2 + 3 * l3 + 2) >> 2
                elif z % 2 == 0:
                    o[y][x] = (ll[yu] + ll[yu + 1] + 1) >> 1
                else:
                    o[y][x] = (ll[yu] + 2 * ll[yu + 1] + ll[yu + 2] + 2) >> 2
    return o
