"""Scalar deblocking filter for the test decoder (spec 8.7).

Processes macroblocks in raster order — per MB: the four vertical edge
columns left-to-right, then the four horizontal edge rows top-to-bottom —
which is the normative sequential formulation the batched encoder filter
(ops/deblock.py) must match bit-exactly.
"""

from __future__ import annotations

import numpy as np

from h264lab_tpu_torch.ops.tables import ALPHA_TABLE, BETA_TABLE, TC0_TABLE, \
    QPC_FROM_QPY


def _bs_edge(intra_p, intra_q, nnz_p, nnz_q, mv_p, mv_q, mb_edge):
    if intra_p or intra_q:
        return 4 if mb_edge else 3
    if nnz_p or nnz_q:
        return 2
    if (abs(int(mv_p[0]) - int(mv_q[0])) >= 4
            or abs(int(mv_p[1]) - int(mv_q[1])) >= 4):
        return 1
    return 0


def _filter_luma_seg(plane, ys, xs, vert, bs, qp):
    """Filter a 4-sample luma edge segment. vert: edge is vertical
    (samples vary along y); (ys, xs) = q0 position of the first sample."""
    if bs == 0:
        return
    alpha = int(ALPHA_TABLE[qp])
    beta = int(BETA_TABLE[qp])
    tc0 = int(TC0_TABLE[qp][min(bs, 3) - 1])
    for i in range(4):
        y0, x0 = (ys + i, xs) if vert else (ys, xs + i)

        def gp(j):  # p_j sample
            return int(plane[y0, x0 - 1 - j] if vert else plane[y0 - 1 - j, x0])

        def gq(j):
            return int(plane[y0, x0 + j] if vert else plane[y0 + j, x0])

        def sp(j, v):
            if vert:
                plane[y0, x0 - 1 - j] = np.uint8(np.clip(v, 0, 255))
            else:
                plane[y0 - 1 - j, x0] = np.uint8(np.clip(v, 0, 255))

        def sq(j, v):
            if vert:
                plane[y0, x0 + j] = np.uint8(np.clip(v, 0, 255))
            else:
                plane[y0 + j, x0] = np.uint8(np.clip(v, 0, 255))

        p0, p1, p2, p3 = gp(0), gp(1), gp(2), gp(3)
        q0, q1, q2, q3 = gq(0), gq(1), gq(2), gq(3)
        if not (abs(p0 - q0) < alpha and abs(p1 - p0) < beta
                and abs(q1 - q0) < beta):
            continue
        ap = abs(p2 - p0) < beta
        aq = abs(q2 - q0) < beta
        if bs == 4:
            if abs(p0 - q0) < (alpha >> 2) + 2 and ap:
                sp(0, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
                sp(1, (p2 + p1 + p0 + q0 + 2) >> 2)
                sp(2, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
            else:
                sp(0, (2 * p1 + p0 + q1 + 2) >> 2)
            if abs(p0 - q0) < (alpha >> 2) + 2 and aq:
                sq(0, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3)
                sq(1, (q2 + q1 + q0 + p0 + 2) >> 2)
                sq(2, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3)
            else:
                sq(0, (2 * q1 + q0 + p1 + 2) >> 2)
        else:
            tc = tc0 + int(ap) + int(aq)
            delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
            sp(0, p0 + delta)
            sq(0, q0 - delta)
            if ap:
                sp(1, p1 + np.clip((p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1,
                                   -tc0, tc0))
            if aq:
                sq(1, q1 + np.clip((q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1,
                                   -tc0, tc0))


def _filter_chroma_seg(plane, ys, xs, vert, bs, qpc):
    """Filter a 2-sample chroma edge segment at chroma resolution."""
    if bs == 0:
        return
    alpha = int(ALPHA_TABLE[qpc])
    beta = int(BETA_TABLE[qpc])
    tc0 = int(TC0_TABLE[qpc][min(bs, 3) - 1])
    for i in range(2):
        y0, x0 = (ys + i, xs) if vert else (ys, xs + i)
        if vert:
            p1, p0 = int(plane[y0, x0 - 2]), int(plane[y0, x0 - 1])
            q0, q1 = int(plane[y0, x0]), int(plane[y0, x0 + 1])
        else:
            p1, p0 = int(plane[y0 - 2, x0]), int(plane[y0 - 1, x0])
            q0, q1 = int(plane[y0, x0]), int(plane[y0 + 1, x0])
        if not (abs(p0 - q0) < alpha and abs(p1 - p0) < beta
                and abs(q1 - q0) < beta):
            continue
        if bs == 4:
            np0 = (2 * p1 + p0 + q1 + 2) >> 2
            nq0 = (2 * q1 + q0 + p1 + 2) >> 2
        else:
            tc = tc0 + 1
            delta = int(np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3,
                                -tc, tc))
            np0 = np.clip(p0 + delta, 0, 255)
            nq0 = np.clip(q0 - delta, 0, 255)
        if vert:
            plane[y0, x0 - 1] = np.uint8(np.clip(np0, 0, 255))
            plane[y0, x0] = np.uint8(np.clip(nq0, 0, 255))
        else:
            plane[y0 - 1, x0] = np.uint8(np.clip(np0, 0, 255))
            plane[y0, x0] = np.uint8(np.clip(nq0, 0, 255))


def deblock_picture(frame, mb_intra, mb_avail, mv4, nnz_luma, mb_qp,
                    mb_width, mb_height, chroma_qp_offset=0,
                    mb_slice=None, skip_slice_edges=False):
    """In-place deblock of a DecodedFrame after all MBs are decoded."""
    y, u, v = frame.y, frame.u, frame.v
    for r in range(mb_height):
        for c in range(mb_width):
            qp_cur = int(mb_qp[r, c])
            # ---- vertical edges (left to right) ----
            for e in range(4):
                x = 16 * c + 4 * e
                if e == 0 and c == 0:
                    continue
                if (e == 0 and skip_slice_edges and mb_slice is not None
                        and mb_slice[r, c - 1] != mb_slice[r, c]):
                    continue
                for g in range(4):
                    yseg = 16 * r + 4 * g
                    if e == 0:
                        intra_p = mb_intra[r, c - 1]
                        nnz_p = nnz_luma[4 * r + g, 4 * c - 1]
                        mv_p = mv4[4 * r + g, 4 * c - 1]
                        qp_p = int(mb_qp[r, c - 1])
                        mb_edge = True
                    else:
                        intra_p = mb_intra[r, c]
                        nnz_p = nnz_luma[4 * r + g, 4 * c + e - 1]
                        mv_p = mv4[4 * r + g, 4 * c + e - 1]
                        qp_p = qp_cur
                        mb_edge = False
                    bs = _bs_edge(intra_p, mb_intra[r, c], nnz_p,
                                  nnz_luma[4 * r + g, 4 * c + e],
                                  mv_p, mv4[4 * r + g, 4 * c + e], mb_edge)
                    qp_avg = (qp_p + qp_cur + 1) >> 1
                    _filter_luma_seg(y, yseg, x, True, bs, qp_avg)
                    if e in (0, 2):
                        qc_p = int(QPC_FROM_QPY[np.clip(qp_p + chroma_qp_offset, 0, 51)])
                        qc_q = int(QPC_FROM_QPY[np.clip(qp_cur + chroma_qp_offset, 0, 51)])
                        qpc_avg = (qc_p + qc_q + 1) >> 1
                        cx = 8 * c + 4 * (e // 2)
                        cy = 8 * r + 2 * g
                        _filter_chroma_seg(u, cy, cx, True, bs, qpc_avg)
                        _filter_chroma_seg(v, cy, cx, True, bs, qpc_avg)
            # ---- horizontal edges (top to bottom) ----
            for e in range(4):
                yy = 16 * r + 4 * e
                if e == 0 and r == 0:
                    continue
                if (e == 0 and skip_slice_edges and mb_slice is not None
                        and mb_slice[r - 1, c] != mb_slice[r, c]):
                    continue
                for g in range(4):
                    xseg = 16 * c + 4 * g
                    if e == 0:
                        intra_p = mb_intra[r - 1, c]
                        nnz_p = nnz_luma[4 * r - 1, 4 * c + g]
                        mv_p = mv4[4 * r - 1, 4 * c + g]
                        qp_p = int(mb_qp[r - 1, c])
                        mb_edge = True
                    else:
                        intra_p = mb_intra[r, c]
                        nnz_p = nnz_luma[4 * r + e - 1, 4 * c + g]
                        mv_p = mv4[4 * r + e - 1, 4 * c + g]
                        qp_p = qp_cur
                        mb_edge = False
                    bs = _bs_edge(intra_p, mb_intra[r, c], nnz_p,
                                  nnz_luma[4 * r + e, 4 * c + g],
                                  mv_p, mv4[4 * r + e, 4 * c + g], mb_edge)
                    qp_avg = (qp_p + qp_cur + 1) >> 1
                    _filter_luma_seg(y, yy, xseg, False, bs, qp_avg)
                    if e in (0, 2):
                        qc_p = int(QPC_FROM_QPY[np.clip(qp_p + chroma_qp_offset, 0, 51)])
                        qc_q = int(QPC_FROM_QPY[np.clip(qp_cur + chroma_qp_offset, 0, 51)])
                        qpc_avg = (qc_p + qc_q + 1) >> 1
                        cy = 8 * r + 4 * (e // 2)
                        cx = 8 * c + 2 * g
                        _filter_chroma_seg(u, cy, cx, False, bs, qpc_avg)
                        _filter_chroma_seg(v, cy, cx, False, bs, qpc_avg)
