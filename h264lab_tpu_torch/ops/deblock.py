"""In-loop deblocking filter (spec 8.7): boundary strength and the edge
filters, batched over macroblocks.

PyTorch counterpart of `h264lab_tpu/ops/deblock.py`. The edge filters
update their (k, rows, cols) int32 strip in place (the JAX module returns
a new array); `filter_*_h` filters a transposed view of the strip.

QP arguments are a 0-d int tensor or one QP per strip (k,).
"""

from __future__ import annotations

import functools

import torch

from h264lab_tpu_torch.ops import tables


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    return (torch.as_tensor(tables.ALPHA_TABLE, device=device),
            torch.as_tensor(tables.BETA_TABLE, device=device),
            torch.as_tensor(tables.TC0_TABLE, device=device))


def _thresholds(qp: torch.Tensor, bs: torch.Tensor):
    """(alpha, beta, tc0) for an edge; alpha/beta shaped to broadcast
    against per-row samples like `bs`, tc0 shaped like `bs`."""
    alpha_t, beta_t, tc0_t = _tables(bs.device)
    idx = torch.clamp(qp.long(), 0, 51)
    if idx.ndim:
        idx = idx.reshape(idx.shape + (1,) * (bs.ndim - 1))
    tc0 = tc0_t[idx, torch.clamp(bs.long() - 1, 0, 2)]
    return alpha_t[idx], beta_t[idx], tc0


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def mb_edge_bs(intra_p, intra_q, nnz_p, nnz_q, mv_py, mv_px, mv_qy, mv_qx,
               is_mb_edge: bool):
    """Boundary strength for one edge position (one reference picture)."""
    coeff = (nnz_p > 0) | (nnz_q > 0)
    mv_far = ((mv_py - mv_qy).abs() >= 4) | ((mv_px - mv_qx).abs() >= 4)
    return torch.where(intra_p | intra_q, 4 if is_mb_edge else 3,
                       torch.where(coeff, 2, torch.where(mv_far, 1, 0)))


def _filter_luma_cols(strip, x, bs_rows, alpha, beta, tc0_rows):
    """Filter the vertical luma edge at column x (last axis) in place."""
    p3, p2, p1, p0 = (strip[..., x - 4], strip[..., x - 3],
                      strip[..., x - 2], strip[..., x - 1])
    q0, q1, q2, q3 = (strip[..., x], strip[..., x + 1],
                      strip[..., x + 2], strip[..., x + 3])
    filt = ((bs_rows > 0) & ((p0 - q0).abs() < alpha)
            & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta

    # normal filter (bS 1..3)
    tc = tc0_rows + ap.to(torch.int32) + aq.to(torch.int32)
    delta = _clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = torch.clamp(p0 + delta, 0, 255)
    nq0 = torch.clamp(q0 - delta, 0, 255)
    avg = (p0 + q0 + 1) >> 1
    np1 = torch.where(ap, p1 + _clip((p2 + avg - 2 * p1) >> 1,
                                     -tc0_rows, tc0_rows), p1)
    nq1 = torch.where(aq, q1 + _clip((q2 + avg - 2 * q1) >> 1,
                                     -tc0_rows, tc0_rows), q1)

    # strong filter (bS 4)
    strong_ok = (p0 - q0).abs() < ((alpha >> 2) + 2)
    use_p = strong_ok & ap
    use_q = strong_ok & aq
    s_p0 = torch.where(use_p, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
    s_p1 = torch.where(use_p, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    s_p2 = torch.where(use_p, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    s_q0 = torch.where(use_q, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
    s_q1 = torch.where(use_q, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    s_q2 = torch.where(use_q, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs_rows == 4
    f4 = filt & is4
    fn = filt & ~is4
    new = (torch.where(f4, s_p2, p2),
           torch.where(fn, np1, torch.where(f4, s_p1, p1)),
           torch.where(filt, torch.where(is4, s_p0, np0), p0),
           torch.where(filt, torch.where(is4, s_q0, nq0), q0),
           torch.where(fn, nq1, torch.where(f4, s_q1, q1)),
           torch.where(f4, s_q2, q2))
    for i, col in enumerate(new):
        strip[..., x - 3 + i] = col
    return strip


def _filter_chroma_cols(strip, x, bs_rows, alpha, beta, tc0_rows):
    """Filter the vertical chroma edge at column x (last axis) in place."""
    p1, p0, q0, q1 = (strip[..., x - 2], strip[..., x - 1],
                      strip[..., x], strip[..., x + 1])
    filt = ((bs_rows > 0) & ((p0 - q0).abs() < alpha)
            & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    tc = tc0_rows + 1
    delta = _clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = torch.clamp(p0 + delta, 0, 255)
    nq0 = torch.clamp(q0 - delta, 0, 255)
    is4 = bs_rows == 4
    f_p0 = torch.where(filt, torch.where(is4, (2 * p1 + p0 + q1 + 2) >> 2,
                                         np0), p0)
    f_q0 = torch.where(filt, torch.where(is4, (2 * q1 + q0 + p1 + 2) >> 2,
                                         nq0), q0)
    strip[..., x - 1] = f_p0
    strip[..., x] = f_q0
    return strip


def filter_luma_v(strip, bs_edges, qp, edge_x0: int = 16):
    """Vertical edges of a (k, 16, W) int32 strip whose MB starts at
    column `edge_x0`; bs_edges (k, 4 edges, 4 row groups)."""
    qp = torch.as_tensor(qp, device=strip.device)
    for e in range(4):
        bs = bs_edges[:, e].repeat_interleave(4, dim=1)           # (k, 16)
        alpha, beta, tc0 = _thresholds(qp, bs)
        _filter_luma_cols(strip, edge_x0 + 4 * e, bs, alpha, beta, tc0)
    return strip


def filter_luma_h(strip, bs_edges, qp, edge_y0: int = 16):
    """Horizontal edges of a (k, H, 16) strip whose MB starts at row
    `edge_y0`: the vertical filter on the transposed view."""
    filter_luma_v(strip.transpose(1, 2), bs_edges, qp, edge_x0=edge_y0)
    return strip


def filter_chroma_v(strip, bs_edges, qpc, edge_x0: int = 8):
    """Vertical chroma edges (x = edge_x0, edge_x0 + 4, using luma edge
    groups 0 and 2) of a (k, ..., 8, W) strip; leading plane axes
    broadcast, so (k, 2, 8, W) filters u and v together."""
    qpc = torch.as_tensor(qpc, device=strip.device)
    extra = strip.ndim - 3
    for ci, e in enumerate((0, 2)):
        bs = bs_edges[:, e].repeat_interleave(2, dim=1)
        bs = bs.reshape(bs.shape[:1] + (1,) * extra + bs.shape[1:])
        alpha, beta, tc0 = _thresholds(qpc, bs)
        _filter_chroma_cols(strip, edge_x0 + 4 * ci, bs, alpha, beta, tc0)
    return strip


def filter_chroma_h(strip, bs_edges, qpc, edge_y0: int = 8):
    filter_chroma_v(strip.transpose(-1, -2), bs_edges, qpc, edge_x0=edge_y0)
    return strip
