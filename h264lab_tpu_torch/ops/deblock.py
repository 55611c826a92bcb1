"""In-loop deblocking filter (spec 8.7): boundary strength and the edge
filters, batched over macroblocks, and K2, the whole deblocking of a frame
batch (bS and the edge QPs included) as one CUDA kernel.

PyTorch counterpart of `h264lab_tpu/ops/deblock.py`. The edge filters
update their (k, rows, cols) int32 strip in place (the JAX module returns
a new array); `filter_*_h` filters a transposed view of the strip. They
are the plain version: `models/mbscan.deblock_frame_plain` runs them over
the slope-1 MB diagonals, and K2 (`deblock_tiles`, `csrc/deblock.cu`) is
held against it. `mb_edge_bs` and `edge_qps` serve the plain version; K2
derives bS and the edge QPs itself by the same rules.

QP arguments are a 0-d int tensor, one QP per strip (k,), or one QP per
strip and edge (k, 4) for luma, (k, 2) for chroma: with per-MB QPs
(`mb_qp_delta`) an MB edge takes the two MBs' average QP and the inner
edges the MB's own (spec 8.7.2.1; `edge_qps`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from h264lab_tpu_torch.ops import cuda_build, tables
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS  # noqa: F401


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
        alpha, beta, tc0 = _thresholds(qp[:, e] if qp.ndim == 2 else qp, bs)
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
        alpha, beta, tc0 = _thresholds(qpc[:, ci] if qpc.ndim == 2 else qpc,
                                       bs)
        _filter_chroma_cols(strip, edge_x0 + 4 * ci, bs, alpha, beta, tc0)
    return strip


def filter_chroma_h(strip, bs_edges, qpc, edge_y0: int = 8):
    filter_chroma_v(strip.transpose(-1, -2), bs_edges, qpc, edge_x0=edge_y0)
    return strip


def edge_qps(qp: torch.Tensor, qpc: torch.Tensor, n: int, mb_width: int,
             mb_height: int):
    """The QP of every MB edge of n frames or bands from per-frame (n,) or
    per-MB (n, nmb) int32 QPs: luma (n, nmb, 4) for the vertical and the
    horizontal edges, chroma (n, nmb, 2) for each, from `qpc`. An MB edge
    takes the rounded average of the MB's QP and its left or upper
    neighbour's (its own in column or row 0, where bS is 0), an inner edge
    the MB's own; per-frame QPs give every edge the frame's QP. Returns
    (qv, qh, qcv, qch)."""
    nmb = mb_width * mb_height

    def expand(q, n_edges):
        if q.ndim < 2:
            q = q.reshape(n, 1).expand(n, nmb)
        q2 = q.reshape(n, mb_height, mb_width)
        left = torch.cat([q2[:, :, :1], q2[:, :, :-1]], dim=2)
        top = torch.cat([q2[:, :1], q2[:, :-1]], dim=1)
        inner = q.reshape(n, nmb, 1).expand(n, nmb, n_edges - 1)
        return [torch.cat([((q2 + nb + 1) >> 1).reshape(n, nmb, 1), inner],
                          dim=2) for nb in (left, top)]

    return (*expand(qp, 4), *expand(qpc, 2))


# ---------------------------------------------------------------------------
# K2: the CUDA kernel, built with nvcc at first use and bound with ctypes
# ---------------------------------------------------------------------------

_SRC = cuda_build.CSRC / "deblock.cu"
_lib = cuda_build.Library(_SRC, {"h264lab_deblock": (
    [ctypes.c_void_p] * 18 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p], ctypes.c_int)})
# the tables K2 takes by value, host copies that live as long as the module
_HOST_TABLES = tuple(np.ascontiguousarray(t, dtype=np.uint8) for t in (
    tables.ALPHA_TABLE, tables.BETA_TABLE, tables.TC0_TABLE))
# K2 loads these in 16-byte chunks
_ALIGNED = ("recon_y", "recon_u", "recon_v", "nnz_blk", "mv4_y", "mv4_x")


def _k2_args(n: int, nmb: int, per_mb_qp: bool):
    """K2's tensor arguments in order: name, dtype, shape."""
    q = (n, nmb) if per_mb_qp else (n,)
    return (("recon_y", torch.uint8, (n, nmb, 16, 16)),
            ("recon_u", torch.uint8, (n, nmb, 8, 8)),
            ("recon_v", torch.uint8, (n, nmb, 8, 8)),
            ("sel", torch.int32, (n, nmb)),
            ("nnz_blk", torch.int32, (n, nmb, 4, 4)),
            ("mv4_y", torch.int32, (n, nmb, 4, 4)),
            ("mv4_x", torch.int32, (n, nmb, 4, 4)),
            ("qp", torch.int32, q), ("qpc", torch.int32, q),
            ("avail_top", torch.uint8, (nmb,)),
            ("avail_left", torch.uint8, (nmb,)))


def deblock_tiles(recon_y, recon_u, recon_v, sel, nnz_blk, mv4_y, mv4_x,
                  qp, qpc, avail_top, avail_left, mb_width: int,
                  mb_height: int):
    """K2: the whole deblocking of n frames or bands of MB tiles, bS and
    the edge QPs included, in one launch on the card. Takes what
    `mbscan.deblock_frame` takes, in the form `mbscan.deblock_tiles_args`
    packs: recon_y (n, nmb, 16, 16), recon_u and recon_v (n, nmb, 8, 8)
    uint8; sel (n, nmb), nnz_blk, mv4_y and mv4_x (n, nmb, 4, 4) int32; qp
    and qpc int32, both per frame (n,) or both per MB (n, nmb); avail_top
    and avail_left (nmb,) uint8; all contiguous on one CUDA device, the
    tiles and the blocks' arrays 16-byte aligned. Returns new (df_y, df_u,
    df_v) uint8 tiles; the inputs are left as they are. Raises on any
    other input: the plain version is `mbscan.deblock_frame_plain`."""
    args = (recon_y, recon_u, recon_v, sel, nnz_blk, mv4_y, mv4_x, qp, qpc,
            avail_top, avail_left)
    dev = recon_y.device
    if dev.type != "cuda" or any(x.device != dev for x in args):
        raise ValueError("deblock_tiles: K2 takes tensors on one CUDA "
                         f"device, not {[str(x.device) for x in args]}")
    n, nmb = recon_y.shape[0], mb_width * mb_height
    for x, (name, dtype, shape) in zip(args, _k2_args(n, nmb,
                                                       qp.ndim == 2)):
        if x.dtype != dtype:
            raise TypeError(f"deblock_tiles: {name} is {x.dtype}, not "
                            f"{dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"deblock_tiles: {name} of shape "
                             f"{tuple(x.shape)}, not {shape}")
        if not x.is_contiguous():
            raise ValueError(f"deblock_tiles: {name} is not contiguous")
        if name in _ALIGNED and x.data_ptr() % 16:
            raise ValueError(f"deblock_tiles: {name} is not 16-byte "
                             "aligned")
    with torch.cuda.device(dev):
        outs = [torch.empty_like(x) for x in args[:3]]
        if n == 0 or nmb == 0:
            return tuple(outs)
        # zeroed for the launch: the ticket (16 bytes), then a mailbox
        # entry of 16 8-byte units per MB of each MB row and plane group
        # (luma, chroma)
        sync = torch.zeros(4 + 2 * n * nmb * 32, dtype=torch.int32,
                           device=dev)
        cuda_build.check(_lib().h264lab_deblock(
            *(x.data_ptr() for x in args[:3]),
            *(o.data_ptr() for o in outs),
            *(x.data_ptr() for x in args[3:]), sync.data_ptr(),
            *(t.ctypes.data for t in _HOST_TABLES), n, mb_width, mb_height,
            int(qp.ndim == 2), torch.cuda.current_stream(dev).cuda_stream),
            "deblock")
        cuda_build.count_launch("deblock")
    return tuple(outs)
