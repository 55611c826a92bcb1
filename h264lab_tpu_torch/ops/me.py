"""Motion estimation of the P path: hierarchical dense search, batched
over the macroblocks of N frames (bands) at once, and the partition
search.

PyTorch counterpart of `h264lab_tpu/ops/me.py`: the same three-stage
funnel, the same costs and the same tie rules, so every MV and prediction
is identical.

1. coarse: dense full search on the 4x box pyramid, +-8 coarse px, one
   loop trip per dy with the 17 dx shifts batched (`coarse_search_4x`);
2. candidate centres (coarse winner, zero MV, the previous frame's MV) by
   full-resolution 16x16 SAD + lambda * mv bits, then a dense +-3 full-pel
   sweep of the winner's (34, 34) window;
3. sub-pel (speeds below 9): the window re-centred on the full-pel
   winner, 6-tap half-pel planes from it, the 16 quarter-pel phase planes,
   and a dense +-3 quarter-pel sweep with the early-skip bias. Speeds 9
   and 10 stop at the full-pel winner.

`partition_search` (speed 0) searches the 16x8, 8x16 and 8x8 partitions
of every MB from the same half-pel planes: per block a +-2 full-pel sweep
around the 16x16 winner, then one +-0.75 quarter-pel sweep of every block
of a geometry at once.

On the card the two searches are the hand kernels of `csrc/me.cu`: K4
(`motion_search_tiles`, the dense 16x16 search in one launch, a block per
tile of 2 x 8 MBs with its coarse halo) and K5 (`partition_tiles`). They
write the plain versions' arrays.
`motion_search_plain` and `partition_plain` are the plain functions with
the kernels' arguments: `models/mbscan.inter_stage_core` runs them on CPU
tensors, and the kernels are held against them.

Where the JAX package avoided TPU gathers (nine strided reshapes for the
zero-MV windows, shift-select chains for re-centring), the port reads each
per-MB window with one indexed gather (`qpel.windows`,
`qpel.shift_window`); the results are the same integers. Every sweep
updates on a strict `<`, so the first-visited best wins ties on both
sides, and `min(dim)` returns the first minimum, as `jnp.argmin` does.

The mode-decision lambda is a stored table: the JAX package computes it
as `max(sqrt(0.85 * 2^((qp - 12) / 3)), 1)` truncated to int in float32;
the port keeps the 52 integers that function returns, so no float
rounding can differ. The tests check the table against the JAX function.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from h264lab_tpu_torch.ops import cuda_build, qpel
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS  # noqa: F401
from h264lab_tpu_torch.ops.qpel import GUARD
from h264lab_tpu_torch.ops.tuning import (SKIP_BIAS_BITS, SKIP_THR_BASE,
                                          SKIP_THR_QP)

I32 = torch.int32

COARSE_R4 = 8        # coarse search radius in 4x-downsampled pixels (=32)
REFINE_R = 3         # full-pel refinement radius around the coarse winner
WIN_M = 9            # window margin each side of the candidate centre
WIN_S = 16 + 2 * WIN_M          # = 34: window side
ALN_S = 27           # aligned window side: winner-5 .. winner+21
SUB = 22             # aligned qpel plane side: winner-3 .. winner+18
MAX_CAND_FP = GUARD - WIN_M - 3   # full-pel candidate-centre clip (52)

LAMBDA_ME = np.array([
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2,
    2, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20,
    23, 26, 29, 33, 37, 41, 46, 52, 59, 66, 74, 83], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _lut(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(LAMBDA_ME, device=device)


def lambda_me(qp: torch.Tensor) -> torch.Tensor:
    """Integer mode-decision lambda for int QP tensors in [0, 51]."""
    return _lut(qp.device)[qp.long()]


def bitlen32(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative ints < 2^32 (the JAX `32 - clz`), by
    binary search in exact integer arithmetic."""
    x = x.long()
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hi = x >> s
        big = hi > 0
        x = torch.where(big, hi, x)
        n = n + big.long() * s
    return (n + (x > 0).long()).to(I32)


def mv_bits(v: torch.Tensor) -> torch.Tensor:
    """Exp-Golomb bit count of se(v) (an MV component in quarter-pel)."""
    code = torch.where(v > 0, 2 * v - 1, -2 * v) + 1
    return 2 * bitlen32(torch.clamp(code, min=1)) - 1


def downsample4(plane: torch.Tensor) -> torch.Tensor:
    """4x box downsample (..., h, w) uint8 -> uint8, `(sum + 8) >> 4`."""
    h, w = plane.shape[-2:]
    x = plane[..., :h - h % 4, :w - w % 4].to(I32)
    x = x.reshape(x.shape[:-2] + (h // 4, 4, w // 4, 4)).sum((-3, -1),
                                                            dtype=I32)
    return ((x + 8) >> 4).to(torch.uint8)


def coarse_search_4x(cur4, ref4_pad, lane, lam, mb_height: int,
                     mb_width: int, row_offset, mvp_y, mvp_x,
                     radius: int = COARSE_R4):
    """Dense full search on the 4x pyramid.

    cur4 (N, mbh*4, mbw*4) band planes; ref4_pad (L, ., .) lane-batched
    full-frame 4x planes with a GUARD//4 guard; lane, lam, row_offset
    (N,); mvp_y/mvp_x (N, nmb) quarter-pel predictors. The dx axis is a
    batch axis and the loop runs over dy; a later dy must be strictly
    cheaper. Returns per-MB coarse-pixel (dy4, dx4), each (N, nmb) int32."""
    n = cur4.shape[0]
    g4 = GUARD // 4
    h4, w4 = mb_height * 4, mb_width * 4
    side = 2 * radius + 1
    dev = cur4.device
    cur = cur4.to(I32)[:, None]
    mvp_y2 = mvp_y.reshape(n, 1, mb_height, mb_width)
    mvp_x2 = mvp_x.reshape(n, 1, mb_height, mb_width)
    lam4 = lam.reshape(n, 1, 1, 1)
    dx_all = torch.arange(-radius, radius + 1, dtype=I32,
                          device=dev).reshape(1, side, 1, 1)
    dx_bits = lam4 * mv_bits(dx_all * 16 - mvp_x2)         # (N, side, ., .)
    shape = (n, mb_height, mb_width)
    best = torch.full(shape, 1 << 30, dtype=I32, device=dev)
    best_dy = torch.zeros(shape, dtype=I32, device=dev)
    best_dx = torch.zeros(shape, dtype=I32, device=dev)
    oy0 = g4 + row_offset.long() * 4
    ox = torch.full_like(oy0, g4 - radius)
    for i in range(side):
        dy = i - radius
        row = qpel.windows(ref4_pad, lane, oy0 + dy, ox, h4, w4 + 2 * radius)
        subs = row.unfold(2, w4, 1).permute(0, 2, 1, 3).to(I32)
        sad = (cur - subs).abs().reshape(
            n, side, mb_height, 4, mb_width, 4).sum((3, 5), dtype=I32)
        cost = sad * 16 + lam4 * mv_bits(dy * 16 - mvp_y2) + dx_bits
        cmin, k = cost.min(dim=1)
        upd = cmin < best
        best = torch.where(upd, cmin, best)
        best_dy = torch.where(upd, dy, best_dy)
        best_dx = torch.where(upd, k.to(I32) - radius, best_dx)
    return best_dy.reshape(n, -1), best_dx.reshape(n, -1)


def median3(a, b, c):
    """Elementwise median of three int tensors."""
    return torch.maximum(torch.minimum(torch.maximum(a, b), c),
                         torch.minimum(a, b))


def spatial_predictor(dy, dx, mb_height: int, mb_width: int):
    """Quarter-pel MV predictor per MB from the dense coarse field (N, nmb):
    the median of the left, top and top-right coarse winners within the
    band; top-right falls back to top-left on the last column, and row 0
    takes the left neighbour alone. Returns (mvp_y, mvp_x), (N, nmb)."""
    pad = torch.nn.functional.pad

    def shifts(q):
        q = q.reshape(-1, mb_height, mb_width)
        a = pad(q, (1, 0))[..., :-1]                       # left
        b = pad(q, (0, 0, 1, 0))[..., :-1, :]              # top
        c = pad(q, (0, 1, 1, 0))[..., :-1, 1:]             # top-right
        d = pad(q, (1, 0, 1, 1))[..., :-2, :-1]            # top-left
        c[..., -1] = d[..., -1]
        med = median3(a, b, c)
        med[:, 0, :] = a[:, 0, :]
        return med.reshape(q.shape[0], -1)
    return shifts(dy * 16), shifts(dx * 16)


def _hpel_from_window(win):
    """6-tap half-pel values of aligned (K, 27, 27) int32 windows (spec
    8.4.2.2.1). With the winner at coord 5, returns the (F, B, H, J)
    planes, (K, 22, 22) each, aligned on coord i == full-pel i + 2."""
    def f6_h(x):
        return (x[..., :, 0:-5] - 5 * x[..., :, 1:-4] + 20 * x[..., :, 2:-3]
                + 20 * x[..., :, 3:-2] - 5 * x[..., :, 4:-1] + x[..., :, 5:])

    def f6_v(x):
        return (x[..., 0:-5, :] - 5 * x[..., 1:-4, :] + 20 * x[..., 2:-3, :]
                + 20 * x[..., 3:-2, :] - 5 * x[..., 4:-1, :] + x[..., 5:, :])

    f = win[:, 2:24, 2:24]
    b = torch.clamp((f6_h(win) + 16) >> 5, 0, 255)[:, 2:24, :]
    h_raw = f6_v(win)                                       # (K, 22, 27)
    h = torch.clamp((h_raw + 16) >> 5, 0, 255)[:, :, 2:24]
    j = torch.clamp((f6_h(h_raw) + 512) >> 10, 0, 255)
    return f, b, h, j


def _phase_planes(wins):
    """The 16 quarter-pel phase planes of the (F, B, H, J) planes as one
    (4, 4, K, S, S) uint8 stack: stack[fy, fx][., y, x] is the sample at
    (4y + fy, 4x + fx) from the planes' full-pel origin (spec Figure 8-4).
    Each plane becomes uint8 before the stack."""
    sy, sx = wins[0].shape[1:]

    def pad(w):                          # one edge row and column
        w = torch.cat([w, w[:, -1:]], dim=1)
        return torch.cat([w, w[:, :, -1:]], dim=2)

    f, b, h, j = (pad(w) for w in wins)

    def avg(p, q):
        return (p + q + 1) >> 1

    def s(w, ey=0, ex=0):
        return w[:, ey:ey + sy, ex:ex + sx]

    # keyed (fx, fy), as the JAX table
    tab = {
        (0, 0): lambda: s(f),
        (1, 0): lambda: avg(s(f), s(b)),
        (2, 0): lambda: s(b),
        (3, 0): lambda: avg(s(b), s(f, 0, 1)),
        (0, 1): lambda: avg(s(f), s(h)),
        (1, 1): lambda: avg(s(b), s(h)),
        (2, 1): lambda: avg(s(b), s(j)),
        (3, 1): lambda: avg(s(b), s(h, 0, 1)),
        (0, 2): lambda: s(h),
        (1, 2): lambda: avg(s(h), s(j)),
        (2, 2): lambda: s(j),
        (3, 2): lambda: avg(s(j), s(h, 0, 1)),
        (0, 3): lambda: avg(s(h), s(f, 1, 0)),
        (1, 3): lambda: avg(s(h), s(b, 1, 0)),
        (2, 3): lambda: avg(s(j), s(b, 1, 0)),
        (3, 3): lambda: avg(s(h, 0, 1), s(b, 1, 0)),
    }
    return torch.stack([torch.stack([tab[(fx, fy)]().to(torch.uint8)
                                     for fx in range(4)])
                        for fy in range(4)])


def _sweep_fullpel(cur_i, win, base_y: int, base_x: int, radius: int,
                   cost_fn):
    """Dense (2r+1)^2 full-pel SAD sweep over per-MB windows (K, S, S):
    the block at (base_y + dy, base_x + dx). cost_fn(sad, dy, dx) -> cost.
    Returns (cost, dy, dx), the best per MB."""
    k, bh, bw = cur_i.shape
    dev = cur_i.device
    best = torch.full((k,), 1 << 30, dtype=I32, device=dev)
    bdy = torch.zeros((k,), dtype=I32, device=dev)
    bdx = torch.zeros((k,), dtype=I32, device=dev)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            blk = win[:, base_y + dy:base_y + dy + bh,
                      base_x + dx:base_x + dx + bw]
            sad = (cur_i - blk.to(I32)).abs().sum((1, 2), dtype=I32)
            cost = cost_fn(sad, dy, dx)
            upd = cost < best
            best = torch.where(upd, cost, best)
            bdy = torch.where(upd, dy, bdy)
            bdx = torch.where(upd, dx, bdx)
    return best, bdy, bdx


def _sweep_qpel(cur_i, phases, center: int, cost_fn, radius: int = 3):
    """Dense (2r+1)^2 quarter-pel sweep over the (4, 4, K, S, S) phase
    stack, the full-pel winner at plane coord `center`. cost_fn(sad, dyq,
    dxq) -> cost. Returns (cost, dyq, dxq, pred (K, bh, bw) int32)."""
    k, bh, bw = cur_i.shape
    dev = cur_i.device
    best = torch.full((k,), 1 << 30, dtype=I32, device=dev)
    byq = torch.zeros((k,), dtype=I32, device=dev)
    bxq = torch.zeros((k,), dtype=I32, device=dev)
    bpred = torch.zeros((k, bh, bw), dtype=I32, device=dev)
    for dyq in range(-radius, radius + 1):
        for dxq in range(-radius, radius + 1):
            oy = center + (dyq >> 2)
            ox = center + (dxq >> 2)
            pred = phases[dyq & 3, dxq & 3, :, oy:oy + bh,
                          ox:ox + bw].to(I32)
            sad = (cur_i - pred).abs().sum((1, 2), dtype=I32)
            cost = cost_fn(sad, dyq, dxq)
            upd = cost < best
            best = torch.where(upd, cost, best)
            byq = torch.where(upd, dyq, byq)
            bxq = torch.where(upd, dxq, bxq)
            bpred = torch.where(upd[:, None, None], pred, bpred)
    return best, byq, bxq, bpred


def motion_search_dense(cur_plane, cur_tiles, ref_pad, ref4_pad, lane,
                        base_y, base_x, qp, mb_height: int, mb_width: int,
                        row_offset, prev_my=None, prev_mx=None,
                        enable_subpel: bool = True):
    """Hierarchical dense ME (module docstring), for N frames or bands at
    once, with the quarter-pel stage when `enable_subpel`.

    cur_plane (N, mbh*16, mbw*16) and cur_tiles (N, nmb, 16, 16) uint8;
    ref_pad/ref4_pad (L, ., .) lane-batched guard-padded luma and 4x
    planes; lane, qp, row_offset (N,): each frame's reference lane, QP and
    MB-row offset in the lane's frame; base_y/base_x (N, nmb) MB origins in
    padded coordinates; prev_my/prev_mx (N, nmb) full-pel previous-frame
    MVs (a third candidate centre, clipped to +-MAX_CAND_FP) or None.

    Returns (mv_y, mv_x, cost, pred, aux): quarter-pel MVs and costs (N,
    nmb), pred (N, nmb, 16, 16) uint8, aux = dict(cy4, cx4, full_my,
    full_mx, mvp_y, mvp_x), each (N, nmb), and `wins`: the (F, B, H, J)
    half-pel planes around the full-pel winner (`_hpel_from_window`, each
    (N * nmb, 22, 22) int32) that the partition search reads, or None
    without the sub-pel stage. Without it the MVs are the full-pel winner
    times 4 and the prediction is the window at the winner."""
    n = cur_plane.shape[0]
    nmb = mb_height * mb_width
    dev = cur_plane.device
    kk = n * nmb
    lam = lambda_me(qp)
    zero_n = torch.zeros((n, nmb), dtype=I32, device=dev)
    cy4, cx4 = coarse_search_4x(downsample4(cur_plane), ref4_pad, lane, lam,
                                mb_height, mb_width, row_offset,
                                zero_n, zero_n)
    mvp_y, mvp_x = spatial_predictor(cy4, cx4, mb_height, mb_width)

    # everything below is per MB: the K = N * nmb MBs of all frames
    def flat(x):
        return x.reshape(kk)
    lam_k = lam.repeat_interleave(nmb)
    lane_k = lane.long().repeat_interleave(nmb)
    by, bx = flat(base_y), flat(base_x)
    pvy, pvx = flat(mvp_y), flat(mvp_x)
    cur_i = cur_tiles.reshape(kk, 16, 16).to(I32)

    def centre_cost(win, cy, cx):
        blk = win[:, WIN_M:WIN_M + 16, WIN_M:WIN_M + 16].to(I32)
        return ((cur_i - blk).abs().sum((1, 2), dtype=I32)
                + lam_k * (mv_bits(cy * 4 - pvy) + mv_bits(cx * 4 - pvx)))

    # candidate centres: zero MV first, then the coarse winner and the
    # previous frame's MV, each replacing the best on a strictly lower cost
    win = qpel.windows(ref_pad, lane_k, by - WIN_M, bx - WIN_M, WIN_S, WIN_S)
    zero = torch.zeros((kk,), dtype=I32, device=dev)
    best_ccost = centre_cost(win, zero, zero)
    cm_y, cm_x = zero, zero
    cands = [(4 * flat(cy4), 4 * flat(cx4))]
    if prev_my is not None:
        cands.append((flat(prev_my).clamp(-MAX_CAND_FP, MAX_CAND_FP),
                      flat(prev_mx).clamp(-MAX_CAND_FP, MAX_CAND_FP)))
    for cy, cx in cands:
        win_c = qpel.windows(ref_pad, lane_k, by + cy - WIN_M,
                             bx + cx - WIN_M, WIN_S, WIN_S)
        cost = centre_cost(win_c, cy, cx)
        upd = cost < best_ccost
        best_ccost = torch.where(upd, cost, best_ccost)
        cm_y = torch.where(upd, cy, cm_y)
        cm_x = torch.where(upd, cx, cm_x)
        win = torch.where(upd[:, None, None], win_c, win)

    def refine_cost(sad, dy, dx):
        return sad + lam_k * (mv_bits((cm_y + dy) * 4 - pvy)
                              + mv_bits((cm_x + dx) * 4 - pvx))

    full_cost, best_dy, best_dx = _sweep_fullpel(cur_i, win, WIN_M, WIN_M,
                                                 REFINE_R, refine_cost)
    full_my = cm_y + best_dy
    full_mx = cm_x + best_dx

    # re-centre the window on the refined winner: a[p] = win[winner-5+p]
    a = qpel.shift_window(win, best_dy, WIN_M - 5, ALN_S, 1)
    a = qpel.shift_window(a, best_dx, WIN_M - 5, ALN_S, 2).to(I32)

    def frames(x):
        return x.reshape((n, nmb) + x.shape[1:])
    aux = dict(cy4=cy4, cx4=cx4, full_my=frames(full_my),
               full_mx=frames(full_mx), mvp_y=mvp_y, mvp_x=mvp_x, wins=None)
    if not enable_subpel:
        return (frames(full_my * 4), frames(full_mx * 4), frames(full_cost),
                frames(a[:, 5:21, 5:21].to(torch.uint8)), aux)

    aux["wins"] = wins = _hpel_from_window(a)
    phases = _phase_planes(wins)
    skip_thr = SKIP_THR_BASE + qp.to(I32).repeat_interleave(nmb) * SKIP_THR_QP

    def qpel_cost(sad, dyq, dxq):
        mvy = full_my * 4 + dyq
        mvx = full_mx * 4 + dxq
        cost = sad + lam_k * (mv_bits(mvy - pvy) + mv_bits(mvx - pvx))
        # early-skip bias: the predictor position with a SAD under the
        # skip threshold gets a bits bonus
        at_pred = (mvy == pvy) & (mvx == pvx) & (sad < skip_thr)
        return torch.where(at_pred, cost - lam_k * SKIP_BIAS_BITS, cost)

    best_cost, dyq, dxq, pred = _sweep_qpel(cur_i, phases, 3, qpel_cost)
    return (frames(full_my * 4 + dyq), frames(full_mx * 4 + dxq),
            frames(best_cost), frames(pred.to(torch.uint8)), aux)


# ---------------------------------------------------------------------------
# partition search (16x8, 8x16, 8x8) from the 16x16 search's planes
# ---------------------------------------------------------------------------

def _search_geometry(cur_tiles, wins, lam, offsets, bh: int, bw: int,
                     full_my, full_mx, mvp_y, mvp_x):
    """Search every block of one partition geometry. cur_tiles (K, 16, 16)
    int32; wins: the (F, B, H, J) planes, (K, 22, 22) with the 16x16
    winner at coord 3; lam, full_m*, mvp_* (K,); offsets: the blocks'
    (y, x) in the MB. Per block a +-2 full-pel sweep around the 16x16
    winner, the (bh + 2, bw + 2) planes re-centred on the block's winner,
    then one +-0.75 quarter-pel sweep over all blocks (phase planes with
    the winner at coord 1). Returns (cost, mv_y, mv_x, pred), each with a
    leading (n_blocks, K)."""
    k = cur_tiles.shape[0]
    nb = len(offsets)
    subs = [[], [], [], []]
    curs, blk_my, blk_mx = [], [], []

    def part_cost(sad, dy, dx):
        return sad + lam * (mv_bits((full_my + dy) * 4 - mvp_y)
                            + mv_bits((full_mx + dx) * 4 - mvp_x))

    for oy0, ox0 in offsets:
        cur_i = cur_tiles[:, oy0:oy0 + bh, ox0:ox0 + bw]
        curs.append(cur_i)
        _, bdy, bdx = _sweep_fullpel(cur_i, wins[0], 3 + oy0, 3 + ox0, 2,
                                     part_cost)
        blk_my.append(full_my + bdy)
        blk_mx.append(full_mx + bdx)
        for i, w in enumerate(wins):
            t = qpel.shift_window(w, bdy, 3 + oy0 - 1, bh + 2, 1)
            subs[i].append(qpel.shift_window(t, bdx, 3 + ox0 - 1, bw + 2, 2))

    bmy, bmx = torch.cat(blk_my), torch.cat(blk_mx)
    lam_b, mvpy, mvpx = lam.repeat(nb), mvp_y.repeat(nb), mvp_x.repeat(nb)

    def qcost(sad, dyq, dxq):
        return sad + lam_b * (mv_bits(bmy * 4 + dyq - mvpy)
                              + mv_bits(bmx * 4 + dxq - mvpx))

    cost, dyq, dxq, pred = _sweep_qpel(
        torch.cat(curs), _phase_planes([torch.cat(s) for s in subs]), 1,
        qcost)
    return (cost.reshape(nb, k), (bmy * 4 + dyq).reshape(nb, k),
            (bmx * 4 + dxq).reshape(nb, k), pred.reshape(nb, k, bh, bw))


def partition_search(cur_tiles, aux, lam):
    """Quarter-pel search of the 16x8, 8x16 and 8x8 partitions of K MBs.
    cur_tiles (K, 16, 16) uint8; aux: `motion_search_dense`'s, flattened
    to K MBs (`wins`, `full_my`, `full_mx`, `mvp_y`, `mvp_x`); lam (K,)
    the ME lambda. MV costs count against the 16x16 search's predictor.

    Returns dict: mv16x8 (top, bottom) and mv8x16 (left, right) (K, 2, 2)
    and mv8x8 (raster quadrants) (K, 4, 2), the last axis (y, x) in
    quarter-pel; cost16x8 / cost8x16 / cost8x8 (K,), the sums over the
    blocks; pred16x8 / pred8x16 / pred8x8 (K, 16, 16) int32."""
    cur = cur_tiles.to(I32)
    args = (aux["full_my"], aux["full_mx"], aux["mvp_y"], aux["mvp_x"])
    out = {}
    for name, offsets, bh, bw in (
            ("16x8", [(0, 0), (8, 0)], 8, 16),
            ("8x16", [(0, 0), (0, 8)], 16, 8),
            ("8x8", [(0, 0), (0, 8), (8, 0), (8, 8)], 8, 8)):
        c, my, mx, pr = _search_geometry(cur, aux["wins"], lam, offsets, bh,
                                         bw, *args)
        out[f"mv{name}"] = torch.stack([my, mx], dim=-1).permute(1, 0, 2)
        out[f"cost{name}"] = c.sum(0)
        pred = torch.zeros((cur.shape[0], 16, 16), dtype=I32,
                           device=cur.device)
        for (oy0, ox0), p in zip(offsets, pr):
            pred[:, oy0:oy0 + bh, ox0:ox0 + bw] = p
        out[f"pred{name}"] = pred
    return out


def motion_search_plain(y_pad, y4_pad, cur_tiles, lane, row_offset, qp,
                        prev_my, prev_mx, mb_width: int, mb_height: int,
                        enable_subpel: bool = True, planes: bool = False):
    """`motion_search_dense` with K4's arguments and outputs
    (`motion_search_tiles`): the MB origins from the row offsets, and with
    `planes` the (F, B, H, J) planes as one (N * nmb, 4, 22, 22) uint8
    tensor in aux["wins"] (else None). The CPU path of
    `mbscan.inter_stage_core` and the version K4 is held against."""
    n, nmb = cur_tiles.shape[:2]
    idx = torch.arange(nmb, dtype=I32, device=cur_tiles.device)
    base_y = GUARD + 16 * (idx // mb_width + row_offset[:, None])
    base_x = (GUARD + 16 * (idx % mb_width)).expand(n, nmb)
    plane = (cur_tiles.reshape(n, mb_height, mb_width, 16, 16)
             .permute(0, 1, 3, 2, 4).reshape(n, 16 * mb_height, 16 * mb_width))
    *out, aux = motion_search_dense(
        plane, cur_tiles, y_pad, y4_pad, lane, base_y, base_x, qp, mb_height,
        mb_width, row_offset, prev_my, prev_mx, enable_subpel=enable_subpel)
    aux["wins"] = (torch.stack(aux["wins"], 1).to(torch.uint8) if planes
                   else None)
    return (*out, aux)


def partition_plain(cur_tiles, planes, full_my, full_mx, mvp_y, mvp_x, lam):
    """`partition_search` with K5's arguments (`partition_tiles`): the
    planes as K4's (K, 4, 22, 22) uint8 tensor. The CPU path of
    `mbscan.inter_stage_core` and the version K5 is held against."""
    return partition_search(cur_tiles, dict(
        wins=[planes[:, i].to(I32) for i in range(4)], full_my=full_my,
        full_mx=full_mx, mvp_y=mvp_y, mvp_x=mvp_x), lam)


# ---------------------------------------------------------------------------
# K4 and K5: the searches as hand kernels on the card (csrc/me.cu)
# ---------------------------------------------------------------------------

_SRC = cuda_build.CSRC / "me.cu"
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_lib = cuda_build.Library(_SRC, {
    "h264lab_me": ([_VP] * 20 + [ctypes.c_longlong] + [_CI] * 10 + [_VP],
                   _CI),
    "h264lab_partition": ([_VP] * 16 + [ctypes.c_longlong, _VP], _CI),
    "h264lab_me_occupancy": ([_VP], _CI),
    "h264lab_partition_occupancy": ([_VP], _CI)})
# K4's int32 outputs, (N, nmb) each, in the order of its C entry point
K4_FIELDS = ("cy4", "cx4", "mvp_y", "mvp_x", "full_my", "full_mx", "mv_y",
             "mv_x", "cost")
# K5's outputs: name, dtype, trailing shape, in the order of its entry point
K5_OUTPUTS = (("mv16x8", torch.int32, (2, 2)), ("mv8x16", torch.int32, (2, 2)),
              ("mv8x8", torch.int32, (4, 2)), ("cost16x8", torch.int64, ()),
              ("cost8x16", torch.int64, ()), ("cost8x8", torch.int64, ()),
              ("pred16x8", torch.int32, (16, 16)),
              ("pred8x16", torch.int32, (16, 16)),
              ("pred8x8", torch.int32, (16, 16)))
# K5's int32 outputs with the strides of a contiguous (K,) + shape view
# (the first: its elements per MB), and its int64 outputs
_K5_I32 = tuple((name, shape, tuple(math.prod(shape[j:])
                                    for j in range(len(shape) + 1)))
                for name, dtype, shape in K5_OUTPUTS if dtype == torch.int32)
_K5_I32_PER_MB = sum(strides[0] for _, _, strides in _K5_I32)
_K5_I64 = tuple(name for name, dtype, _ in K5_OUTPUTS if dtype == torch.int64)


@functools.lru_cache(maxsize=None)
def _launch_shape(device: torch.device, entry: str, n: int) -> tuple:
    """The n ints that a kernel's launch-shape entry point of the library
    reports on the CUDA `device`."""
    out = (ctypes.c_int * n)()
    with torch.cuda.device(device):
        cuda_build.check(getattr(_lib(), entry)(out), entry)
    return tuple(out)


def occupancy(device: torch.device) -> dict:
    """K4's launch shape on the CUDA `device`: threads a block, dynamic
    shared memory bytes a block, resident blocks an SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) and the tile's MB
    rows and columns (a block's MBs)."""
    threads, smem, blocks, rows, cols = _launch_shape(
        device, "h264lab_me_occupancy", 5)
    return dict(threads=threads, smem_bytes=smem, blocks_per_sm=blocks,
                tile=(rows, cols))


def partition_occupancy(device: torch.device) -> dict:
    """K5's launch shape on the CUDA `device`: threads a block, static
    shared memory bytes a block, resident blocks an SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) and warps a block
    (an MB each)."""
    threads, smem, blocks, warps = _launch_shape(
        device, "h264lab_partition_occupancy", 4)
    return dict(threads=threads, smem_bytes=smem, blocks_per_sm=blocks,
                warps=warps)


def _check(name, x, dtype, shape, dev, aligned=False):
    """Raise unless `x` is a contiguous `dtype` tensor of `shape` (None:
    any 3-D shape) on `dev`, 16-byte aligned if asked."""
    if not isinstance(x, torch.Tensor) or x.device != dev:
        raise ValueError(f"{name}: the kernels take tensors on one CUDA "
                         f"device ({dev}), not "
                         f"{getattr(x, 'device', type(x).__name__)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} is {x.dtype}, not {dtype}")
    if (x.ndim != 3) if shape is None else (tuple(x.shape) != shape):
        raise ValueError(f"{name} of shape {tuple(x.shape)}, not "
                         f"{shape or '3-D'}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if aligned and x.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def motion_search_tiles(y_pad, y4_pad, cur_tiles, lane, row_offset, qp,
                        prev_my, prev_mx, mb_width: int, mb_height: int,
                        enable_subpel: bool = True, planes: bool = False):
    """K4: `motion_search_dense` of N frames or bands on the card, one
    launch of `csrc/me.cu` (a block per tile of MBs of a frame: the coarse
    search of its MBs and of the neighbours their predictors read, then
    the rest from the tile's reference strip in shared memory); the ME
    lambda comes from the stored table by QP.

    y_pad (L, H + 2 GUARD, W + 2 GUARD) and y4_pad (L, ., .) uint8: the
    lanes' guard-padded luma and 4x planes (`refstate.prepare_reference`);
    cur_tiles (N, nmb, 16, 16) uint8, 16-byte aligned; lane, row_offset,
    qp (N,) int32: each frame's reference lane, first MB row in the lane's
    frame and first-row QP; prev_my/prev_mx (N, nmb) int32 full-pel
    previous MVs or both None; all contiguous on one CUDA device. The MB
    origins are GUARD + 16 (row + row_offset), GUARD + 16 col, as
    `inter_stage_core` builds them for the plain version.

    Returns `motion_search_dense`'s (mv_y, mv_x, cost, pred, aux), equal
    array for array; aux["wins"] is None unless `planes` (with
    `enable_subpel`): then the (F, B, H, J) planes as one (N * nmb, 4,
    22, 22) uint8 tensor, which K5 reads. Raises on any other input."""
    dev = cur_tiles.device
    if dev.type != "cuda":
        raise ValueError("motion_search_tiles: K4 takes tensors on one CUDA "
                         f"device, not {dev}")
    if planes and not enable_subpel:
        raise ValueError("motion_search_tiles: the planes need the sub-pel "
                         "stage")
    n, nmb = cur_tiles.shape[:2]
    if mb_width <= 0 or mb_height <= 0 or nmb != mb_width * mb_height:
        raise ValueError(f"motion_search_tiles: {nmb} MBs are not "
                         f"{mb_width} x {mb_height}")
    _check("y_pad", y_pad, torch.uint8, None, dev)
    _check("y4_pad", y4_pad, torch.uint8, None, dev)
    if y4_pad.shape[0] != y_pad.shape[0]:
        raise ValueError("motion_search_tiles: y_pad and y4_pad hold "
                         f"{y_pad.shape[0]} and {y4_pad.shape[0]} lanes")
    _check("cur_tiles", cur_tiles, torch.uint8, (n, nmb, 16, 16), dev, True)
    for name, x in (("lane", lane), ("row_offset", row_offset), ("qp", qp)):
        _check(name, x, torch.int32, (n,), dev)
    if (prev_my is None) != (prev_mx is None):
        raise ValueError("motion_search_tiles: prev_my and prev_mx go "
                         "together")
    if prev_my is not None:
        for name, x in (("prev_my", prev_my), ("prev_mx", prev_mx)):
            _check(name, x, torch.int32, (n, nmb), dev)
    with torch.cuda.device(dev):
        fields = torch.empty((len(K4_FIELDS), n, nmb), dtype=torch.int32,
                             device=dev)
        out = dict(zip(K4_FIELDS, fields.unbind(0)))
        pred = torch.empty((n, nmb, 16, 16), dtype=torch.uint8, device=dev)
        wins = (torch.empty((n * nmb, 4, SUB, SUB), dtype=torch.uint8,
                            device=dev) if planes else None)
        if n and nmb:
            cuda_build.check(_lib().h264lab_me(
                y_pad.data_ptr(), y4_pad.data_ptr(), cur_tiles.data_ptr(),
                lane.data_ptr(), row_offset.data_ptr(), qp.data_ptr(),
                _lut(dev).data_ptr(),
                None if prev_my is None else prev_my.data_ptr(),
                None if prev_mx is None else prev_mx.data_ptr(),
                *(out[k].data_ptr() for k in K4_FIELDS), pred.data_ptr(),
                None if wins is None else wins.data_ptr(), n, mb_width,
                mb_height, *y_pad.shape[1:], *y4_pad.shape[1:],
                int(enable_subpel), SKIP_THR_BASE, SKIP_THR_QP,
                SKIP_BIAS_BITS, torch.cuda.current_stream(dev).cuda_stream),
                "motion search")
            cuda_build.count_launch("me")
    aux = {k: out[k] for k in ("cy4", "cx4", "full_my", "full_mx", "mvp_y",
                               "mvp_x")}
    aux["wins"] = wins
    return out["mv_y"], out["mv_x"], out["cost"], pred, aux


def partition_tiles(cur_tiles, planes, full_my, full_mx, mvp_y, mvp_x, lam):
    """K5: `partition_search` of K MBs on the card, one launch of
    `csrc/me.cu` (a warp per MB: one full-pel pass shared by the three
    geometries, then a quarter-pel pass per geometry over all its blocks).
    cur_tiles (K, 16, 16) uint8 and planes, K4's (K, 4, 22, 22) uint8 (F,
    B, H, J) planes, each 16-byte aligned; full_my, full_mx, mvp_y, mvp_x:
    K4's aux fields flattened to (K,); lam (K,) the ME lambda; int32 and
    contiguous on one CUDA device. Returns `partition_search`'s dict, equal
    array for array (the cost sums int64, the predictions int32), as views
    of one int32 and one int64 buffer. Raises on any other input."""
    dev = cur_tiles.device
    if dev.type != "cuda":
        raise ValueError("partition_tiles: K5 takes tensors on one CUDA "
                         f"device, not {dev}")
    k = cur_tiles.shape[0]
    _check("cur_tiles", cur_tiles, torch.uint8, (k, 16, 16), dev, True)
    _check("planes", planes, torch.uint8, (k, 4, SUB, SUB), dev, True)
    args = (full_my, full_mx, mvp_y, mvp_x, lam)
    for name, x in zip(("full_my", "full_mx", "mvp_y", "mvp_x", "lam"), args):
        _check(name, x, torch.int32, (k,), dev)
    with torch.cuda.device(dev):
        out = _k5_buffers(k, dev)
        if k:
            cuda_build.check(_lib().h264lab_partition(
                cur_tiles.data_ptr(), planes.data_ptr(),
                *(x.data_ptr() for x in args),
                *(out[name].data_ptr() for name, _, _ in K5_OUTPUTS), k,
                torch.cuda.current_stream(dev).cuda_stream),
                "partition search")
            cuda_build.count_launch("partition")
    return out


def _k5_buffers(k: int, dev) -> dict:
    """K5's outputs for K MBs (`K5_OUTPUTS`) as contiguous views of one
    int32 buffer (the MVs, then the predictions, which start 16-byte
    aligned) and one int64 buffer (the cost sums)."""
    i32 = torch.empty(k * _K5_I32_PER_MB, dtype=torch.int32, device=dev)
    i64 = torch.empty((len(_K5_I64), k), dtype=torch.int64, device=dev)
    # one `as_strided` a view: on the card a slice and a view each cost
    # more host time than an allocation of its own
    views, at = {}, 0
    for name, shape, strides in _K5_I32:
        views[name] = i32.as_strided((k,) + shape, strides, at)
        at += k * strides[0]
    views.update(zip(_K5_I64, i64))
    return {name: views[name] for name, _, _ in K5_OUTPUTS}
