"""Intra 4x4 prediction (all 9 spec modes, 8.3.1.2) and the full Intra_4x4
macroblock encode, batched over MBs.

PyTorch counterpart of `h264lab_tpu/ops/intra4.py`. The JAX module runs
the 16 blocks as one `lax.scan` over b = 0..15 in raster order; here that
is a Python loop over the same order, so every block-dependent offset is
a static slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from h264lab_tpu_torch.ops import tables, transform
from h264lab_tpu_torch.ops.intra import INVALID_COST, pick

I32 = torch.int32

# raster blocks whose top-right neighbour is never available in coded
# order (or lies outside the MB rows): replicate the rightmost top sample
NO_TOPRIGHT = frozenset({5, 7, 11, 13, 15})

N_MODES = 9     # V, H, DC, DDL, DDR, VR, HD, VL, HU (spec order)


def _index_tables():
    """Static (4, 4) gather indices of the directional modes, in the
    layout of the JAX module: `p` = [tl, t0..t7] (index i+1 for p[i]),
    `v` = [l3, l2, l1, l0, tl, t0..t3], `w` = [t3, t2, t1, t0, tl, l0..l3],
    `l` = [l0..l3]."""
    yy, xx = np.mgrid[0:4, 0:4]
    idx = np.minimum(xx + yy, 6)
    i0 = xx - yy + 4
    iv = xx - (yy >> 1) + 5
    nv = 5 + (2 * xx - yy)
    iw = yy - (xx >> 1) + 5
    nw = 5 + (2 * yy - xx)
    xv = xx + (yy >> 1)
    yu = yy + (xx >> 1)
    c8 = lambda a: np.clip(a, 0, 8)
    c7 = lambda a: np.clip(a, 0, 7)
    c3 = lambda a: np.clip(a, 0, 3)
    return dict(
        ddl=[idx + 1, np.minimum(idx + 1, 7) + 1, np.minimum(idx + 2, 7) + 1],
        ddr=[i0 - 1, i0, i0 + 1],
        vr=[c8(iv - 2), c8(iv - 1), c8(iv)],
        vr_neg=[c8(nv - 1), c8(nv), c8(nv + 1)],
        hd=[c8(iw - 2), c8(iw - 1), c8(iw)],
        hd_neg=[c8(nw - 1), c8(nw), c8(nw + 1)],
        vl=[c7(xv) + 1, c7(xv + 1) + 1, c7(xv + 2) + 1],
        hu=[c3(yu), c3(yu + 1), c3(yu + 2)],
    ), dict(
        br=(xx == 3) & (yy == 3),
        zvr=2 * xx - yy, zhd=2 * yy - xx, zhu=xx + 2 * yy,
        y_even=yy % 2 == 0,
    )


_IDX_NP, _MASK_NP = _index_tables()


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    idx = {k: [torch.as_tensor(a.reshape(-1), dtype=torch.long,
                               device=device) for a in v]
           for k, v in _IDX_NP.items()}
    masks = {k: torch.as_tensor(v, device=device)
             for k, v in _MASK_NP.items()}
    modes = torch.arange(N_MODES, dtype=I32, device=device)
    scan = torch.as_tensor(tables.BLOCK_SCAN_4x4, dtype=torch.long,
                           device=device)
    return idx, masks, modes, scan


def _take3(vec, idxs, k):
    return [vec[:, i].reshape(k, 4, 4) for i in idxs]


def predict4(top, left, tl, tr, avail_top, avail_left, avail_tl):
    """All 9 predictions for a batch of 4x4 blocks.

    top (k, 4) p[0..3,-1]; left (k, 4) p[-1,0..3]; tl (k,) p[-1,-1];
    tr (k, 4) p[4..7,-1] (already replicated when unavailable); avail_*
    (k,) bool. Returns (k, 9, 4, 4) int32 predictions and (k, 9) validity.
    """
    k = top.shape[0]
    idx, m, _, _ = _consts(top.device)
    t = top.to(I32)
    l = left.to(I32)
    tl = tl.to(I32)
    tr = tr.to(I32)
    p = torch.cat([tl[:, None], t, tr], dim=1)             # p[-1], p0..p7
    v = torch.cat([l.flip(1), tl[:, None], t], dim=1)
    w = torch.cat([t.flip(1), tl[:, None], l], dim=1)

    pred_v = t[:, None, :].expand(k, 4, 4)
    pred_h = l[:, :, None].expand(k, 4, 4)
    sum_t = t.sum(1, dtype=I32)
    sum_l = l.sum(1, dtype=I32)
    dc = torch.where(avail_top & avail_left, (sum_t + sum_l + 4) >> 3,
                     torch.where(avail_top, (sum_t + 2) >> 2,
                                 torch.where(avail_left, (sum_l + 2) >> 2,
                                             128)))
    pred_dc = dc[:, None, None].expand(k, 4, 4)

    def three_tap(a, b, c):
        return (a + 2 * b + c + 2) >> 2

    a, b, c = _take3(p, idx["ddl"], k)
    br_val = (p[:, 7] + 3 * p[:, 8] + 2) >> 2
    pred_ddl = torch.where(m["br"], br_val[:, None, None], three_tap(a, b, c))

    pred_ddr = three_tap(*_take3(v, idx["ddr"], k))

    def vr_like(vec, pos, neg, z):
        a, b, c = _take3(vec, idx[pos], k)
        even = (b + c + 1) >> 1
        odd = three_tap(a, b, c)
        neg_v = three_tap(*_take3(vec, idx[neg], k))
        return torch.where(z >= 0, torch.where(z % 2 == 0, even, odd), neg_v)

    pred_vr = vr_like(v, "vr", "vr_neg", m["zvr"])
    pred_hd = vr_like(w, "hd", "hd_neg", m["zhd"])

    a, b, c = _take3(p, idx["vl"], k)
    pred_vl = torch.where(m["y_even"], (a + b + 1) >> 1, three_tap(a, b, c))

    la, lb, lc = _take3(l, idx["hu"], k)
    zhu = m["zhu"]
    pred_hu = torch.where(
        zhu > 5, l[:, 3][:, None, None],
        torch.where(zhu == 5,
                    ((l[:, 2] + 3 * l[:, 3] + 2) >> 2)[:, None, None],
                    torch.where(zhu % 2 == 0, (la + lb + 1) >> 1,
                                three_tap(la, lb, lc))))

    preds = torch.stack([pred_v, pred_h, pred_dc, pred_ddl, pred_ddr,
                         pred_vr, pred_hd, pred_vl, pred_hu], dim=1)
    ones = torch.ones_like(avail_top)
    diag = avail_top & avail_left & avail_tl
    valid = torch.stack([avail_top, avail_left, ones, avail_top, diag, diag,
                         diag, avail_top, avail_left], dim=1)
    return preds, valid


def encode_i4x4_mb(src_mb, top_row, left_col, tl_px, tr4_px,
                   avail_top, avail_left, avail_tl, avail_tr,
                   left_modes, top_modes, qp, deadzone_q8: int, lam):
    """Full Intra_4x4 encode of a batch of k MBs: per-block 9-mode choice,
    TQ and reconstruction, blocks in raster order (a topological order of
    the left/top/top-right dependencies).

    src_mb (k, 16, 16) uint8; top_row/left_col (k, 16); tl_px (k,);
    tr4_px (k, 4); avail_* (k,) bool MB-neighbour availability;
    left_modes/top_modes (k, 4) neighbouring MBs' edge block modes (2 = DC
    when absent or not Intra_4x4); qp, lam: 0-d or (k,) int tensors.

    Returns dict(levels (k,4,4,4,4) int32, recon (k,16,16) uint8, modes
    (k,16) raster int32, mode_sym_val/len (k,16) int32 in coded block
    order, cost (k,) int32).
    """
    k = src_mb.shape[0]
    dev = src_mb.device
    _, _, mode_ids, scan = _consts(dev)
    src = src_mb.to(I32)
    qp = torch.as_tensor(qp, device=dev)
    lam = torch.as_tensor(lam, dtype=I32, device=dev).reshape(-1, 1)
    # canvas rows 0..16 (0 = top edge), cols 0..20 (0 = left edge,
    # 17..20 = top-right extension)
    canvas = torch.zeros((k, 17, 21), dtype=I32, device=dev)
    canvas[:, 0, 1:17] = top_row
    canvas[:, 0, 17:21] = tr4_px
    canvas[:, 1:17, 0] = left_col
    canvas[:, 0, 0] = tl_px
    ones = torch.ones((k,), dtype=torch.bool, device=dev)
    modes = torch.full((k, 16), 2, dtype=I32, device=dev)
    cost = torch.zeros((k,), dtype=I32, device=dev)
    levels = torch.empty((k, 4, 4, 4, 4), dtype=I32, device=dev)
    s_vals = torch.empty((k, 16), dtype=I32, device=dev)
    s_lens = torch.empty((k, 16), dtype=I32, device=dev)
    for b in range(16):
        bi, bj = divmod(b, 4)
        y0, x0 = 4 * bi, 4 * bj
        t4 = canvas[:, y0, x0 + 1:x0 + 5]
        l4 = canvas[:, y0 + 1:y0 + 5, x0]
        tlp = canvas[:, y0, x0]
        a_top = ones if bi > 0 else avail_top
        a_left = ones if bj > 0 else avail_left
        if bi > 0 and bj > 0:
            a_tl = ones
        elif bi == 0 and bj == 0:
            a_tl = avail_tl
        else:
            a_tl = avail_top if bi == 0 else avail_left
        if b in NO_TOPRIGHT:
            tr4 = t4[:, 3:4].expand(k, 4)
        else:
            tr_ok = ones if bi > 0 else (avail_tr if bj == 3 else avail_top)
            tr4 = torch.where(tr_ok[:, None], canvas[:, y0, x0 + 5:x0 + 9],
                              t4[:, 3:4])
        preds, valid = predict4(t4, l4, tlp, tr4, a_top, a_left, a_tl)

        # predicted mode (spec 8.3.1.1): an unavailable neighbour block
        # forces DC; a non-Intra_4x4 neighbour contributes DC (2)
        mode_a = left_modes[:, bi] if bj == 0 else modes[:, b - 1]
        mode_b = top_modes[:, bj] if bi == 0 else modes[:, b - 4]
        avail_ab = (ones if bj > 0 else avail_left) & \
            (ones if bi > 0 else avail_top)
        pred_mode = torch.where(avail_ab, torch.minimum(mode_a, mode_b), 2)

        src_blk = src[:, y0:y0 + 4, x0:x0 + 4]
        sad = (src_blk[:, None] - preds).abs().sum((2, 3), dtype=I32)
        bits = 4 - 3 * (mode_ids[None, :] == pred_mode[:, None]).to(I32)
        c = torch.where(valid, sad + lam * bits, INVALID_COST)
        cmin, m = c.min(dim=1)
        m = m.to(I32)
        best = pick(preds, m)
        cost = cost + cmin
        modes[:, b] = m

        # mode syntax: flag(1)=1 if m == pred else 0 + rem(3)
        eq = m == pred_mode
        s_vals[:, b] = torch.where(eq, 1, torch.where(m < pred_mode, m, m - 1))
        s_lens[:, b] = torch.where(eq, 1, 4)

        coef = transform.fdct4x4(src_blk - best)
        lev = transform.quant4x4(coef, qp, deadzone_q8)
        res = transform.idct4x4(transform.dequant4x4(lev, qp))
        canvas[:, y0 + 1:y0 + 5, x0 + 1:x0 + 5] = torch.clamp(res + best,
                                                              0, 255)
        levels[:, bi, bj] = lev

    return dict(levels=levels, recon=canvas[:, 1:17, 1:17].to(torch.uint8),
                modes=modes, mode_sym_val=s_vals[:, scan],
                mode_sym_len=s_lens[:, scan], cost=cost)
