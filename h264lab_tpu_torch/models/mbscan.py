"""Macroblock engine, intra part: the slope-2 wavefront mode selection
(Intra_16x16, Intra_4x4, chroma), CAVLC symbolization and in-loop
deblocking of I slices.

PyTorch counterpart of the intra path of `h264lab_tpu/models/mbscan.py`.
Every function takes a leading frame axis N (the GOP lanes times the
slice bands, which JAX vmapped over) followed by the per-frame MB axis;
per-frame QPs are (N,) int tensors. Within a wavefront step all live MBs
of all N frames form one flat batch.

Form differences from the JAX module, none of them in the result:
- the wavefront `lax.scan` is a Python loop over the diagonals; plan
  entries padded with -1 are dropped on the host, so no index ever
  points outside the frame and each step writes its outputs straight to
  their raster positions (no diagonal re-ordering of inputs/outputs);
- the carried state is the same 72-byte edge record per MB, as one
  (N, nmb, 72) uint8 tensor updated in place;
- the deblocking wavefront runs on the frame's MB tiles (with one zero
  MB of padding above and to the left) instead of a row-indexed carry;
  it keeps the same slope-1 order with the V pass of a whole diagonal
  before its H pass, which is what makes the result equal the spec's
  raster order.
"""

from __future__ import annotations

import numpy as np
import torch

from h264lab_tpu_torch.ops import cavlc, deblock, intra, intra4, tables, \
    transform
from h264lab_tpu_torch.ops.intra import INVALID_COST
from h264lab_tpu_torch.ops.me import lambda_me
from h264lab_tpu_torch.ops.tuning import I4_PENALTY_BITS, INTRA_DEADZONE_Q8

SEL_INTER, SEL_I16, SEL_I4 = 0, 1, 2
I32 = torch.int32

# packed per-MB edge-record layout (uint8): recon edges + i4 edge modes
_E_BOT_Y = slice(0, 16)
_E_RIGHT_Y = slice(16, 32)
_E_BOT_U = slice(32, 40)
_E_RIGHT_U = slice(40, 48)
_E_BOT_V = slice(48, 56)
_E_RIGHT_V = slice(56, 64)
_E_EM_B = slice(64, 68)
_E_EM_R = slice(68, 72)
_E_BYTES = 72


def mb_to_blocks(mb: torch.Tensor, nblk: int) -> torch.Tensor:
    k = mb.shape[0]
    return mb.reshape(k, nblk, 4, nblk, 4).permute(0, 1, 3, 2, 4)


def blocks_to_mb(blocks: torch.Tensor) -> torch.Tensor:
    k, n = blocks.shape[:2]
    return blocks.permute(0, 1, 3, 2, 4).reshape(k, n * 4, n * 4)


def _bitlen32(x: torch.Tensor) -> torch.Tensor:
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


def _ue_codes(v: torch.Tensor):
    code = v.to(I32) + 1
    return code, 2 * _bitlen32(code) - 1


def _per_item(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N,) per-frame values -> (N*k,) per MB of a step (frame-major)."""
    return x[:, None].expand(x.shape[0], k).reshape(-1)


def _encode_luma_i16(src, pred, qp):
    """Intra_16x16 TQ + recon of (K, 16, 16) MBs at per-MB qp (K,)."""
    sb = mb_to_blocks(src.to(I32), 4)
    pb = mb_to_blocks(pred.to(I32), 4)
    coef = transform.fdct4x4(sb - pb)
    dc_lev = transform.quant_luma_dc(coef[..., 0, 0], qp)
    dc_deq = transform.dequant_luma_dc(dc_lev, qp)
    qb = qp[:, None, None]
    ac_lev = transform.quant4x4(coef, qb, INTRA_DEADZONE_Q8)
    deq = transform.dequant4x4(ac_lev, qb)
    ac_lev[..., 0, 0] = 0
    deq[..., 0, 0] = dc_deq
    recon = torch.clamp(transform.idct4x4(deq) + pb, 0, 255).to(torch.uint8)
    return dc_lev, ac_lev, blocks_to_mb(recon)


def _encode_chroma(src, pred, qpc, deadzone):
    """Chroma TQ + recon of (K, 8, 8) planes (u and v stacked on the batch
    axis) at per-plane qpc (K,)."""
    sb = mb_to_blocks(src.to(I32), 2)
    pb = mb_to_blocks(pred.to(I32), 2)
    coef = transform.fdct4x4(sb - pb)
    dc_lev = transform.quant_chroma_dc(coef[..., 0, 0], qpc)
    dc_deq = transform.dequant_chroma_dc(dc_lev, qpc)
    qb = qpc[:, None, None]
    ac_lev = transform.quant4x4(coef, qb, deadzone)
    deq = transform.dequant4x4(ac_lev, qb)
    ac_lev[..., 0, 0] = 0
    deq[..., 0, 0] = dc_deq
    recon = torch.clamp(transform.idct4x4(deq) + pb, 0, 255).to(torch.uint8)
    return dc_lev, ac_lev, blocks_to_mb(recon)


# ---------------------------------------------------------------------------
# stage 2: mode selection (intra slices: the slope-2 wavefront)
# ---------------------------------------------------------------------------

def _wave_steps(steps, avail_top, avail_left, mb_width: int, device):
    """Per-step index and availability tensors for the live MBs of each
    plan row, uploaded in one transfer and sliced per step."""
    steps = np.asarray(steps)
    at = np.asarray(avail_top, dtype=bool)
    al = np.asarray(avail_left, dtype=bool)
    rows, bounds = [], [0]
    for row in steps:
        c = row[row >= 0].astype(np.int64)
        a_top, a_left = at[c], al[c]
        rows.append(np.stack([
            c,
            np.maximum(c - mb_width, 0),             # top
            np.maximum(c - 1, 0),                    # left
            np.maximum(c - mb_width - 1, 0),         # top-left
            np.maximum(c - mb_width + 1, 0),         # top-right
            a_top, a_left, a_top & a_left,
            a_top & (c % mb_width < mb_width - 1)]))
        bounds.append(bounds[-1] + len(c))
    allv = torch.as_tensor(np.concatenate(rows, axis=1), device=device)
    idx, avail = allv[:5], allv[5:].bool()
    return [(idx[:, a:b], avail[:, a:b]) for a, b in zip(bounds, bounds[1:])
            if b > a]


def select_stage_core(src_y_mb, src_u_mb, src_v_mb, qp, qpc,
                      steps, avail_top, avail_left, mb_width: int):
    """Mode selection + intra encode of N intra frames/bands.

    src_*_mb (N, nmb, 16, 16)/(N, nmb, 8, 8) uint8; qp/qpc (N,) int;
    steps: the slope-2 `wavefront.make_plan` steps; avail_top/avail_left
    (nmb,) bool. Returns the dict of the JAX stage's intra outputs, each
    with the leading N axis."""
    N, nmb = src_y_mb.shape[:2]
    dev = src_y_mb.device
    qp = torch.as_tensor(qp, dtype=I32, device=dev).reshape(N)
    qpc = torch.as_tensor(qpc, dtype=I32, device=dev).reshape(N)
    lam = lambda_me(qp)

    def buf(shape, dtype=I32):
        return torch.empty((N, nmb) + shape, dtype=dtype, device=dev)

    out = dict(sel=buf(()), mode16=buf(()), cmode=buf(()),
               dc_lev=buf((4, 4)), ac_lev=buf((4, 4, 4, 4)),
               cdc_lev=buf((2, 2, 2)), cac_lev=buf((2, 2, 2, 4, 4)),
               recon_y=buf((16, 16), torch.uint8),
               recon_u=buf((8, 8), torch.uint8),
               recon_v=buf((8, 8), torch.uint8),
               i4modes=buf((16,)), i4sym_v=buf((16,)), i4sym_l=buf((16,)))
    E = torch.zeros((N, nmb, _E_BYTES), dtype=torch.uint8, device=dev)

    for idx, avail in _wave_steps(steps, avail_top, avail_left, mb_width,
                                  dev):
        cidx = idx[0]
        k = cidx.shape[0]
        K = N * k

        def gather(x, i):
            g = x[:, i]
            return g.reshape((K,) + g.shape[2:])

        Et, El, Etl, Etr = (gather(E, idx[j]) for j in range(1, 5))
        a_top, a_left, a_tl, a_tr = (a.repeat(N) for a in avail)
        src_y = gather(src_y_mb, cidx)
        qpk, qpck, lamk = (_per_item(x, k) for x in (qp, qpc, lam))
        top_row = Et[:, _E_BOT_Y]
        left_col = El[:, _E_RIGHT_Y]

        # intra 16x16 candidate
        preds, valid = intra.predict_16x16(top_row, left_col, a_top, a_left)
        m16, pred_y16, cost16 = intra.select_mode(src_y, preds, valid)
        dc_lev, ac_lev16, rec_y16 = _encode_luma_i16(src_y, pred_y16, qpk)

        # intra 4x4 candidate
        i4 = intra4.encode_i4x4_mb(
            src_y, top_row, left_col, Etl[:, 15], Etr[:, 0:4],
            a_top, a_left, a_tl, a_tr,
            El[:, _E_EM_R].to(I32), Et[:, _E_EM_B].to(I32),
            qpk, INTRA_DEADZONE_Q8, lamk)
        cost4 = i4["cost"] + lamk * I4_PENALTY_BITS

        # chroma, u and v stacked on the batch axis
        top_c = torch.cat([Et[:, _E_BOT_U], Et[:, _E_BOT_V]])
        left_c = torch.cat([El[:, _E_RIGHT_U], El[:, _E_RIGHT_V]])
        preds_c, valid_c = intra.predict_chroma(
            top_c, left_c, torch.cat([a_top, a_top]),
            torch.cat([a_left, a_left]))
        src_c = torch.cat([gather(src_u_mb, cidx), gather(src_v_mb, cidx)])
        ccost2 = intra.sad(src_c[:, None], preds_c)              # (2K, 3)
        ccost = torch.where(valid_c[:K], ccost2[:K] + ccost2[K:],
                            INVALID_COST)
        cm = ccost.argmin(dim=1).to(I32)
        pred_c = intra.pick(preds_c, torch.cat([cm, cm]))
        cdc_c, cac_c, rec_c = _encode_chroma(
            src_c, pred_c, torch.cat([qpck, qpck]), INTRA_DEADZONE_Q8)

        # selection over (inter, I16, I4); no inter candidate here
        costs = torch.stack([torch.full_like(cost16, INVALID_COST),
                             cost16, cost4], dim=1)
        sel = costs.argmin(dim=1).to(I32)
        is_i4 = sel == SEL_I4
        rec_y = torch.where(is_i4[:, None, None], i4["recon"], rec_y16)
        rec_u, rec_v = rec_c[:K], rec_c[K:]
        em_b = torch.where(is_i4[:, None], i4["modes"][:, 12:16], 2)
        em_r = torch.where(is_i4[:, None], i4["modes"][:, 3::4], 2)
        ac_store = torch.where(is_i4[:, None, None, None, None],
                               i4["levels"], ac_lev16)

        E[:, cidx] = torch.cat([
            rec_y[:, -1, :], rec_y[:, :, -1],
            rec_u[:, -1, :], rec_u[:, :, -1],
            rec_v[:, -1, :], rec_v[:, :, -1],
            em_b.to(torch.uint8), em_r.to(torch.uint8)], dim=1).reshape(
                N, k, _E_BYTES)
        for name, val in (
                ("sel", sel), ("mode16", m16), ("cmode", cm),
                ("dc_lev", dc_lev), ("ac_lev", ac_store),
                ("cdc_lev", torch.stack([cdc_c[:K], cdc_c[K:]], dim=1)),
                ("cac_lev", torch.stack([cac_c[:K], cac_c[K:]], dim=1)),
                ("recon_y", rec_y), ("recon_u", rec_u), ("recon_v", rec_v),
                ("i4modes", i4["modes"]), ("i4sym_v", i4["mode_sym_val"]),
                ("i4sym_l", i4["mode_sym_len"])):
            out[name][:, cidx] = val.reshape((N, k) + val.shape[1:])
    return out


# ---------------------------------------------------------------------------
# stage 4: deblocking — parallel bS derivation + slope-1 wavefront filter
# ---------------------------------------------------------------------------

def _frame_bs(sel, nnz_blk, mv4_y, mv4_x, avail_top, avail_left,
              mb_width: int, mb_height: int):
    """Boundary strengths of every MB, fully parallel. sel (N, nmb);
    nnz_blk/mv4_* (N, nmb, 4, 4). Returns (bs_v, bs_h): (N, nmb, 4, 4)."""
    N, nmb = sel.shape
    dev = sel.device
    is_intra = sel != SEL_INTER

    def pad(x):
        return torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)

    nnz_pad, mvy_pad, mvx_pad, intra_pad = (
        pad(nnz_blk), pad(mv4_y), pad(mv4_x), pad(is_intra))
    idx = torch.arange(nmb, device=dev)
    rr = idx // mb_width
    cc = idx % mb_width
    avail_top = torch.as_tensor(avail_top, device=dev)
    avail_left = torch.as_tensor(avail_left, device=dev)
    has_left = (cc > 0) & avail_left
    has_top = (rr > 0) & avail_top
    li = torch.where(has_left, idx - 1, nmb)
    ti = torch.where(has_top, idx - mb_width, nmb)

    def edges(nb_i, has_nb, vertical):
        def sel_e(a, edge):
            return a[..., :, edge] if vertical else a[..., edge, :]

        out = [torch.where(has_nb[:, None], deblock.mb_edge_bs(
            intra_pad[:, nb_i][..., None], is_intra[..., None],
            sel_e(nnz_pad[:, nb_i], 3), sel_e(nnz_blk, 0),
            sel_e(mvy_pad[:, nb_i], 3), sel_e(mvx_pad[:, nb_i], 3),
            sel_e(mv4_y, 0), sel_e(mv4_x, 0), True), 0)]
        for e in range(1, 4):
            out.append(deblock.mb_edge_bs(
                is_intra[..., None], is_intra[..., None],
                sel_e(nnz_blk, e - 1), sel_e(nnz_blk, e),
                sel_e(mv4_y, e - 1), sel_e(mv4_x, e - 1),
                sel_e(mv4_y, e), sel_e(mv4_x, e), False))
        return torch.stack(out, dim=2)

    return edges(li, has_left, True), edges(ti, has_top, False)


def deblock_frame(recon_y, recon_u, recon_v, sel, nnz_blk, mv4_y, mv4_x,
                  qp, qpc, avail_top, avail_left,
                  mb_width: int, mb_height: int):
    """In-loop deblocking of N frames/bands at per-frame (N,) QPs.

    bS is derived in parallel; the filter walks slope-1 diagonals and runs
    the V pass of the whole diagonal before its H pass: the one raster
    dependency inside a diagonal — MB (r, c)'s top-edge H filter reading
    pixels that MB (r-1, c+1)'s left-edge V filter wrote — is met because
    the H pass reads the tiles after every V write of the diagonal."""
    N, nmb = sel.shape
    dev = sel.device
    mbh, mbw = mb_height, mb_width
    qp = torch.as_tensor(qp, dtype=I32, device=dev).reshape(N)
    qpc = torch.as_tensor(qpc, dtype=I32, device=dev).reshape(N)
    bs_v, bs_h = _frame_bs(sel, nnz_blk, mv4_y, mv4_x, avail_top,
                           avail_left, mb_width, mb_height)
    # MB tiles with one zero MB row above and column to the left: the
    # missing neighbours of the first row/column (their bS is 0)
    ty = torch.zeros((N, mbh + 1, mbw + 1, 16, 16), dtype=I32, device=dev)
    ty[:, 1:, 1:] = recon_y.reshape(N, mbh, mbw, 16, 16)
    tc = torch.zeros((N, mbh + 1, mbw + 1, 2, 8, 8), dtype=I32, device=dev)
    tc[:, 1:, 1:, 0] = recon_u.reshape(N, mbh, mbw, 8, 8)
    tc[:, 1:, 1:, 1] = recon_v.reshape(N, mbh, mbw, 8, 8)

    diags = []
    for d in range(mbw + mbh - 1):
        r = np.arange(max(0, d - mbw + 1), min(mbh - 1, d) + 1)
        diags.append(np.stack([r, d - r, r * mbw + d - r]))
    allv = torch.as_tensor(np.concatenate(diags, axis=1), device=dev)
    start = 0
    for dg in diags:
        r, c, mbi = allv[:, start:start + dg.shape[1]]
        start += dg.shape[1]
        k = r.shape[0]
        K = N * k
        bv = bs_v[:, mbi].reshape(K, 4, 4)
        bh = bs_h[:, mbi].reshape(K, 4, 4)
        qk, qck = _per_item(qp, k), _per_item(qpc, k)
        r1, c1 = r + 1, c + 1

        # luma V: 4 left columns from the left neighbour
        strip = torch.cat([ty[:, r1, c, :, 12:16], ty[:, r1, c1]], dim=-1)
        deblock.filter_luma_v(strip.view(K, 16, 20), bv, qk, edge_x0=4)
        ty[:, r1, c, :, 13:16] = strip[..., 1:4]
        ty[:, r1, c1] = strip[..., 4:20]
        # luma H: 4 top rows from the top neighbour (after the V writes)
        strip = torch.cat([ty[:, r, c1, 12:16, :], ty[:, r1, c1]], dim=-2)
        deblock.filter_luma_h(strip.view(K, 20, 16), bh, qk, edge_y0=4)
        ty[:, r, c1, 13:16, :] = strip[..., 1:4, :]
        ty[:, r1, c1] = strip[..., 4:20, :]

        # chroma, u and v on a plane axis
        strip = torch.cat([tc[:, r1, c, :, :, 6:8], tc[:, r1, c1]], dim=-1)
        deblock.filter_chroma_v(strip.view(K, 2, 8, 10), bv, qck, edge_x0=2)
        tc[:, r1, c, :, :, 7:8] = strip[..., 1:2]
        tc[:, r1, c1] = strip[..., 2:10]
        strip = torch.cat([tc[:, r, c1, :, 6:8, :], tc[:, r1, c1]], dim=-2)
        deblock.filter_chroma_h(strip.view(K, 2, 10, 8), bh, qck, edge_y0=2)
        tc[:, r, c1, :, 7:8, :] = strip[..., 1:2, :]
        tc[:, r1, c1] = strip[..., 2:10, :]

    df_y = ty[:, 1:, 1:].reshape(N, nmb, 16, 16).to(torch.uint8)
    df_c = tc[:, 1:, 1:].reshape(N, nmb, 2, 8, 8).to(torch.uint8)
    return df_y, df_c[:, :, 0], df_c[:, :, 1]


def deblock_stage_core(recon_y, recon_u, recon_v, sel, qp, qpc,
                       avail_top, avail_left, mb_width: int, mb_height: int):
    """Stage 4 for intra frames: no coded inter blocks, zero motion."""
    N, nmb = sel.shape
    zeros = torch.zeros((N, nmb, 4, 4), dtype=I32, device=sel.device)
    return deblock_frame(recon_y, recon_u, recon_v, sel, zeros, zeros, zeros,
                         qp, qpc, avail_top, avail_left, mb_width, mb_height)


# ---------------------------------------------------------------------------
# stage 3: symbolization (I slices)
# ---------------------------------------------------------------------------

def _block_nc(nnz_grid, blk_avail_left, blk_avail_top):
    """nC from the left/top 4x4 neighbours of a (N, gh, gw) nnz grid."""
    na = torch.nn.functional.pad(nnz_grid, (1, 0))[..., :-1]
    nb = torch.nn.functional.pad(nnz_grid, (0, 0, 1, 0))[..., :-1, :]
    return torch.where(blk_avail_left & blk_avail_top, (na + nb + 1) >> 1,
                       torch.where(blk_avail_left, na,
                                   torch.where(blk_avail_top, nb, 0)))


def _nc_grid(nnz, mbh, mbw, n):
    """nC of every n x n block of (N, nmb, n, n) nnz counts, raster in-MB."""
    N = nnz.shape[0]
    g = nnz.reshape(N, mbh, mbw, n, n).permute(0, 1, 3, 2, 4).reshape(
        N, mbh * n, mbw * n)
    gy = torch.arange(mbh * n, device=nnz.device)[:, None]
    gx = torch.arange(mbw * n, device=nnz.device)[None, :]
    nc = _block_nc(g, gx > 0, gy > 0)
    return nc.reshape(N, mbh, n, mbw, n).permute(0, 1, 3, 2, 4).reshape(
        N, mbh * mbw, n, n)


def symbolize(sel, mode16, cmode, i4sym_v, i4sym_l, dc_lev, ac_lev,
              cdc_lev, cac_lev, mb_width: int, mb_height: int):
    """CAVLC + syntax symbol assembly of N I slices.

    Returns dict(sym_vals (N, nmb, 952) int32 (uint32 bit patterns),
    sym_lens (N, nmb, 952) int32, tail_val/tail_len (N,) (the trailing
    skip run; zero in I slices), total_bits (N,) int32). The unit layout
    is the JAX module's: unit 0 = 34 MB-header slots, units 1..27 = the
    CAVLC blocks in decode order."""
    N, nmb = sel.shape
    dev = sel.device
    ns = cavlc.N_SLOTS
    zz = torch.as_tensor(tables.ZIGZAG_4x4, dtype=torch.long, device=dev)
    blk_scan = torch.as_tensor(tables.BLOCK_SCAN_4x4, dtype=torch.long,
                               device=dev)
    cbp_code_t = torch.as_tensor(tables.CBP_TO_CODENUM, device=dev)
    is_i16 = sel == SEL_I16
    is_i4 = sel == SEL_I4

    # nnz and cbp (ac_lev: i16 AC levels with DC zeroed, or i4 levels)
    nnz_intra = (ac_lev != 0).sum((-2, -1), dtype=I32)         # (N,nmb,4,4)
    cdc_nnz = (cdc_lev != 0).sum((-2, -1), dtype=I32)          # (N,nmb,2)
    cac_nnz = (cac_lev != 0).sum((-2, -1), dtype=I32)          # (N,nmb,2,2,2)
    gnz = nnz_intra.reshape(N, nmb, 2, 2, 2, 2).permute(
        0, 1, 2, 4, 3, 5).sum((4, 5)) > 0
    cbpl_i4 = (gnz[..., 0, 0].to(I32) + 2 * gnz[..., 0, 1]
               + 4 * gnz[..., 1, 0] + 8 * gnz[..., 1, 1])
    cbpl_i16 = nnz_intra.sum((2, 3)) > 0                       # all or none
    cbpc = torch.where(cac_nnz.sum((2, 3, 4)) > 0, 2,
                       torch.where(cdc_nnz.sum(2) > 0, 1, 0)).to(I32)
    cbp_luma = torch.where(is_i4, cbpl_i4,
                           torch.where(cbpl_i16, 15, 0)).to(I32)
    cbp = cbp_luma + (cbpc << 4)

    # nC contexts from the coded nnz
    luma_nnz = torch.where((is_i4 | cbpl_i16)[..., None, None], nnz_intra, 0)
    cac_nnz_coded = torch.where((cbpc == 2)[..., None, None, None],
                                cac_nnz, 0)
    nc_luma = _nc_grid(luma_nnz, mb_height, mb_width, 4)
    nc_chroma = torch.stack([
        _nc_grid(cac_nnz_coded[:, :, p], mb_height, mb_width, 2)
        for p in range(2)], dim=2)                              # (N,nmb,2,2,2)

    # luma DC (i16 only)
    dc_vals, dc_lens, _ = cavlc.encode_blocks(
        dc_lev.reshape(N * nmb, 16)[:, zz], nc_luma[..., 0, 0].reshape(-1),
        16)
    dc_lens = torch.where(is_i16.reshape(-1, 1), dc_lens, 0)

    # luma: i16 blocks code their AC-15 view, i4 blocks all 16
    scan = ac_lev.reshape(N * nmb * 16, 16)[:, zz]
    i16_blk = is_i16.repeat_interleave(16).reshape(-1)
    scan_lv = torch.where(
        i16_blk[:, None],
        torch.cat([scan[:, 1:], torch.zeros_like(scan[:, :1])], dim=1), scan)
    vv, ll, _ = cavlc.encode_blocks(scan_lv, nc_luma.reshape(-1),
                                    torch.where(i16_blk, 15, 16))
    luma_vals = vv.reshape(N, nmb, 16, ns)
    ll = ll.reshape(N, nmb, 16, ns)
    blk = torch.arange(16, device=dev)
    grp_of_block = (blk // 8) * 2 + (blk % 4) // 2
    bit = (cbp_luma[..., None] >> grp_of_block) & 1
    blk_coded = torch.where(is_i16[..., None], cbpl_i16[..., None],
                            is_i4[..., None] & (bit > 0))
    luma_lens = torch.where(blk_coded[..., None], ll, 0)

    # chroma DC
    cdc_vals, cdc_lens, _ = cavlc.encode_blocks(
        torch.nn.functional.pad(cdc_lev.reshape(N * nmb * 2, 4), (0, 12)),
        torch.full((N * nmb * 2,), -1, dtype=I32, device=dev), 4)
    cdc_lens = torch.where((cbpc >= 1)[..., None, None],
                           cdc_lens.reshape(N, nmb, 2, ns), 0)

    # chroma AC
    cacf = cac_lev.reshape(N * nmb * 8, 16)[:, zz][:, 1:]
    cac_vals, cac_lens, _ = cavlc.encode_blocks(
        torch.nn.functional.pad(cacf, (0, 1)), nc_chroma.reshape(-1), 15)
    cac_lens = torch.where((cbpc == 2)[..., None, None],
                           cac_lens.reshape(N, nmb, 8, ns), 0)

    # MB header symbols; the slot layout of the JAX module (skip run,
    # base_mode, mb_type, 4 sub_mb_type, 8 mvd, 16 i4 modes, chroma mode,
    # cbp, dQP) with the inter-only slots zero-length
    mb_type = torch.where(is_i4, 0,
                          1 + mode16 + 4 * cbpc + 12 * cbpl_i16.to(I32))
    mt_v, mt_l = _ue_codes(mb_type)
    cm_v, cm_l = _ue_codes(cmode)
    # (column 0 intra, 1 inter: the JAX module takes the inter code for
    # I16 MBs, whose cbp slot is zero-length)
    cbp_c = torch.clamp(cbp, 0, 47).long()
    cbpv, cbpl_ = _ue_codes(torch.where(is_i4, cbp_code_t[cbp_c, 0],
                                        cbp_code_t[cbp_c, 1]))
    zero1 = torch.zeros((N, nmb, 1), dtype=I32, device=dev)
    one1 = torch.ones((N, nmb, 1), dtype=I32, device=dev)
    hdr_vals = torch.cat([
        zero1, zero1, mt_v[..., None], one1.expand(N, nmb, 12),
        i4sym_v.to(I32), cm_v[..., None], cbpv[..., None], one1], dim=2)
    hdr_lens = torch.cat([
        zero1, zero1, mt_l[..., None], zero1.expand(N, nmb, 12),
        torch.where(is_i4[..., None], i4sym_l, 0).to(I32), cm_l[..., None],
        torch.where(is_i4, cbpl_, 0)[..., None],
        (is_i16 | (cbp != 0)).to(I32)[..., None]], dim=2)

    sym_vals = torch.cat([
        hdr_vals, dc_vals.reshape(N, nmb, ns),
        luma_vals[:, :, blk_scan].reshape(N, nmb, 16 * ns),
        cdc_vals.reshape(N, nmb, 2 * ns), cac_vals.reshape(N, nmb, 8 * ns),
    ], dim=2)
    sym_lens = torch.cat([
        hdr_lens, dc_lens.reshape(N, nmb, ns),
        luma_lens[:, :, blk_scan].reshape(N, nmb, 16 * ns),
        cdc_lens.reshape(N, nmb, 2 * ns), cac_lens.reshape(N, nmb, 8 * ns),
    ], dim=2)
    zero = torch.zeros((N,), dtype=I32, device=dev)
    return dict(sym_vals=sym_vals, sym_lens=sym_lens,
                tail_val=zero, tail_len=zero,
                total_bits=sym_lens.sum((1, 2), dtype=I32))
