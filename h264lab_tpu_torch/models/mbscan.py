"""Macroblock engine: motion search, partition search, inter transform
and the fully parallel P mode selection; the slope-2 wavefront mode
selection of I slices and of P slices with Intra_4x4 (Intra_16x16,
Intra_4x4 and chroma, with the inter candidate in P); CAVLC symbolization
of I and P slices, with per-MB-row QPs through `mb_qp_delta`; in-loop
deblocking.

PyTorch counterpart of `h264lab_tpu/models/mbscan.py` with every P
toolset of the JAX stages: partitions (speed 0), Intra_4x4 in P through
the wavefront (speeds 0 and 1), quarter-pel ME (below 9), and the fully
parallel P path without Intra_4x4 (speed 2 and up). Every function takes
a leading frame axis N (the GOP lanes times the slice bands, which JAX
vmapped over) followed by the per-frame MB axis; QPs are (N,) int tensors
or, for per-row fine rate control, (N, mb_height). Within a wavefront
step all live MBs of all N frames form one flat batch; the parallel
stages run over all N * nmb MBs at once.

On CUDA tensors the slope-2 wavefront and the deblocking filter are one
launch each of the hand kernels K3 and K2 (`_select_wavefront`,
`deblock_frame`), the motion search of `inter_stage_core` is K4 and, at
speed 0, K5 (`ops/me.motion_search_tiles`, `partition_tiles`), the rest
of that stage K7 (`inter_residual`, `ops/residual.inter_tiles`), the
parallel P select K8 (`select_parallel`, `ops/residual.select_tiles`),
and `symbolize` is K6 (`ops/symbolize.symbolize_tiles`); the loops and
batches below and in `ops/me.py` are their plain versions, which run on
CPU tensors and which the kernels are held against.

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
  raster order;
- the skip-run and dQP-run `associative_scan(max)` are `torch.cummax`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from h264lab_tpu_torch.ops import cavlc, deblock, intra, intra4, me, qpel, \
    residual, tables, transform, wavefront
from h264lab_tpu_torch.ops import symbolize as symbolize_k6
from h264lab_tpu_torch.ops.intra import INVALID_COST
from h264lab_tpu_torch.ops.me import bitlen32, lambda_me, median3
from h264lab_tpu_torch.ops.tuning import (I4_PENALTY_BITS, INTER_DEADZONE_Q8,
                                          INTER_ZERO_THR2_Q8,
                                          INTER_ZERO_THR_Q8,
                                          INTRA_DEADZONE_Q8,
                                          INTRA_IN_P_PENALTY_BITS,
                                          PART_16X8_PENALTY_BITS,
                                          PART_8X8_PENALTY_BITS)

SEL_INTER, SEL_I16, SEL_I4 = 0, 1, 2
I32, U8 = torch.int32, torch.uint8

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


def _ue_codes(v: torch.Tensor):
    """ue(v) codes (value, length) of non-negative int tensors; the values
    are the int32 bit patterns of the JAX module's uint32 codes."""
    code = v.to(I32) + 1
    return code, 2 * bitlen32(code) - 1


def _se_codes(v: torch.Tensor):
    v = v.to(I32)
    return _ue_codes(torch.where(v > 0, 2 * v - 1, -2 * v))


def _per_item(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N,) per-frame values -> (N*k,) per MB of a step (frame-major)."""
    return x[:, None].expand(x.shape[0], k).reshape(-1)


def _frames(x: torch.Tensor, n: int, nmb: int) -> torch.Tensor:
    """(N*nmb, ...) per-MB values -> (N, nmb, ...)."""
    return x.reshape((n, nmb) + x.shape[1:])


def _qp_views(qp, qpc, n: int, nmb: int, mb_width: int, dev):
    """Per-frame (N,) or per-MB-row (N, mb_height) QPs -> (qp0, qp_k,
    qpc_k): qp0 (N,) the QP of each frame's first row, which the ME and
    mode-decision lambdas take, and (N * nmb,) per-MB QPs for the
    quantizers."""
    qp = torch.as_tensor(qp, dtype=I32, device=dev)
    qpc = torch.as_tensor(qpc, dtype=I32, device=dev)
    if qp.ndim == 2:
        return (qp[:, 0], qp.repeat_interleave(mb_width, 1).reshape(-1),
                qpc.repeat_interleave(mb_width, 1).reshape(-1))
    qp, qpc = qp.reshape(n), qpc.reshape(n)
    return qp, _per_item(qp, nmb), _per_item(qpc, nmb)


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


def _encode_inter_luma(src, pred, qp, zero_thr: bool = True):
    """Inter luma TQ + recon of (K, 16, 16) MBs at per-MB qp (K,), with the
    zero-block kills unless `zero_thr` is off (base-mode frames): a 4x4
    block whose coefficients all sit at or under INTER_ZERO_THR_Q8/256
    quant steps, and a whole 8x8 quarter under INTER_ZERO_THR2_Q8/256, is
    zeroed. Returns (levels (K, 4, 4, 4, 4), recon (K, 16, 16) uint8)."""
    sb = mb_to_blocks(src.to(I32), 4)
    pb = mb_to_blocks(pred.to(I32), 4)
    coef = transform.fdct4x4(sb - pb)
    qb = qp[:, None, None]
    lev = transform.quant4x4(coef, qb, INTER_DEADZONE_Q8)
    deq = transform.dequant4x4(lev, qb)
    if zero_thr and INTER_ZERO_THR_Q8 > 0:
        thr1 = transform.zero_thr4x4(qp, INTER_ZERO_THR_Q8)[:, None, None]
        thr2 = transform.zero_thr4x4(qp, INTER_ZERO_THR2_Q8)[:, None, None]
        a = coef.abs()                                    # (K, 4, 4, 4, 4)
        z1 = (a <= thr1).all(-1).all(-1)                  # (K, 4, 4) blocks
        z2b = (a <= thr2).all(-1).all(-1)
        # 8x8 quarters = 2x2 block groups
        z2q = (z2b.reshape(-1, 2, 2, 2, 2).permute(0, 1, 3, 2, 4)
               .reshape(-1, 4, 4).all(-1).reshape(-1, 2, 2))
        z2 = z2q.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        kill = (z1 | z2)[..., None, None]
        lev = torch.where(kill, 0, lev)
        deq = torch.where(kill, 0, deq)
    recon = torch.clamp(transform.idct4x4(deq) + pb, 0, 255).to(torch.uint8)
    return lev, blocks_to_mb(recon)


# ---------------------------------------------------------------------------
# stage 1 (P slices): dense ME + chroma MC + inter transform, fully parallel
# ---------------------------------------------------------------------------

def inter_stage_core(src_y_mb, src_u_mb, src_v_mb, ref, lane, qp, qpc,
                     mb_row_offset, prev_my, prev_mx, mb_width: int,
                     mb_height: int, enable_partitions: bool = False,
                     enable_qpel: bool = True):
    """ME + MC + inter TQ of N P frames/bands: the 16x16 search, quarter-
    pel unless `enable_qpel` is off (speeds 9 and 10), and with
    `enable_partitions` (speed 0, quarter-pel only) the 16x8 / 8x16 / 8x8
    search, the shape chosen per MB on cost plus its side-info penalty.

    src_*_mb (N, nmb, t, t) uint8; ref: the lanes' reference planes
    (`refstate.prepare_reference`: y_pad, u_pad, v_pad, y4_pad, leading
    axis L); lane, mb_row_offset (N,): each band's reference lane and
    first MB row in the lane's frame; qp, qpc (N,) or per MB row (N,
    mb_height); prev_my/prev_mx (N, nmb) full-pel previous MVs or None.

    Everything runs on the tiles' device: on CUDA tensors K4 and, with
    partitions, K5 (`me.motion_search_tiles`, `me.partition_tiles`), then
    K7 (`inter_residual`: the shape, chroma MC, TQ and recon); on CPU
    tensors their plain versions (`me.motion_search_plain`,
    `me.partition_plain`, `inter_residual_plain`), with the same arguments
    (`motion_search_args`, `inter_residual_args`). Both give the same
    arrays."""
    N, nmb = src_y_mb.shape[:2]
    dev = src_y_mb.device
    K = N * nmb
    qp = torch.as_tensor(qp, dtype=I32, device=dev)
    qp0 = qp[:, 0] if qp.ndim == 2 else qp.reshape(N)
    lane = torch.as_tensor(lane, device=dev).reshape(N)
    row0 = torch.as_tensor(mb_row_offset, dtype=I32, device=dev).reshape(N)
    partitions = enable_partitions and enable_qpel
    on_cpu = dev.type == "cpu"
    search = me.motion_search_plain if on_cpu else me.motion_search_tiles
    margs = motion_search_args(src_y_mb, ref, lane, row0, qp0, prev_my,
                               prev_mx)
    mv_y, mv_x, cost16, pred16, aux = search(
        *margs, mb_width, mb_height, enable_qpel, partitions)
    parts = None
    if partitions:
        lam_k = _per_item(lambda_me(qp0), nmb)
        parts = (me.partition_plain if on_cpu else me.partition_tiles)(
            _packed(src_y_mb, torch.uint8, (K, 16, 16), dev), aux["wins"],
            *(aux[k].reshape(K) for k in ("full_my", "full_mx", "mvp_y",
                                          "mvp_x")), lam_k.contiguous())
    return dict(mv_y=mv_y, mv_x=mv_x, **inter_residual(
        src_y_mb, src_u_mb, src_v_mb, ref["u_pad"], ref["v_pad"], margs[3],
        margs[4], qp, qpc, mv_y, mv_x, aux["full_my"], aux["full_mx"],
        cost16, pred16, parts, mb_width, mb_height))


def inter_residual(src_y_mb, src_u_mb, src_v_mb, u_pad, v_pad, lane, row0,
                   qp, qpc, mv_y, mv_x, full_my, full_mx, cost16, pred16,
                   parts, mb_width: int, mb_height: int,
                   zero_thr: bool = True) -> dict:
    """Everything of the inter stage after the searches, on the tiles'
    device: the partition shape (with `parts`, K5's dict), the MV grid,
    chroma MC, the inter luma TQ (with the zero-block kills unless
    `zero_thr` is off), the chroma TQ and the reconstruction. The one entry
    of every encode path. On CUDA tensors one launch of K7
    (`residual.inter_tiles`, `csrc/inter.cu`) on `inter_residual_args`'
    packing; on CPU tensors `inter_residual_plain`."""
    args = (src_y_mb, src_u_mb, src_v_mb, u_pad, v_pad, lane, row0, qp, qpc,
            mv_y, mv_x, full_my, full_mx, cost16, pred16, parts, mb_width,
            mb_height, zero_thr)
    if src_y_mb.device.type == "cpu":
        return inter_residual_plain(*args)
    return residual.inter_tiles(*inter_residual_args(*args))


def inter_residual_args(src_y_mb, src_u_mb, src_v_mb, u_pad, v_pad, lane,
                        row0, qp, qpc, mv_y, mv_x, full_my, full_mx, cost16,
                        pred16, parts, mb_width: int, mb_height: int,
                        zero_thr: bool = True):
    """`inter_residual`'s arguments in the form K7 (`residual.inter_tiles`)
    takes them, on the tiles' device: the tiles and pred16 as contiguous
    16-byte aligned uint8, the chroma planes contiguous, lane and row0 (N,)
    int32, qp and qpc (N,) or (N, mb_height) int32, the search's MVs and
    cost (N, nmb) int32, and K5's outputs (`residual.K7_PARTS`, over N *
    nmb MBs, the int32 ones 16-byte aligned) as a tuple, or None."""
    N, nmb = src_y_mb.shape[:2]
    dev = src_y_mb.device
    mb = (N, nmb)
    q = torch.as_tensor(qp)
    qshape = (N, mb_height) if q.ndim == 2 else (N,)
    if parts is not None:
        parts = tuple(_packed(parts[name], dtype, (N * nmb,) + trail, dev)
                      for name, dtype, trail in residual.K7_PARTS)
    return (_packed(src_y_mb, U8, mb + (16, 16), dev),
            _packed(src_u_mb, U8, mb + (8, 8), dev),
            _packed(src_v_mb, U8, mb + (8, 8), dev), u_pad.contiguous(),
            v_pad.contiguous(), _packed(lane, I32, (N,), dev),
            _packed(row0, I32, (N,), dev), _packed(qp, I32, qshape, dev),
            _packed(qpc, I32, qshape, dev),
            *(_packed(x, I32, mb, dev) for x in (mv_y, mv_x, full_my,
                                                 full_mx, cost16)),
            _packed(pred16, U8, mb + (16, 16), dev), parts, mb_width,
            mb_height, zero_thr)


def inter_residual_plain(src_y_mb, src_u_mb, src_v_mb, u_pad, v_pad, lane,
                         row0, qp, qpc, mv_y, mv_x, full_my, full_mx, cost16,
                         pred16, parts, mb_width: int, mb_height: int,
                         zero_thr: bool = True) -> dict:
    """`inter_residual` in plain PyTorch, on any device: the CPU path and
    the version K7 is held against. Returns mv4_y, mv4_x, shape,
    inter_cost (int32), lev_inter, recon_*_inter, cdc_inter and cac_inter,
    each with the leading (N, nmb)."""
    N, nmb = src_y_mb.shape[:2]
    dev = src_y_mb.device
    K = N * nmb
    qp, qp_k, qpc_k = _qp_views(qp, qpc, N, nmb, mb_width, dev)
    lane = torch.as_tensor(lane, device=dev).reshape(N)
    row0 = torch.as_tensor(row0, dtype=I32, device=dev).reshape(N)
    idx = torch.arange(nmb, dtype=I32, device=dev)
    rr = idx // mb_width
    cc = idx % mb_width
    mv4_y = mv_y.reshape(K, 1, 1).expand(K, 4, 4)
    mv4_x = mv_x.reshape(K, 1, 1).expand(K, 4, 4)
    shape = torch.zeros((K,), dtype=I32, device=dev)
    inter_cost = cost16.reshape(K)
    pred_y = pred16.reshape(K, 16, 16)
    lane_k = _per_item(lane, nmb)
    cb_y = (qpel.GUARD // 2 + 8 * (rr[None] + row0[:, None])).reshape(K)
    cb_x = (qpel.GUARD // 2 + 8 * cc).repeat(N)
    if parts is not None:
        lam_k = _per_item(lambda_me(qp), nmb)
        costs = torch.stack([
            inter_cost,
            parts["cost16x8"] + lam_k * PART_16X8_PENALTY_BITS,
            parts["cost8x16"] + lam_k * PART_16X8_PENALTY_BITS,
            parts["cost8x8"] + lam_k * PART_8X8_PENALTY_BITS], dim=1)
        inter_cost, shape = costs.min(dim=1)
        inter_cost, shape = inter_cost.to(I32), shape.to(I32)
        # per-4x4-block MV grids of each shape: block row / column halves
        # and the raster 8x8 quadrants
        half = torch.tensor([0, 0, 1, 1], device=dev)
        quad = torch.tensor([[0, 0, 1, 1], [0, 0, 1, 1], [2, 2, 3, 3],
                             [2, 2, 3, 3]], device=dev)
        sh = shape[:, None, None]

        def grid(c, m4):
            m168 = parts["mv16x8"][:, half, c][:, :, None].expand(K, 4, 4)
            m816 = parts["mv8x16"][:, half, c][:, None, :].expand(K, 4, 4)
            m88 = parts["mv8x8"][:, quad, c]
            return torch.where(sh == 1, m168, torch.where(
                sh == 2, m816, torch.where(sh == 3, m88, m4)))
        mv4_y, mv4_x = grid(0, mv4_y), grid(1, mv4_x)
        pred_y = torch.where(sh == 1, parts["pred16x8"], torch.where(
            sh == 2, parts["pred8x16"], torch.where(
                sh == 3, parts["pred8x8"], pred_y.to(I32)))).to(torch.uint8)
        # one MV per 4x4 block: the general chroma MC
        pred_u, pred_v = (qpel.mc_chroma_grid(p, lane_k, mv4_y, mv4_x, cb_y,
                                              cb_x) for p in (u_pad, v_pad))
    else:
        pred_u, pred_v = qpel.mc_chroma_uniform(
            u_pad, v_pad, lane_k, cb_y, cb_x, full_my.reshape(K),
            full_mx.reshape(K), mv_y.reshape(K), mv_x.reshape(K))
    lev_inter, recon_y = _encode_inter_luma(
        src_y_mb.reshape(K, 16, 16), pred_y, qp_k, zero_thr)
    # u and v batched through one chroma TQ
    cdc, cac, recon_uv = _encode_chroma(
        torch.cat([src_u_mb.reshape(K, 8, 8), src_v_mb.reshape(K, 8, 8)]),
        torch.cat([pred_u, pred_v]), torch.cat([qpc_k, qpc_k]),
        INTER_DEADZONE_Q8)

    def frames(x):
        return _frames(x, N, nmb)
    return dict(mv4_y=frames(mv4_y), mv4_x=frames(mv4_x),
                shape=frames(shape), inter_cost=frames(inter_cost),
                lev_inter=frames(lev_inter), recon_y_inter=frames(recon_y),
                recon_u_inter=frames(recon_uv[:K]),
                recon_v_inter=frames(recon_uv[K:]),
                cdc_inter=frames(torch.stack([cdc[:K], cdc[K:]], dim=1)),
                cac_inter=frames(torch.stack([cac[:K], cac[K:]], dim=1)))


def motion_search_args(src_y_mb, ref, lane, row0, qp, prev_my, prev_mx):
    """`inter_stage_core`'s 16x16 search arguments in the form K4
    (`me.motion_search_tiles`) takes them, on the tiles' device: the
    lanes' y_pad and y4_pad, the tiles as contiguous 16-byte aligned
    uint8, lane, row0 and the first-row qp as (N,) int32, and the previous
    MVs as (N, nmb) int32 (or Nones)."""
    N, nmb = src_y_mb.shape[:2]
    dev = src_y_mb.device
    prev = [None if p is None else _packed(p, I32, (N, nmb), dev)
            for p in (prev_my, prev_mx)]
    return (ref["y_pad"].contiguous(), ref["y4_pad"].contiguous(),
            _packed(src_y_mb, torch.uint8, (N, nmb, 16, 16), dev),
            *(_packed(x, I32, (N,), dev) for x in (lane, row0, qp)), *prev)


# ---------------------------------------------------------------------------
# stage 2: mode selection (P slices: fully parallel; I slices: the slope-2
# wavefront)
# ---------------------------------------------------------------------------

def select_stage_core(src_y_mb, src_u_mb, src_v_mb, qp, qpc, steps,
                      avail_top, avail_left, inter, mb_width: int,
                      mb_height: int, enable_i4x4: bool = False):
    """Mode selection + intra encode of N frames/bands.

    src_*_mb (N, nmb, t, t) uint8; qp/qpc (N,) int, or per MB row (N,
    mb_height) on the parallel P path only; steps: the slope-2
    `wavefront.make_plan` steps; avail_top/avail_left (nmb,) bool; inter:
    `inter_stage_core`'s output (P slices) or None (I slices). I slices
    take the wavefront with Intra_4x4; P slices take it too, with the
    inter candidate, when `enable_i4x4` (speeds 0 and 1), and else the
    fully parallel path without Intra_4x4. Returns the JAX stage's dict,
    each entry with the leading N axis; MVs of intra MBs are zero."""
    if torch.as_tensor(qp).ndim == 2 and (inter is None or enable_i4x4):
        raise NotImplementedError(
            "per-row QP requires the fully-parallel P path "
            "(encode_speed >= 2)")
    if inter is not None and not enable_i4x4:
        return select_parallel(src_y_mb, src_u_mb, src_v_mb, qp, qpc,
                               avail_top, avail_left, inter, mb_width)
    out = _select_wavefront(src_y_mb, src_u_mb, src_v_mb, qp, qpc, steps,
                            avail_top, avail_left, mb_width, inter)
    if inter is None:           # every MB intra: zero MVs and inter levels
        out.update(_inter_dummies(*src_y_mb.shape[:2], src_y_mb.device))
        return out
    return _merge_inter(out, inter)


def _merge_inter(out: dict, inter: dict) -> dict:
    """The selection's fields merged with the inter stage's: chroma levels
    of inter MBs from `inter`, MVs and shapes of intra MBs zeroed, and
    lev_inter passed through."""
    is_intra = out["sel"] != SEL_INTER
    m4 = is_intra[..., None, None]
    m6 = m4[..., None, None]
    out["cdc_lev"] = torch.where(m4[..., None], out["cdc_lev"],
                                 inter["cdc_inter"])
    out["cac_lev"] = torch.where(m6[..., None], out["cac_lev"],
                                 inter["cac_inter"])
    for k in ("mv_y", "mv_x", "shape"):
        out[k] = torch.where(is_intra, 0, inter[k])
    for k in ("mv4_y", "mv4_x"):
        out[k] = torch.where(m4, 0, inter[k])
    out["lev_inter"] = inter["lev_inter"]
    return out


# the stage-1 outputs of an intra frame (no inter candidate)
_INTRA_ZEROS = dict(mv_y=(), mv_x=(), shape=(), mv4_y=(4, 4), mv4_x=(4, 4),
                    lev_inter=(4, 4, 4, 4))


def _inter_dummies(N: int, nmb: int, dev) -> dict:
    """Zero MVs, partition shapes and inter levels of intra frames: views
    of one zeroed buffer, one fill on the device."""
    sizes = [N * nmb * int(np.prod(s)) for s in _INTRA_ZEROS.values()]
    flat = torch.zeros(sum(sizes), dtype=I32, device=dev)
    return {k: x.view((N, nmb) + shape) for (k, shape), x in zip(
        _INTRA_ZEROS.items(), flat.split(sizes))}


def select_parallel(src_y_mb, src_u_mb, src_v_mb, qp, qpc, avail_top,
                    avail_left, inter, mb_width: int) -> dict:
    """The fully parallel P path (speeds 2 and up): an MB may be
    Intra_16x16 only if its in-slice left and top neighbours are inter
    (decided on the pre-selection "wants intra" mask), so every intra
    prediction reads inter recon from stage 1 and all MBs encode in one
    batch; then the merge with the inter fields (`_merge_inter`). The one
    entry of every encode path. On CUDA tensors K8
    (`residual.select_tiles`, `csrc/select.cu`, one launch) on
    `select_parallel_args`' packing; on CPU tensors
    `select_parallel_plain`."""
    args = (src_y_mb, src_u_mb, src_v_mb, qp, qpc, avail_top, avail_left,
            inter, mb_width)
    if src_y_mb.device.type == "cpu":
        return select_parallel_plain(*args)
    out = residual.select_tiles(*select_parallel_args(*args))
    out["lev_inter"] = inter["lev_inter"]
    return out


def select_parallel_args(src_y_mb, src_u_mb, src_v_mb, qp, qpc, avail_top,
                         avail_left, inter, mb_width: int):
    """`select_parallel`'s arguments in the form K8
    (`residual.select_tiles`) takes them, on the tiles' device: the tiles
    (and the inter recon tiles) as contiguous 16-byte aligned uint8; qp and
    qpc (N,) or (N, mb_height) int32; avail_top and avail_left as one (2,
    nmb) uint8 tensor (`_device_avail`); the inter stage's cost, chroma
    levels, MVs and shape as contiguous int32 (cac_inter 16-byte
    aligned); mb_width."""
    N, nmb = src_y_mb.shape[:2]
    dev = src_y_mb.device
    mb = (N, nmb)
    q = torch.as_tensor(qp)
    qshape = (N, nmb // mb_width) if q.ndim == 2 else (N,)
    return (_packed(src_y_mb, U8, mb + (16, 16), dev),
            _packed(src_u_mb, U8, mb + (8, 8), dev),
            _packed(src_v_mb, U8, mb + (8, 8), dev),
            _packed(qp, I32, qshape, dev), _packed(qpc, I32, qshape, dev),
            _device_avail(avail_top, avail_left, nmb, dev),
            _packed(inter["inter_cost"], I32, mb, dev),
            _packed(inter["recon_y_inter"], U8, mb + (16, 16), dev),
            _packed(inter["recon_u_inter"], U8, mb + (8, 8), dev),
            _packed(inter["recon_v_inter"], U8, mb + (8, 8), dev),
            _packed(inter["cdc_inter"], I32, mb + (2, 2, 2), dev),
            _packed(inter["cac_inter"], I32, mb + (2, 2, 2, 4, 4), dev),
            _packed(inter["mv_y"], I32, mb, dev),
            _packed(inter["mv_x"], I32, mb, dev),
            _packed(inter["mv4_y"], I32, mb + (4, 4), dev),
            _packed(inter["mv4_x"], I32, mb + (4, 4), dev),
            _packed(inter["shape"], I32, mb, dev), mb_width)


def _device_avail(avail_top, avail_left, nmb: int, dev) -> torch.Tensor:
    """avail_top and avail_left (host masks, as the encoders' plans hold
    them) as one (2, nmb) uint8 tensor on `dev`, copied once per distinct
    pair of masks and device (`_avail_on`): a copy from host memory would
    wait for the device at every call."""
    masks = np.stack([np.broadcast_to(np.asarray(a, dtype=bool), (nmb,))
                      for a in (avail_top, avail_left)])
    return _avail_on(np.packbits(masks).tobytes(), nmb, str(dev))


@functools.lru_cache(maxsize=16)
def _avail_on(bits: bytes, nmb: int, dev: str) -> torch.Tensor:
    masks = np.unpackbits(np.frombuffer(bits, np.uint8))[:2 * nmb]
    return torch.from_numpy(masks.reshape(2, nmb).copy()).to(dev)


def select_parallel_plain(src_y_mb, src_u_mb, src_v_mb, qp, qpc, avail_top,
                          avail_left, inter, mb_width: int) -> dict:
    """`select_parallel` in plain PyTorch, on any device: the CPU path and
    the version K8 is held against."""
    N, nmb = src_y_mb.shape[:2]
    dev = src_y_mb.device
    K = N * nmb
    qp0, qp_k, qpc_k = _qp_views(qp, qpc, N, nmb, mb_width, dev)
    at = torch.as_tensor(avail_top, device=dev).bool()
    al = torch.as_tensor(avail_left, device=dev).bool()
    at_k, al_k = at.repeat(N), al.repeat(N)
    lam_k = _per_item(lambda_me(qp0), nmb)
    ry, ru, rv = (inter[k] for k in ("recon_y_inter", "recon_u_inter",
                                     "recon_v_inter"))

    def above(edge, n):                  # the MB above's edge; zeros on row 0
        return torch.cat([torch.zeros_like(edge[:, :mb_width]),
                          edge[:, :-mb_width]], dim=1).reshape(K, n)

    def left(edge, n):                   # the previous MB's edge
        return torch.cat([torch.zeros_like(edge[:, :1]), edge[:, :-1]],
                         dim=1).reshape(K, n)

    src_y = src_y_mb.reshape(K, 16, 16)
    preds, valid16 = intra.predict_16x16(above(ry[:, :, 15, :], 16),
                                         left(ry[:, :, :, 15], 16),
                                         at_k, al_k)
    mode16, pred_y16, cost16 = intra.select_mode(src_y, preds, valid16)
    icost16 = cost16 + lam_k * INTRA_IN_P_PENALTY_BITS
    want = (icost16 < inter["inter_cost"].reshape(K)).reshape(N, nmb)
    want_l = torch.cat([torch.zeros_like(want[:, :1]), want[:, :-1]], dim=1)
    want_t = torch.cat([torch.zeros_like(want[:, :mb_width]),
                        want[:, :-mb_width]], dim=1)
    is_i16 = want & ~(want_l & al) & ~(want_t & at)
    sel = torch.where(is_i16, SEL_I16, SEL_INTER).to(I32)
    dc_lev, ac_lev, rec_y16 = _encode_luma_i16(src_y, pred_y16, qp_k)

    # chroma intra (u and v batched), edges from inter recon
    top_c = torch.cat([above(ru[:, :, 7, :], 8), above(rv[:, :, 7, :], 8)])
    left_c = torch.cat([left(ru[:, :, :, 7], 8), left(rv[:, :, :, 7], 8)])
    preds_c, valid_c = intra.predict_chroma(top_c, left_c,
                                            torch.cat([at_k, at_k]),
                                            torch.cat([al_k, al_k]))
    src_c = torch.cat([src_u_mb.reshape(K, 8, 8), src_v_mb.reshape(K, 8, 8)])
    ccost2 = intra.sad(src_c[:, None], preds_c)
    ccost = torch.where(valid_c[:K], ccost2[:K] + ccost2[K:], INVALID_COST)
    cmode = ccost.argmin(dim=1).to(I32)
    pred_c = intra.pick(preds_c, torch.cat([cmode, cmode]))
    cdc_c, cac_c, rec_c = _encode_chroma(src_c, pred_c,
                                         torch.cat([qpc_k, qpc_k]),
                                         INTRA_DEADZONE_Q8)

    def frames(x):
        return _frames(x, N, nmb)
    m = is_i16[..., None, None]
    out = dict(
        sel=sel, mode16=frames(mode16), cmode=frames(cmode),
        dc_lev=frames(dc_lev), ac_lev=frames(ac_lev),
        cdc_lev=frames(torch.stack([cdc_c[:K], cdc_c[K:]], dim=1)),
        cac_lev=frames(torch.stack([cac_c[:K], cac_c[K:]], dim=1)),
        recon_y=torch.where(m, frames(rec_y16), ry),
        recon_u=torch.where(m, frames(rec_c[:K]), ru),
        recon_v=torch.where(m, frames(rec_c[K:]), rv),
        i4modes=torch.full((N, nmb, 16), 2, dtype=I32, device=dev),
        i4sym_v=torch.zeros((N, nmb, 16), dtype=I32, device=dev),
        i4sym_l=torch.zeros((N, nmb, 16), dtype=I32, device=dev))
    return _merge_inter(out, inter)


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


def _packed(x, dtype, shape, dev):
    """`x` as a contiguous, 16-byte aligned `dtype` tensor of `shape` on
    `dev`, the form the hand kernels take; no copy when it is one."""
    x = torch.as_tensor(x, device=dev).reshape(shape).to(dtype).contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _select_wavefront(src_y_mb, src_u_mb, src_v_mb, qp, qpc,
                      steps, avail_top, avail_left, mb_width: int,
                      inter=None):
    """The slope-2 wavefront (Intra_16x16, Intra_4x4, chroma) over N
    frames/bands: of I slices, or of P slices with the inter candidate of
    `inter` (its cost and recon; both intra costs then carry
    INTRA_IN_P_PENALTY_BITS, and inter wins ties).

    The one entry of every encode path. On CUDA tensors: one launch of K3
    (`wavefront.wavefront_tiles`, `csrc/wavefront.cu`) for the whole
    batch, which follows the row rule itself and does not read `steps`.
    On CPU tensors: `_select_wavefront_plain`."""
    args = (src_y_mb, src_u_mb, src_v_mb, qp, qpc, steps, avail_top,
            avail_left, mb_width, inter)
    if src_y_mb.device.type == "cpu":
        return _select_wavefront_plain(*args)
    return wavefront.wavefront_tiles(*select_wavefront_args(*args))


def select_wavefront_args(src_y_mb, src_u_mb, src_v_mb, qp, qpc, steps,
                          avail_top, avail_left, mb_width: int, inter=None):
    """`_select_wavefront`'s arguments in the form K3
    (`wavefront.wavefront_tiles`) takes them, on the tiles' device: the
    source tiles (and the inter candidate's recon tiles) as contiguous
    16-byte aligned uint8; qp and qpc (N,) int32; lam = `lambda_me(qp)`
    and the intra-in-P penalty (0 without `inter`) as (N,) int32, made
    here so that `ops/tuning.py`'s overrides reach the kernel; avail_top
    and avail_left as (nmb,) uint8, copied to the device in one transfer;
    the inter cost (N, nmb) int32 or four Nones; mb_width,
    INTRA_DEADZONE_Q8 and I4_PENALTY_BITS. `steps` is not used: K3 orders
    the MBs itself. Raises ValueError when the first MB row has avail_top
    or the first column avail_left set: the plain version reads clamped
    records there, K3 treats them as unavailable."""
    N, nmb = src_y_mb.shape[:2]
    dev = src_y_mb.device
    mb = (N, nmb)
    qp = torch.as_tensor(qp, dtype=I32, device=dev).reshape(N).contiguous()
    qpc = torch.as_tensor(qpc, dtype=I32, device=dev).reshape(N).contiguous()
    lam = lambda_me(qp).to(I32).contiguous()
    pen = lam * INTRA_IN_P_PENALTY_BITS if inter is not None \
        else torch.zeros_like(lam)
    avail = np.stack([np.broadcast_to(np.asarray(a, dtype=bool), (nmb,))
                      for a in (avail_top, avail_left)])
    if avail[0, :mb_width].any() or avail[1, ::mb_width].any():
        raise ValueError("select_wavefront_args: avail_top is set on the "
                         "first MB row or avail_left on the first column")
    avail = torch.from_numpy(avail.astype(np.uint8)).to(dev)
    if inter is None:
        cand = (None,) * 4
    else:
        cand = (_packed(inter["inter_cost"], I32, mb, dev),
                _packed(inter["recon_y_inter"], U8, mb + (16, 16), dev),
                _packed(inter["recon_u_inter"], U8, mb + (8, 8), dev),
                _packed(inter["recon_v_inter"], U8, mb + (8, 8), dev))
    return (_packed(src_y_mb, U8, mb + (16, 16), dev),
            _packed(src_u_mb, U8, mb + (8, 8), dev),
            _packed(src_v_mb, U8, mb + (8, 8), dev),
            qp, qpc, lam, pen, avail[0], avail[1], *cand, mb_width,
            INTRA_DEADZONE_Q8, I4_PENALTY_BITS)


def _select_wavefront_plain(src_y_mb, src_u_mb, src_v_mb, qp, qpc,
                            steps, avail_top, avail_left, mb_width: int,
                            inter=None):
    """`_select_wavefront` in plain PyTorch, on any device: the CPU path
    and the version K3 is held against. A Python loop over the diagonals
    of the slope-2 plan `steps`; within a step all live MBs of all N
    frames form one batch."""
    N, nmb = src_y_mb.shape[:2]
    dev = src_y_mb.device
    qp = torch.as_tensor(qp, dtype=I32, device=dev).reshape(N)
    qpc = torch.as_tensor(qpc, dtype=I32, device=dev).reshape(N)
    lam = lambda_me(qp)
    pen = lam * INTRA_IN_P_PENALTY_BITS if inter is not None \
        else torch.zeros_like(lam)

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
        qpk, qpck, lamk, penk = (_per_item(x, k)
                                 for x in (qp, qpc, lam, pen))
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

        # selection over (inter, I16, I4); the first minimum wins ties
        inter_cost = (gather(inter["inter_cost"], cidx) if inter is not None
                      else torch.full_like(cost16, INVALID_COST))
        costs = torch.stack([inter_cost, cost16 + penk, cost4 + penk], dim=1)
        sel = costs.argmin(dim=1).to(I32)
        is_i4 = sel == SEL_I4
        rec_y = torch.where(is_i4[:, None, None], i4["recon"], rec_y16)
        rec_u, rec_v = rec_c[:K], rec_c[K:]
        if inter is not None:
            is_inter = (sel == SEL_INTER)[:, None, None]
            rec_y, rec_u, rec_v = (
                torch.where(is_inter, gather(inter[name], cidx), rec)
                for name, rec in (("recon_y_inter", rec_y),
                                  ("recon_u_inter", rec_u),
                                  ("recon_v_inter", rec_v)))
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
    avail_top = torch.as_tensor(avail_top, device=dev).bool()
    avail_left = torch.as_tensor(avail_left, device=dev).bool()
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
    """In-loop deblocking of N frames/bands at per-frame (N,) QPs, or at
    per-MB (N, nmb) decoded QPs (`mb_qp_delta`): then an MB edge takes
    the two MBs' average QP and the inner edges the MB's own (spec
    8.7.2.1), chroma likewise from the per-MB chroma QPs. avail_top and
    avail_left: a bool, or per MB (nmb,). Returns the filtered (df_y,
    df_u, df_v) uint8 tiles.

    The one entry of every encode path. On CUDA tensors: one launch of K2
    (`deblock.deblock_tiles`, `csrc/deblock.cu`), which derives bS and
    the edge QPs itself, for the whole batch. On CPU tensors:
    `deblock_frame_plain`."""
    args = (recon_y, recon_u, recon_v, sel, nnz_blk, mv4_y, mv4_x, qp, qpc,
            avail_top, avail_left, mb_width, mb_height)
    if recon_y.device.type == "cpu":
        return deblock_frame_plain(*args)
    return deblock.deblock_tiles(*deblock_tiles_args(*args))


def deblock_tiles_args(recon_y, recon_u, recon_v, sel, nnz_blk, mv4_y,
                       mv4_x, qp, qpc, avail_top, avail_left,
                       mb_width: int, mb_height: int):
    """`deblock_frame`'s arguments in the form K2 (`deblock.deblock_tiles`)
    takes them, on the tiles' device: the tiles as contiguous uint8, sel,
    nnz_blk, the MVs and the QPs as contiguous int32 (the QPs (N,) per
    frame or (N, nmb) per MB), avail_top and avail_left as (nmb,) uint8,
    mb_width and mb_height. The tiles and the blocks' arrays are 16-byte
    aligned. On the encode paths every tensor is in that form already, so
    the packing is one copy of the availability to the device."""
    N, nmb = sel.shape
    dev = recon_y.device
    mb = (N, nmb)
    if any(isinstance(a, torch.Tensor) for a in (avail_top, avail_left)):
        avail = torch.stack([torch.as_tensor(a, device=dev).to(
            torch.uint8).expand(nmb) for a in (avail_top, avail_left)])
    else:                       # host flags: one copy
        avail = torch.from_numpy(np.stack([np.broadcast_to(np.asarray(
            a, dtype=np.uint8), (nmb,)) for a in (avail_top, avail_left)])
        ).to(dev)
    qp_shape = (N, nmb) if torch.as_tensor(qp).ndim == 2 else (N,)
    return (_packed(recon_y, U8, mb + (16, 16), dev),
            _packed(recon_u, U8, mb + (8, 8), dev),
            _packed(recon_v, U8, mb + (8, 8), dev),
            _packed(sel, I32, mb, dev),
            *(_packed(x, I32, mb + (4, 4), dev) for x in (nnz_blk, mv4_y,
                                                           mv4_x)),
            _packed(qp, I32, qp_shape, dev), _packed(qpc, I32, qp_shape, dev),
            avail[0], avail[1], mb_width, mb_height)


def deblock_frame_plain(recon_y, recon_u, recon_v, sel, nnz_blk, mv4_y,
                        mv4_x, qp, qpc, avail_top, avail_left,
                        mb_width: int, mb_height: int):
    """`deblock_frame` in plain PyTorch, on any device: the CPU path and
    the version K2 is held against.

    bS is derived in parallel; the filter walks slope-1 diagonals and runs
    the V pass of the whole diagonal before its H pass: the one raster
    dependency inside a diagonal — MB (r, c)'s top-edge H filter reading
    pixels that MB (r-1, c+1)'s left-edge V filter wrote — is met because
    the H pass reads the tiles after every V write of the diagonal."""
    N, nmb = sel.shape
    dev = sel.device
    mbh, mbw = mb_height, mb_width
    qp = torch.as_tensor(qp, dtype=I32, device=dev)
    qpc = torch.as_tensor(qpc, dtype=I32, device=dev)
    per_mb = qp.ndim == 2
    if per_mb:
        qv, qh, qcv, qch = deblock.edge_qps(qp, qpc, N, mbw, mbh)
    else:
        qp, qpc = qp.reshape(N), qpc.reshape(N)
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
        if per_mb:
            qkv, qkh, qckv, qckh = (x[:, mbi].reshape(K, -1)
                                    for x in (qv, qh, qcv, qch))
        else:
            qkv = qkh = _per_item(qp, k)
            qckv = qckh = _per_item(qpc, k)
        r1, c1 = r + 1, c + 1

        # luma V: 4 left columns from the left neighbour
        strip = torch.cat([ty[:, r1, c, :, 12:16], ty[:, r1, c1]], dim=-1)
        deblock.filter_luma_v(strip.view(K, 16, 20), bv, qkv, edge_x0=4)
        ty[:, r1, c, :, 13:16] = strip[..., 1:4]
        ty[:, r1, c1] = strip[..., 4:20]
        # luma H: 4 top rows from the top neighbour (after the V writes)
        strip = torch.cat([ty[:, r, c1, 12:16, :], ty[:, r1, c1]], dim=-2)
        deblock.filter_luma_h(strip.view(K, 20, 16), bh, qkh, edge_y0=4)
        ty[:, r, c1, 13:16, :] = strip[..., 1:4, :]
        ty[:, r1, c1] = strip[..., 4:20, :]

        # chroma, u and v on a plane axis
        strip = torch.cat([tc[:, r1, c, :, :, 6:8], tc[:, r1, c1]], dim=-1)
        deblock.filter_chroma_v(strip.view(K, 2, 8, 10), bv, qckv,
                                edge_x0=2)
        tc[:, r1, c, :, :, 7:8] = strip[..., 1:2]
        tc[:, r1, c1] = strip[..., 2:10]
        strip = torch.cat([tc[:, r, c1, :, 6:8, :], tc[:, r1, c1]], dim=-2)
        deblock.filter_chroma_h(strip.view(K, 2, 10, 8), bh, qckh,
                                edge_y0=2)
        tc[:, r, c1, :, 7:8, :] = strip[..., 1:2, :]
        tc[:, r1, c1] = strip[..., 2:10, :]

    df_y = ty[:, 1:, 1:].reshape(N, nmb, 16, 16).to(torch.uint8)
    df_c = tc[:, 1:, 1:].reshape(N, nmb, 2, 8, 8).to(torch.uint8)
    return df_y, df_c[:, :, 0], df_c[:, :, 1]


def deblock_stage_core(recon_y, recon_u, recon_v, sel, lev_inter, mv4_y,
                       mv4_x, qp, qpc, avail_top, avail_left, mb_width: int,
                       mb_height: int):
    """Stage 4: in-loop deblocking of N frames/bands; bS sees the coded
    inter blocks (nonzero counts of `lev_inter`) and the MVs."""
    nnz_inter_blk = (lev_inter != 0).sum((-2, -1), dtype=I32)
    return deblock_frame(recon_y, recon_u, recon_v, sel, nnz_inter_blk,
                         mv4_y, mv4_x, qp, qpc, avail_top, avail_left,
                         mb_width, mb_height)




# ---------------------------------------------------------------------------
# stage 3: symbolization (I and P slices)
# ---------------------------------------------------------------------------

def _block_nc(nnz_grid, blk_avail_left, blk_avail_top):
    """nC from the left/top 4x4 neighbours of a (N, gh, gw) nnz grid."""
    na = torch.nn.functional.pad(nnz_grid, (1, 0))[..., :-1]
    nb = torch.nn.functional.pad(nnz_grid, (0, 0, 1, 0))[..., :-1, :]
    return torch.where(blk_avail_left & blk_avail_top, (na + nb + 1) >> 1,
                       torch.where(blk_avail_left, na,
                                   torch.where(blk_avail_top, nb, 0)))


def cbp_luma_bits(nnz):
    """The coded_block_pattern luma bits of (..., 4, 4) per-block nonzero
    counts (raster blocks): bit g is set when 8x8 quarter g holds one."""
    gnz = nnz.reshape(nnz.shape[:-2] + (2, 2, 2, 2)).transpose(-3, -2).sum(
        (-2, -1)) > 0
    return (gnz[..., 0, 0].to(I32) + 2 * gnz[..., 0, 1]
            + 4 * gnz[..., 1, 0] + 8 * gnz[..., 1, 1])


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


def _mv_predictors(mv4_y, mv4_x, is_intra, mb_width: int, mb_height: int):
    """Per-partition MV predictors over the 4x4-block MV grid of N slices
    (spec 8.4.1.3 with the directional 16x8/8x16 rules and the neighbour
    availability of partitions in decode order) and the P_Skip predictor
    (8.4.1.1). mv4_* (N, nmb, 4, 4); is_intra (N, nmb). Returns (mvp,
    skip_y, skip_x): mvp[shape][part] = (mvp_y, mvp_x), each (N, nmb)."""
    mbh, mbw = mb_height, mb_width
    N = mv4_y.shape[0]
    BH, BW = 4 * mbh, 4 * mbw

    def grid(x):
        return (x.reshape(N, mbh, mbw, 4, 4).permute(0, 1, 3, 2, 4)
                .reshape(N, BH, BW))

    def pad(x):                             # offsets -1..7 stay in range
        return torch.nn.functional.pad(x, (1, 4, 1, 4))

    mvy_p, mvx_p = pad(grid(mv4_y)), pad(grid(mv4_x))
    ref0 = (~is_intra).to(I32).reshape(N, mbh, mbw)
    ref0_p = pad(ref0.repeat_interleave(4, 1).repeat_interleave(4, 2)) > 0
    avail_p = pad(torch.ones((1, BH, BW), dtype=I32,
                             device=mv4_y.device)) > 0

    def blk(dy, dx, static_avail=True):
        """The neighbour block at MB-relative block offset (dy, dx)."""
        def at(arr):
            return arr[:, 1 + dy:1 + dy + BH:4,
                       1 + dx:1 + dx + BW:4].reshape(arr.shape[0], -1)
        avail = at(avail_p) & static_avail
        ref = at(ref0_p) & avail
        return (torch.where(ref, at(mvy_p), 0), torch.where(ref, at(mvx_p), 0),
                ref, avail)

    def derive(a, b, c, d, directional=None):
        """a/b/c/d = (dy, dx, static_avail). Returns (mvp_y, mvp_x)."""
        ay, ax, aref, aav = blk(*a)
        by, bx, bref, bav = blk(*b)
        cy, cx, cref, cav = blk(*c)
        dy_, dx_, dref, dav = blk(*d)
        # C unavailable -> D (8.4.1.3.2)
        cy = torch.where(cav, cy, dy_)
        cx = torch.where(cav, cx, dx_)
        cref = torch.where(cav, cref, dref)
        cav2 = cav | dav
        # B and C unavailable, A available -> A
        subst = (~bav) & (~cav2) & aav
        by = torch.where(subst, ay, by)
        bx = torch.where(subst, ax, bx)
        bref = torch.where(subst, aref, bref)
        cy = torch.where(subst, ay, cy)
        cx = torch.where(subst, ax, cx)
        cref = torch.where(subst, aref, cref)
        cnt = aref.to(I32) + bref.to(I32) + cref.to(I32)
        only_a = (cnt == 1) & aref
        only_b = (cnt == 1) & bref
        only_c = (cnt == 1) & cref
        mvp_y = torch.where(only_a, ay, torch.where(
            only_b, by, torch.where(only_c, cy, median3(ay, by, cy))))
        mvp_x = torch.where(only_a, ax, torch.where(
            only_b, bx, torch.where(only_c, cx, median3(ax, bx, cx))))
        for name, (ry, rx, rref) in (("A", (ay, ax, aref)),
                                     ("B", (by, bx, bref)),
                                     ("C", (cy, cx, cref))):
            if directional == name:
                mvp_y = torch.where(rref, ry, mvp_y)
                mvp_x = torch.where(rref, rx, mvp_x)
        return mvp_y, mvp_x

    def A(dy, dx):
        return (dy, dx, True)
    NO = (0, 0, False)
    out = {
        0: [derive(A(0, -1), A(-1, 0), A(-1, 4), A(-1, -1))],
        1: [derive(A(0, -1), A(-1, 0), A(-1, 4), A(-1, -1), "B"),
            derive(A(2, -1), A(1, 0), NO, A(1, -1), "A")],
        2: [derive(A(0, -1), A(-1, 0), A(-1, 2), A(-1, -1), "A"),
            derive(A(0, 1), A(-1, 2), A(-1, 4), A(-1, 1), "C")],
        3: [derive(A(0, -1), A(-1, 0), A(-1, 2), A(-1, -1)),
            derive(A(0, 1), A(-1, 2), A(-1, 4), A(-1, 1)),
            derive(A(2, -1), A(1, 0), A(1, 2), A(1, -1)),
            derive(A(2, 1), A(1, 2), NO, A(1, 1))],
    }
    # P_Skip predictor (8.4.1.1) from the 16x16 A/B neighbours
    ay, ax, aref, aav = blk(0, -1)
    by, bx, bref, bav = blk(-1, 0)
    force0 = ((~aav) | (~bav) | (aref & (ay == 0) & (ax == 0))
              | (bref & (by == 0) & (bx == 0)))
    skip_y = torch.where(force0, 0, out[0][0][0])
    skip_x = torch.where(force0, 0, out[0][0][1])
    return out, skip_y, skip_x


# partition layouts: top-left block (by, bx) per partition, per shape
_PART_BLOCKS = {
    0: [(0, 0)],
    1: [(0, 0), (2, 0)],
    2: [(0, 0), (0, 2)],
    3: [(0, 0), (0, 2), (2, 0), (2, 2)],
}
_N_PARTS = (1, 2, 2, 4)


def symbolize(sel, mode16, cmode, i4sym_v, i4sym_l, mv4_y, mv4_x, shape,
              dc_lev, ac_lev, lev_inter, cdc_lev, cac_lev, mb_width: int,
              mb_height: int, has_inter: bool, qp_rows=None,
              svc_base_mode_bit: bool = False, base_mode: bool = False):
    """CAVLC + syntax symbol assembly of N I, P or base-mode slices: the
    outputs of `symbolize_plain`, which says what they are.

    The one entry of every encode path. On CUDA tensors: K6
    (`ops/symbolize.symbolize_tiles`, `csrc/symbolize.cu`, three launches
    for the whole batch, two for base-mode slices) on the arguments
    `symbolize_args` packs. On CPU tensors: `symbolize_plain`."""
    args = (sel, mode16, cmode, i4sym_v, i4sym_l, mv4_y, mv4_x, shape,
            dc_lev, ac_lev, lev_inter, cdc_lev, cac_lev, mb_width,
            mb_height, has_inter, qp_rows, svc_base_mode_bit, base_mode)
    if lev_inter.device.type == "cpu":
        return symbolize_plain(*args)
    return symbolize_k6.symbolize_tiles(*symbolize_args(*args))


def symbolize_args(sel, mode16, cmode, i4sym_v, i4sym_l, mv4_y, mv4_x, shape,
                   dc_lev, ac_lev, lev_inter, cdc_lev, cac_lev,
                   mb_width: int, mb_height: int, has_inter: bool,
                   qp_rows=None, svc_base_mode_bit: bool = False,
                   base_mode: bool = False):
    """`symbolize`'s arguments in the form K6
    (`symbolize_k6.symbolize_tiles`) takes them, on `lev_inter`'s device:
    the 13 tensors as contiguous 16-byte aligned int32 of shape (N, nmb) +
    their trailing shapes (a None, the inputs a base-mode slice does not
    read, stays None); qp_rows as (N, mb_height) int32, or None; mb_width and
    mb_height; has_inter, svc_base_mode_bit and base_mode as bools. On the
    encode paths every tensor is in that form already, so nothing is
    copied."""
    N, nmb = lev_inter.shape[:2]
    dev = lev_inter.device
    tensors = (sel, mode16, cmode, i4sym_v, i4sym_l, mv4_y, mv4_x, shape,
               dc_lev, ac_lev, lev_inter, cdc_lev, cac_lev)
    packed = tuple(None if x is None else _packed(x, I32, (N, nmb) + trail,
                                                   dev)
                   for x, (_, trail) in zip(tensors, symbolize_k6.INPUTS))
    if qp_rows is not None:
        qp_rows = _packed(qp_rows, I32, (N, mb_height), dev)
    return (*packed, qp_rows, mb_width, mb_height, bool(has_inter),
            bool(svc_base_mode_bit), bool(base_mode))


def symbolize_plain(sel, mode16, cmode, i4sym_v, i4sym_l, mv4_y, mv4_x,
                    shape, dc_lev, ac_lev, lev_inter, cdc_lev, cac_lev,
                    mb_width: int, mb_height: int, has_inter: bool,
                    qp_rows=None, svc_base_mode_bit: bool = False,
                    base_mode: bool = False):
    """CAVLC + syntax symbol assembly of N I, P or base-mode slices in
    plain PyTorch, on any device: the CPU path of `symbolize` and the
    version K6 is held against.

    `svc_base_mode_bit`: the slices are scalable-extension slices with
    `adaptive_base_mode_flag=1`, so every coded macroblock_layer leads
    with a base_mode_flag=0 bit (G.7.3.6.1).

    `base_mode`: the slices are SVC base-mode slices (`models/svc.py`,
    reference `src/h264-lab.h:5754-5764`): every MB is coded, none
    skipped, with base_mode_flag=1 and its residual coded inter-style
    from `lev_inter`, `cdc_lev` and `cac_lev`, the only inputs it takes
    (the others None). Its header (unit 0) is slot 0 base_mode_flag `1`,
    slot 1 the coded_block_pattern (ue, the inter column), slot 2
    mb_qp_delta se(0) = `1` where the cbp is not 0, every other slot 0
    with length 0; its luma-DC unit (unit 1) is empty, values too; there
    is no slice tail; nC reads one slice of coded MBs.

    `qp_rows` ((N, mb_height) or None): a per-MB-row QP plan; every MB
    that carries `mb_qp_delta` codes the step from the running QP (spec
    7.4.5), where without a plan it codes se(0).

    Returns dict(sym_vals (N, nmb, 952) int32 (uint32 bit patterns),
    sym_lens (N, nmb, 952) int32, tail_val/tail_len (N,) (the trailing
    skip run of a P slice, appended after the MB bits), total_bits (N,)
    int32, tail included, row_bits (N, mb_height) the MB bits of each row,
    skip (N, nmb) bool, cbp and cbpc (N, nmb), the partitions' MV
    differences mvd_py/mvd_px (N, nmb, 4), and with a plan qp_dec (N,
    nmb): each MB's decoded running QP, which deblocking takes; an MB
    without `mb_qp_delta` keeps the running QP).
    The unit layout is the JAX module's: unit 0 = 34 MB-header slots,
    units 1..27 = the CAVLC blocks in decode order."""
    N, nmb = lev_inter.shape[:2]
    dev = lev_inter.device
    ns = cavlc.N_SLOTS
    if base_mode:
        given = [name for (name, _), x in zip(symbolize_k6.INPUTS, (
            sel, mode16, cmode, i4sym_v, i4sym_l, mv4_y, mv4_x, shape, dc_lev,
            ac_lev)) if x is not None]
        if given or has_inter or qp_rows is not None or svc_base_mode_bit:
            raise ValueError("a base-mode slice takes lev_inter, cdc_lev and "
                             "cac_lev only, without has_inter, qp_rows or "
                             f"svc_base_mode_bit (given: {given})")
        # every MB inter, no MV, no intra levels
        sel, mode16, cmode, shape = (torch.zeros((N, nmb), dtype=I32,
                                                 device=dev)
                                     for _ in range(4))
        i4sym_v = i4sym_l = torch.zeros((N, nmb, 16), dtype=I32, device=dev)
        mv4_y = mv4_x = dc_lev = torch.zeros((N, nmb, 4, 4), dtype=I32,
                                             device=dev)
        ac_lev = torch.zeros_like(lev_inter)
    zz = torch.as_tensor(tables.ZIGZAG_4x4, dtype=torch.long, device=dev)
    blk_scan = torch.as_tensor(tables.BLOCK_SCAN_4x4, dtype=torch.long,
                               device=dev)
    cbp_code_t = torch.as_tensor(tables.CBP_TO_CODENUM, device=dev)
    is_inter = sel == SEL_INTER
    is_i16 = sel == SEL_I16
    is_i4 = sel == SEL_I4
    is_intra = ~is_inter

    # nnz and cbp (ac_lev: i16 AC levels with DC zeroed, or i4 levels;
    # lev_inter: inter levels)
    nnz_intra = (ac_lev != 0).sum((-2, -1), dtype=I32)         # (N,nmb,4,4)
    nnz_inter = (lev_inter != 0).sum((-2, -1), dtype=I32)
    cdc_nnz = (cdc_lev != 0).sum((-2, -1), dtype=I32)          # (N,nmb,2)
    cac_nnz = (cac_lev != 0).sum((-2, -1), dtype=I32)          # (N,nmb,2,2,2)

    cbpl_i16 = nnz_intra.sum((2, 3)) > 0                       # all or none
    cbpc = torch.where(cac_nnz.sum((2, 3, 4)) > 0, 2,
                       torch.where(cdc_nnz.sum(2) > 0, 1, 0)).to(I32)
    cbp_luma = torch.where(is_i4, cbp_luma_bits(nnz_intra), torch.where(
        is_inter, cbp_luma_bits(nnz_inter),
        torch.where(cbpl_i16, 15, 0))).to(I32)
    cbp = cbp_luma + (cbpc << 4)

    # MV predictors, MVDs of the coded partitions, P_Skip
    mvd_py = torch.zeros((N, nmb, 4), dtype=I32, device=dev)
    mvd_px = torch.zeros((N, nmb, 4), dtype=I32, device=dev)
    if has_inter:
        mvps, skip_y, skip_x = _mv_predictors(mv4_y, mv4_x, is_intra,
                                              mb_width, mb_height)
        for sh in range(4):
            for p, (by, bx) in enumerate(_PART_BLOCKS[sh]):
                mvp_y, mvp_x = mvps[sh][p]
                sel_sh = shape == sh
                mvd_py[..., p] = torch.where(sel_sh, mv4_y[..., by, bx] - mvp_y,
                                             mvd_py[..., p])
                mvd_px[..., p] = torch.where(sel_sh, mv4_x[..., by, bx] - mvp_x,
                                             mvd_px[..., p])
        skip = (is_inter & (shape == 0) & (cbp == 0)
                & (mv4_y[..., 0, 0] == skip_y) & (mv4_x[..., 0, 0] == skip_x))
    else:
        skip = torch.zeros_like(is_inter)
    coded = ~skip

    # nC contexts from the coded nnz
    luma_nnz = torch.where(is_inter[..., None, None], nnz_inter, torch.where(
        (is_i4 | cbpl_i16)[..., None, None], nnz_intra, 0))
    luma_nnz = torch.where(skip[..., None, None], 0, luma_nnz)
    cac_nnz_coded = torch.where(((cbpc == 2) & coded)[..., None, None, None],
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
    if base_mode:
        dc_vals = torch.zeros_like(dc_vals)

    # luma: i16 blocks code their AC-15 view, inter and i4 blocks all 16
    full_lev = torch.where(is_inter[..., None, None, None, None], lev_inter,
                           ac_lev)
    acn = full_lev.reshape(N * nmb * 16, 16)[:, zz]
    aci = ac_lev.reshape(N * nmb * 16, 16)[:, zz]
    aci = torch.cat([aci[:, 1:], torch.zeros_like(aci[:, :1])], dim=1)
    i16_blk = is_i16.repeat_interleave(16).reshape(-1)
    vv, ll, _ = cavlc.encode_blocks(torch.where(i16_blk[:, None], aci, acn),
                                    nc_luma.reshape(-1),
                                    torch.where(i16_blk, 15, 16))
    luma_vals = vv.reshape(N, nmb, 16, ns)
    ll = ll.reshape(N, nmb, 16, ns)
    blk = torch.arange(16, device=dev)
    grp_of_block = (blk // 8) * 2 + (blk % 4) // 2
    bit = (cbp_luma[..., None] >> grp_of_block) & 1
    blk_coded = torch.where(is_i16[..., None], cbpl_i16[..., None],
                            (coded & (is_inter | is_i4))[..., None]
                            & (bit > 0))
    luma_lens = torch.where(blk_coded[..., None], ll, 0)

    # chroma DC
    cdc_vals, cdc_lens, _ = cavlc.encode_blocks(
        torch.nn.functional.pad(cdc_lev.reshape(N * nmb * 2, 4), (0, 12)),
        torch.full((N * nmb * 2,), -1, dtype=I32, device=dev), 4)
    cdc_lens = torch.where(((cbpc >= 1) & coded)[..., None, None],
                           cdc_lens.reshape(N, nmb, 2, ns), 0)

    # chroma AC
    cacf = cac_lev.reshape(N * nmb * 8, 16)[:, zz][:, 1:]
    cac_vals, cac_lens, _ = cavlc.encode_blocks(
        torch.nn.functional.pad(cacf, (0, 1)), nc_chroma.reshape(-1), 15)
    cac_lens = torch.where(((cbpc == 2) & coded)[..., None, None],
                           cac_lens.reshape(N, nmb, 8, ns), 0)

    # MB header symbols: skip run, base_mode, mb_type, 4 sub_mb_type, 8
    # mvd, 16 i4 modes, chroma mode, cbp, dQP (the JAX slot layout)
    i16code = 1 + mode16 + 4 * cbpc + 12 * cbpl_i16.to(I32)
    zero = torch.zeros((N,), dtype=I32, device=dev)
    if has_inter:
        skip_i = skip.to(I32)
        s_cum = torch.cumsum(skip_i, dim=1, dtype=I32)
        marker = torch.where(coded, s_cum, -1)
        run_base = torch.cummax(marker, dim=1).values
        run_base_prev = torch.cat([torch.zeros_like(run_base[:, :1]),
                                   run_base[:, :-1].clamp(min=0)], dim=1)
        skip_run = torch.where(coded, s_cum - skip_i - run_base_prev, 0)
        sr_v, sr_l = _ue_codes(skip_run.clamp(min=0))
        sr_l = torch.where(coded, sr_l, 0)
        trailing = s_cum[:, -1] - marker.max(dim=1).values.clamp(min=0)
        tr_v, tr_l = _ue_codes(trailing.clamp(min=0))
        tr_l = torch.where(trailing > 0, tr_l, 0)
        mb_type = torch.where(is_inter, shape,
                              torch.where(is_i4, 5, 5 + i16code))
    else:
        sr_v = sr_l = torch.zeros((N, nmb), dtype=I32, device=dev)
        tr_v = tr_l = zero
        mb_type = torch.where(is_i4, 0, i16code)
    mt_v, mt_l = _ue_codes(mb_type)
    mt_l = torch.where(coded, mt_l, 0)

    inter_coded = coded & is_inter
    n_parts = torch.as_tensor(_N_PARTS, device=dev)[shape.clamp(0, 3).long()]
    # sub_mb_type: P_8x8 emits four ue(0) ("1") entries
    sub_l = (inter_coded & (shape == 3))[..., None].to(I32).expand(N, nmb, 4)
    # per-partition MVDs, interleaved (x, y) per partition
    part_active = ((torch.arange(4, device=dev) < n_parts[..., None])
                   & inter_coded[..., None])
    mvdx_v, mvdx_l = _se_codes(mvd_px)
    mvdy_v, mvdy_l = _se_codes(mvd_py)
    mvd_vals = torch.stack([mvdx_v, mvdy_v], dim=3).reshape(N, nmb, 8)
    mvd_lens = torch.stack([torch.where(part_active, mvdx_l, 0),
                            torch.where(part_active, mvdy_l, 0)],
                           dim=3).reshape(N, nmb, 8)

    cm_v, cm_l = _ue_codes(cmode)
    cbp_c = torch.clamp(cbp, 0, 47).long()
    cbpv, cbpl_ = _ue_codes(torch.where(is_i4, cbp_code_t[cbp_c, 0],
                                        cbp_code_t[cbp_c, 1]))
    zero1 = torch.zeros((N, nmb, 1), dtype=I32, device=dev)
    one1 = torch.ones((N, nmb, 1), dtype=I32, device=dev)

    # mb_qp_delta: se(0) = '1' without a row plan; with one, the step from
    # the QP of the last MB before this one that carried a dQP
    dqp_needed = coded & (is_i16 | (cbp != 0))
    qp_dec = None
    if qp_rows is None:
        dqp_v = one1[..., 0]
        dqp_l = dqp_needed.to(I32)
    else:
        qp_rows = torch.as_tensor(qp_rows, dtype=I32, device=dev)
        qp_mb = qp_rows.repeat_interleave(mb_width, 1)           # (N, nmb)
        idx = torch.arange(nmb, device=dev).expand(N, nmb)
        run_idx = torch.cummax(torch.where(dqp_needed, idx, -1),
                               dim=1).values
        prev_run = torch.cat([torch.full_like(run_idx[:, :1], -1),
                              run_idx[:, :-1]], dim=1)

        def running(i):
            return torch.where(i >= 0, qp_mb.gather(1, i.clamp(min=0)),
                               qp_rows[:, :1])
        dqp_v, dqp_l = _se_codes(qp_mb - running(prev_run))
        dqp_l = torch.where(dqp_needed, dqp_l, 0)
        qp_dec = running(run_idx)

    if base_mode:
        # base_mode_flag, coded_block_pattern, mb_qp_delta
        rest = torch.zeros((N, nmb, ns - 3), dtype=I32, device=dev)
        hdr_vals = torch.cat([one1, cbpv[..., None], one1, rest], dim=2)
        hdr_lens = torch.cat([one1, cbpl_[..., None],
                              (cbp != 0).to(I32)[..., None], rest], dim=2)
    else:
        bm_l = coded.to(I32)[..., None] if svc_base_mode_bit else zero1
        hdr_vals = torch.cat([
            sr_v[..., None], zero1, mt_v[..., None], one1.expand(N, nmb, 4),
            mvd_vals, i4sym_v.to(I32), cm_v[..., None], cbpv[..., None],
            dqp_v[..., None]], dim=2)
        hdr_lens = torch.cat([
            sr_l[..., None], bm_l, mt_l[..., None], sub_l, mvd_lens,
            torch.where(is_i4[..., None], i4sym_l, 0).to(I32),
            torch.where(coded & is_intra, cm_l, 0)[..., None],
            torch.where(coded & (is_inter | is_i4), cbpl_, 0)[..., None],
            dqp_l[..., None]], dim=2)

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
    mb_bits = sym_lens.sum(2, dtype=I32)
    out = dict(sym_vals=sym_vals, sym_lens=sym_lens,
               tail_val=tr_v, tail_len=tr_l,
               total_bits=mb_bits.sum(1, dtype=I32) + tr_l,
               row_bits=mb_bits.reshape(N, mb_height, mb_width).sum(
                   2, dtype=I32),
               skip=skip, cbp=cbp, cbpc=cbpc, mvd_py=mvd_py, mvd_px=mvd_px)
    if qp_dec is not None:
        out["qp_dec"] = qp_dec
    return out


# ---------------------------------------------------------------------------
# one intra frame, whole (the driver entry point's function)
# ---------------------------------------------------------------------------

def encode_intra_core(src_y_mb, src_u_mb, src_v_mb, qp, qpc, steps,
                      avail_top, avail_left, mb_width: int, mb_height: int):
    """One I frame through the slope-2 wavefront (Intra_16x16, Intra_4x4,
    chroma) and CAVLC symbolization, without deblocking: JAX's
    `encode_intra_core` at its defaults, for one frame without the leading
    frame axis. src_*_mb (nmb, t, t) uint8; qp, qpc 0-d int tensors;
    steps, avail_top and avail_left the plan (tensors or arrays; the
    wavefront reads them on the host). Returns JAX's `encode_frame_core`
    dict: `symbolize`'s outputs, recon_* and df_* (the same planes, as
    nothing filters them), mv_*, mv4_*, shape, sel and i4modes."""
    out = encode_intra_frames(src_y_mb[None], src_u_mb[None], src_v_mb[None],
                              qp.reshape(1), qpc.reshape(1), steps,
                              avail_top, avail_left, mb_width, mb_height)
    return {k: v[0] for k, v in out.items()}


def encode_intra_frames(src_y_mb, src_u_mb, src_v_mb, qp, qpc, steps,
                        avail_top, avail_left, mb_width: int,
                        mb_height: int):
    """`encode_intra_core` of N frames at once: src_*_mb (N, nmb, t, t),
    qp and qpc (N,); every output keeps the leading N axis (JAX vmaps
    `encode_intra_core` over it)."""
    steps, avail_top, avail_left = (torch.as_tensor(x).cpu().numpy()
                                    for x in (steps, avail_top, avail_left))
    st = select_stage_core(src_y_mb, src_u_mb, src_v_mb, qp, qpc, steps,
                           avail_top, avail_left, None, mb_width, mb_height)
    out = symbolize(*(st[k] for k in (
        "sel", "mode16", "cmode", "i4sym_v", "i4sym_l", "mv4_y", "mv4_x",
        "shape", "dc_lev", "ac_lev", "lev_inter", "cdc_lev", "cac_lev")),
        mb_width, mb_height, False)
    for k in ("recon_y", "recon_u", "recon_v", "mv_y", "mv_x", "mv4_y",
              "mv4_x", "shape", "sel", "i4modes"):
        out[k] = st[k]
    for p in "yuv":
        out[f"df_{p}"] = st[f"recon_{p}"]
    return out
