"""K7 and K8: the P step's residual coding and its parallel mode decision,
the CUDA kernels of `csrc/inter.cu` and `csrc/select.cu`, built with nvcc
at first use and bound with ctypes.

K7 (`inter_tiles`, one launch) is everything of the `inter` stage after
the motion searches: the partition shape and MV grid (speed 0), chroma
motion compensation, the inter luma TQ with its zero-block kills, the
chroma TQ and the reconstruction. It replaces
`h264lab_tpu/models/mbscan.py:221-293`. K8 (`select_tiles`, one launch)
is the `select` stage of P frames at speeds 2 and up: the Intra_16x16
decision against the inter candidate, the intra TQ and the merge of the
inter fields. It replaces `h264lab_tpu/models/mbscan.py:338-405` with the
merge at `:415-428`. The JAX package left both to XLA; the port ran them
as a few hundred eager operations each. Their plain versions are
`models/mbscan.inter_residual_plain` and `select_parallel_plain`;
`mbscan.inter_residual` and `mbscan.select_parallel` are the entries of
every encode path and pack the kernels' arguments with
`mbscan.inter_residual_args` and `select_parallel_args`.

Both kernels include `csrc/tq.h` (the transform and quantiser helpers)
and its tables `csrc/tq_tables.h`, macros written by `tables_header` from
`ops/tables.py`, `ops/me.py` (the lambda) and `models/mbscan.py` (the
`sel` codes); `python -m h264lab_tpu_torch.ops.residual` writes it anew
and a test holds the committed file equal to `tables_header()`. The
tuning constants (deadzones, kill thresholds, penalties) are arguments,
read from `ops/tuning.py` at each call.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from h264lab_tpu_torch.ops import cuda_build, tables, tuning
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS  # noqa: F401
from h264lab_tpu_torch.ops.qpel import GUARD

K7_SRC = cuda_build.CSRC / "inter.cu"
K8_SRC = cuda_build.CSRC / "select.cu"
HEADER = cuda_build.CSRC / "tq_tables.h"
# each entry point takes one array of 64-bit words: the inputs' and the
# outputs' addresses, then the sizes, flags and the stream (`inter_tiles`,
# `select_tiles`)
_k7 = cuda_build.Library(K7_SRC, {"h264lab_inter_residual": (
    [ctypes.c_void_p], ctypes.c_int)})
_k8 = cuda_build.Library(K8_SRC, {"h264lab_select_parallel": (
    [ctypes.c_void_p], ctypes.c_int)})

I32, U8, I64 = torch.int32, torch.uint8, torch.int64
# K7's outputs in the plain version's order: name, dtype, trailing shape
# after (n, nmb); also the order of its entry point's output pointers
K7_OUTPUTS = (("mv4_y", I32, (4, 4)), ("mv4_x", I32, (4, 4)),
              ("shape", I32, ()), ("inter_cost", I32, ()),
              ("lev_inter", I32, (4, 4, 4, 4)),
              ("recon_y_inter", U8, (16, 16)), ("recon_u_inter", U8, (8, 8)),
              ("recon_v_inter", U8, (8, 8)), ("cdc_inter", I32, (2, 2, 2)),
              ("cac_inter", I32, (2, 2, 2, 4, 4)))
# K5's outputs, which K7 reads at speed 0 (`ops/me.K5_OUTPUTS`' order)
K7_PARTS = (("mv16x8", I32, (2, 2)), ("mv8x16", I32, (2, 2)),
            ("mv8x8", I32, (4, 2)), ("cost16x8", I64, ()),
            ("cost8x16", I64, ()), ("cost8x8", I64, ()),
            ("pred16x8", I32, (16, 16)), ("pred8x16", I32, (16, 16)),
            ("pred8x8", I32, (16, 16)))
# K8's outputs in the plain version's order but lev_inter (the inter
# stage's, passed through)
K8_OUTPUTS = (("sel", I32, ()), ("mode16", I32, ()), ("cmode", I32, ()),
              ("dc_lev", I32, (4, 4)), ("ac_lev", I32, (4, 4, 4, 4)),
              ("cdc_lev", I32, (2, 2, 2)), ("cac_lev", I32, (2, 2, 2, 4, 4)),
              ("recon_y", U8, (16, 16)), ("recon_u", U8, (8, 8)),
              ("recon_v", U8, (8, 8)), ("i4modes", I32, (16,)),
              ("i4sym_v", I32, (16,)), ("i4sym_l", I32, (16,)),
              ("mv_y", I32, ()), ("mv_x", I32, ()), ("shape", I32, ()),
              ("mv4_y", I32, (4, 4)), ("mv4_x", I32, (4, 4)))


def tables_header() -> str:
    """The text of `csrc/tq_tables.h`: the TQ_* macros of K7's and K8's
    tables, from the port's own tables."""
    from h264lab_tpu_torch.models import mbscan
    from h264lab_tpu_torch.ops.me import LAMBDA_ME

    def arr(a):
        return "{" + ", ".join(str(int(v)) for v in np.asarray(a).reshape(
            -1)) + "}"

    pos = sum(int(c) << (2 * i) for i, c in enumerate(tables.POS_CLASS))
    lines = [
        "// K7's and K8's tables, written by "
        "`python -m h264lab_tpu_torch.ops.residual` from",
        "// ops/tables.py, ops/me.py and models/mbscan.py. Do not edit.",
        "#pragma once",
        f"#define TQ_SEL_INTER {mbscan.SEL_INTER}",
        f"#define TQ_SEL_I16 {mbscan.SEL_I16}",
        f"#define TQ_QUANT_MF {arr(tables.QUANT_MF)}",
        f"#define TQ_DEQUANT_V {arr(tables.DEQUANT_V)}",
        f"#define TQ_LAMBDA_ME {arr(LAMBDA_ME)}",
        # the position class of raster index i of a 4x4 block, 2 bits each
        f"#define TQ_POS_CLASS(i) ((int)(({pos:#x}u >> (2 * (i))) & 3u))",
    ]
    return "\n".join(lines) + "\n"


def _layout(outputs, n: int, nmb: int) -> tuple:
    return tuple((name, dtype, (n, nmb) + trail)
                 for name, dtype, trail in outputs)


@functools.lru_cache(maxsize=64)
def k7_inputs(n: int, nmb: int, mbh: int, plan: bool, parts: bool,
              planes: tuple):
    """K7's tensor arguments in order, (name, dtype, shape, alignment
    mask): 15 for the 16-byte aligned ones (the bulk-copied tiles and
    prediction, K5's int32 outputs), 3 for the chroma planes (read as
    words), else 0; `planes` the shape of the chroma reference planes;
    K5's outputs only with `parts`."""
    q = torch.Size((n, mbh) if plan else (n,))
    mb = [torch.Size((n, nmb) + t) for t in ((), (16, 16), (8, 8))]
    specs = [("src_y", U8, mb[1], 15), ("src_u", U8, mb[2], 15),
             ("src_v", U8, mb[2], 15),
             ("u_pad", U8, torch.Size(planes), 3),
             ("v_pad", U8, torch.Size(planes), 3),
             ("lane", I32, torch.Size((n,)), 0),
             ("row0", I32, torch.Size((n,)), 0), ("qp", I32, q, 0),
             ("qpc", I32, q, 0)]
    specs += [(name, I32, mb[0], 0) for name in (
        "mv_y", "mv_x", "full_my", "full_mx", "cost16")]
    specs.append(("pred16", U8, mb[1], 15))
    if parts:
        specs += [(name, dtype, torch.Size((n * nmb,) + t),
                   15 if dtype is I32 else 0) for name, dtype, t in K7_PARTS]
    return tuple(specs)


@functools.lru_cache(maxsize=64)
def _k7_plan(n: int, nmb: int, mbh: int, plan: bool, parts: bool,
             planes: tuple):
    """What a K7 call of these sizes needs, worked out once: the inputs'
    checks (`k7_inputs`), the buffer's bytes, its views and the output
    offsets in `K7_OUTPUTS`' order."""
    nbytes, views, offsets = cuda_build.buffer_plan(
        _layout(K7_OUTPUTS, n, nmb))
    return (k7_inputs(n, nmb, mbh, plan, parts, planes), nbytes, views,
            tuple(offsets[name] for name, _, _ in K7_OUTPUTS))


def inter_tiles(src_y, src_u, src_v, u_pad, v_pad, lane, row0, qp, qpc,
                mv_y, mv_x, full_my, full_mx, cost16, pred16, parts,
                mb_width: int, mb_height: int, zero_thr: bool = True) -> dict:
    """K7: the inter residual of n P frames or bands on the card, one
    launch. Takes what `mbscan.inter_residual` takes, in the form
    `mbscan.inter_residual_args` packs: the source tiles (n, nmb, 16, 16)
    and (n, nmb, 8, 8) uint8; the lanes' chroma reference planes u_pad and
    v_pad (L, h, w) uint8, w a multiple of 4; lane and row0 (n,) int32; qp
    and qpc (n,) or per MB row (n, mb_height) int32; the 16x16 search's
    mv_y, mv_x, full_my, full_mx and cost16 (n, nmb) int32 and pred16 (n,
    nmb, 16, 16) uint8; `parts` None or K5's nine outputs over n * nmb MBs
    in `K7_PARTS`' order (the partition shapes, speed 0); every tensor
    contiguous on one CUDA device, the tiles, pred16 and K5's int32
    outputs 16-byte aligned, the planes 4-byte aligned. `zero_thr`
    switches the zero-block kills. Returns the plain version's dict
    (`K7_OUTPUTS`), every output a view of one buffer. Raises on any other
    input: the plain version is `mbscan.inter_residual_plain`."""
    what = "inter_tiles (K7)"
    index = cuda_build.card_of(what, src_y)
    n, nmb = src_y.shape[:2]
    if mb_width <= 0 or mb_height <= 0 or nmb != mb_width * mb_height:
        raise ValueError(f"{what}: {nmb} MBs are not {mb_width} x "
                         f"{mb_height}")
    planes = tuple(getattr(u_pad, "shape", ()))
    if len(planes) != 3 or planes[2] % 4:
        raise ValueError(f"{what}: u_pad of shape {planes}, not (L, h, w) "
                         "with w a multiple of 4")
    tensors = (src_y, src_u, src_v, u_pad, v_pad, lane, row0, qp, qpc, mv_y,
               mv_x, full_my, full_mx, cost16, pred16)
    if parts is not None:
        tensors += tuple(parts)
    checks, nbytes, views, offsets = _k7_plan(
        n, nmb, mb_height, getattr(qp, "ndim", 1) == 2, parts is not None,
        planes)
    ptrs = cuda_build.pointers(what, tensors, checks, index)
    if parts is None:
        ptrs += [0] * len(K7_PARTS)
    buf = torch.empty(nbytes, dtype=U8, device=src_y.device)
    out = cuda_build.buffer_views(buf, views)
    if n * nmb:
        base = buf.data_ptr()
        kill = bool(zero_thr) and tuning.INTER_ZERO_THR_Q8 > 0
        cuda_build.call(_k7().h264lab_inter_residual, ptrs + [
            base + o for o in offsets] + [
            n, mb_width, mb_height, int(qp.ndim == 2), planes[1], planes[2],
            GUARD // 2, tuning.INTER_DEADZONE_Q8, int(kill),
            tuning.INTER_ZERO_THR_Q8, tuning.INTER_ZERO_THR2_Q8,
            tuning.PART_16X8_PENALTY_BITS, tuning.PART_8X8_PENALTY_BITS,
            cuda_build.stream_of(index)], "inter residual", index)
        cuda_build.count_launch("inter_residual")
    return out


@functools.lru_cache(maxsize=64)
def k8_inputs(n: int, nmb: int, mbh: int, plan: bool):
    """K8's tensor arguments in order, (name, dtype, shape, alignment
    mask): 15 for the 16-byte aligned arrays it bulk-copies, else 0."""
    q = torch.Size((n, mbh) if plan else (n,))

    def mb(*t):
        return torch.Size((n, nmb) + t)
    return (("src_y", U8, mb(16, 16), 15), ("src_u", U8, mb(8, 8), 15),
            ("src_v", U8, mb(8, 8), 15), ("qp", I32, q, 0),
            ("qpc", I32, q, 0), ("avail", U8, torch.Size((2, nmb)), 0),
            ("inter_cost", I32, mb(), 0),
            ("recon_y_inter", U8, mb(16, 16), 15),
            ("recon_u_inter", U8, mb(8, 8), 15),
            ("recon_v_inter", U8, mb(8, 8), 15),
            ("cdc_inter", I32, mb(2, 2, 2), 15),
            ("cac_inter", I32, mb(2, 2, 2, 4, 4), 15),
            ("mv_y", I32, mb(), 0), ("mv_x", I32, mb(), 0),
            ("mv4_y", I32, mb(4, 4), 15), ("mv4_x", I32, mb(4, 4), 15),
            ("shape", I32, mb(), 0))


@functools.lru_cache(maxsize=64)
def _k8_plan(n: int, nmb: int, mbh: int, plan: bool):
    """What a K8 call of these sizes needs, worked out once: the inputs'
    checks (`k8_inputs`), the buffer's bytes, its views and the output
    offsets in `K8_OUTPUTS`' order."""
    nbytes, views, offsets = cuda_build.buffer_plan(
        _layout(K8_OUTPUTS, n, nmb))
    return (k8_inputs(n, nmb, mbh, plan), nbytes, views,
            tuple(offsets[name] for name, _, _ in K8_OUTPUTS))


def select_tiles(src_y, src_u, src_v, qp, qpc, avail, inter_cost,
                 recon_y_inter, recon_u_inter, recon_v_inter, cdc_inter,
                 cac_inter, mv_y, mv_x, mv4_y, mv4_x, shape,
                 mb_width: int) -> dict:
    """K8: the parallel mode decision of n P frames or bands on the card,
    one launch. Takes what `mbscan.select_parallel` takes, in the
    form `mbscan.select_parallel_args` packs: the source tiles (n, nmb,
    16, 16) and (n, nmb, 8, 8) uint8; qp and qpc (n,) or per MB row (n,
    mb_height) int32; avail (2, nmb) uint8, avail_top then avail_left;
    the inter stage's inter_cost, recon_*_inter, cdc_inter, cac_inter,
    mv_y, mv_x, mv4_y, mv4_x and shape; every tensor contiguous on one
    CUDA device, the tiles, the inter reconstruction, cdc_inter,
    cac_inter, mv4_y and mv4_x 16-byte aligned. Returns the plain
    version's dict but lev_inter (`K8_OUTPUTS`), every output a view of
    one buffer. Raises on any other input: the plain
    version is `mbscan.select_parallel_plain`."""
    what = "select_tiles (K8)"
    index = cuda_build.card_of(what, src_y)
    n, nmb = src_y.shape[:2]
    if mb_width <= 0 or nmb % mb_width:
        raise ValueError(f"{what}: {nmb} MBs are no whole rows of "
                         f"{mb_width}")
    mb_height = nmb // mb_width
    tensors = (src_y, src_u, src_v, qp, qpc, avail, inter_cost,
               recon_y_inter, recon_u_inter, recon_v_inter, cdc_inter,
               cac_inter, mv_y, mv_x, mv4_y, mv4_x, shape)
    checks, nbytes, views, offsets = _k8_plan(
        n, nmb, mb_height, getattr(qp, "ndim", 1) == 2)
    ptrs = cuda_build.pointers(what, tensors, checks, index)
    buf = torch.empty(nbytes, dtype=U8, device=src_y.device)
    out = cuda_build.buffer_views(buf, views)
    if n * nmb:
        base = buf.data_ptr()
        cuda_build.call(_k8().h264lab_select_parallel, ptrs + [
            base + o for o in offsets] + [
            n, mb_width, mb_height, int(qp.ndim == 2),
            tuning.INTRA_DEADZONE_Q8, tuning.INTRA_IN_P_PENALTY_BITS,
            cuda_build.stream_of(index)], "parallel select", index)
        cuda_build.count_launch("select_parallel")
    return out


if __name__ == "__main__":
    HEADER.write_text(tables_header())
