"""K7 and K8: the P step's residual coding and its parallel mode decision,
the CUDA kernels of `csrc/inter.cu` and `csrc/select.cu`, built with nvcc
at first use and bound with ctypes.

K7 (`inter_tiles`, one launch) is everything of the `inter` stage after
the motion searches: the partition shape and MV grid (speed 0), chroma
motion compensation, the inter luma TQ with its zero-block kills, the
chroma TQ and the reconstruction. It replaces
`h264lab_tpu/models/mbscan.py:221-293`. K8 (`select_tiles`, two launches)
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
_VP, _CI, _CLL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_k7 = cuda_build.Library(K7_SRC, {"h264lab_inter_residual": (
    [_VP] * 34 + [_CLL] + [_CI] * 12 + [_VP], _CI)})
_k8 = cuda_build.Library(K8_SRC, {"h264lab_select_parallel": (
    [_VP] * 36 + [_CLL] + [_CI] * 5 + [_VP], _CI)})

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
# stage's, passed through), then its scratch: a byte per MB
K8_OUTPUTS = (("sel", I32, ()), ("mode16", I32, ()), ("cmode", I32, ()),
              ("dc_lev", I32, (4, 4)), ("ac_lev", I32, (4, 4, 4, 4)),
              ("cdc_lev", I32, (2, 2, 2)), ("cac_lev", I32, (2, 2, 2, 4, 4)),
              ("recon_y", U8, (16, 16)), ("recon_u", U8, (8, 8)),
              ("recon_v", U8, (8, 8)), ("i4modes", I32, (16,)),
              ("i4sym_v", I32, (16,)), ("i4sym_l", I32, (16,)),
              ("mv_y", I32, ()), ("mv_x", I32, ()), ("shape", I32, ()),
              ("mv4_y", I32, (4, 4)), ("mv4_x", I32, (4, 4)),
              ("want", U8, ()))


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


@functools.lru_cache(maxsize=64)
def _plan(outputs, n: int, nmb: int):
    """One buffer for `outputs` at (n, nmb): its bytes and each output's
    (name, dtype, shape, strides, offset in elements of its dtype), each
    starting on a 16-byte boundary."""
    views, at = [], 0
    for name, dtype, trail in outputs:
        shape = (n, nmb) + trail
        size = torch.empty((), dtype=dtype).element_size()
        strides = tuple(int(np.prod(shape[j + 1:])) for j in range(len(shape)))
        views.append((name, dtype, shape, strides, at // size))
        at += -(-int(np.prod(shape)) * size // 16) * 16
    return at, tuple(views)


def _views(buf, views) -> dict:
    """The outputs as views of the one uint8 buffer (`_plan`'s views)."""
    as_dtype = {U8: buf}
    out = {}
    for name, dtype, shape, strides, off in views:
        b = as_dtype.get(dtype)
        if b is None:
            b = as_dtype[dtype] = buf.view(dtype)
        out[name] = b.as_strided(shape, strides, off)
    return out


def _pointers(what, tensors, specs, index):
    """The inputs' addresses when the kernel takes every one of them: a
    tensor of its spec's dtype and shape, contiguous, on card `index`, 16
    bytes aligned where the spec says so. Raises for the first it does
    not take."""
    ptrs = []
    for x, (name, dtype, shape, aligned) in zip(tensors, specs):
        if not isinstance(x, torch.Tensor) or x.get_device() != index:
            raise ValueError(f"{what}: {name} is not a tensor on "
                             f"cuda:{index} ({getattr(x, 'device', x)!r})")
        if x.dtype is not dtype:
            raise TypeError(f"{what}: {name} is {x.dtype}, not {dtype}")
        if x.shape != shape:
            raise ValueError(f"{what}: {name} of shape {tuple(x.shape)}, "
                             f"not {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
        ptrs.append(x.data_ptr())
        if aligned and ptrs[-1] % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    return ptrs


def _card(what, x) -> int:
    """The index of the CUDA device of `x`; raises for anything else."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{what} takes tensors on one CUDA device, not "
                         f"{getattr(x, 'device', type(x).__name__)}")
    return x.get_device()


@functools.lru_cache(maxsize=64)
def k7_inputs(n: int, nmb: int, mbh: int, plan: bool, parts: bool,
              planes: tuple):
    """K7's tensor arguments in order, (name, dtype, shape, 16-byte
    aligned): `planes` the shape of the chroma reference planes; K5's
    outputs only with `parts`."""
    q = torch.Size((n, mbh) if plan else (n,))
    mb = [torch.Size((n, nmb) + t) for t in ((), (16, 16), (8, 8))]
    specs = [("src_y", U8, mb[1], True), ("src_u", U8, mb[2], True),
             ("src_v", U8, mb[2], True),
             ("u_pad", U8, torch.Size(planes), False),
             ("v_pad", U8, torch.Size(planes), False),
             ("lane", I32, torch.Size((n,)), False),
             ("row0", I32, torch.Size((n,)), False), ("qp", I32, q, False),
             ("qpc", I32, q, False)]
    specs += [(name, I32, mb[0], False) for name in (
        "mv_y", "mv_x", "full_my", "full_mx", "cost16")]
    specs.append(("pred16", U8, mb[1], True))
    if parts:
        specs += [(name, dtype, torch.Size((n * nmb,) + t), dtype is I32)
                  for name, dtype, t in K7_PARTS]
    return tuple(specs)


def inter_tiles(src_y, src_u, src_v, u_pad, v_pad, lane, row0, qp, qpc,
                mv_y, mv_x, full_my, full_mx, cost16, pred16, parts,
                mb_width: int, mb_height: int, zero_thr: bool = True) -> dict:
    """K7: the inter residual of n P frames or bands on the card, one
    launch. Takes what `mbscan.inter_residual` takes, in the form
    `mbscan.inter_residual_args` packs: the source tiles (n, nmb, 16, 16)
    and (n, nmb, 8, 8) uint8; the lanes' chroma reference planes u_pad and
    v_pad (L, h, w) uint8; lane and row0 (n,) int32; qp and qpc (n,) or
    per MB row (n, mb_height) int32; the 16x16 search's mv_y, mv_x,
    full_my, full_mx and cost16 (n, nmb) int32 and pred16 (n, nmb, 16, 16)
    uint8; `parts` None or K5's nine outputs over n * nmb MBs in
    `K7_PARTS`' order (the partition shapes, speed 0); every tensor
    contiguous on one CUDA device, the tiles and K5's int32 outputs
    16-byte aligned. `zero_thr` switches the zero-block kills. Returns the
    plain version's dict (`K7_OUTPUTS`), every output a view of one
    buffer. Raises on any other input: the plain version is
    `mbscan.inter_residual_plain`."""
    what = "inter_tiles (K7)"
    index = _card(what, src_y)
    n, nmb = src_y.shape[:2]
    if mb_width <= 0 or mb_height <= 0 or nmb != mb_width * mb_height:
        raise ValueError(f"{what}: {nmb} MBs are not {mb_width} x "
                         f"{mb_height}")
    tensors = [src_y, src_u, src_v, u_pad, v_pad, lane, row0, qp, qpc, mv_y,
               mv_x, full_my, full_mx, cost16, pred16]
    if parts is not None:
        tensors += list(parts)
    planes = tuple(getattr(u_pad, "shape", ()))
    if len(planes) != 3:
        raise ValueError(f"{what}: u_pad of shape {planes}, not (L, h, w)")
    specs = k7_inputs(n, nmb, mb_height, getattr(qp, "ndim", 1) == 2,
                      parts is not None, planes)
    if len(tensors) != len(specs):
        raise ValueError(f"{what}: {len(tensors)} tensors, not {len(specs)}")
    ptrs = _pointers(what, tensors, specs, index)
    ptrs += [None] * (24 - len(ptrs))
    nbytes, views = _plan(K7_OUTPUTS, n, nmb)
    with torch.cuda.device(index):
        buf = torch.empty(nbytes, dtype=U8, device=src_y.device)
        out = _views(buf, views)
        if n * nmb:
            kill = bool(zero_thr) and tuning.INTER_ZERO_THR_Q8 > 0
            cuda_build.check(_k7().h264lab_inter_residual(
                *ptrs, *(out[name].data_ptr() for name, _, _ in K7_OUTPUTS),
                n, mb_width, mb_height, int(qp.ndim == 2), planes[1],
                planes[2], GUARD // 2, tuning.INTER_DEADZONE_Q8, int(kill),
                tuning.INTER_ZERO_THR_Q8, tuning.INTER_ZERO_THR2_Q8,
                tuning.PART_16X8_PENALTY_BITS, tuning.PART_8X8_PENALTY_BITS,
                torch.cuda.current_stream(index).cuda_stream),
                "inter residual")
            cuda_build.count_launch("inter_residual")
    return out


@functools.lru_cache(maxsize=64)
def k8_inputs(n: int, nmb: int, mbh: int, plan: bool):
    """K8's tensor arguments in order, (name, dtype, shape, 16-byte
    aligned)."""
    q = torch.Size((n, mbh) if plan else (n,))

    def mb(*t):
        return torch.Size((n, nmb) + t)
    return (("src_y", U8, mb(16, 16), True), ("src_u", U8, mb(8, 8), True),
            ("src_v", U8, mb(8, 8), True), ("qp", I32, q, False),
            ("qpc", I32, q, False), ("avail", U8, torch.Size((2, nmb)), False),
            ("inter_cost", I32, mb(), False),
            ("recon_y_inter", U8, mb(16, 16), True),
            ("recon_u_inter", U8, mb(8, 8), True),
            ("recon_v_inter", U8, mb(8, 8), True),
            ("cdc_inter", I32, mb(2, 2, 2), False),
            ("cac_inter", I32, mb(2, 2, 2, 4, 4), True),
            ("mv_y", I32, mb(), False), ("mv_x", I32, mb(), False),
            ("mv4_y", I32, mb(4, 4), False), ("mv4_x", I32, mb(4, 4), False),
            ("shape", I32, mb(), False))


def select_tiles(src_y, src_u, src_v, qp, qpc, avail, inter_cost,
                 recon_y_inter, recon_u_inter, recon_v_inter, cdc_inter,
                 cac_inter, mv_y, mv_x, mv4_y, mv4_x, shape,
                 mb_width: int) -> dict:
    """K8: the parallel mode decision of n P frames or bands on the card,
    two launches (the "wants intra" byte of every MB, then the decision
    and the coding). Takes what `mbscan.select_parallel` takes, in the
    form `mbscan.select_parallel_args` packs: the source tiles (n, nmb,
    16, 16) and (n, nmb, 8, 8) uint8; qp and qpc (n,) or per MB row (n,
    mb_height) int32; avail (2, nmb) uint8, avail_top then avail_left;
    the inter stage's inter_cost, recon_*_inter, cdc_inter, cac_inter,
    mv_y, mv_x, mv4_y, mv4_x and shape; every tensor contiguous on one
    CUDA device, the tiles and cac_inter 16-byte aligned. Returns the
    plain version's dict but lev_inter (`K8_OUTPUTS` but the scratch),
    every output a view of one buffer. Raises on any other input: the
    plain version is `mbscan.select_parallel_plain`."""
    what = "select_tiles (K8)"
    index = _card(what, src_y)
    n, nmb = src_y.shape[:2]
    if mb_width <= 0 or nmb % mb_width:
        raise ValueError(f"{what}: {nmb} MBs are no whole rows of "
                         f"{mb_width}")
    mb_height = nmb // mb_width
    tensors = (src_y, src_u, src_v, qp, qpc, avail, inter_cost,
               recon_y_inter, recon_u_inter, recon_v_inter, cdc_inter,
               cac_inter, mv_y, mv_x, mv4_y, mv4_x, shape)
    specs = k8_inputs(n, nmb, mb_height, getattr(qp, "ndim", 1) == 2)
    ptrs = _pointers(what, tensors, specs, index)
    nbytes, views = _plan(K8_OUTPUTS, n, nmb)
    with torch.cuda.device(index):
        buf = torch.empty(nbytes, dtype=U8, device=src_y.device)
        out = _views(buf, views)
        if n * nmb:
            cuda_build.check(_k8().h264lab_select_parallel(
                *ptrs, *(out[name].data_ptr() for name, _, _ in K8_OUTPUTS),
                n, mb_width, mb_height, int(qp.ndim == 2),
                tuning.INTRA_DEADZONE_Q8, tuning.INTRA_IN_P_PENALTY_BITS,
                torch.cuda.current_stream(index).cuda_stream),
                "parallel select")
            cuda_build.count_launch("select_parallel")
    del out["want"]
    return out


if __name__ == "__main__":
    HEADER.write_text(tables_header())
