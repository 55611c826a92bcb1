"""K3: the slope-2 intra wavefront (Intra_16x16, Intra_4x4 and chroma
selection and intra TQ, with an optional inter candidate) of a batch of
frames or slice bands, one launch of the CUDA kernel `csrc/wavefront.cu`,
built with nvcc at first use and bound with ctypes.

It replaces `h264lab_tpu/models/mbscan.py` `_wavefront_scan` with
`h264lab_tpu/ops/intra4.py` `encode_i4x4_mb`, which the JAX package left
to XLA. Its plain version is `models/mbscan._select_wavefront_plain`;
`mbscan._select_wavefront` is the one entry of every encode path and
packs K3's arguments with `mbscan.select_wavefront_args`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from h264lab_tpu_torch.ops import cuda_build, tables
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

_SRC = cuda_build.CSRC / "wavefront.cu"
_lib_handle = None
REC_BYTES = 48                  # K3's record of an MB for the row below
# the outputs, in the plain version's order: name, dtype, trailing shape
OUTPUTS = (("sel", torch.int32, ()), ("mode16", torch.int32, ()),
           ("cmode", torch.int32, ()), ("dc_lev", torch.int32, (4, 4)),
           ("ac_lev", torch.int32, (4, 4, 4, 4)),
           ("cdc_lev", torch.int32, (2, 2, 2)),
           ("cac_lev", torch.int32, (2, 2, 2, 4, 4)),
           ("recon_y", torch.uint8, (16, 16)),
           ("recon_u", torch.uint8, (8, 8)), ("recon_v", torch.uint8, (8, 8)),
           ("i4modes", torch.int32, (16,)), ("i4sym_v", torch.int32, (16,)),
           ("i4sym_l", torch.int32, (16,)))
# K3 loads these a 4-byte word at a time
TILES = ("src_y", "src_u", "src_v", "recon_y_inter", "recon_u_inter",
         "recon_v_inter")


@functools.lru_cache(maxsize=None)
def device_tables(device: torch.device) -> torch.Tensor:
    """QUANT_MF, DEQUANT_V, POS_CLASS and BLOCK_SCAN_4x4 of ops/tables.py
    as one int32 array on `device`, in the order K3 reads them."""
    return torch.as_tensor(np.concatenate([
        tables.QUANT_MF.ravel(), tables.DEQUANT_V.ravel(), tables.POS_CLASS,
        tables.BLOCK_SCAN_4x4]).astype(np.int32), device=device)


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = ctypes.CDLL(str(cuda_build.build(_SRC)[0]))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.h264lab_wavefront.argtypes = [vp] * 29 + [
            ctypes.c_longlong, ci, ci, ci, ci, vp]
        lib.h264lab_wavefront.restype = ci
        _lib_handle = lib
    return _lib_handle


def k3_inputs(n: int, nmb: int, inter: bool):
    """K3's tensor arguments in order: name, dtype, shape (the inter
    candidate's only with `inter`)."""
    args = [("src_y", torch.uint8, (n, nmb, 16, 16)),
            ("src_u", torch.uint8, (n, nmb, 8, 8)),
            ("src_v", torch.uint8, (n, nmb, 8, 8)),
            ("qp", torch.int32, (n,)), ("qpc", torch.int32, (n,)),
            ("lam", torch.int32, (n,)), ("pen", torch.int32, (n,)),
            ("avail_top", torch.uint8, (nmb,)),
            ("avail_left", torch.uint8, (nmb,))]
    if inter:
        args += [("inter_cost", torch.int32, (n, nmb)),
                 ("recon_y_inter", torch.uint8, (n, nmb, 16, 16)),
                 ("recon_u_inter", torch.uint8, (n, nmb, 8, 8)),
                 ("recon_v_inter", torch.uint8, (n, nmb, 8, 8))]
    return args


def wavefront_tiles(src_y, src_u, src_v, qp, qpc, lam, pen, avail_top,
                    avail_left, inter_cost, recon_y_inter, recon_u_inter,
                    recon_v_inter, mb_width: int, deadzone_q8: int,
                    i4_penalty_bits: int) -> dict:
    """K3: the slope-2 wavefront mode selection and intra TQ of n frames or
    bands of MB tiles, in one launch on the card. Takes what
    `mbscan._select_wavefront` takes, in the form
    `mbscan.select_wavefront_args` packs: src_y (n, nmb, 16, 16), src_u and
    src_v (n, nmb, 8, 8) uint8; qp, qpc, lam (`lambda_me(qp)`) and pen (the
    intra-in-P penalty, 0 on I frames) (n,) int32, one QP per frame (no
    per-row QPs); avail_top and avail_left (nmb,) uint8 (the first row
    and column are unavailable whatever they say); the inter candidate,
    inter_cost (n, nmb) int32 and its recon_*_inter tiles, or four Nones;
    all contiguous on one CUDA device, the tiles 16-byte aligned; the
    quantizer deadzone and the Intra_4x4 penalty bits. Returns a dict of
    the plain version's 13 outputs (`OUTPUTS`). Raises on any other
    input: the plain version is `mbscan._select_wavefront_plain`."""
    inter = (inter_cost, recon_y_inter, recon_u_inter, recon_v_inter)
    has_inter = inter_cost is not None
    if any((x is None) == has_inter for x in inter):
        raise ValueError("wavefront_tiles: the inter candidate's cost and "
                         "tiles go together")
    args = (src_y, src_u, src_v, qp, qpc, lam, pen, avail_top, avail_left)
    if has_inter:
        args += inter
    dev = src_y.device
    if dev.type != "cuda" or any(x.device != dev for x in args):
        raise ValueError("wavefront_tiles: K3 takes tensors on one CUDA "
                         f"device, not {[str(x.device) for x in args]}")
    if qp.ndim != 1:
        raise ValueError("wavefront_tiles: K3 takes one QP per frame, not "
                         f"QPs of shape {tuple(qp.shape)} (per-row QPs "
                         "need the parallel P path)")
    n, nmb = src_y.shape[:2]
    if mb_width <= 0 or nmb % mb_width:
        raise ValueError(f"wavefront_tiles: {nmb} MBs are no whole rows of "
                         f"{mb_width}")
    for x, (name, dtype, shape) in zip(args, k3_inputs(n, nmb, has_inter)):
        if x.dtype != dtype:
            raise TypeError(f"wavefront_tiles: {name} is {x.dtype}, not "
                            f"{dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"wavefront_tiles: {name} of shape "
                             f"{tuple(x.shape)}, not {shape}")
        if not x.is_contiguous():
            raise ValueError(f"wavefront_tiles: {name} is not contiguous")
        if name in TILES and x.data_ptr() % 16:
            raise ValueError(f"wavefront_tiles: {name} is not 16-byte "
                             "aligned")
    mb_height = nmb // mb_width
    with torch.cuda.device(dev):
        out = {name: torch.empty((n, nmb) + shape, dtype=dtype, device=dev)
               for name, dtype, shape in OUTPUTS}
        if n == 0 or nmb == 0:
            return out
        # zeroed for the launch: the ticket, then a progress count per row
        sync = torch.zeros(1 + n * mb_height, dtype=torch.int32, device=dev)
        records = torch.empty(n * nmb * REC_BYTES, dtype=torch.uint8,
                              device=dev)
        ptr = [x.data_ptr() for x in args[:9]] + (
            [x.data_ptr() for x in inter] if has_inter else [None] * 4)
        cuda_build.check(_lib().h264lab_wavefront(
            *ptr, device_tables(dev).data_ptr(),
            *(out[name].data_ptr() for name, _, _ in OUTPUTS),
            records.data_ptr(), sync.data_ptr(), n, mb_width, mb_height,
            deadzone_q8, i4_penalty_bits,
            torch.cuda.current_stream(dev).cuda_stream), "wavefront")
        LAUNCH_COUNTS["wavefront"] += 1
    return out
