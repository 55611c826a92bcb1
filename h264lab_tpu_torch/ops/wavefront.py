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
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS  # noqa: F401

_SRC = cuda_build.CSRC / "wavefront.cu"
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_lib = cuda_build.Library(_SRC, {
    "h264lab_wavefront": ([_VP] * 29 + [ctypes.c_longlong, _CI, _CI, _CI, _CI,
                                        _CI, _VP], _CI),
    "h264lab_wavefront_occupancy": ([_CI, _CI, _VP], _CI)})
# K3's record of an MB for the row below: 9 units of 8 bytes, each 4
# bytes of it (Y bottom row 0-3, U 4-5, V 6-7, the bottom Intra_4x4 modes
# 8) and a tag that shows it written
REC_UNITS = 9
# the MB rows of a thread-block cluster that K3 may take, largest first:
# the rows of a cluster hand their records over in shared memory, a
# cluster's first row reads the row above from global memory
CLUSTERS = (8, 4, 2)
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


# the Intra_4x4 modes whose prediction is four taps of the neighbours (all
# but DC), in K3's order
TAP_MODES = (0, 1, 3, 4, 5, 6, 7, 8)


def i4_taps(mode: int, py: int, px: int) -> tuple:
    """The four taps of Intra_4x4 `mode` (not DC) at pixel (py, px): indices
    into a block's neighbours U = [l3, l2, l1, l0, tl, t0..t7] (the layout
    of `intra4.predict4`'s `v` extended by the top-right) such that the
    prediction is (U[a] + U[b] + U[c] + U[d] + 2) >> 2. A three-tap filter
    (a + 2 b + c + 2) >> 2 is (a, b, b, c), a two-tap mean (b + c + 1) >> 1
    is (b, b, c, c), a copy of U[a] is (a, a, a, a)."""
    def cl(i):
        return min(max(i, 0), 8)

    def tap3(a, b, c):
        return (a, b, b, c)

    def avg2(b, c):
        return (b, b, c, c)

    if mode == 0:                                       # V
        return (5 + px,) * 4
    if mode == 1:                                       # H
        return (3 - py,) * 4
    if mode == 3:                                       # DDL
        if px == 3 and py == 3:
            return (11, 12, 12, 12)
        i = min(px + py, 6)
        return tap3(i + 5, min(i + 1, 7) + 5, min(i + 2, 7) + 5)
    if mode == 4:                                       # DDR
        i = px - py + 4
        return tap3(i - 1, i, i + 1)
    if mode in (5, 6):                      # VR; HD is VR mirrored
        x, y = (px, py) if mode == 5 else (py, px)
        z = 2 * x - y
        if z < 0:
            t = tap3(cl(4 + z), cl(5 + z), cl(6 + z))
        else:
            i = x - (y >> 1) + 5
            a, b, c = cl(i - 2), cl(i - 1), cl(i)
            t = tap3(a, b, c) if z & 1 else avg2(b, c)
        return t if mode == 5 else tuple(8 - i for i in t)
    if mode == 7:                                       # VL
        i = px + (py >> 1)
        a, b, c = (min(i + k, 7) + 5 for k in range(3))
        return tap3(a, b, c) if py & 1 else avg2(a, b)
    if mode == 8:                                       # HU
        i, z = py + (px >> 1), px + 2 * py
        a, b, c = (3 - min(i + k, 3) for k in range(3))
        if z > 5:
            return (0,) * 4
        if z == 5:
            return (1, 0, 0, 0)
        return tap3(a, b, c) if z & 1 else avg2(a, b)
    raise ValueError(f"i4_taps: mode {mode} has no taps")


def i4_tap_tables() -> np.ndarray:
    """K3's Intra_4x4 tap tables: for each pixel (raster in the 4x4 block)
    and each of TAP_MODES, a byte-permute selector of its four taps within
    a window of 8 neighbours, U[0..7] or U[5..12] (taps span at most three
    neighbours, so one of the two holds them), then per pixel the windows,
    a bit per mode (set: U[5..12]). (16 x 8 + 16,) uint32 as int32 bits."""
    sel = np.zeros((16, len(TAP_MODES)), np.uint32)
    win = np.zeros(16, np.uint32)
    for pix in range(16):
        for k, mode in enumerate(TAP_MODES):
            t = i4_taps(mode, pix >> 2, pix & 3)
            w = int(max(t) > 7)
            assert min(t) >= 5 * w and max(t) <= 5 * w + 7, (mode, pix, t)
            sel[pix, k] = sum((i - 5 * w) << (4 * j) for j, i in enumerate(t))
            win[pix] |= w << k
    return np.concatenate([sel.ravel(), win]).view(np.int32)


@functools.lru_cache(maxsize=None)
def device_tables(device: torch.device) -> torch.Tensor:
    """QUANT_MF, DEQUANT_V, POS_CLASS and BLOCK_SCAN_4x4 of ops/tables.py
    and `i4_tap_tables` as one int32 array on `device`, in the order K3
    reads them."""
    return torch.as_tensor(np.concatenate([
        tables.QUANT_MF.ravel(), tables.DEQUANT_V.ravel(), tables.POS_CLASS,
        tables.BLOCK_SCAN_4x4, i4_tap_tables()]).astype(np.int32),
        device=device)


@functools.lru_cache(maxsize=None)
def occupancy(mb_width: int, cluster: int,
              device: torch.device) -> tuple[int, int]:
    """K3's resident blocks (MB rows) per SM and resident clusters of
    `cluster` rows on the CUDA `device` at `mb_width` MBs a row
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor` and
    `cudaOccupancyMaxActiveClusters` at its block size and shared
    memory)."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        cuda_build.check(_lib().h264lab_wavefront_occupancy(
            mb_width, cluster, out), "wavefront occupancy")
    return out[0], out[1]


def cluster_rows(n: int, mb_width: int, mb_height: int,
                 device: torch.device) -> int:
    """The MB rows per cluster of K3's launch on n frames of mb_width x
    mb_height MBs on the CUDA `device`: the largest of CLUSTERS whose
    clusters are all resident at once, so that no row waits for a place
    and the most rows hand their records over in shared memory; else the
    smallest, so that a finished row holds its place only until the one
    other row of its cluster has finished."""
    for c in CLUSTERS:
        if n * -(-mb_height // c) <= occupancy(mb_width, c, device)[1]:
            return c
    return CLUSTERS[-1]


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
        # zeroed for the launch, in one fill: the ticket (16 bytes), then
        # the record units
        sync = torch.zeros(2 + n * nmb * REC_UNITS, dtype=torch.int64,
                           device=dev)
        ptr = [x.data_ptr() for x in args[:9]] + (
            [x.data_ptr() for x in inter] if has_inter else [None] * 4)
        cuda_build.check(_lib().h264lab_wavefront(
            *ptr, device_tables(dev).data_ptr(),
            *(out[name].data_ptr() for name, _, _ in OUTPUTS),
            sync.data_ptr() + 16, sync.data_ptr(), n, mb_width, mb_height,
            deadzone_q8, i4_penalty_bits,
            cluster_rows(n, mb_width, mb_height, dev),
            torch.cuda.current_stream(dev).cuda_stream), "wavefront")
        cuda_build.count_launch("wavefront")
    return out
