"""SVC spatial resampling: 2x frame downsampling for the base layer and
the normative-style 4-tap / bilinear intra upsampling for inter-layer
prediction, and K9 and K10, the two stages of an SVC frame that use them,
as CUDA kernels (`csrc/resample.cu`, built with nvcc at first use and
bound with ctypes).

PyTorch counterpart of `h264lab_tpu/ops/resample.py` (reference
`h264e_frame_downsampling` `src/h264-lab.h:2984-3048` and
`h264e_intra_upsampling` `:3078-3183`). `downsample2x`,
`upsample2x_luma` and `upsample2x_chroma` take whole planes on the
tensor's own device, integer-exact, over any leading batch axes: (..., h,
w) uint8 in, uint8 out.

The stage entries of `models/svc.py` dispatch on the tensors' device:
`downsample_planes` (the `down` stage: the three input planes) runs
`downsample2x` on CPU tensors and K9 (`downsample_k9`, one launch) on
CUDA tensors; `upsample_tiles` (the `up` stage: the base layer's deblocked
tiles to the enhancement's prediction tiles and guard-padded chroma
planes) runs `upsample_tiles_plain` or K10 (`upsample_k10`, one launch on
16-byte aligned tiles).
The wrappers refuse CPU tensors; the plain versions are the references
the kernels are held against.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from h264lab_tpu_torch.ops import cuda_build, qpel
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS  # noqa: F401
from h264lab_tpu_torch.ops.qpel import GUARD

SRC = cuda_build.CSRC / "resample.cu"
# each entry point takes one array of 64-bit words: the planes' addresses,
# then the sizes and the stream (`downsample_k9`, `upsample_k10`)
_lib = cuda_build.Library(SRC, {
    "h264lab_resample_down": ([ctypes.c_void_p], ctypes.c_int),
    "h264lab_resample_up": ([ctypes.c_void_p], ctypes.c_int)})
U8 = torch.uint8

# 16-phase 4-tap luma upsampling filter (SVC normative family); for the
# dyadic 2x case only phases 4 and 12 are exercised.
FILTER16_LUMA = np.array([
    [0, 32, 0, 0], [-1, 32, 2, -1], [-2, 31, 4, -1], [-3, 30, 6, -1],
    [-3, 28, 8, -1], [-4, 26, 11, -1], [-4, 24, 14, -2], [-3, 22, 16, -3],
    [-3, 19, 19, -3], [-3, 16, 22, -3], [-2, 14, 24, -4], [-1, 11, 26, -4],
    [-1, 8, 28, -3], [-1, 6, 30, -3], [-1, 4, 31, -2], [-1, 2, 32, -1],
], dtype=np.int32)


def downsample2x(plane: torch.Tensor) -> torch.Tensor:
    """Dyadic 2x downsampling by 2x2 box average (the reference's
    bilinear decimation); an odd last row or column is dropped."""
    h, w = plane.shape[-2:]
    x = plane[..., :h - h % 2, :w - w % 2].to(torch.int32)
    x = x.reshape(x.shape[:-2] + (h // 2, 2, w // 2, 2)).sum((-3, -1),
                                                           dtype=torch.int32)
    return ((x + 2) >> 2).to(torch.uint8)


def _up_axis(x: torch.Tensor, dim: int, even_taps, odd_taps) -> torch.Tensor:
    """2x upsampling of int32 `x` along `dim`: output 2i takes `even_taps`
    and 2i + 1 `odd_taps` over source samples i-1, i, i+1, ..., the edge
    samples replicated past both ends (JAX's `mode="edge"` padding)."""
    n = x.shape[dim]
    idx = torch.arange(-1, n + len(even_taps) - 2,
                       device=x.device).clamp(0, n - 1)
    p = x.index_select(dim, idx)

    def taps(f):
        return sum(int(c) * p.narrow(dim, k, n) for k, c in enumerate(f)
                   if c)
    out = torch.stack([taps(even_taps), taps(odd_taps)], dim=dim + 1)
    shape = list(x.shape)
    shape[dim] = 2 * n
    return out.reshape(shape)


def upsample2x_luma(plane: torch.Tensor) -> torch.Tensor:
    """Dyadic 2x intra upsampling (separable 4-tap, phases 4 and 12),
    rows first. Normalization: two passes of gain 32 -> (t + 512) >> 10,
    an arithmetic shift (first-pass sums go negative)."""
    x = plane.to(torch.int32)
    f4, f12 = FILTER16_LUMA[4], FILTER16_LUMA[12]
    t = _up_axis(x, x.ndim - 2, f4, f12)
    t = _up_axis(t, t.ndim - 1, f4, f12)
    return torch.clamp((t + 512) >> 10, 0, 255).to(torch.uint8)


def upsample2x_chroma(plane: torch.Tensor) -> torch.Tensor:
    """Dyadic 2x chroma upsampling (bilinear, phases 1/4 and 3/4), rows
    first, then (t + 8) >> 4."""
    x = plane.to(torch.int32)
    even, odd = (1, 3, 0), (0, 3, 1)
    t = _up_axis(x, x.ndim - 2, even, odd)
    t = _up_axis(t, t.ndim - 1, even, odd)
    return torch.clamp((t + 8) >> 4, 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# the `down` stage: K9
# ---------------------------------------------------------------------------

def downsample_planes(y, u, v):
    """The base layer's input: `downsample2x` of the (h, w) luma and (h/2,
    w/2) chroma planes, on their device. On CUDA tensors one launch of K9
    (`downsample_k9`); on CPU tensors the plain `downsample2x`."""
    if y.device.type == "cpu":
        return tuple(downsample2x(p) for p in (y, u, v))
    return downsample_k9(*(p.contiguous() for p in (y, u, v)))


@functools.lru_cache(maxsize=64)
def _down_plan(shapes: tuple):
    """The planes' checks (any address: K9 takes each plane on its 16-byte
    path where it can, else byte by byte), the outputs' buffer, their byte
    offsets in it and the kernel's size words, once per size."""
    if any(len(s) != 2 for s in shapes):
        raise ValueError(f"downsample_k9 (K9): planes of shapes "
                         f"{tuple(tuple(s) for s in shapes)}, not (h, w)")
    specs = tuple((name, U8, torch.Size(shape), 0)
                  for name, shape in zip(("y", "u", "v"), shapes))
    nbytes, views, offsets = cuda_build.buffer_plan(tuple(
        (name, U8, (h // 2, w // 2)) for name, (h, w) in zip("yuv", shapes)))
    return (specs, nbytes, views, [offsets[name] for name in "yuv"],
            [int(d) for shape in shapes for d in shape])


def downsample_k9(y, u, v):
    """K9: `downsample2x` of three contiguous 2-D uint8 planes on one CUDA
    device, at any address, one launch. Returns the three half-size
    planes, views of one buffer. Raises on any other input."""
    what = "downsample_k9 (K9)"
    index = cuda_build.card_of(what, y)
    try:
        shapes = (y.shape, u.shape, v.shape)
    except AttributeError:
        shapes = tuple(tuple(getattr(p, "shape", ())) for p in (y, u, v))
    specs, nbytes, views, offsets, sizes = _down_plan(shapes)
    ptrs = cuda_build.pointers(what, (y, u, v), specs, index)
    buf = torch.empty(nbytes, dtype=U8, device=y.device)
    out = cuda_build.buffer_views(buf, views)
    base = buf.data_ptr()
    cuda_build.call(_lib().h264lab_resample_down, ptrs + [
        base + at for at in offsets] + sizes + [cuda_build.stream_of(index)],
        "2x downsampling", index)
    cuda_build.count_launch("resample_down")
    return out["y"], out["u"], out["v"]


# ---------------------------------------------------------------------------
# the `up` stage: K10
# ---------------------------------------------------------------------------

def upsample_tiles(base_tiles, base_mb_width: int, crops, mb_width: int,
                   mb_height: int):
    """The base-mode frame's prediction from the base layer's deblocked
    tiles: each plane of `base_tiles` ((bnmb, t, t) uint8, Y, U, V, or
    with a leading axis of 1), cropped to its (h, w) of `crops` (the base
    picture), upsampled 2x (`upsample2x_luma`, `upsample2x_chroma`),
    edge-replicated to the enhancement's padded size of mb_width x
    mb_height MBs and cut into its MB tiles. Returns (pred_y, pred_u,
    pred_v, u_pad, v_pad): the (1, nmb, t, t) tiles and the chroma planes
    guard-padded by GUARD // 2, (1, 8 mb_height + GUARD, 8 mb_width +
    GUARD), which the base-mode frame's chroma prediction reads. On CUDA
    tensors one launch of K10 (`upsample_k10`; tiles that are not 16-byte
    aligned copied first, `_k10_tiles`); on CPU tensors
    `upsample_tiles_plain`."""
    tiles = tuple(t.reshape((-1,) + t.shape[-2:]) for t in base_tiles)
    crops = tuple((int(h), int(w)) for h, w in crops)
    if tiles[0].device.type == "cpu":
        return upsample_tiles_plain(tiles, base_mb_width, crops, mb_width,
                                    mb_height)
    return upsample_k10(*(_k10_tiles(t) for t in tiles), base_mb_width,
                        crops, mb_width, mb_height)


# tiles in the form K10 takes (it bulk-copies them); no copy where they
# are, as on the base-mode IDR's `up` stage (K2's outputs are fresh
# allocations)
_k10_tiles = cuda_build.aligned16


def upsample_tiles_plain(base_tiles, base_mb_width: int, crops,
                         mb_width: int, mb_height: int):
    """`upsample_tiles` in plain PyTorch: the base planes from their tiles
    (`refstate.tiles_to_planes`), cropped, `upsample2x_*`, `stages.pad_to`,
    the tiling, and `qpel.pad_guard` of the padded chroma planes."""
    from h264lab_tpu_torch.models.refstate import tiles_to_planes
    from h264lab_tpu_torch.models.stages import pad_to

    pred, pads = [], []
    for tiles, (h, w), up in zip(base_tiles, crops, (
            upsample2x_luma, upsample2x_chroma, upsample2x_chroma)):
        t = tiles.shape[-1]
        plane = tiles_to_planes(tiles[None], tiles.shape[0] // base_mb_width,
                                base_mb_width)[0, :h, :w]
        th, tw = mb_height * t, mb_width * t
        p = pad_to(up(plane)[None], th, tw)
        pred.append(p.reshape(1, mb_height, t, mb_width, t)
                    .permute(0, 1, 3, 2, 4).reshape(1, -1, t, t))
        pads.append(qpel.pad_guard(p, GUARD // 2))
    return (*pred, pads[1], pads[2])


UP_OUTPUTS = ("pred_y", "pred_u", "pred_v", "u_pad", "v_pad")


@functools.lru_cache(maxsize=64)
def _up_plan(base_nmb: int, base_mb_width: int, crops: tuple, mb_width: int,
             mb_height: int):
    """The sizes' and crops' checks, the tiles' specs (16-byte aligned: K10
    bulk-copies them), the outputs' buffer, their byte offsets in it and
    the kernel's size words, once per size."""
    what = "upsample_k10 (K10)"
    bmbh = base_nmb // base_mb_width if base_mb_width > 0 else 0
    if (base_mb_width <= 0 or bmbh * base_mb_width != base_nmb
            or mb_width <= 0 or mb_height <= 0 or len(crops) != 3):
        raise ValueError(f"{what}: {base_nmb} base MBs are no whole rows of "
                         f"{base_mb_width}, or {mb_width} x {mb_height} "
                         f"enhancement MBs, or crops {crops}")
    for (h, w), t in zip(crops, (16, 8, 8)):
        if not (0 < h <= bmbh * t and 0 < w <= base_mb_width * t):
            raise ValueError(f"{what}: crop {(h, w)} outside the base "
                             f"planes of {bmbh} x {base_mb_width} MBs")
    nmb = mb_width * mb_height
    ch, cw = 8 * mb_height + GUARD, 8 * mb_width + GUARD
    specs = tuple((name, U8, torch.Size((base_nmb, t, t)), 15)
                  for name, t in (("base_y", 16), ("base_u", 8),
                                  ("base_v", 8)))
    nbytes, views, offsets = cuda_build.buffer_plan((
        ("pred_y", U8, (1, nmb, 16, 16)), ("pred_u", U8, (1, nmb, 8, 8)),
        ("pred_v", U8, (1, nmb, 8, 8)), ("u_pad", U8, (1, ch, cw)),
        ("v_pad", U8, (1, ch, cw))))
    return (specs, nbytes, views, [offsets[name] for name in UP_OUTPUTS],
            [base_mb_width] + [d for crop in crops for d in crop]
            + [mb_width, mb_height, GUARD // 2])


def upsample_k10(base_y, base_u, base_v, base_mb_width: int, crops,
                 mb_width: int, mb_height: int):
    """K10: `upsample_tiles` on the card, one launch. base_y (bnmb, 16,
    16), base_u and base_v (bnmb, 8, 8) uint8, contiguous and 16-byte
    aligned on one CUDA device, bnmb whole rows of base_mb_width MBs;
    crops ((h, w), (hc, wc), (hc, wc)), each at least a pixel and within
    its base plane. Returns (pred_y, pred_u, pred_v, u_pad, v_pad), views
    of one buffer. Raises on any other input: the plain version is
    `upsample_tiles_plain`."""
    what = "upsample_k10 (K10)"
    index = cuda_build.card_of(what, base_y)
    base_nmb = int(getattr(base_y, "shape", (0,))[0])
    try:
        plan = _up_plan(base_nmb, base_mb_width, crops, mb_width, mb_height)
    except TypeError:               # crops given as lists
        plan = _up_plan(base_nmb, base_mb_width, tuple(
            (int(h), int(w)) for h, w in crops), mb_width, mb_height)
    specs, nbytes, views, offsets, sizes = plan
    ptrs = cuda_build.pointers(what, (base_y, base_u, base_v), specs, index)
    buf = torch.empty(nbytes, dtype=U8, device=base_y.device)
    out = cuda_build.buffer_views(buf, views)
    base = buf.data_ptr()
    cuda_build.call(_lib().h264lab_resample_up, ptrs + [
        base + at for at in offsets] + sizes + [cuda_build.stream_of(index)],
        "2x upsampling", index)
    cuda_build.count_launch("resample_up")
    return tuple(out[name] for name in UP_OUTPUTS)
