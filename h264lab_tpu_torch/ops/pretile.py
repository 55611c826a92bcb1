"""K12: the source planes of G lanes edge-replicated to the padded picture
and cut into MB tiles, the CUDA kernel of `csrc/pretile.cu`, built with
nvcc at first use and bound with ctypes.

K12 (`tiles_k12`, one launch for the three planes of all lanes) is the
`pre` stage of every encode path: it replaces the JAX package's host
padding `h264lab_tpu/models/wavefront.py:70-75` `pad_plane` and its
device tiling `pre_fn` (`h264lab_tpu/parallel/gop.py:94-106`). Its plain
version is `stages.source_tiles_plain`; `stages.source_tiles` is the stage
entry that dispatches on the planes' device, and `stages.Staging` uploads
numpy planes to the card through pinned memory before it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from h264lab_tpu_torch.ops import cuda_build
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS  # noqa: F401

SRC = cuda_build.CSRC / "pretile.cu"
# the entry point takes one array of 64-bit words: the sizes, the tiles'
# addresses, the stream, then each lane's planes' addresses and pitches
_lib = cuda_build.Library(SRC, {"h264lab_pad_tiles": (
    [ctypes.c_void_p], ctypes.c_int)})
U8 = torch.uint8
TILE = (16, 8, 8)
NAMES = ("y", "u", "v")


@functools.lru_cache(maxsize=64)
def _plan(n: int, mb_width: int, mb_height: int):
    """The tiles' buffer and views, once per size."""
    nmb = mb_width * mb_height
    return cuda_build.buffer_plan(tuple(
        (name, U8, (n, nmb, t, t)) for name, t in zip(NAMES, TILE)))[:2]


def _table(planes, shapes, index: int) -> list:
    """The kernel's table: per lane, its Y, U and V planes' (address,
    pitch). Each plane a 2-D uint8 tensor of its plane's shape on card
    `index` whose rows are contiguous (any address, any pitch of at least
    its width); `_refuse` raises for the first that is not."""
    n = len(planes[0])
    table = [0] * (6 * n)
    for p, (lanes, shape) in enumerate(zip(planes, shapes)):
        h, w = shape
        at = 2 * p
        try:
            for x in lanes:
                s0, s1 = x.stride()
                if (x.dtype is not U8 or x.shape != shape
                        or x.get_device() != index
                        or (w > 1 and s1 != 1) or (h > 1 and s0 < w)):
                    break
                table[at] = x.data_ptr()
                table[at + 1] = s0 if h > 1 else w
                at += 6
            else:
                continue
        except (AttributeError, ValueError):
            pass
        for x in lanes:
            _refuse("tiles_k12 (K12)", x, shape, index)
        raise AssertionError("tiles_k12 (K12): a plane was refused, then "
                             "taken")
    return table


def _refuse(what: str, x, shape, index: int):
    """Raise if `_table` does not take plane `x`."""
    if not isinstance(x, torch.Tensor) or x.get_device() != index:
        raise ValueError(f"{what}: a plane is not a tensor on cuda:{index} "
                         f"({getattr(x, 'device', x)!r})")
    if x.dtype is not U8:
        raise TypeError(f"{what}: a plane is {x.dtype}, not {U8}")
    if x.shape != shape:
        raise ValueError(f"{what}: planes of shapes {tuple(x.shape)} and "
                         f"{tuple(shape)} in one plane's lanes")
    h, w = shape
    if (w > 1 and x.stride(1) != 1) or (h > 1 and x.stride(0) < w):
        raise ValueError(f"{what}: a plane's rows are not contiguous "
                         f"(strides {x.stride()})")


def tiles_k12(planes, mb_width: int, mb_height: int):
    """K12: the (G, mb_width mb_height, t, t) uint8 tiles of G lanes'
    planes, edge-replicated to (mb_height t, mb_width t) (t = 16, 8, 8),
    one launch. planes: (Y, U, V), each G 2-D uint8 tensors of one shape
    (at least a pixel) on one CUDA device, rows contiguous, at any address
    and pitch. Returns the three tile tensors, views of one buffer. Raises
    on any other input: the plain version is `stages.source_tiles_plain`."""
    what = "tiles_k12 (K12)"
    if len(planes) != 3 or len({len(lanes) for lanes in planes}) != 1:
        raise ValueError(f"{what}: takes Y, U and V planes of the same lanes")
    if mb_width <= 0 or mb_height <= 0:
        raise ValueError(f"{what}: {mb_width} x {mb_height} MBs")
    n = len(planes[0])
    if n == 0:
        raise ValueError(f"{what}: no lanes")
    index = cuda_build.card_of(what, planes[0][0])
    shapes = [getattr(lanes[0], "shape", None) for lanes in planes]
    if any(s is None or len(s) != 2 or 0 in s for s in shapes):
        raise ValueError(f"{what}: planes of shapes {shapes}, not (h, w) of "
                         "at least a pixel")
    table = _table(planes, shapes, index)
    nbytes, views = _plan(n, mb_width, mb_height)
    buf = torch.empty(nbytes, dtype=U8, device=planes[0][0].device)
    out = cuda_build.buffer_views(buf, views)
    base = buf.data_ptr()
    offsets = [base + off for *_, off in views]
    cuda_build.call(_lib().h264lab_pad_tiles, [n, mb_width, mb_height] + [
        d for s in shapes for d in s] + offsets + [
        cuda_build.stream_of(index)] + table, "pad and tile", index)
    cuda_build.count_launch("pad_tiles")
    return out["y"], out["u"], out["v"]
