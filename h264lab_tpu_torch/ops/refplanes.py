"""K11: the reference planes of L pictures from their deblocked MB tiles,
the CUDA kernel of `csrc/refplanes.cu`, built with nvcc at first use and
bound with ctypes.

K11 (`planes_k11`, one launch for all L pictures) is the `ref` stage of
every encode path: the guard-padded y_pad, u_pad and v_pad and the 4x
pyramid y4_pad of `models/refstate.prepare_reference`. It replaces
`h264lab_tpu/models/refstate.py:28-47`, which the JAX package left to
XLA. Its plain version is `refstate.prepare_reference_plain`;
`refstate.prepare_reference` (every path's `ref` stage, the mesh's
`exchange` once per device) and `refstate.reference_chroma` (the chroma
planes alone) are the stage entries that dispatch on the tiles' device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from h264lab_tpu_torch.ops import cuda_build
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS  # noqa: F401
from h264lab_tpu_torch.ops.qpel import GUARD

SRC = cuda_build.CSRC / "refplanes.cu"
# the entry point takes one array of 64-bit words: the tiles' and the
# planes' addresses, then the sizes and the stream
_lib = cuda_build.Library(SRC, {"h264lab_reference_planes": (
    [ctypes.c_void_p], ctypes.c_int)})
U8 = torch.uint8
PLANES = ("y_pad", "u_pad", "v_pad", "y4_pad")


@functools.lru_cache(maxsize=64)
def _plan(n: int, mb_width: int, mb_height: int, luma: bool):
    """The tiles' checks (16-byte aligned: K11 bulk-copies them), the
    planes' buffer and the kernel's words after the tiles' addresses (each
    plane's byte offset in the buffer, -1 for a plane not written, then the
    sizes), once per size."""
    nmb = mb_width * mb_height
    H, W = 16 * mb_height, 16 * mb_width
    names = ("y", "u", "v") if luma else ("u", "v")
    specs = tuple((f"{name} tiles", U8, torch.Size((n, nmb, t, t)), 15)
                  for name, t in zip(names, (16, 8, 8)[-len(names):]))
    layout = (("y_pad", U8, (n, H + 2 * GUARD, W + 2 * GUARD)),
              ("u_pad", U8, (n, H // 2 + GUARD, W // 2 + GUARD)),
              ("v_pad", U8, (n, H // 2 + GUARD, W // 2 + GUARD)),
              ("y4_pad", U8, (n, H // 4 + GUARD // 2, W // 4 + GUARD // 2)))
    nbytes, views, offsets = cuda_build.buffer_plan(
        layout if luma else layout[1:3])
    return (specs, nbytes, views, [offsets.get(k, -1) for k in PLANES],
            [n, mb_width, mb_height, GUARD])


def planes_k11(y, u, v, mb_width: int, mb_height: int) -> dict:
    """K11: the reference planes of L pictures on the card, one launch.
    y (L, nmb, 16, 16), u and v (L, nmb, 8, 8) uint8 tiles of mb_width x
    mb_height MBs, contiguous and 16-byte aligned on one CUDA device; y may
    be None, and then only u_pad and v_pad are written. Returns
    `refstate.prepare_reference_plain`'s dict (or its two chroma planes),
    every plane a view of one buffer. Raises on any other input."""
    what = "planes_k11 (K11)"
    index = cuda_build.card_of(what, u)
    n = int(getattr(u, "shape", (0,))[0])
    if mb_width <= 0 or mb_height <= 0:
        raise ValueError(f"{what}: {mb_width} x {mb_height} MBs")
    luma = y is not None
    specs, nbytes, views, planes, sizes = _plan(n, mb_width, mb_height, luma)
    ptrs = cuda_build.pointers(what, (y, u, v) if luma else (u, v), specs,
                               index)
    buf = torch.empty(nbytes, dtype=U8, device=u.device)
    out = cuda_build.buffer_views(buf, views)
    if n:
        base = buf.data_ptr()
        cuda_build.call(_lib().h264lab_reference_planes, (
            ptrs if luma else [0] + ptrs) + [
            base + at if at >= 0 else 0 for at in planes] + sizes + [
            cuda_build.stream_of(index)], "reference planes", index)
        cuda_build.count_launch("refplanes")
    return out
