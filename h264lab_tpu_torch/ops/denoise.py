"""Temporal denoising pre-filter: a recursive per-pixel blend of the
current frame toward the previous denoised frame, whose gain decays with
the local temporal difference (strong smoothing for small, noise-like
differences; none for large, motion-like ones).

PyTorch counterpart of `h264lab_tpu/ops/denoise.py`. `denoise_planes`, the
stage entry, dispatches on the planes' device: on CUDA tensors one launch
of K13 (`denoise_k13`, the CUDA kernel of `csrc/denoise.cu`, built with
nvcc at first use and bound with ctypes) for the frame's three planes, on
CPU tensors the plain `denoise_plane` of each plane, the reference K13 is
held against.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from h264lab_tpu_torch.ops import cuda_build
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS  # noqa: F401
from h264lab_tpu_torch.ops.qpel import pad_guard

# gain LUT in Q8 indexed by |diff| (0..31, clamped): ~0.75 blend at diff 0
# decaying to 0 by diff ~12
GAIN_Q8 = np.clip(192 - np.arange(32) * 16, 0, 255).astype(np.int32)

SRC = cuda_build.CSRC / "denoise.cu"
# the entry point takes one array of 64-bit words: the planes' addresses,
# their sizes, the 32 gains and the stream
_lib = cuda_build.Library(SRC, {"h264lab_denoise": (
    [ctypes.c_void_p], ctypes.c_int)})
U8 = torch.uint8


def denoise_plane(cur: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """One recursive denoise step of (H, W) uint8 planes: returns the
    denoised current plane; `prev` is the previous denoised one."""
    c = cur.to(torch.int32)
    d = c - prev.to(torch.int32)
    ad = d.abs()
    # neighbourhood activity: the mean of the 4-neighbour abs diffs (edge
    # replicated); high activity (real motion or texture change) suppresses
    # the blend
    p = pad_guard(ad, 1)
    act = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] + 2) >> 2
    gain = torch.as_tensor(GAIN_Q8, device=cur.device)[
        torch.maximum(ad, act).clamp(0, 31).long()]
    return torch.clamp(c - ((d * gain) >> 8), 0, 255).to(torch.uint8)


def denoise_planes(cur, prev):
    """One recursive denoise step of a frame: cur and prev the (Y, U, V)
    uint8 planes of the current frame and the previous denoised one, on one
    device. Returns the denoised (Y, U, V). On CUDA tensors one launch of
    K13 (`denoise_k13`); on CPU tensors `denoise_plane` of each plane."""
    if cur[0].device.type == "cpu":
        return tuple(denoise_plane(c, p) for c, p in zip(cur, prev))
    return denoise_k13(*(p.contiguous() for p in (*cur, *prev)))


def gain_words() -> list:
    """The gains K13 is handed, GAIN_Q8 in its order."""
    return [int(g) for g in GAIN_Q8]


@functools.lru_cache(maxsize=64)
def _plan(shapes: tuple):
    """The planes' checks (any address), the outputs' buffer, their byte
    offsets in it and the kernel's size and gain words, once per size."""
    if any(len(s) != 2 for s in shapes):
        raise ValueError(f"denoise_k13 (K13): planes of shapes "
                         f"{tuple(tuple(s) for s in shapes)}, not (h, w)")
    specs = tuple((f"{kind} {name}", U8, torch.Size(shape), 0)
                  for kind in ("cur", "prev")
                  for name, shape in zip("yuv", shapes))
    nbytes, views, offsets = cuda_build.buffer_plan(tuple(
        (name, U8, tuple(shape)) for name, shape in zip("yuv", shapes)))
    return (specs, nbytes, views, [offsets[name] for name in "yuv"],
            [int(d) for shape in shapes for d in shape] + gain_words())


def denoise_k13(cur_y, cur_u, cur_v, prev_y, prev_u, prev_v):
    """K13: the denoised (Y, U, V) of a frame from its contiguous 2-D
    uint8 planes and the previous denoised ones (each the same shape as
    its current plane) on one CUDA device, at any address, one launch.
    Returns the three planes, views of one buffer. Raises on any other
    input: the plain version is `denoise_plane`."""
    what = "denoise_k13 (K13)"
    index = cuda_build.card_of(what, cur_y)
    try:
        shapes = (cur_y.shape, cur_u.shape, cur_v.shape)
    except AttributeError:
        shapes = tuple(tuple(getattr(p, "shape", ()))
                       for p in (cur_y, cur_u, cur_v))
    specs, nbytes, views, offsets, sizes = _plan(shapes)
    ptrs = cuda_build.pointers(what, (cur_y, cur_u, cur_v, prev_y, prev_u,
                                      prev_v), specs, index)
    buf = torch.empty(nbytes, dtype=U8, device=cur_y.device)
    out = cuda_build.buffer_views(buf, views)
    base = buf.data_ptr()
    cuda_build.call(_lib().h264lab_denoise, ptrs + [
        base + at for at in offsets] + sizes + [cuda_build.stream_of(index)],
        "temporal denoise", index)
    cuda_build.count_launch("denoise")
    return out["y"], out["u"], out["v"]
