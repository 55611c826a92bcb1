"""Guard padding, per-MB reference windows and chroma motion compensation.

PyTorch counterpart of the parts of `h264lab_tpu/ops/qpel.py` that the
speed-2 P path runs: `GUARD`, `pad_guard` and `mc_chroma_uniform`. Luma
sub-pel samples come from the ME windows (`ops/me.py`), so no frame-level
half-pel planes exist.

`windows` is the one per-MB window read of the port: where the JAX package
used `lax.dynamic_slice` per MB (and, for the zero-MV windows, strided
reshapes to spare the TPU a gather), the port does one indexed gather. Its
starts are clamped into the plane exactly as `lax.dynamic_slice` clamps
them, so an out-of-range start reads the same pixels on both sides.
Reference planes are lane-batched, (L, H, W), and window k reads the plane
of its lane `lane[k]`.
"""

from __future__ import annotations

import torch

GUARD = 64  # luma guard ring in pixels: the coarse +-32 MV range, the +-3
            # refine, the 6-tap support, the ME window margin and the
            # previous-MV candidate reach (me.MAX_CAND_FP = 52 full-pel)

I32 = torch.int32


def pad_guard(plane: torch.Tensor, guard: int = GUARD) -> torch.Tensor:
    """Edge-replicate pad of (..., H, W) planes by `guard` on every side."""
    h, w = plane.shape[-2:]
    dev = plane.device
    iy = torch.arange(-guard, h + guard, device=dev).clamp(0, h - 1)
    ix = torch.arange(-guard, w + guard, device=dev).clamp(0, w - 1)
    return plane.index_select(-2, iy).index_select(-1, ix)


def windows(planes: torch.Tensor, lane: torch.Tensor, oy: torch.Tensor,
            ox: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """(K, sh, sw) windows of (L, H, W) planes: window k is
    planes[lane[k], oy[k]:oy[k]+sh, ox[k]:ox[k]+sw], its start clamped into
    the plane as `lax.dynamic_slice` clamps it. Keeps the planes' dtype."""
    _, h, w = planes.shape
    dev = planes.device
    oy = oy.long().clamp(0, h - sh)
    ox = ox.long().clamp(0, w - sw)
    ry = oy[:, None] + torch.arange(sh, device=dev)
    rx = ox[:, None] + torch.arange(sw, device=dev)
    return planes[lane.long()[:, None, None], ry[:, :, None], rx[:, None, :]]


def shift_window(x: torch.Tensor, sel: torch.Tensor, base: int, size: int,
                 axis: int) -> torch.Tensor:
    """out[k] = x[k] sliced at base + sel[k] for `size` along `axis` (one
    index gather; the JAX package's shift-select chains)."""
    shape = list(x.shape)
    shape[axis] = size
    view = [1] * x.ndim
    view[0] = x.shape[0]
    ar = [1] * x.ndim
    ar[axis] = size
    idx = (base + sel.long()).reshape(view) + torch.arange(
        size, device=x.device).reshape(ar)
    return x.gather(axis, idx.expand(shape))


def mc_chroma_uniform(u_pad, v_pad, lane, cb_y, cb_x, full_my, full_mx,
                      mv_y, mv_x):
    """Uniform-MV (16x16) chroma MC of both planes (spec 8.4.2.2.2).

    u_pad/v_pad (L, h, w) lane-batched guard-padded chroma planes; lane,
    cb_y, cb_x (K,): each MB's lane and chroma block base in padded
    coordinates; full_my/full_mx: the full-pel ME winner; mv_y/mv_x: the
    final quarter-pel MV (within +-0.75 px of the winner). A (2, 10, 10)
    window at the winner, re-centred by 0 or 1 chroma pixel on the final
    MV, then the eighth-pel bilinear. Returns (pred_u, pred_v), (K, 8, 8)
    uint8."""
    oy = cb_y + (full_my >> 1) - 1
    ox = cb_x + (full_mx >> 1) - 1
    win = torch.stack([windows(p, lane, oy, ox, 10, 10)
                       for p in (u_pad, v_pad)], dim=1).to(I32)
    ry = (mv_y >> 3) - ((full_my >> 1) - 1)                 # 0 or 1
    rx = (mv_x >> 3) - ((full_mx >> 1) - 1)
    w9 = shift_window(shift_window(win, ry, 0, 9, 2), rx, 0, 9, 3)
    fy = (mv_y & 7)[:, None, None, None]
    fx = (mv_x & 7)[:, None, None, None]
    a = w9[:, :, 0:8, 0:8]
    b = w9[:, :, 0:8, 1:9]
    c = w9[:, :, 1:9, 0:8]
    d = w9[:, :, 1:9, 1:9]
    out = ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
           + (8 - fx) * fy * c + fx * fy * d + 32) >> 6
    out = out.to(torch.uint8)
    return out[:, 0], out[:, 1]
