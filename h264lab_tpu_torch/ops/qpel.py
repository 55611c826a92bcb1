"""Guard padding, per-MB reference windows and chroma motion compensation.

PyTorch counterpart of the parts of `h264lab_tpu/ops/qpel.py` that the P
path runs: `GUARD`, `pad_guard`, `mc_chroma_uniform` (one MV per MB) and
`mc_chroma` / `mc_chroma_grid` (one MV per 4x4 luma block, partitioned
MBs). Luma sub-pel samples come from the ME windows (`ops/me.py`), so no
frame-level half-pel planes exist.

`windows` is the one per-MB window read of the port: where the JAX package
used `lax.dynamic_slice` per MB (and, for the zero-MV windows, strided
reshapes to spare the TPU a gather), the port does one indexed gather. A
start past the end is clamped into the plane as `lax.dynamic_slice`
clamps it, so it reads the same pixels on both sides; a negative start,
which `lax.dynamic_slice` counts from the end, is clamped to 0. No start
of the P path is negative (`mc_chroma`).
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
    the plane (as `lax.dynamic_slice` clamps a start past the end). Keeps
    the planes' dtype."""
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


def mc_chroma(planes, lane, mv_y, mv_x, base_y, base_x, bh: int, bw: int):
    """Chroma MC with the eighth-pel bilinear (spec 8.4.2.2.2) of (K, bh,
    bw) blocks: block k reads the plane of lane `lane[k]` from (base_y[k],
    base_x[k]) moved by its MV (luma quarter-pel = chroma eighth-pel).

    The blocks are read with one plain index gather, where the JAX package
    reads them as `plane[yy, xx]` (`gather_blocks`), which would clamp an
    index past the end and wrap a negative one. No index of the P path
    leaves the plane, so the two agree: a chroma plane has a GUARD // 2 =
    32 pixel guard ring, and an MV is at most the candidate-centre clip
    me.MAX_CAND_FP = 52 plus the +-3 refine, the +-2 partition sweep and
    +-0.75 quarter-pel, 57.75 luma = 28.875 chroma pixels; so a read starts
    at least 32 - 29 = 3 pixels inside the ring and ends at most 29 + 1 of
    the bilinear's neighbour = 30 pixels into the far one. An index out of
    the plane would raise here, not read other pixels."""
    iy = base_y + (mv_y >> 3)
    ix = base_x + (mv_x >> 3)
    fy = (mv_y & 7)[:, None, None]
    fx = (mv_x & 7)[:, None, None]
    dev = planes.device
    ry = iy.long()[:, None] + torch.arange(bh + 1, device=dev)
    rx = ix.long()[:, None] + torch.arange(bw + 1, device=dev)
    w = planes[lane.long()[:, None, None], ry[:, :, None],
               rx[:, None, :]].to(I32)
    a, b = w[:, :bh, :bw], w[:, :bh, 1:]
    c, d = w[:, 1:, :bw], w[:, 1:, 1:]
    out = ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
           + (8 - fx) * fy * c + fx * fy * d + 32) >> 6
    return out.to(torch.uint8)


def mc_chroma_grid(planes, lane, mv4_y, mv4_x, cb_base_y, cb_base_x):
    """Chroma MC of MBs with one MV per 4x4 luma block (2x2 chroma pixels
    each), so partitions may differ inside an MB. planes (L, h, w); lane,
    cb_base_y, cb_base_x (K,); mv4_y/mv4_x (K, 4, 4) quarter-pel. Returns
    (K, 8, 8) uint8."""
    k = mv4_y.shape[0]
    o = torch.arange(4, dtype=I32, device=mv4_y.device) * 2
    by = (cb_base_y[:, None, None] + o[None, :, None]).expand(k, 4, 4)
    bx = (cb_base_x[:, None, None] + o[None, None, :]).expand(k, 4, 4)
    blocks = mc_chroma(planes, lane.repeat_interleave(16),
                       mv4_y.reshape(-1), mv4_x.reshape(-1),
                       by.reshape(-1), bx.reshape(-1), 2, 2)
    return (blocks.reshape(k, 4, 4, 2, 2).permute(0, 1, 3, 2, 4)
            .reshape(k, 8, 8))
