"""Intra 16x16 and chroma prediction, batched over macroblocks.

PyTorch counterpart of `h264lab_tpu/ops/intra.py` (same mode numbering:
luma 0=V, 1=H, 2=DC; chroma 0=DC, 1=H, 2=V). Mode selection is a masked
SAD argmin; `torch.argmin` returns the first minimum, as `jnp.argmin`
does, so ties resolve identically.
"""

from __future__ import annotations

import torch

I32 = torch.int32
INVALID_COST = 1 << 30


def _dc(avail_top, avail_left, both, t_only, l_only):
    return torch.where(avail_top & avail_left, both,
                       torch.where(avail_top, t_only,
                                   torch.where(avail_left, l_only, 128)))


def predict_16x16(top: torch.Tensor, left: torch.Tensor,
                  avail_top: torch.Tensor, avail_left: torch.Tensor):
    """top/left (k, 16) uint8 edges, avail_* (k,) bool. Returns (k, 3, 16,
    16) uint8 predictions [V, H, DC] and a (k, 3) bool validity mask."""
    top = top.to(I32)
    left = left.to(I32)
    k = top.shape[0]
    pred_v = top[:, None, :].expand(k, 16, 16)
    pred_h = left[:, :, None].expand(k, 16, 16)
    sum_t = top.sum(1, dtype=I32)
    sum_l = left.sum(1, dtype=I32)
    dc = _dc(avail_top, avail_left, (sum_t + sum_l + 16) >> 5,
             (sum_t + 8) >> 4, (sum_l + 8) >> 4)
    pred_dc = dc[:, None, None].expand(k, 16, 16)
    preds = torch.stack([pred_v, pred_h, pred_dc], dim=1)
    valid = torch.stack([avail_top, avail_left,
                         torch.ones_like(avail_top)], dim=1)
    return preds.to(torch.uint8), valid


def predict_chroma(top: torch.Tensor, left: torch.Tensor,
                   avail_top: torch.Tensor, avail_left: torch.Tensor):
    """top/left (k, 8) uint8 edges of one plane. Returns (k, 3, 8, 8) uint8
    [DC, H, V] and (k, 3) validity; DC per 4x4 quadrant (spec 8.3.4.1)."""
    top = top.to(I32)
    left = left.to(I32)
    k = top.shape[0]
    pred_v = top[:, None, :].expand(k, 8, 8)
    pred_h = left[:, :, None].expand(k, 8, 8)
    st0 = top[:, 0:4].sum(1, dtype=I32)
    st1 = top[:, 4:8].sum(1, dtype=I32)
    sl0 = left[:, 0:4].sum(1, dtype=I32)
    sl1 = left[:, 4:8].sum(1, dtype=I32)

    def quad_dc(sum_t, sum_l, prefer):
        both = (sum_t + sum_l + 4) >> 3
        t_only = (sum_t + 2) >> 2
        l_only = (sum_l + 2) >> 2
        if prefer == "both":
            return _dc(avail_top, avail_left, both, t_only, l_only)
        if prefer == "top":
            return torch.where(avail_top, t_only,
                               torch.where(avail_left, l_only, 128))
        return torch.where(avail_left, l_only,
                           torch.where(avail_top, t_only, 128))

    q = torch.stack([quad_dc(st0, sl0, "both"), quad_dc(st1, sl0, "top"),
                     quad_dc(st0, sl1, "left"), quad_dc(st1, sl1, "both")],
                    dim=1).reshape(k, 2, 1, 2, 1)
    pred_dc = q.expand(k, 2, 4, 2, 4).reshape(k, 8, 8)
    preds = torch.stack([pred_dc, pred_h, pred_v], dim=1)
    valid = torch.stack([torch.ones_like(avail_top), avail_left, avail_top],
                        dim=1)
    return preds.to(torch.uint8), valid


def sad(a: torch.Tensor, b: torch.Tensor, dims=(-2, -1)) -> torch.Tensor:
    """Sum of absolute differences over trailing dims, int32."""
    return (a.to(I32) - b.to(I32)).abs().sum(dims, dtype=I32)


def pick(preds: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
    """preds (k, m, ...) -> (k, ...) the prediction of each row's mode."""
    return preds[torch.arange(preds.shape[0], device=preds.device), mode]


def select_mode(src: torch.Tensor, preds: torch.Tensor, valid: torch.Tensor):
    """Masked SAD argmin. src (k, h, w); preds (k, m, h, w); valid (k, m).
    Returns (mode (k,) int32, best_pred (k, h, w), cost (k,) int32)."""
    costs = torch.where(valid, sad(src[:, None], preds), INVALID_COST)
    cost, mode = costs.min(dim=1)
    return mode.to(I32), pick(preds, mode), cost
