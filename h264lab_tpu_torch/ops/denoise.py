"""Temporal denoising pre-filter: a recursive per-pixel blend of the
current frame toward the previous denoised frame, whose gain decays with
the local temporal difference (strong smoothing for small, noise-like
differences; none for large, motion-like ones).

PyTorch counterpart of `h264lab_tpu/ops/denoise.py`, one fused
elementwise pass on the planes where they lie (the card, or the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from h264lab_tpu_torch.ops.qpel import pad_guard

# gain LUT in Q8 indexed by |diff| (0..31, clamped): ~0.75 blend at diff 0
# decaying to 0 by diff ~12
GAIN_Q8 = np.clip(192 - np.arange(32) * 16, 0, 255).astype(np.int32)


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
