"""SVC spatial resampling: 2x frame downsampling for the base layer and
the normative-style 4-tap / bilinear intra upsampling for inter-layer
prediction.

PyTorch counterpart of `h264lab_tpu/ops/resample.py` (reference
`h264e_frame_downsampling` `src/h264-lab.h:2984-3048` and
`h264e_intra_upsampling` `:3078-3183`). Whole planes on the tensor's own
device, integer-exact, over any leading batch axes: (..., h, w) uint8 in,
uint8 out.
"""

from __future__ import annotations

import numpy as np
import torch

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
