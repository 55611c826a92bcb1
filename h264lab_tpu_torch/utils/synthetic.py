"""Deterministic synthetic test input: rotating chessboard.

Behavioral clone of the reference driver's asset-free input generator
(`src/minih264e_test.c:407-452`): an anti-aliased chessboard rotated by
0.01 rad/frame, gray chroma. Lets every test and benchmark run without
shipping video assets. Vectorized over the full frame; C truncation
semantics (`(int)x`, `i/16`) are reproduced with trunc operations.
"""

from __future__ import annotations

import numpy as np


def _pixel_field(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    mid = (np.abs(x) < 4) & (np.abs(y) < 4)
    i = np.trunc(x).astype(np.int64)
    j = np.trunc(y).astype(np.int64)
    idiv16 = np.trunc(i / 16.0).astype(np.int64)   # C truncating division
    jdiv16 = np.trunc(j / 16.0).astype(np.int64)
    black = np.where(mid, 128, idiv16)
    white = np.where(mid, 128, 255 - jdiv16)

    def cell(ii, jj):
        return np.where((((ii >> 4) + (jj >> 4)) & 1) != 0, white, black)

    c00 = cell(i, j)
    c01 = cell(i + 1, j)
    c10 = cell(i, j + 1)
    c11 = cell(i + 1, j + 1)
    fx = x - i
    fy = y - j
    s = ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
         + (c10 * (1 - fx) + c11 * fx) * fy + 0.5).astype(np.int64)
    return np.clip(s, 0, 255).astype(np.uint8)


def chessboard_frame(width: int, height: int, frame_idx: int) -> np.ndarray:
    """Luma plane (height, width) uint8 for frame `frame_idx`."""
    co = np.cos(0.01 * frame_idx)
    si = np.sin(0.01 * frame_idx)
    c = np.arange(width, dtype=np.float64)[None, :] - (width >> 1)
    r = np.arange(height, dtype=np.float64)[:, None] - (height >> 1)
    x = co * c + si * r
    y = -si * c + co * r
    return _pixel_field(x, y)


def chessboard_sequence(width: int, height: int, n_frames: int,
                        start: int = 0):
    """Yield (y, u, v) planes; chroma is constant mid-gray (128), matching
    the reference driver (`src/minih264e_test.c:580-583`)."""
    u = np.full((height // 2, width // 2), 128, dtype=np.uint8)
    v = np.full((height // 2, width // 2), 128, dtype=np.uint8)
    for t in range(start, start + n_frames):
        yield chessboard_frame(width, height, t), u, v


def noise_pan_frame(width: int, height: int, frame_idx: int,
                    seed: int = 7, vx: float = 1.5, vy: float = 0.5):
    """Low-pass-filtered random texture panning at a constant sub-pel
    velocity — a natural-content stand-in (smooth gradients + global
    motion) complementing the chessboard's hard periodic edges. The
    texture is a fixed random field box-filtered twice; frames sample it
    at a translated origin with bilinear interpolation, so motion
    estimation must track real sub-pel displacement."""
    rng = np.random.default_rng(seed)
    pad = 64
    tex = rng.integers(0, 256, (height + 2 * pad, width + 2 * pad))
    tex = tex.astype(np.float64)
    for _ in range(2):                     # separable 5-tap box, twice
        k = np.ones(5) / 5.0
        tex = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 0, tex)
        tex = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 1, tex)
    tex = np.clip((tex - tex.mean()) * 3.0 + 128.0, 0, 255)

    ox = (pad + vx * frame_idx) % pad
    oy = (pad + vy * frame_idx) % pad
    i0, j0 = int(oy), int(ox)
    fy, fx = oy - i0, ox - j0
    w = tex[i0:i0 + height + 1, j0:j0 + width + 1]
    s = ((w[:-1, :-1] * (1 - fx) + w[:-1, 1:] * fx) * (1 - fy)
         + (w[1:, :-1] * (1 - fx) + w[1:, 1:] * fx) * fy + 0.5)
    return np.clip(s, 0, 255).astype(np.uint8)


_NOISE_TEX_CACHE = {}


def noise_pan_sequence(width: int, height: int, n_frames: int,
                       start: int = 0):
    """Yield (y, u, v) panning filtered-noise frames (gray chroma)."""
    u = np.full((height // 2, width // 2), 128, dtype=np.uint8)
    v = np.full((height // 2, width // 2), 128, dtype=np.uint8)
    for t in range(start, start + n_frames):
        key = (width, height, t)
        if key not in _NOISE_TEX_CACHE:
            _NOISE_TEX_CACHE[key] = noise_pan_frame(width, height, t)
        yield _NOISE_TEX_CACHE[key], u, v
