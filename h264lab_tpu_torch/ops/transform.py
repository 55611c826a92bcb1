"""4x4 integer transform, Hadamard DC transforms, quantization and
dequantization, batched over blocks as `(..., 4, 4)` int32 tensors.

PyTorch counterpart of `h264lab_tpu/ops/transform.py`: the same spec
arithmetic (forward core transform, exact dequant rounding, JM deadzone
quantizer), op for op, so every level and reconstruction is identical.

QP arguments are int tensors that broadcast against the *batch* shape of
the blocks (`coef.shape[:-2]`): a 0-d tensor for one QP, or one QP per
block (callers reshape per-MB QPs to `(k, 1, 1)` for `(k, 4, 4, 4, 4)`
block grids, where JAX vmapped a scalar).
"""

from __future__ import annotations

import functools

import torch

from h264lab_tpu_torch.ops import tables

I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device):
    pos = torch.as_tensor(tables.POS_CLASS.reshape(4, 4), dtype=torch.long,
                          device=device)
    mf = torch.as_tensor(tables.QUANT_MF, device=device)
    v = torch.as_tensor(tables.DEQUANT_V, device=device)
    # per-(qp%6) full 4x4 MF / V grids: (6, 4, 4)
    return mf[:, pos], v[:, pos], mf[:, 0], v[:, 0]


def _qp(qp, device) -> torch.Tensor:
    return torch.as_tensor(qp, dtype=torch.long, device=device)


def _bf(x0, x1, x2, x3):
    """Forward 1-D core transform butterfly (spec 8.5.12 / Cf matrix)."""
    t0 = x0 + x3
    t1 = x0 - x3
    t2 = x1 + x2
    t3 = x1 - x2
    return t0 + t2, 2 * t1 + t3, t0 - t2, t1 - 2 * t3


def _ibf(d0, d1, d2, d3):
    """Inverse 1-D core transform butterfly (spec 8.5.12.2)."""
    e0 = d0 + d2
    e1 = d0 - d2
    e2 = (d1 >> 1) - d3
    e3 = d1 + (d3 >> 1)
    return e0 + e3, e1 + e2, e1 - e2, e0 - e3


def fdct4x4(res: torch.Tensor) -> torch.Tensor:
    """Forward 4x4 core transform of residuals, batched (..., 4, 4) int32."""
    res = res.to(I32)
    t = torch.stack(_bf(res[..., 0, :], res[..., 1, :], res[..., 2, :],
                        res[..., 3, :]), dim=-2)
    return torch.stack(_bf(t[..., :, 0], t[..., :, 1], t[..., :, 2],
                           t[..., :, 3]), dim=-1)


def idct4x4(coef: torch.Tensor) -> torch.Tensor:
    """Inverse 4x4 core transform incl. final (x+32)>>6, batched int32."""
    coef = coef.to(I32)
    t = torch.stack(_ibf(coef[..., :, 0], coef[..., :, 1], coef[..., :, 2],
                         coef[..., :, 3]), dim=-1)
    out = torch.stack(_ibf(t[..., 0, :], t[..., 1, :], t[..., 2, :],
                           t[..., 3, :]), dim=-2)
    return (out + 32) >> 6


def hadamard4x4(x: torch.Tensor) -> torch.Tensor:
    """4x4 Hadamard transform (Intra_16x16 luma DC, spec 8.5.10)."""
    x = x.to(I32)

    def h(a, b, c, d):
        s0 = a + c
        s1 = b + d
        d0 = a - c
        d1 = b - d
        return s0 + s1, d0 + d1, d0 - d1, s0 - s1

    t = torch.stack(h(x[..., 0, :], x[..., 1, :], x[..., 2, :],
                      x[..., 3, :]), dim=-2)
    return torch.stack(h(t[..., :, 0], t[..., :, 1], t[..., :, 2],
                         t[..., :, 3]), dim=-1)


def hadamard2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 Hadamard for chroma DC (spec 8.5.11), batched (..., 2, 2) int32."""
    x = x.to(I32)
    a = x[..., 0, 0]
    b = x[..., 0, 1]
    c = x[..., 1, 0]
    d = x[..., 1, 1]
    return torch.stack([
        torch.stack([a + b + c + d, a - b + c - d], dim=-1),
        torch.stack([a + b - c - d, a - b - c + d], dim=-1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# AC quant / dequant
# ---------------------------------------------------------------------------

def zero_thr4x4(qp, thr_q8: int) -> torch.Tensor:
    """Per-coefficient zero thresholds at `thr_q8`/256 quantization steps
    (the inter path's block-kill decisions): (2^(15+qp//6) * thr_q8/256)
    // MF[qp%6, class]. Returns (..., 4, 4) int32 for qp of shape (...)."""
    qp = _qp(qp, None)                    # keeps a tensor's device
    mf_grid, _, _, _ = _consts(qp.device)
    mf = mf_grid[qp % 6]                                  # (..., 4, 4)
    qbits = (15 + qp // 6)[..., None, None]
    return ((torch.full_like(qbits, thr_q8) << (qbits - 8)) // mf).to(I32)


def quant4x4(coef: torch.Tensor, qp, deadzone_q8: int) -> torch.Tensor:
    """level = sign(W) * ((|W| * MF[qp%6, class] + f) >> (15 + qp//6)),
    f = deadzone_q8/256 * 2^(15+qp//6); int32 throughout (see the JAX
    module for the range argument)."""
    coef = coef.to(I32)
    mf_grid, _, _, _ = _consts(coef.device)
    qp = _qp(qp, coef.device)
    mf = mf_grid[qp % 6]                                  # (..., 4, 4)
    qbits = (15 + qp // 6).to(I32)[..., None, None]
    f = torch.full_like(qbits, deadzone_q8) << (qbits - 8)
    mag = (coef.abs() * mf + f) >> qbits
    return (torch.sign(coef) * mag).to(I32)


def dequant4x4(level: torch.Tensor, qp) -> torch.Tensor:
    """W' = level * V[qp%6, class] << (qp//6) (spec 8.5.12.1)."""
    level = level.to(I32)
    _, v_grid, _, _ = _consts(level.device)
    qp = _qp(qp, level.device)
    v = v_grid[qp % 6]
    shift = (qp // 6).to(I32)[..., None, None]
    return (level * v) << shift


# ---------------------------------------------------------------------------
# Luma DC (Intra_16x16) — spec 8.5.10
# ---------------------------------------------------------------------------

def quant_luma_dc(dc: torch.Tensor, qp) -> torch.Tensor:
    """Hadamard, then quantize with 4x the AC step, rounding 1/2."""
    f = hadamard4x4(dc)
    _, _, mf00_t, _ = _consts(f.device)
    qp = _qp(qp, f.device)
    mf00 = mf00_t[qp % 6][..., None, None]
    qbits = (17 + qp // 6).to(I32)[..., None, None]
    rnd = torch.ones_like(qbits) << (qbits - 1)
    mag = (f.abs() * mf00 + rnd) >> qbits
    return (torch.sign(f) * mag).to(I32)


def dequant_luma_dc(level: torch.Tensor, qp) -> torch.Tensor:
    """Hadamard, then scale with the exact rounding of spec 8.5.10."""
    f = hadamard4x4(level)
    _, _, _, v00_t = _consts(f.device)
    qp = _qp(qp, f.device)
    v00 = v00_t[qp % 6][..., None, None]
    div6 = (qp // 6).to(I32)[..., None, None]
    hi = (f * v00) << torch.clamp(div6 - 2, min=0)
    lo = ((f * v00 + (torch.ones_like(div6) << torch.clamp(1 - div6, min=0)))
          >> (2 - torch.clamp(div6, max=2)))
    return torch.where(div6 >= 2, hi, lo).to(I32)


# ---------------------------------------------------------------------------
# Chroma DC — spec 8.5.11
# ---------------------------------------------------------------------------

def quant_chroma_dc(dc: torch.Tensor, qpc) -> torch.Tensor:
    """2x2 Hadamard, then quantize with doubled step (rounding 1/2)."""
    f = hadamard2x2(dc)
    _, _, mf00_t, _ = _consts(f.device)
    qpc = _qp(qpc, f.device)
    mf00 = mf00_t[qpc % 6][..., None, None]
    qbits = (16 + qpc // 6).to(I32)[..., None, None]
    rnd = torch.ones_like(qbits) << (qbits - 1)
    mag = (f.abs() * mf00 + rnd) >> qbits
    return (torch.sign(f) * mag).to(I32)


def dequant_chroma_dc(level: torch.Tensor, qpc) -> torch.Tensor:
    """2x2 Hadamard, then dcC = ((f * V00) << qp//6) >> 1."""
    f = hadamard2x2(level)
    _, _, _, v00_t = _consts(f.device)
    qpc = _qp(qpc, f.device)
    v00 = v00_t[qpc % 6][..., None, None]
    div6 = (qpc // 6).to(I32)[..., None, None]
    return (((f * v00) << div6) >> 1).to(I32)
