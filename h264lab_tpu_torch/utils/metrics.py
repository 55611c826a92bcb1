"""PSNR / rate metrics, matching the reference driver's accounting
(`src/minih264e_test.c:331-405`): per-plane accumulated MSE, kbps@30fps,
and the two combined quality/rate figures."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return 10 * math.log10(255.0 * 255.0 / mse)


@dataclasses.dataclass
class RdReport:
    psnr_y: float
    psnr_u: float
    psnr_v: float
    psnr_all: float
    kbps_30fps: float
    psnr_to_kbps_ratio: float
    psnr_to_logkbps_ratio: float

    def __str__(self):
        return (f"{self.kbps_30fps:5.0f} kbps@30fps   "
                f"YPSNR={self.psnr_y:.2f} db  UPSNR={self.psnr_u:.2f} db  "
                f"VPSNR={self.psnr_v:.2f} db    "
                f"{self.psnr_to_kbps_ratio:.2f} db/rate   "
                f"{self.psnr_to_logkbps_ratio:.3f} db/lgrate")


class PsnrAccumulator:
    """Accumulates noise/bytes over a sequence (reference `psnr_add`)."""

    def __init__(self):
        self.noise = [0.0, 0.0, 0.0]
        self.count = [0.0, 0.0, 0.0]
        self.bytes = 0.0
        self.frames = 0

    def add(self, orig_planes, recon_planes, coded_bytes: int):
        for k in range(3):
            d = (orig_planes[k].astype(np.float64)
                 - recon_planes[k].astype(np.float64))
            self.noise[k] += float(np.sum(d * d))
            self.count[k] += d.size
        self.bytes += coded_bytes
        self.frames += 1

    def report(self, fps: float = 30.0) -> RdReport:
        def db(noise, count):
            if noise == 0:
                return float("inf")
            return 10 * math.log10(255.0 * 255.0 / (noise / count))

        real_kbps = self.bytes * 8.0 / (self.frames / fps) / 1000.0 if self.frames else 0.0
        y_db = db(self.noise[0], self.count[0])
        ratio = 10 * math.log10(
            self.count[0] * self.count[0] * 1.5 * 255 * 255
            / (self.noise[0] * self.bytes)) if self.noise[0] and self.bytes else float("inf")
        return RdReport(
            psnr_y=y_db,
            psnr_u=db(self.noise[1], self.count[1]),
            psnr_v=db(self.noise[2], self.count[2]),
            psnr_all=db(sum(self.noise), sum(self.count)),
            kbps_30fps=real_kbps,
            psnr_to_kbps_ratio=ratio,
            psnr_to_logkbps_ratio=(y_db / math.log10(real_kbps)
                                   if real_kbps > 1 else float("inf")),
        )
