"""Stream-level constants and the per-frame result type shared by the
encoders (the part of `h264lab_tpu/models/encoder.py` that the GOP-lane
encoder needs; the sequential `H264Encoder` is not ported yet)."""

from __future__ import annotations

import dataclasses

PIC_INIT_QP = 26


@dataclasses.dataclass
class FrameResult:
    payload: bytes                  # Annex-B bytes for this frame
    frame_type: str                 # "IDR" | "I" | "P"
    qp: int
    recon: tuple | None = None      # (y, u, v) deblocked recon if requested
