"""Encoder configuration — the public parameter model.

Mirrors the capability surface of the reference encoder's create/run
parameter structs (`src/h264-lab.h:86-226`) as idiomatic
dataclasses:

- `EncoderConfig`  ≈ `H264E_create_param_t` (`src/h264-lab.h:86-172`)
- `RunConfig`      ≈ `H264E_run_param_t`    (`src/h264-lab.h:177-226`)
- `FrameType`      ≈ frame-type enum        (`src/h264-lab.h:63-70`)
- `SpeedPreset`    ≈ speed presets          (`src/h264-lab.h:76-85`)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional


class FrameType(enum.IntEnum):
    """Per-frame type request (reference: `src/h264-lab.h:63-70`)."""

    DEFAULT = 0      # follow the GOP structure set at create time
    KEY = 1          # IDR frame: SPS/PPS re-emitted, decoder refresh
    I = 2            # intra frame, not IDR
    GOLDEN = 3       # P frame predicted from the "golden" long-term reference
    RECOVERY = 4     # P frame predicted from golden, stored as new golden
    DROPPABLE = 5    # P frame not used as a reference (temporal scalability)
    CUSTOM = 6       # caller controls long_term_idx_use/update directly
    P = 7            # plain predicted frame (what DEFAULT resolves to mid-GOP)


class SpeedPreset(enum.IntEnum):
    """Speed/quality presets 0..10 (reference: `src/h264-lab.h:76-85`).

    Tool gating matches the reference's policy:
      - speed >= 1: sub-16x16 inter partitions disabled
      - speed >= 2: intra-4x4-on-P and temporal denoise disabled
      - speed >= 9: sub-pel (qpel) motion refinement disabled
      - speed in {8, 10}: deblocking disabled
    """

    BEST_QUALITY = 0
    BALANCED = 5
    FASTEST = 10


class Error(Exception):
    """Base class for encoder API errors (reference status codes
    `src/h264-lab.h:25-35`)."""


class ParameterError(Error):
    """Invalid create/run parameters."""


# Limits matching the reference's validation (`src/h264-lab.h:6252-6286`).
MAX_LONG_TERM_FRAMES = 8
MIN_QP = 10
MAX_QP = 51


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Create-time (stream-level) configuration.

    Equivalent of the reference's `H264E_create_param_t`
    (`src/h264-lab.h:86-172`).
    """

    width: int
    height: int
    gop: int = 20                      # key-frame period; 0 = infinite GOP
    qp: int = 33                       # initial / fixed QP (pic_init_qp)

    # Rate control / VBV
    vbv_size_bytes: int = 0            # 0 = VBV disabled
    vbv_overflow_empty_frame_flag: bool = False
    vbv_underflow_stuffing_flag: bool = False
    fine_rate_control_flag: bool = False   # MB-level rate control

    # Behavior flags
    const_input_flag: bool = True      # do not write recon into caller input
    temporal_denoise_flag: bool = False
    max_long_term_reference_frames: int = 0

    sps_id: int = 0

    # SVC spatial scalability: 1 = plain AVC, 2 = two-layer scalable baseline
    num_layers: int = 1
    inter_layer_pred_flag: bool = False

    # Parallelism (the batched analog of the reference's max_threads,
    # `src/h264-lab.h:142-170`): number of independent slice bands per frame
    # (encoded in one batched dispatch), and
    # GOP-parallel lane count (default for parallel.gop.GopBandEncoder /
    # encode_stream).
    slice_bands: int = 1
    gop_parallel: int = 1

    # Multi-slice by size: start a new NALU once a slice exceeds this many
    # bytes (0 = single slice). Per-frame override in RunConfig.
    desired_nalu_bytes: int = 0

    def __post_init__(self):
        if self.width < 16 or self.height < 16:
            raise ParameterError("frame size must be at least 16x16")
        if self.width % 2 or self.height % 2:
            raise ParameterError("frame dimensions must be even")
        if self.width > 4096 or self.height > 4096:
            raise ParameterError("frame size above level 5.1 limits")
        if not (0 <= self.max_long_term_reference_frames <= MAX_LONG_TERM_FRAMES):
            raise ParameterError("max_long_term_reference_frames out of range")
        if self.num_layers not in (1, 2):
            raise ParameterError("num_layers must be 1 or 2")
        if self.slice_bands < 1 or self.gop_parallel < 1:
            raise ParameterError("parallelism factors must be >= 1")
        if not (MIN_QP <= self.qp <= MAX_QP):
            raise ParameterError("qp out of [10, 51]")

    # ---- derived geometry ------------------------------------------------
    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16

    @property
    def n_mb(self) -> int:
        return self.mb_width * self.mb_height

    @property
    def padded_width(self) -> int:
        return self.mb_width * 16

    @property
    def padded_height(self) -> int:
        return self.mb_height * 16

    @property
    def cropping(self) -> bool:
        return self.padded_width != self.width or self.padded_height != self.height


@dataclasses.dataclass
class RunConfig:
    """Per-frame (run-time) parameters.

    Equivalent of the reference's `H264E_run_param_t`
    (`src/h264-lab.h:177-226`).
    """

    frame_type: FrameType = FrameType.DEFAULT
    encode_speed: int = 0

    # Long-term reference control (FrameType.CUSTOM):
    #   long_term_idx_use:    -1 = intra, 0 = short-term ref, 1..8 = LTR slot
    #   long_term_idx_update: -1 = don't store (droppable), 0 = short-term,
    #                         1..8 = store into LTR slot
    long_term_idx_use: int = 0
    long_term_idx_update: int = 0

    # Rate control: if desired_frame_bytes > 0, RC picks QP in [qp_min, qp_max];
    # otherwise fixed qp_min(==qp_max) is used.
    desired_frame_bytes: int = 0
    qp_min: int = 33
    qp_max: int = 33

    desired_nalu_bytes: int = 0

    # Streaming hook: called with each finished NALU (bytes include the
    # Annex-B start code). Reference: `nalu_callback`, `src/h264-lab.h:215-224`.
    nalu_callback: Optional[Callable[[bytes, int], None]] = None
