"""Bitstream layer: bit writing, Exp-Golomb codes, NAL framing, and
high-level H.264 syntax (SPS/PPS/slice headers).

Reference equivalents: bit cache + golomb (`src/h264-lab.h:2688-2772`),
NAL framing + emulation prevention (`src/h264-lab.h:3926-4022`),
SPS/PPS/slice headers (`src/h264-lab.h:4040-4372`).
"""

from h264lab_tpu_torch.bitstream.bitwriter import BitWriter
from h264lab_tpu_torch.bitstream.nal import (
    escape_rbsp,
    unescape_rbsp,
    annexb_nal,
)
from h264lab_tpu_torch.bitstream import headers

__all__ = [
    "BitWriter",
    "escape_rbsp",
    "unescape_rbsp",
    "annexb_nal",
    "headers",
]
