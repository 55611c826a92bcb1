"""h264lab_tpu_torch — the PyTorch/CUDA port of h264lab_tpu for NVIDIA
Hopper (H100).

The port keeps the JAX package's layout and names (`ops/`, `models/`,
`parallel/`, `bitstream/`, `rc/`, `utils/`) and is held against it: equal
arrays at every stage boundary and byte-identical Annex-B streams. It
imports torch and numpy, never jax and nothing of `h264lab_tpu`; the
numpy-only modules it needs (configuration, spec tables, bitstream
writers, rate control) are its own copies.

Implemented so far: all-intra GOP-lane encoding
(`parallel.gop.GopBandEncoder`), with the bit-pack stage as a CUDA kernel
(`ops/bitpack.py`, `csrc/bitpack.cu`). Entry points run on the CUDA card
unless the caller passes `device="cpu"`.
"""

from h264lab_tpu_torch.config import (
    EncoderConfig,
    FrameType,
    RunConfig,
    SpeedPreset,
)

__all__ = ["EncoderConfig", "FrameType", "RunConfig", "SpeedPreset"]
