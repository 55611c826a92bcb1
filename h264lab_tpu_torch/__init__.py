"""h264lab_tpu_torch — the PyTorch/CUDA port of h264lab_tpu for NVIDIA
Hopper (H100).

The port keeps the JAX package's layout and names (`ops/`, `models/`,
`parallel/`, `bitstream/`, `rc/`, `utils/`) and is held against it: equal
arrays at every stage boundary and byte-identical Annex-B streams. It
imports torch and numpy, never jax and nothing of `h264lab_tpu`; the
numpy-only modules it needs (configuration, spec tables, bitstream
writers, rate control) are its own copies.

Implemented so far: the sequential encoder (`H264Encoder`, and its
command line `python -m h264lab_tpu_torch.cli`) at every encode speed;
two-layer SVC spatial scalability (`models.svc.SvcEncoder`: the base
layer at half resolution with prefix NALs, the enhancement layer in NAL
20 with a subset SPS, base-mode I/IDR frames with inter-layer
prediction); GOP-lane encoding (`parallel.gop.GopBandEncoder`) of
IDR, I and P frames at speeds 0 to 7 and 9, with the bit-pack stage as a
CUDA kernel (`ops/bitpack.py`, `csrc/bitpack.cu`), on one device or over
a ("gop", "band") device mesh (`parallel.gop.make_mesh`,
`encode_stream(mesh=...)`, and the all-intra
`parallel.sharding.ShardedIntraEncoder`); the independent decoder
(`decoder.decoder.H264Decoder`, numpy on the host, both SVC layers),
which plays the card's streams where there is no jax; and the entry
points (`entry.entry`: the 128x96 wavefront intra encode and its
example arguments; `entry.dryrun_multichip`: a short IPPP GOP over an
n-device mesh, decoded and checked). That is every user surface of the
JAX package. Entry points run on the CUDA cards unless the caller passes
`device="cpu"` (a mesh: `devices=["cpu"] * n`).
"""

from h264lab_tpu_torch.config import (
    EncoderConfig,
    FrameType,
    RunConfig,
    SpeedPreset,
)
from h264lab_tpu_torch.models.encoder import FrameResult, H264Encoder

__all__ = ["EncoderConfig", "FrameResult", "FrameType", "H264Encoder",
           "RunConfig", "SpeedPreset"]
