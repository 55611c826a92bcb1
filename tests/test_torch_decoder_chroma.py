"""The port's decoder on streams with non-flat chroma and several slices.

An Intra_4x4 MB predicts its chroma from the MBs above and to the left
only where they are available: decoded and in the same slice. With flat
chroma (every other fixture) a wrong neighbour test cannot show, since
every edge sample is 128. Here the frames come from
`utils.synthetic.color_chroma_sequence` (seeded noise fields in U and
V), encoded at 176x144, QP 28, as an IDR and two P frames: by
`GopBandEncoder` with 3 slice bands at speeds 2 and 0, and by
`H264Encoder` with `desired_nalu_bytes=400` (several slices a frame) at
speeds 0 and 2. The JAX package and the port on `device="cpu"` encode
the same frames; their bytes must be equal, and the port's decoder must
give exactly the encoder's reconstruction in every plane. The oracle is
the reconstruction and never the JAX decoder's output. Each
configuration is encoded once per module. Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest

import h264lab_tpu.config as jcfg
from h264lab_tpu.bitstream.nal import split_annexb
from h264lab_tpu.models.encoder import H264Encoder as JaxEncoder
from h264lab_tpu.parallel import gop as jgop
from h264lab_tpu_torch import H264Encoder
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.decoder.decoder import H264Decoder
from h264lab_tpu_torch.parallel import gop as tgop
from h264lab_tpu_torch.utils.synthetic import color_chroma_sequence

W, H, QP, N = 176, 144, 28, 3
# name: (encoder, encode_speed, configuration)
CASES = {
    "gop_bands3_s2": ("gop", 2, dict(slice_bands=3)),
    "gop_bands3_s0": ("gop", 0, dict(slice_bands=3)),
    "seq_nalu400_s0": ("seq", 0, dict(desired_nalu_bytes=400)),
    "seq_nalu400_s2": ("seq", 2, dict(desired_nalu_bytes=400)),
}


def _runs(speed):
    run = RunConfig(qp_min=QP, qp_max=QP, encode_speed=speed)
    kw = {f.name: getattr(run, f.name) for f in dataclasses.fields(run)}
    kw.update(frame_type=jcfg.FrameType(int(run.frame_type)),
              nalu_callback=None)
    return jcfg.RunConfig(**kw), run


def _encode(case):
    """(JAX bytes, port bytes, [port recon per frame]) of one lane."""
    kind, speed, extra = CASES[case]
    kw = dict(width=W, height=H, gop=10, qp=QP, **extra)
    jrun, trun = _runs(speed)
    frames = list(color_chroma_sequence(W, H, N))
    jbytes, tbytes, recons = [], [], []
    if kind == "gop":
        jenc = jgop.GopBandEncoder(jcfg.EncoderConfig(**kw), n_gop=1)
        tenc = tgop.GopBandEncoder(EncoderConfig(**kw), n_gop=1,
                                   device="cpu")
        for f in frames:
            jbytes.append(jenc.encode_step([f], jrun)[0].payload)
            got = tenc.encode_step([f], trun, return_recon=True)[0]
            tbytes.append(got.payload)
            recons.append(got.recon)
    else:
        jenc = JaxEncoder(jcfg.EncoderConfig(**kw))
        tenc = H264Encoder(EncoderConfig(**kw), device="cpu")
        for f in frames:
            jbytes.append(jenc.encode(*f, jrun).payload)
            got = tenc.encode(*f, trun, return_recon=True)
            tbytes.append(got.payload)
            recons.append(got.recon)
    return jbytes, tbytes, recons


@pytest.fixture(scope="module")
def streams():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _encode(case)
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_color_chroma_bytes_equal_jax(streams, case):
    jbytes, tbytes, _ = streams(case)
    assert len(jbytes) == len(tbytes) == N
    for t, (a, b) in enumerate(zip(jbytes, tbytes)):
        assert b == a, f"frame {t}"
    # several slices in every frame
    slices = [n for n in split_annexb(b"".join(tbytes))
              if (n[0] & 0x1F) in (1, 5)]
    assert len(slices) >= 2 * N, len(slices)


@pytest.mark.parametrize("case", list(CASES))
def test_port_decoder_gives_the_recon(streams, case):
    _, tbytes, recons = streams(case)
    dec = H264Decoder()
    frames = dec.decode(b"".join(tbytes))
    assert len(frames) == N
    for t, df in enumerate(frames):
        for p, (got, want) in enumerate(zip(df.cropped(dec.sps), recons[t])):
            np.testing.assert_array_equal(np.asarray(got), want,
                                          err_msg=f"frame {t} plane {p}")
    # the chroma is not flat: its edges reach across MB and slice borders
    assert min(float(np.std(recons[0][p])) for p in (1, 2)) > 5.0
