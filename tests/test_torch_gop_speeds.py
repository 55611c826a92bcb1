"""The port's GopBandEncoder at the P speeds of the speed-0 slice
against the JAX package's: speed 0 (partitions and Intra_4x4 in P),
speed 1 (Intra_4x4 in P) and speed 9 (full-pel ME).

Same seeded inputs, same configuration, `device="cpu"` for the port: an
IDR and two P steps of two lanes, at 64x48 (one band, chessboard) and
64x64 (two bands, noise-pan content); every lane's Annex-B bytes must be
identical to `h264lab_tpu`'s and decode bit-exactly (independent decoder)
to the port's reconstruction. Speeds 8 and 10 are refused on this path
(`tests/test_torch_gop.py`).
"""

import numpy as np
import pytest

import h264lab_tpu.config as jcfg
from h264lab_tpu.decoder.decoder import H264Decoder
from h264lab_tpu.parallel import gop as jgop
from h264lab_tpu.utils.synthetic import chessboard_sequence, noise_pan_sequence
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.parallel import gop as tgop

GOP_CASES = {
    "chess64x48_b1": (64, 48, 1, chessboard_sequence, 33),
    "noise64x64_b2": (64, 64, 2, noise_pan_sequence, 22),
}


@pytest.mark.parametrize("case", list(GOP_CASES))
@pytest.mark.parametrize("speed", [0, 1, 9])
def test_gop_lanes_byte_identical(case, speed):
    w, h, b, seq, qp = GOP_CASES[case]
    frames = list(seq(w, h, 4))
    kw = dict(width=w, height=h, gop=3, qp=qp, slice_bands=b)
    jenc = jgop.GopBandEncoder(jcfg.EncoderConfig(**kw), n_gop=2)
    tenc = tgop.GopBandEncoder(EncoderConfig(**kw), n_gop=2, device="cpu")
    rk = dict(qp_min=qp, qp_max=qp, encode_speed=speed)
    streams, recons = [b"", b""], [[], []]
    for t in range(3):               # lane g encodes frames g, g+1, g+2
        want = jenc.encode_step(frames[t:t + 2], jcfg.RunConfig(**rk))
        got = tenc.encode_step(frames[t:t + 2], RunConfig(**rk),
                               return_recon=True)
        assert [r.frame_type for r in got] == ["IDR" if t == 0 else "P"] * 2
        for g in range(2):
            assert got[g].payload == want[g].payload, f"step {t} lane {g}"
            streams[g] += got[g].payload
            recons[g].append(got[g].recon)
    for stream, rec in zip(streams, recons):
        dec = H264Decoder()
        for t, df in enumerate(dec.decode(stream)):
            for a, want in zip(df.cropped(dec.sps), rec[t]):
                np.testing.assert_array_equal(np.asarray(a), want)
