"""The port's decoder (`h264lab_tpu_torch/decoder/`) against the JAX
package's (`h264lab_tpu/decoder/`).

Streams come from the port's encoders on the CPU at 64x48 to 128x96, on
chessboard and noise-pan content: `H264Encoder` at speeds 0 (IDR, P, P:
partitions, Intra_4x4 in P), 2 and 10 (deblocking off); two slice bands
under `desired_nalu_bytes` (several slices per frame); long-term
references (golden and recovery frames); a 2-lane `GopBandEncoder` at
speed 2; and `SvcEncoder` with inter-layer prediction at speed 0 (gop 3,
through a base-mode IDR) and without it at speed 2, each decoded whole
(the enhancement layer in `enh_frames`) and with NAL types 14, 15 and 20
stripped (the base layer as plain AVC). Both decoders give the same
number of frames, the same planes and the same parsed SPS and PPS, and
the planes equal the encoder's reconstruction. Both refuse a NAL of type
2 and an SPS with poc_type 1 with the same NotImplementedError, and their
bit readers read the same values from random bytes. Each stream is
encoded once per module. Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from h264lab_tpu.decoder import bitreader as jbr
from h264lab_tpu.decoder.decoder import H264Decoder as JaxDecoder
from h264lab_tpu_torch.bitstream.bitwriter import BitWriter
from h264lab_tpu_torch.bitstream.nal import annexb_nal, split_annexb
from h264lab_tpu_torch.config import EncoderConfig, FrameType, RunConfig
from h264lab_tpu_torch.decoder import bitreader as tbr
from h264lab_tpu_torch.decoder.decoder import H264Decoder
from h264lab_tpu_torch.models.encoder import H264Encoder
from h264lab_tpu_torch.models.svc import SvcEncoder
from h264lab_tpu_torch.parallel.gop import GopBandEncoder
from h264lab_tpu_torch.utils.synthetic import (chessboard_sequence,
                                               noise_pan_sequence)

QP = 30
LTR_TYPES = [FrameType.KEY, FrameType.P, FrameType.GOLDEN, FrameType.P,
             FrameType.RECOVERY, FrameType.P]


def _run(speed=2, **kw):
    return RunConfig(qp_min=QP, qp_max=QP, encode_speed=speed, **kw)


def _sequential(cfg, frames, runs):
    enc = H264Encoder(cfg, device="cpu")
    res = [enc.encode(*f, r, return_recon=True) for f, r in zip(frames, runs)]
    return [(b"".join(r.payload for r in res), [r.recon for r in res])]


def _encode(case):
    """[(stream, [recon per frame], [enhancement recon] or None)]."""
    if case == "s0":
        cfg = EncoderConfig(width=64, height=48, gop=10, qp=QP)
        return _sequential(cfg, list(noise_pan_sequence(64, 48, 3)),
                           [_run(0)] * 3)
    if case in ("s2", "s10"):
        speed = int(case[1:])
        cfg = EncoderConfig(width=96, height=64, gop=10, qp=QP)
        return _sequential(cfg, list(chessboard_sequence(96, 64, 3)),
                           [_run(speed)] * 3)
    if case == "bands_nalu":
        cfg = EncoderConfig(width=64, height=64, gop=10, qp=QP,
                            slice_bands=2, desired_nalu_bytes=160)
        return _sequential(cfg, list(noise_pan_sequence(64, 64, 2)),
                           [_run(2)] * 2)
    if case == "ltr":
        cfg = EncoderConfig(width=64, height=48, gop=0, qp=QP,
                            max_long_term_reference_frames=2)
        return _sequential(cfg, list(chessboard_sequence(64, 48, 6)),
                           [_run(2, frame_type=t) for t in LTR_TYPES])
    if case == "gop2":
        enc = GopBandEncoder(EncoderConfig(width=64, height=48, gop=3,
                                           qp=QP), n_gop=2, device="cpu")
        frames = list(noise_pan_sequence(64, 48, 4))
        steps = [enc.encode_step([frames[t], frames[t + 1]], _run(2),
                                 return_recon=True) for t in range(3)]
        return [(b"".join(s[g].payload for s in steps),
                 [s[g].recon for s in steps]) for g in range(2)]
    # SVC: the whole stream, then the base layer alone
    ilp, speed, gop, n = dict(svc_ilp=(True, 0, 3, 4),
                              svc_plain=(False, 2, 10, 2))[case]
    enc = SvcEncoder(EncoderConfig(width=128, height=96, gop=gop, qp=QP,
                                   num_layers=2, inter_layer_pred_flag=ilp),
                     device="cpu")
    res = [enc.encode(*f, _run(speed), return_recon=True)
           for f in chessboard_sequence(128, 96, n)]
    assert [r.frame_type for r in res][-1] == ("IDR" if ilp else "P")
    stream = b"".join(r.payload for r in res)
    base = b"".join(b"\x00\x00\x00\x01" + m for m in split_annexb(stream)
                    if m[0] & 0x1F not in (14, 15, 20))
    return [(stream, [r.base_recon for r in res], [r.recon for r in res]),
            (base, [r.base_recon for r in res])]


CASES = ["s0", "s2", "s10", "bands_nalu", "ltr", "gop2", "svc_ilp",
         "svc_plain"]


@pytest.fixture(scope="module")
def streams():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _encode(case)
        return cache[case]
    return get


def _planes(frames):
    return [[np.asarray(p) for p in f.cropped(f.sps)] for f in frames]


@pytest.mark.parametrize("case", CASES)
def test_decoders_agree_with_each_other_and_the_recon(streams, case):
    for item in streams(case):
        stream, recon = item[:2]
        enh = item[2] if len(item) > 2 else None
        port, jax_dec = H264Decoder(), JaxDecoder()
        got = port.decode(stream)
        want = jax_dec.decode(stream)
        assert len(got) == len(want) == len(recon)
        assert dataclasses.asdict(port.sps) == dataclasses.asdict(jax_dec.sps)
        assert dataclasses.asdict(port.pps) == dataclasses.asdict(jax_dec.pps)
        for t, (a, b, r) in enumerate(zip(_planes(got), _planes(want),
                                          recon)):
            for pa, pb, pr in zip(a, b, r):
                np.testing.assert_array_equal(pa, pb, err_msg=f"frame {t}")
                np.testing.assert_array_equal(pa, pr, err_msg=f"frame {t}")
        assert len(port.enh_frames) == len(jax_dec.enh_frames) == \
            (len(enh) if enh else 0)
        if enh:
            for t, (a, b, r) in enumerate(zip(_planes(port.enh_frames),
                                              _planes(jax_dec.enh_frames),
                                              enh)):
                for pa, pb, pr in zip(a, b, r):
                    np.testing.assert_array_equal(pa, pb,
                                                  err_msg=f"enh frame {t}")
                    np.testing.assert_array_equal(pa, pr,
                                                  err_msg=f"enh frame {t}")
    if case == "bands_nalu":
        slices = [m for m in split_annexb(streams(case)[0][0])
                  if m[0] & 0x1F in (1, 5)]
        assert len(slices) > 2 * 2            # more slices than bands


def _poc_type_1_sps() -> bytes:
    bw = BitWriter()
    bw.u(8, 66)                 # profile_idc
    bw.u(8, 0)                  # constraint flags
    bw.u(8, 30)                 # level_idc
    bw.ue(0)                    # seq_parameter_set_id
    bw.ue(1)                    # log2_max_frame_num - 4
    bw.ue(1)                    # pic_order_cnt_type
    bw.ue(0)
    bw.rbsp_trailing_bits()
    return annexb_nal(3, 7, bw.to_bytes())


@pytest.mark.parametrize("stream", [
    b"\x00\x00\x00\x01\x02\x80",          # a data partition (NAL type 2)
    _poc_type_1_sps()])
def test_unsupported_streams_raise_alike(stream):
    errors = []
    for dec in (H264Decoder(), JaxDecoder()):
        with pytest.raises(NotImplementedError) as e:
            dec.decode(stream)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _reads(module, data, ops):
    """The values of `ops` read in turn, and what ended the reads."""
    br, out = module.BitReader(data), []
    try:
        for op, n in ops:
            out.append(br.u(n) if op == "u" else getattr(br, op)())
            out.append(br.pos)
        out.append(br.more_rbsp_data())
    except IndexError:
        out.append("IndexError")
    return out


@settings(max_examples=200, deadline=None, database=None)
@given(st.binary(min_size=1, max_size=24),
       st.lists(st.tuples(st.sampled_from(["u", "u1", "ue", "se"]),
                          st.integers(0, 16)), max_size=24))
def test_bit_readers_agree(data, ops):
    assert _reads(tbr, data, ops) == _reads(jbr, data, ops)
