"""The port's GopBandEncoder on IPPP streams against the JAX package's.

Same seeded inputs, same configuration, speed 2 (the P toolset the port
implements), `device="cpu"` for the port: every lane's Annex-B bytes must
be identical to `h264lab_tpu`'s, and each lane must decode bit-exactly
(independent decoder, `h264lab_tpu.decoder`) to the port's own
reconstruction. Covered: an IDR and two P steps at 64x48 and 72x40
(B=1) and 64x64 and 72x56 (B=2) on chessboard and noise-pan content, and
at speed 7 on one of them; transparent lanes under a tiny VBV; GOLDEN,
DROPPABLE, RECOVERY and CUSTOM frames on long-term slots; a forced
re-pack of P steps; `encode_stream` over several GOPs.
"""

import numpy as np
import pytest

import h264lab_tpu.config as jcfg
from h264lab_tpu.decoder.decoder import H264Decoder
from h264lab_tpu.parallel import gop as jgop
from h264lab_tpu.utils.synthetic import chessboard_sequence, noise_pan_sequence
from h264lab_tpu_torch.config import EncoderConfig, FrameType, RunConfig
from h264lab_tpu_torch.parallel import gop as tgop

# (width, height, slice bands, content, qp)
CASES = {
    "chess64x48_b1": (64, 48, 1, chessboard_sequence, 33),
    "noise72x40_b1": (72, 40, 1, noise_pan_sequence, 20),
    "chess64x64_b2": (64, 64, 2, chessboard_sequence, 33),
    "noise72x56_b2": (72, 56, 2, noise_pan_sequence, 20),
}


def _encoders(case, n_gop=2, **cfg_kw):
    w, h, b, _, qp = CASES[case]
    kw = dict(dict(width=w, height=h, gop=3, qp=qp, slice_bands=b), **cfg_kw)
    return (jgop.GopBandEncoder(jcfg.EncoderConfig(**kw), n_gop=n_gop),
            tgop.GopBandEncoder(EncoderConfig(**kw), n_gop=n_gop,
                                device="cpu"))


def _run(qp, **kw):
    kw = dict(dict(qp_min=qp, qp_max=qp, encode_speed=2), **kw)
    trun = RunConfig(**kw)
    return jcfg.RunConfig(**dict(kw, frame_type=jcfg.FrameType(
        int(trun.frame_type)))), trun


def _step(jenc, tenc, lanes, runs, streams, recons):
    """One step on both encoders; lanes must be byte-identical."""
    want = jenc.encode_step(lanes, runs[0])
    got = tenc.encode_step(lanes, runs[1], return_recon=True)
    for g, (a, b) in enumerate(zip(got, want)):
        assert a.payload == b.payload, f"lane {g} ({a.frame_type})"
        assert (a.frame_type, a.qp) == (b.frame_type, b.qp)
        streams[g] += a.payload
        recons[g].append(a.recon)
    return got


def _check_decodes(streams, recons):
    for stream, rec in zip(streams, recons):
        dec = H264Decoder()
        frames = dec.decode(stream)
        assert len(frames) == len(rec)
        for t, df in enumerate(frames):
            for got, want in zip(df.cropped(dec.sps), rec[t]):
                np.testing.assert_array_equal(np.asarray(got), want,
                                              err_msg=f"frame {t}")


@pytest.mark.parametrize("case,speed", [
    *(pytest.param(c, 2, id=c) for c in CASES),
    # speeds 2 to 7 select one P toolset; 7 is its other end
    pytest.param("chess64x48_b1", 7, id="chess64x48_b1_speed7")])
def test_ippp_lanes_byte_identical_and_decode(case, speed):
    w, h, _, seq, qp = CASES[case]
    frames = list(seq(w, h, 4))
    jenc, tenc = _encoders(case)
    runs = _run(qp, encode_speed=speed)
    streams, recons = [b"", b""], [[], []]
    kinds = []
    for t in range(3):               # lane g encodes frames g, g+1, g+2
        got = _step(jenc, tenc, frames[t:t + 2], runs, streams, recons)
        kinds.append(got[0].frame_type)
    assert kinds == ["IDR", "P", "P"]
    _check_decodes(streams, recons)


def test_transparent_lanes_under_tiny_vbv():
    """A tiny VBV makes lanes overflow: their next P frame becomes one
    all-skip slice whose reconstruction is the unchanged reference, and
    the lane keeps its reference slot and MV field."""
    jenc, tenc = _encoders("chess64x48_b1", gop=0, qp=20,
                           vbv_size_bytes=400,
                           vbv_overflow_empty_frame_flag=True)
    runs = (jcfg.RunConfig(desired_frame_bytes=100, qp_min=20, qp_max=24,
                           encode_speed=5),
            RunConfig(desired_frame_bytes=100, qp_min=20, qp_max=24,
                      encode_speed=5))
    chess = list(chessboard_sequence(64, 48, 6))
    noise = list(noise_pan_sequence(64, 48, 6))
    streams, recons = [b"", b""], [[], []]
    sizes = []
    for t in range(6):
        got = _step(jenc, tenc, [chess[t], noise[t]], runs, streams, recons)
        sizes.append([len(r.payload) for r in got])
    # some lane's P frame was an all-skip slice, and not every lane's
    sizes = np.asarray(sizes[1:])
    assert (sizes < 30).any() and (sizes >= 30).any(), sizes
    _check_decodes(streams, recons)


def test_long_term_frame_types():
    """GOLDEN, DROPPABLE, RECOVERY and CUSTOM frames on long-term slots:
    the slot policy, the slice headers and the predictions match JAX."""
    jenc, tenc = _encoders("chess64x48_b1", gop=0, qp=31,
                           max_long_term_reference_frames=2)
    frames = list(chessboard_sequence(64, 48, 10))
    types = [(FrameType.KEY, {}), (FrameType.P, {}), (FrameType.GOLDEN, {}),
             (FrameType.DROPPABLE, {}), (FrameType.RECOVERY, {}),
             (FrameType.P, {}),
             (FrameType.CUSTOM, dict(long_term_idx_use=1,
                                     long_term_idx_update=2)),
             (FrameType.CUSTOM, dict(long_term_idx_use=2,
                                     long_term_idx_update=0)),
             (FrameType.P, {})]
    streams, recons = [b"", b""], [[], []]
    kinds = []
    for t, (ft, kw) in enumerate(types):
        got = _step(jenc, tenc, frames[t:t + 2],
                    _run(31, frame_type=ft, **kw), streams, recons)
        kinds.append(got[0].frame_type)
    assert kinds == ["IDR"] + ["P"] * 8
    _check_decodes(streams, recons)


def test_forced_p_repack():
    """P steps that overflow `p_cap_words` re-pack their kept symbol grids
    at a larger bucket, on both sides alike (QP 12 noise: P bands of
    about 3,000 to 5,000 bits against 128 words)."""
    jenc, tenc = _encoders("noise72x56_b2", qp=12)
    w, h, _, seq, _ = CASES["noise72x56_b2"]
    frames = list(seq(w, h, 4))
    runs = _run(12)
    streams, recons = [b"", b""], [[], []]
    _step(jenc, tenc, frames[0:2], runs, streams, recons)
    jenc.p_cap_words = tenc.p_cap_words = 128
    for t in (1, 2):
        _step(jenc, tenc, frames[t:t + 2], runs, streams, recons)
    assert tenc.p_cap_words == jenc.p_cap_words > 128
    _check_decodes(streams, recons)


def test_encode_stream_ippp():
    """`encode_stream` over two GOPs of IPP, one per lane, equals JAX's."""
    frames = list(chessboard_sequence(64, 48, 6))
    kw = dict(width=64, height=48, gop=3, qp=33)
    jrun, trun = _run(33)
    want = jgop.encode_stream(frames, jcfg.EncoderConfig(**kw), n_gop=2,
                              run=jrun)
    got = tgop.encode_stream(frames, EncoderConfig(**kw), n_gop=2, run=trun,
                             device="cpu")
    assert got == want
    assert len(H264Decoder().decode(got)) == len(frames)
