"""The port's sequential H264Encoder against the JAX package's.

Same seeded inputs, same configuration, `device="cpu"` for the port:
every frame's Annex-B bytes, frame type, QP and reconstructions
(deblocked and not) must equal `h264lab_tpu`'s, and the port's stream
must decode bit-exactly (independent decoder, `h264lab_tpu.decoder`) to
its own reconstruction. Mirrors the JAX package's `test_inter_e2e`,
`test_intra_e2e`, `test_nalu_split`, `test_ratecontrol`, `test_checkpoint`,
`test_frame_types` and `test_denoise`, spread over encode speeds 0, 1, 2,
8, 9 and 10.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import h264lab_tpu.config as jcfg
from h264lab_tpu import cli as jcli
from h264lab_tpu.bitstream.nal import split_annexb
from h264lab_tpu.decoder.decoder import H264Decoder
from h264lab_tpu.models.encoder import H264Encoder as JaxEncoder
from h264lab_tpu.utils.synthetic import chessboard_sequence, noise_pan_sequence
from h264lab_tpu_torch import H264Encoder
from h264lab_tpu_torch import cli as tcli
from h264lab_tpu_torch.config import EncoderConfig, FrameType, RunConfig


def _jrun(run: RunConfig):
    """The JAX RunConfig of `run`, without its NALU callback."""
    kw = {f.name: getattr(run, f.name) for f in dataclasses.fields(run)}
    kw.update(frame_type=jcfg.FrameType(int(run.frame_type)),
              nalu_callback=None)
    return jcfg.RunConfig(**kw)


def _same(a, b, what):
    """One frame of both encoders: the port's `b` equals JAX's `a`."""
    assert b.payload == a.payload, what
    assert (b.frame_type, b.qp) == (a.frame_type, a.qp), what
    for name in ("recon", "recon_unfiltered"):
        ra, rb = getattr(a, name), getattr(b, name)
        assert (ra is None) == (rb is None), (what, name)
        for pa, pb in zip(ra or (), rb or ()):
            np.testing.assert_array_equal(pb, pa, err_msg=f"{what} {name}")


def _decodes(stream, recons):
    dec = H264Decoder()
    frames = dec.decode(stream)
    assert len(frames) == len(recons)
    for t, df in enumerate(frames):
        for got, want in zip(df.cropped(dec.sps), recons[t]):
            np.testing.assert_array_equal(np.asarray(got), want,
                                          err_msg=f"frame {t}")
    return dec


def _both(cfg_kw, frames, runs, encoders=None):
    """Encode `frames` (with one RunConfig each) on both encoders; every
    frame must match. Returns the port's results, its stream and the
    decoder that played it."""
    jenc, tenc = encoders or (JaxEncoder(jcfg.EncoderConfig(**cfg_kw)),
                              H264Encoder(EncoderConfig(**cfg_kw),
                                          device="cpu"))
    out, stream = [], b""
    for t, (f, run) in enumerate(zip(frames, runs)):
        want = jenc.encode(*f, _jrun(run), return_recon=True)
        got = tenc.encode(*f, run, return_recon=True)
        _same(want, got, f"frame {t}")
        out.append(got)
        stream += got.payload
    return out, stream, _decodes(stream, [r.recon for r in out])


def _fixed(qp, n, **kw):
    return [RunConfig(qp_min=qp, qp_max=qp, **kw)] * n


@pytest.mark.parametrize("speed", [0, 1, 2, 8, 9, 10])
def test_ippp_with_scene_cut(speed):
    """IPPP with a cut from chessboard to noise-pan content (intra MBs in P
    frames) and an IDR refresh (gop 4): every speed preset."""
    w, h = 64, 48
    frames = (list(chessboard_sequence(w, h, 3))
              + list(noise_pan_sequence(w, h, 2)))
    res, _, _ = _both(dict(width=w, height=h, gop=4, qp=28), frames,
                      _fixed(28, 5, encode_speed=speed))
    assert [r.frame_type for r in res] == ["IDR", "P", "P", "P", "IDR"]
    if speed in (8, 10):             # deblocking off: the recon is the output
        for r in res:
            for a, b in zip(r.recon, r.recon_unfiltered):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("speed", [0, 2])
def test_multi_slice_bands(speed):
    """Three slice bands (deblocking idc 2 at slice edges) at 128x96."""
    frames = list(chessboard_sequence(128, 96, 3))
    res, stream, _ = _both(dict(width=128, height=96, gop=20, qp=30,
                                slice_bands=3), frames,
                           _fixed(30, 3, encode_speed=speed))
    slices = [n for n in split_annexb(stream) if (n[0] & 0x1F) in (1, 5)]
    assert len(slices) == 9


def test_all_intra_cropped():
    """gop=1 (IDR only) at a cropped 72x40 size, at two QPs."""
    frames = list(noise_pan_sequence(72, 40, 2))
    for qp in (18, 40):
        res, _, dec = _both(dict(width=72, height=40, gop=1, qp=qp), frames,
                            _fixed(qp, 2, encode_speed=1))
        assert [r.frame_type for r in res] == ["IDR", "IDR"]
        assert res[0].recon[0].shape == (40, 72)


@pytest.mark.parametrize("speed", [0, 2])
def test_nalu_size_rollback_on_scene_cut(speed):
    """desired_nalu_bytes: the scene cut's NALU overflows the target, the
    frame rolls back and re-encodes with more slices, on both sides."""
    W, H, QP, target = 96, 96, 30, 1200
    frames = list(chessboard_sequence(W, H, 2))
    rng = np.random.default_rng(11)
    cut = (rng.integers(0, 256, (H, W), np.uint8),
           np.full((H // 2, W // 2), 128, np.uint8),
           np.full((H // 2, W // 2), 128, np.uint8))
    nals = []
    runs = [RunConfig(qp_min=QP, qp_max=QP, encode_speed=speed,
                      nalu_callback=lambda n, i: nals.append((i, len(n))))
            ] * 3
    _, stream, _ = _both(dict(width=W, height=H, gop=10, qp=QP,
                              desired_nalu_bytes=target),
                         frames + [cut], runs)
    sizes = [len(n) + 4 for n in split_annexb(stream)
             if (n[0] & 0x1F) in (1, 5)]
    assert len(sizes) > 3 and max(sizes) <= target
    # the callback saw every slice NAL of the final encodes, once
    assert [s for _, s in nals] == sizes


def test_bitrate_mode_and_filler():
    """Frame-level RC with VBV stuffing: QPs move, filler NALs appear."""
    cfg = dict(width=64, height=48, gop=10, qp=33, vbv_size_bytes=2000,
               vbv_underflow_stuffing_flag=True)
    frames = list(chessboard_sequence(64, 48, 5))
    runs = [RunConfig(desired_frame_bytes=900, qp_min=10, qp_max=50)] * 5
    res, stream, _ = _both(cfg, frames, runs)
    assert len({r.qp for r in res}) > 1
    assert any((n[0] & 0x1F) == 12 for n in split_annexb(stream))


def test_transparent_frame_on_overflow():
    """A tiny VBV overflows: the next P frame is one all-skip slice whose
    reconstruction is the reference (speed 9)."""
    cfg = dict(width=64, height=48, gop=0, qp=20, vbv_size_bytes=400,
               vbv_overflow_empty_frame_flag=True)
    frames = list(noise_pan_sequence(64, 48, 4))
    runs = [RunConfig(desired_frame_bytes=100, qp_min=20, qp_max=24,
                      encode_speed=9)] * 4
    res, _, _ = _both(cfg, frames, runs)
    assert min(len(r.payload) for r in res[1:]) < 30


def test_fine_rate_control_bands():
    """Per-band QP offsets over two slice bands (speed 1)."""
    cfg = dict(width=64, height=64, gop=8, qp=30, slice_bands=2,
               fine_rate_control_flag=True)
    frames = list(noise_pan_sequence(64, 64, 3))
    runs = [RunConfig(desired_frame_bytes=500, qp_min=20, qp_max=44,
                      encode_speed=1)] * 3
    _both(cfg, frames, runs)


def test_mb_qp_delta_row_rate_control():
    """Per-MB-row QPs in one slice (speed 2): real mb_qp_delta syntax, and
    the decoder's QP map varies inside the slice."""
    W, H = 96, 96
    rng = np.random.default_rng(3)
    strong = rng.integers(0, 256, (H // 2, W)).astype(np.int32)
    weak = 128 + rng.integers(-60, 61, (H // 2, W)).astype(np.int32)
    base = np.concatenate([weak, strong]).astype(np.uint8)
    u = np.full((H // 2, W // 2), 128, np.uint8)
    frames = [(np.roll(base, 2 * t, axis=0), u, u) for t in range(5)]
    cfg = dict(width=W, height=H, gop=5, qp=33, fine_rate_control_flag=True)
    runs = [RunConfig(qp_min=20, qp_max=45, desired_frame_bytes=500,
                      encode_speed=2)] * 5
    _, _, dec = _both(cfg, frames, runs)
    assert int(dec._mb_qp.max() - dec._mb_qp.min()) > 0


def test_checkpoint_resume():
    """A pickled `get_state` resumes to the same bytes in a new encoder,
    and a snapshot of the JAX encoder resumes in the port as JAX goes on
    (speed 0, temporal denoising on: its state is in the snapshot too)."""
    cfg = dict(width=64, height=48, gop=4, qp=30, temporal_denoise_flag=True)
    frames = list(noise_pan_sequence(64, 48, 6))
    runs = _fixed(30, 6)
    jenc = JaxEncoder(jcfg.EncoderConfig(**cfg))
    tenc = H264Encoder(EncoderConfig(**cfg), device="cpu")
    _both(cfg, frames[:3], runs, (jenc, tenc))
    snap = pickle.dumps(tenc.get_state())
    jsnap = jenc.get_state()
    want = [jenc.encode(*f, _jrun(r)).payload
            for f, r in zip(frames[3:], runs)]
    for st in (pickle.loads(snap), jsnap):
        enc = H264Encoder(EncoderConfig(**cfg), device="cpu")
        enc.set_state(st)
        got = [enc.encode(*f, r).payload for f, r in zip(frames[3:], runs)]
        assert got == want
    with pytest.raises(RuntimeError):         # a frame in flight
        tenc.encode_async(*frames[3], runs[0])
        tenc.get_state()


def test_long_term_frame_types():
    """GOLDEN, RECOVERY, DROPPABLE, I and CUSTOM frames on long-term
    slots (speed 0)."""
    cfg = dict(width=64, height=48, gop=0, qp=31,
               max_long_term_reference_frames=2)
    types = [(FrameType.KEY, {}), (FrameType.P, {}), (FrameType.GOLDEN, {}),
             (FrameType.DROPPABLE, {}), (FrameType.RECOVERY, {}),
             (FrameType.I, {}), (FrameType.P, {}),
             (FrameType.CUSTOM, dict(long_term_idx_use=1,
                                     long_term_idx_update=2)),
             (FrameType.CUSTOM, dict(long_term_idx_use=2,
                                     long_term_idx_update=0))]
    runs = [RunConfig(frame_type=ft, qp_min=31, qp_max=31, **kw)
            for ft, kw in types]
    res, _, _ = _both(cfg, list(chessboard_sequence(64, 48, len(runs))),
                      runs)
    assert [r.frame_type for r in res] == ["IDR", "P", "P", "P", "P", "I",
                                           "P", "P", "P"]


def test_dyadic_temporal_schedule():
    """The CLI's dyadic schedule equals JAX's, and a 2-layer stream of
    CUSTOM frames from it matches (speed 2)."""
    for logmod in (1, 2, 3):
        a, b = jcli.DyadicSchedule(logmod), tcli.DyadicSchedule(logmod)
        for i in range(17):
            ja, tb = a.step(i), b.step(i)
            assert (int(ja[0]),) + ja[1:] == (int(tb[0]),) + tb[1:]
    sched = tcli.DyadicSchedule(2)
    runs = []
    for i in range(6):
        ft, use, upd = sched.step(i)
        runs.append(RunConfig(frame_type=ft, long_term_idx_use=use,
                              long_term_idx_update=upd, qp_min=32,
                              qp_max=32, encode_speed=2))
    _both(dict(width=64, height=48, gop=0, qp=32,
               max_long_term_reference_frames=2),
          list(chessboard_sequence(64, 48, 6)), runs)


def test_denoise_gating():
    """Temporal denoising runs at speeds below 2 only, as in JAX."""
    cfg = dict(width=64, height=48, gop=10, qp=30, temporal_denoise_flag=True)
    frames = list(noise_pan_sequence(64, 48, 3))
    for speed in (1, 2):
        _both(cfg, frames, _fixed(30, 3, encode_speed=speed))


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        H264Encoder(EncoderConfig(width=64, height=48))
