"""The port's all-intra GopBandEncoder against the JAX package's.

Same seeded inputs, same configuration, `device="cpu"` for the port:
every lane's Annex-B bytes must be identical to `h264lab_tpu`'s, and each
lane must decode bit-exactly (independent decoder,
`h264lab_tpu.decoder`) to the port's own reconstruction. Also: requests
the slice does not implement raise, the carried constants equal the JAX
values, and no file of the port imports jax or h264lab_tpu.
"""

import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h264lab_tpu.config as jcfg
from h264lab_tpu.decoder.decoder import H264Decoder
from h264lab_tpu.ops import me as jme
from h264lab_tpu.ops import tables as jtb
from h264lab_tpu.ops import tables_cavlc as jtc
from h264lab_tpu.ops import tuning as jtu
from h264lab_tpu.parallel import gop as jgop
from h264lab_tpu.utils.synthetic import chessboard_sequence, noise_pan_sequence
from h264lab_tpu_torch import convert
from h264lab_tpu_torch.config import (EncoderConfig, FrameType, RunConfig)
from h264lab_tpu_torch.parallel import gop as tgop

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (width, height, slice bands, content, qp): 72-wide and 40/56-high frames
# are cropped; B=2 needs an even MB height, hence 64x64 and 72x56
CASES = {
    "chess64x48_b1": (64, 48, 1, chessboard_sequence, 33),
    "noise72x40_b1": (72, 40, 1, noise_pan_sequence, 20),
    "chess64x64_b2": (64, 64, 2, chessboard_sequence, 33),
    "noise72x56_b2": (72, 56, 2, noise_pan_sequence, 20),
}


def _pair(case, **cfg_kw):
    w, h, b, _, qp = CASES[case]
    kw = dict(dict(width=w, height=h, gop=1, qp=qp, slice_bands=b), **cfg_kw)
    return jcfg.EncoderConfig(**kw), EncoderConfig(**kw)


def _runs(qp, **kw):
    kw = dict(qp_min=qp, qp_max=qp, encode_speed=2, **kw)
    return jcfg.RunConfig(**kw), RunConfig(**kw)


def _lane_inputs(case, steps=2):
    w, h, _, seq, _ = CASES[case]
    frames = list(seq(w, h, 2))
    # lane 1 runs the frames in the other order
    return [[frames[t % 2], frames[(t + 1) % 2]] for t in range(steps)]


def _check_decodes(streams, recons):
    for stream, rec in zip(streams, recons):
        dec = H264Decoder()
        frames = dec.decode(stream)
        assert len(frames) == len(rec)
        for t, df in enumerate(frames):
            for got, want in zip(df.cropped(dec.sps), rec[t]):
                np.testing.assert_array_equal(np.asarray(got), want,
                                              err_msg=f"frame {t}")


@pytest.mark.parametrize("case", list(CASES))
def test_lanes_byte_identical_and_decode(case):
    jc, tc = _pair(case)
    jrun, trun = _runs(CASES[case][4])
    jenc = jgop.GopBandEncoder(jc, n_gop=2)
    tenc = tgop.GopBandEncoder(tc, n_gop=2, device="cpu")
    streams, recons = [b"", b""], [[], []]
    for lanes in _lane_inputs(case):
        want = jenc.encode_step(lanes, jrun)
        got = tenc.encode_step(lanes, trun, return_recon=True)
        for g in range(2):
            assert got[g].payload == want[g].payload, f"lane {g}"
            assert (got[g].frame_type, got[g].qp) == \
                (want[g].frame_type, want[g].qp)
            streams[g] += got[g].payload
            recons[g].append(got[g].recon)
    _check_decodes(streams, recons)


def test_rate_control_bands_and_filler():
    """Per-lane RC with fine (per-band) QPs and VBV stuffing: QPs move
    between steps, and the lanes stay byte-identical to JAX."""
    jc, tc = _pair("chess64x64_b2", fine_rate_control_flag=True,
                   vbv_size_bytes=3000, vbv_underflow_stuffing_flag=True)
    kw = dict(desired_frame_bytes=400, qp_min=20, qp_max=40, encode_speed=2)
    jrun, trun = jcfg.RunConfig(**kw), RunConfig(**kw)
    jenc = jgop.GopBandEncoder(jc, n_gop=2)
    tenc = tgop.GopBandEncoder(tc, n_gop=2, device="cpu")
    qps = set()
    for lanes in _lane_inputs("chess64x64_b2", steps=3):
        want = jenc.encode_step(lanes, jrun)
        got = tenc.encode_step(lanes, trun)
        for g in range(2):
            assert got[g].payload == want[g].payload
            qps.add(got[g].qp)
    assert len(qps) > 1


def test_i_frames_long_term_slots_and_encode_stream():
    """FrameType.I (non-IDR intra) and long-term-slot headers match JAX,
    and encode_stream's in-order stitch equals JAX's."""
    jc, tc = _pair("chess64x48_b1", gop=0, max_long_term_reference_frames=1)
    jenc = jgop.GopBandEncoder(jc, n_gop=2)
    tenc = tgop.GopBandEncoder(tc, n_gop=2, device="cpu")
    streams, recons = [b"", b""], [[], []]
    for ft, lanes in zip((FrameType.KEY, FrameType.I, FrameType.I),
                         _lane_inputs("chess64x48_b1", steps=3)):
        jrun, trun = _runs(33, frame_type=jcfg.FrameType(int(ft)))
        want = jenc.encode_step(lanes, jrun)
        got = tenc.encode_step(lanes, dataclasses.replace(trun, frame_type=ft),
                               return_recon=True)
        for g in range(2):
            assert got[g].payload == want[g].payload
            streams[g] += got[g].payload
            recons[g].append(got[g].recon)
    assert [r.frame_type for r in got] == ["I", "I"]
    _check_decodes(streams, recons)

    w, h = 64, 48
    frames = list(chessboard_sequence(w, h, 4))        # two groups of 2
    jc, tc = _pair("chess64x48_b1")
    jrun, trun = _runs(33)
    assert (tgop.encode_stream(frames, tc, n_gop=2, run=trun, device="cpu")
            == jgop.encode_stream(frames, jc, n_gop=2, run=jrun))


def test_unsupported_requests_raise(monkeypatch):
    w, h = 64, 48
    f = next(chessboard_sequence(w, h, 1))
    run = RunConfig(qp_min=30, qp_max=30, encode_speed=2)
    enc = tgop.GopBandEncoder(EncoderConfig(width=w, height=h, gop=2),
                              n_gop=1, device="cpu")
    enc.encode_step([f], run)                              # the IDR
    with pytest.raises(NotImplementedError):               # P from gop=2
        enc.encode_step([f], run)
    # (GOLDEN would resolve to an IDR here: no long-term slot is filled)
    for ft in (FrameType.P, FrameType.DROPPABLE, FrameType.CUSTOM):
        with pytest.raises(NotImplementedError):
            enc.encode_step([f], dataclasses.replace(run, frame_type=ft))
    enc1 = tgop.GopBandEncoder(EncoderConfig(width=w, height=h, gop=1),
                               n_gop=1, device="cpu")
    with pytest.raises(NotImplementedError):
        enc1.encode_step([f], dataclasses.replace(run, encode_speed=8))
    with pytest.raises(NotImplementedError):
        tgop.GopBandEncoder(EncoderConfig(width=w, height=h), n_gop=1,
                            mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        tgop.GopBandEncoder(EncoderConfig(width=w, height=h,
                                          temporal_denoise_flag=True),
                            n_gop=1, device="cpu")
    # no device argument means the CUDA card, and no card is an error
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tgop.GopBandEncoder(EncoderConfig(width=w, height=h), n_gop=1)


def _jax_constants():
    ref = {}
    for prefix, mod in (("tables", jtb), ("tables_cavlc", jtc)):
        for name, val in vars(mod).items():
            if name[:1].isupper() and isinstance(val, np.ndarray):
                ref[f"{prefix}.{name}"] = val
    for name, val in vars(jtu).items():
        if name[:1].isupper() and isinstance(val, int):
            ref[f"tuning.{name}"] = np.asarray(val)
    ref["LAMBDA_ME"] = np.asarray(
        [int(jme.lambda_me(jnp.int32(q))) for q in range(52)])
    return ref


def test_constants_and_configs_carried_across():
    ref = _jax_constants()
    convert.check_constants(ref)
    bad = dict(ref, LAMBDA_ME=ref["LAMBDA_ME"] + 1)
    with pytest.raises(ValueError):
        convert.check_constants(bad)
    jc = jcfg.EncoderConfig(width=96, height=64, gop=3, qp=28,
                            slice_bands=2, max_long_term_reference_frames=1)
    assert dataclasses.asdict(convert.config_from_reference(jc)) == \
        dataclasses.asdict(jc)
    jr = jcfg.RunConfig(frame_type=jcfg.FrameType.GOLDEN, encode_speed=2,
                        qp_min=20, qp_max=40)
    tr = convert.config_from_reference(jr)
    assert isinstance(tr, RunConfig) and tr.frame_type == FrameType.GOLDEN
    assert tr.qp_max == 40 and tr.encode_speed == 2
    with pytest.raises(TypeError):
        convert.config_from_reference(object())


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "h264lab_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_trace_step.py"]
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "h264lab_tpu"), \
                    f"{path.relative_to(ROOT)} imports {name}"
