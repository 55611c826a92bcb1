"""The port's two-layer SVC (SvcEncoder) against the JAX package's.

The same seeded numpy inputs go to the JAX function (on the CPU) and to
its `h264lab_tpu_torch` counterpart on `device="cpu"`; the encoder is
integer arithmetic, so the tolerance is exact equality. Stage parity:
`ops/resample.py` on even and odd planes, `symbolize`'s base_mode_flag
slot, `svc.base_mode_frame_core` (symbol grid, recon and deblocked tiles,
two frames batched; `mbscan.inter_residual` with zero MVs and
`mbscan.symbolize` in its base-mode slice kind) on 8 x 6 MBs at QPs 24
and 38, 1 x 6 MBs at QPs 10 and 51 and 6 x 1 MBs at QPs 51 and 10, and
its K1-width grid packed by `bitpack.pack_frames` against JAX's
`pack_frame_fast` on the unpadded grid. Whole streams:
every frame's Annex-B bytes and both layers' reconstructions, with
inter-layer prediction off and on, at speeds 0 and 2, at 128x96 over
64x48 and at 100x72 over 50x36 (the base picture is cropped, and its
upsampled recon edge-padded to the enhancement's padded size), and a
stream that crosses a second IDR (gop 3, five frames). The JAX decoder
plays the port's streams: the enhancement layer decodes bit-exactly to
the port's recon, and the stripped base layer decodes as plain AVC. Each
case's JAX run happens once per module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h264lab_tpu.config as jcfg
from h264lab_tpu.bitstream.nal import split_annexb
from h264lab_tpu.decoder.decoder import H264Decoder
from h264lab_tpu.models import mbscan as jmb
from h264lab_tpu.models import svc as jsvc
from h264lab_tpu.ops import bitpack as jbp
from h264lab_tpu.ops import resample as jrs
from h264lab_tpu.ops import tables as jtb
from h264lab_tpu.utils.synthetic import chessboard_sequence
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.models import svc as tsvc
from h264lab_tpu_torch.ops import bitpack as tbp
from h264lab_tpu_torch.ops import resample as trs

NS = 34                         # slots per unit

# name: (width, height, inter_layer_pred_flag, encode_speed, gop, frames)
CASES = {
    "plain_s2": (128, 96, False, 2, 10, 3),
    "ilp_s2": (128, 96, True, 2, 10, 3),
    "ilp_s0_gop3": (128, 96, True, 0, 3, 5),     # IDR P P IDR P
    "plain_s0": (128, 96, False, 0, 10, 2),
    "ilp_s2_crop": (100, 72, True, 2, 10, 2),
}
QP = 30


def _eq(jax_val, torch_val, what=""):
    a = np.asarray(jax_val)
    b = torch_val.numpy() if isinstance(torch_val, torch.Tensor) \
        else np.asarray(torch_val)
    if a.dtype == np.uint32:
        b = b.astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=what)


def _encode_both(case):
    w, h, ilp, speed, gop, n = CASES[case]
    kw = dict(width=w, height=h, gop=gop, qp=QP, num_layers=2,
              inter_layer_pred_flag=ilp)
    run = dict(qp_min=QP, qp_max=QP, encode_speed=speed)
    jenc = jsvc.SvcEncoder(jcfg.EncoderConfig(**kw))
    tenc = tsvc.SvcEncoder(EncoderConfig(**kw), device="cpu")
    out = dict(jax=[], port=[], prev_mv=[])
    for f in chessboard_sequence(w, h, n):
        out["jax"].append(jenc.encode(*f, jcfg.RunConfig(**run),
                                      return_recon=True))
        out["port"].append(tenc.encode(*f, RunConfig(**run),
                                       return_recon=True))
        out["prev_mv"].append(tenc.enh._prev_mv is not None)
    return out


@pytest.fixture(scope="module")
def streams():
    """Each case's frames from both encoders, encoded on first use."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _encode_both(case)
        return cache[case]
    return get


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(48, 64), (37, 51), (9, 2)])
def test_resample_parity(h, w):
    rng = np.random.default_rng(h * w)
    planes = rng.integers(0, 256, (2, h, w), np.uint8)
    planes[1, : h // 2] = 0                      # flat and full-scale edges
    planes[1, h // 2:] = 255
    for name in ("downsample2x", "upsample2x_luma", "upsample2x_chroma"):
        got = getattr(trs, name)(torch.from_numpy(planes))   # batched
        for i in range(2):
            _eq(getattr(jrs, name)(jnp.asarray(planes[i])), got[i],
                f"{name} {h}x{w} plane {i}")
    assert trs.downsample2x(torch.from_numpy(planes)).shape[-2:] == \
        (h // 2, w // 2)


def _sym_inputs(seed, nmb):
    """Seeded P-slice symbolize inputs: inter MBs of every partition shape
    (some with no residual and zero MVs, so P_Skip occurs), Intra_16x16
    and Intra_4x4 MBs."""
    rng = np.random.default_rng(seed)
    i32 = np.int32
    sel = rng.choice([0, 0, 0, 1, 2], nmb).astype(i32)
    quiet = (rng.random(nmb) < 0.3) & (sel == 0)

    def lev(shape, p):
        x = rng.integers(-3, 4, (nmb,) + shape) * (rng.random(
            (nmb,) + shape) < p)
        x[quiet] = 0
        return x.astype(i32)
    mv = rng.integers(-9, 10, (2, nmb, 4, 4)).astype(i32)
    mv[:, quiet] = 0
    shape = np.where(quiet, 0, rng.integers(0, 4, nmb)).astype(i32)
    i4l = rng.choice([1, 4], (nmb, 16)).astype(i32)
    return dict(
        sel=sel, mode16=rng.integers(0, 4, nmb).astype(i32),
        cmode=rng.integers(0, 4, nmb).astype(i32),
        i4modes=rng.integers(0, 9, (nmb, 16)).astype(i32),
        i4sym_v=np.where(i4l == 1, 1, rng.integers(0, 8, (nmb, 16))
                         ).astype(i32),
        i4sym_l=i4l, mv4_y=mv[0], mv4_x=mv[1], shape=shape,
        dc_lev=lev((4, 4), 0.3), ac_lev=lev((4, 4, 4, 4), 0.1),
        lev_inter=lev((4, 4, 4, 4), 0.1), cdc_lev=lev((2, 2, 2), 0.3),
        cac_lev=lev((2, 2, 2, 4, 4), 0.05))


@pytest.mark.parametrize("flag", [False, True])
def test_symbolize_base_mode_slot(flag):
    """Two P slices of 8x6 MBs, batched in the port: with the flag, slot 1
    of every coded MB's header is base_mode_flag=0 (length 1, value 0)."""
    mbw, mbh = 8, 6
    ins = [_sym_inputs(s, mbw * mbh) for s in (1, 2)]
    keys = ("sel", "mode16", "cmode", "i4sym_v", "i4sym_l", "mv4_y",
            "mv4_x", "shape", "dc_lev", "ac_lev", "lev_inter", "cdc_lev",
            "cac_lev")
    got = tmb.symbolize(*(torch.from_numpy(np.stack([i[k] for i in ins]))
                          for k in keys), mbw, mbh, True,
                        svc_base_mode_bit=flag)
    for n, i in enumerate(ins):
        want = jmb.symbolize_stage(
            *(i[k] for k in ("sel", "mode16", "cmode", "i4modes", "i4sym_v",
                             "i4sym_l", "mv4_y", "mv4_x", "shape", "dc_lev",
                             "ac_lev", "lev_inter", "cdc_lev", "cac_lev")),
            mbw, mbh, True, svc_base_mode_bit=flag)
        for key in ("sym_vals", "sym_lens", "tail_val", "tail_len",
                    "total_bits"):
            _eq(want[key], got[key][n], f"{key} slice {n}")
        coded = ~np.asarray(want["skip"])
        assert 0 < coded.sum() < mbw * mbh            # skips and coded MBs
        _eq(coded * flag, got["sym_lens"][n, :, 1], "base_mode_flag slot")
        assert not got["sym_vals"][n, :, 1].any()


def _base_mode_inputs(seed, mbw, mbh):
    """Smooth source tiles (a level per MB near mid-grey, so the deblocking
    filter acts on MB edges) and a prediction off by 0 (no residual), +-2
    or +-40 per MB, so MBs with and without coded luma and chroma occur."""
    rng = np.random.default_rng(seed)
    nmb = mbw * mbh
    out = []
    for t in (16, 8, 8):
        src = (rng.integers(108, 149, (nmb, 1, 1))
               + rng.integers(-2, 3, (nmb, t, t)))
        amp = rng.choice([0, 2, 40], nmb)[:, None, None]
        noise = rng.integers(-40, 41, (nmb, t, t)).clip(-amp, amp)
        out.append((src.astype(np.uint8),
                    np.clip(src + noise, 0, 255).astype(np.uint8)))
    return [o[0] for o in out], [o[1] for o in out]


# base-mode frames: (mb_width, mb_height, the two frames' QPs); frames one
# MB wide and one MB high, whose chroma windows reach the guard of the
# planes the TQ reads them from, at the ends of the QP range
BASE_MODE_FRAMES = {"8x6": (8, 6, (24, 38)), "1x6": (1, 6, (10, 51)),
                    "6x1": (6, 1, (51, 10))}


@pytest.fixture(scope="module", params=list(BASE_MODE_FRAMES))
def base_mode(request):
    """Two base-mode frames of each size in `BASE_MODE_FRAMES`: the JAX
    outputs one frame at a time, the port's batched on its leading
    axis."""
    mbw, mbh, qps = BASE_MODE_FRAMES[request.param]
    ins = [_base_mode_inputs(s, mbw, mbh) for s in (3, 4)]
    jout = []
    for (src, pred), qp in zip(ins, qps):
        qpc = int(jtb.QPC_FROM_QPY[qp])
        jout.append({k: np.asarray(v) for k, v in jsvc._base_mode_frame(
            *(jnp.asarray(x) for x in src + pred), jnp.int32(qp),
            jnp.int32(qpc), mbw, mbh).items()})
    stack = [torch.from_numpy(np.stack([i[j][p] for i in ins]))
             for j in (0, 1) for p in range(3)]
    qpc = [int(jtb.QPC_FROM_QPY[q]) for q in qps]
    tout = tsvc.base_mode_frame_core(*stack, list(qps), qpc, mbw, mbh)
    return jout, tout, request.param


def test_base_mode_frame_core(base_mode):
    jout, tout, size = base_mode
    assert tout["sym_vals"].shape[-1] == tbp.K1_SLOTS
    for n, want in enumerate(jout):
        for key in ("recon_y", "recon_u", "recon_v", "df_y", "df_u", "df_v",
                    "cbp", "total_bits"):
            _eq(want[key], tout[key][n], f"{key} frame {n}")
        # the port's grid is JAX's with an empty unit at index 1
        for key in ("sym_vals", "sym_lens"):
            g = tout[key][n]
            assert not g[:, NS:2 * NS].any()
            _eq(want[key], torch.cat([g[:, :NS], g[:, 2 * NS:]], dim=1), key)
        cbp = want["cbp"]
        if size == "8x6":
            assert (cbp == 0).any() and (cbp & 15).any() and (
                cbp >> 4 == 2).any()
            assert (want["df_y"] != want["recon_y"]).any()  # deblocking ran


def test_base_mode_grid_packs_like_pack_frame_fast(base_mode):
    jout, tout, size = base_mode
    for cap in (1024, 128):
        words, nbits = tbp.pack_frames(tout["sym_vals"], tout["sym_lens"],
                                       cap)
        for n, want in enumerate(jout):
            jw, jn = jbp.pack_frame_fast(jnp.asarray(want["sym_vals"]),
                                         jnp.asarray(want["sym_lens"]), cap)
            _eq(jw, words[n], f"words cap {cap} frame {n}")
            assert int(jn) == int(nbits[n]) == int(want["total_bits"])
    if size == "8x6":
        assert int(nbits.max()) > 32 * 128              # cap 128 overflows


# ---------------------------------------------------------------------------
# whole streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_svc_streams_equal_jax(streams, case):
    out = streams(case)
    ilp, gop, n = CASES[case][2], CASES[case][4], CASES[case][5]
    for t, (a, b) in enumerate(zip(out["jax"], out["port"])):
        assert b.payload == a.payload, f"frame {t}"
        assert (b.base_payload, b.enh_payload, b.frame_type) == \
            (a.base_payload, a.enh_payload, a.frame_type), f"frame {t}"
        for name in ("recon", "base_recon"):
            for pa, pb in zip(getattr(a, name), getattr(b, name)):
                np.testing.assert_array_equal(pb, pa, err_msg=f"{t} {name}")
    types = [r.frame_type for r in out["port"]]
    assert types == ["IDR" if t % gop == 0 else "P" for t in range(n)]
    nals = [m[0] & 0x1F for r in out["port"] for m in split_annexb(r.payload)]
    assert {14, 15, 20, 7, 8, 5, 1} <= set(nals)
    if case == "ilp_s0_gop3":
        # the base-mode IDR at frame 3 leaves the enhancement's previous-MV
        # candidate as it was, as the JAX package does
        assert out["prev_mv"] == [False, True, True, True, True]


@pytest.mark.parametrize("case", list(CASES))
def test_svc_streams_decode(streams, case):
    w, h, _, _, _, n = CASES[case]
    res = streams(case)["port"]
    dec = H264Decoder()
    dec.decode(b"".join(r.payload for r in res))
    assert len(dec.enh_frames) == n
    for t, f in enumerate(dec.enh_frames):
        for got, want in zip(f.cropped(f.sps), res[t].recon):
            np.testing.assert_array_equal(got, want, err_msg=f"frame {t}")
    # a plain AVC decoder's view: the SVC NAL types stripped
    base = b"".join(b"\x00\x00\x00\x01" + m for r in res
                    for m in split_annexb(r.payload)
                    if m[0] & 0x1F not in (14, 15, 20))
    dec = H264Decoder()
    frames = dec.decode(base)
    assert len(frames) == n
    assert (dec.sps.width, dec.sps.height) == (w // 2, h // 2)
    for t, f in enumerate(frames):
        for got, want in zip(f.cropped(dec.sps), res[t].base_recon):
            np.testing.assert_array_equal(got, want, err_msg=f"base {t}")


def test_svc_encoder_needs_the_card(monkeypatch):
    cfg = EncoderConfig(width=64, height=48, num_layers=2)
    with pytest.raises(ValueError):
        tsvc.SvcEncoder(dataclasses.replace(cfg, num_layers=1),
                        device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tsvc.SvcEncoder(cfg)
