"""Tests of the port that need the CUDA card (marker `cuda`; they skip
elsewhere). They import no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

- K1 (the CUDA bit-pack kernel) equals the plain PyTorch packer on seeded
  random grids, including 32-bit symbols and an overflowing capacity; on
  unclamped grids past the unit and MB drop boundaries, with empty MBs and
  an empty frame; on 16 frames, on an MB count that is no multiple of
  K1's 8-MB tile, and on frames of equal bit counts. It counts one launch
  per call;
- the encoder gives the same lane bytes and reconstructions on the card
  as on the CPU, at a small size with two bands: all-intra, and IPPP
  (IDR, P steps, a forced re-pack of a P step and a second IDR);
- K1 equals the plain packer on the symbol grids of a real P step, at the
  P capacity and at one that overflows.
Tolerance: exact equality (integer arithmetic).
"""

import numpy as np
import pytest
import torch

from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.ops import bitpack
from h264lab_tpu_torch.parallel.gop import GopBandEncoder
from h264lab_tpu_torch.utils.synthetic import noise_pan_sequence
from tests.torch_grids import EDGE_CASES, edge_grid, random_grid

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _k1_grids(kind, nmb, zero_frac):
    """Numpy (vals, lens) of shape (frames..., nmb, 952) for one case."""
    rng = np.random.default_rng(nmb + int(zero_frac * 100))
    if kind == "random":
        grids = [random_grid(rng, nmb, zero_frac) for _ in range(3)]
    elif kind == "edge":
        grids = [edge_grid(rng, c, nmb) for c in EDGE_CASES]
    elif kind == "frames16":
        grids = ([edge_grid(rng, c, nmb) for c in EDGE_CASES]
                 + [random_grid(rng, nmb, zero_frac + 0.04 * i, clamp=False)
                    for i in range(10)])
    elif kind == "equal_nbits":
        grids = [random_grid(rng, nmb, zero_frac, clamp=False)] * 4
    else:                                       # "unclamped"
        grids = [random_grid(rng, nmb, zero_frac, clamp=False)
                 for _ in range(5)]
    vals = np.stack([g[0] for g in grids])
    lens = np.stack([g[1] for g in grids])
    if kind == "frames16":
        vals, lens = (a.reshape((4, 4) + a.shape[1:]) for a in (vals, lens))
    return vals, lens


@pytest.mark.parametrize("kind,nmb,zero_frac,cap", [
    ("random", 48, 0.97, 1024), ("random", 48, 0.6, 8192),
    ("random", 6, 0.0, 1024), ("random", 48, 0.6, 128),
    ("edge", 48, 0.0, 8192),            # every EDGE_CASES frame
    ("frames16", 61, 0.5, 16384),       # (4, 4) frames
    ("unclamped", 61, 0.5, 16384),      # 61 MBs: 7 tiles and 5 MBs
    ("unclamped", 48, 0.5, 128),        # overflows cap 128
    ("equal_nbits", 40, 0.7, 8192)])
def test_k1_matches_plain_packer(card, kind, nmb, zero_frac, cap):
    vals_np, lens_np = _k1_grids(kind, nmb, zero_frac)
    vals = torch.from_numpy(vals_np.view(np.int32))
    lens = torch.from_numpy(lens_np)
    before = bitpack.LAUNCH_COUNTS["bitpack"]
    wk, nk = bitpack.pack_frames(vals.to(card), lens.to(card), cap)
    torch.cuda.synchronize()
    assert bitpack.LAUNCH_COUNTS["bitpack"] == before + 1
    wp, np_ = bitpack.pack_frames_plain(vals, lens, cap)
    assert torch.equal(nk.cpu(), np_)
    assert torch.equal(wk.cpu(), wp)
    if cap == 128:
        assert int(np_.min()) > 32 * (cap + bitpack.SLACK_WORDS)
    if kind == "equal_nbits":
        assert int(np_.min()) == int(np_.max()) > 0


def test_k1_rejects_bad_inputs(card):
    v = torch.zeros((2, 952), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        bitpack.pack_frames(v.long(), v, 128)
    with pytest.raises(ValueError):
        bitpack.pack_frames(v, v.cpu(), 128)
    with pytest.raises(ValueError):
        bitpack.pack_frames(v, v, 100)
    with pytest.raises(ValueError):
        bitpack.pack_frames(v.t(), v.t(), 128)
    with pytest.raises(ValueError):                 # not 952 slots per MB
        bitpack.pack_frames(v[:, :476].contiguous(), v[:, :476].contiguous(),
                            128)
    shifted = torch.zeros(2 * 952 + 1, dtype=torch.int32,
                          device=card)[1:].view(2, 952)
    with pytest.raises(ValueError):                 # not 16-byte aligned
        bitpack.pack_frames(shifted, shifted, 128)


def test_card_lanes_equal_cpu_lanes(card):
    w, h = 72, 56
    cfg = EncoderConfig(width=w, height=h, gop=1, qp=24, slice_bands=2)
    run = RunConfig(qp_min=24, qp_max=24, encode_speed=2)
    frames = list(noise_pan_sequence(w, h, 3))
    on_card = GopBandEncoder(cfg, n_gop=3)
    on_cpu = GopBandEncoder(cfg, n_gop=3, device="cpu")
    assert on_card.device.type == "cuda"
    for t in range(2):
        lanes = frames[t:] + frames[:t]
        got = on_card.encode_step(lanes, run, return_recon=True)
        want = on_cpu.encode_step(lanes, run, return_recon=True)
        for a, b in zip(got, want):
            assert a.payload == b.payload
            for pa, pb in zip(a.recon, b.recon):
                np.testing.assert_array_equal(pa, pb)


def test_card_ippp_lanes_equal_cpu_lanes(card):
    w, h = 72, 56
    cfg = EncoderConfig(width=w, height=h, gop=3, qp=12, slice_bands=2)
    run = RunConfig(qp_min=12, qp_max=12, encode_speed=2)
    frames = list(noise_pan_sequence(w, h, 6))
    on_card = GopBandEncoder(cfg, n_gop=3)
    on_cpu = GopBandEncoder(cfg, n_gop=3, device="cpu")
    kinds = []
    for t in range(4):
        if t == 2:                      # force a re-pack of this P step
            on_card.p_cap_words = on_cpu.p_cap_words = 128
        lanes = frames[t:t + 3]
        got = on_card.encode_step(lanes, run, return_recon=True)
        want = on_cpu.encode_step(lanes, run, return_recon=True)
        kinds.append(got[0].frame_type)
        for a, b in zip(got, want):
            assert a.payload == b.payload
            for pa, pb in zip(a.recon, b.recon):
                np.testing.assert_array_equal(pa, pb)
    assert kinds == ["IDR", "P", "P", "IDR"]
    assert on_card.p_cap_words == on_cpu.p_cap_words > 128


def test_k1_matches_plain_packer_on_a_p_grid(card):
    w, h = 128, 64
    cfg = EncoderConfig(width=w, height=h, gop=4, qp=20)
    run = RunConfig(qp_min=20, qp_max=20, encode_speed=2)
    frames = list(noise_pan_sequence(w, h, 5))
    enc = GopBandEncoder(cfg, n_gop=4)
    enc.encode_step(frames[:4], run)
    p = enc.encode_step_async(frames[1:], run)
    assert not p.is_intra
    vals, lens = p.out["sym_vals"], p.out["sym_lens"]
    for cap in (enc.p_cap_words, 128):
        wk, nk = bitpack.pack_frames(vals, lens, cap)
        wp, np_ = bitpack.pack_frames_plain(vals.cpu(), lens.cpu(), cap)
        assert torch.equal(nk.cpu(), np_)
        assert torch.equal(wk.cpu(), wp)
    assert int(np_.max()) > 32 * 128
    enc.finish_step(p)
