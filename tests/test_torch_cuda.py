"""Tests of the port that need the CUDA card (marker `cuda`; they skip
elsewhere). They import no JAX, so they also run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

- K1 (the CUDA bit-pack kernel) equals the plain PyTorch packer on seeded
  random grids, including 32-bit symbols and an overflowing capacity, and
  counts one launch per call;
- the all-intra encoder gives the same lane bytes on the card as on the
  CPU, at a small size with two bands.
Tolerance: exact equality (integer arithmetic).
"""

import numpy as np
import pytest
import torch

from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.ops import bitpack
from h264lab_tpu_torch.parallel.gop import GopBandEncoder
from h264lab_tpu_torch.utils.synthetic import noise_pan_sequence
from tests.torch_grids import random_grid

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("nmb,zero_frac,cap", [
    (48, 0.97, 1024), (48, 0.6, 8192), (6, 0.0, 1024), (48, 0.6, 128)])
def test_k1_matches_plain_packer(card, nmb, zero_frac, cap):
    rng = np.random.default_rng(nmb + int(zero_frac * 100))
    grids = [random_grid(rng, nmb, zero_frac) for _ in range(3)]
    vals = torch.from_numpy(np.stack([g[0] for g in grids]).view(np.int32))
    lens = torch.from_numpy(np.stack([g[1] for g in grids]))
    before = bitpack.LAUNCH_COUNTS["bitpack"]
    wk, nk = bitpack.pack_frames(vals.to(card), lens.to(card), cap)
    torch.cuda.synchronize()
    assert bitpack.LAUNCH_COUNTS["bitpack"] == before + 1
    wp, np_ = bitpack.pack_frames_plain(vals, lens, cap)
    assert torch.equal(nk.cpu(), np_)
    assert torch.equal(wk.cpu(), wp)


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
