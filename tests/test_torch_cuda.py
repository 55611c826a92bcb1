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
  P capacity and at one that overflows;
- the sequential H264Encoder gives the same bytes and reconstructions on
  the card as on the CPU at 64x48, at speeds 0, 9 and 10, through a forced
  rollback (desired_nalu_bytes on a scene cut); with per-row QPs
  (mb_qp_delta) at speed 2; with per-band QPs and temporal denoising at
  speed 1; and K1 equals the plain packer on its one-band (N = 1) and
  two-band (B = 2) grids;
- the two-layer SvcEncoder gives the same bytes and both layers'
  reconstructions on the card as on the CPU at 128x96 over 64x48, with
  inter-layer prediction at speed 0 (a base-mode IDR, then P frames with
  the base_mode_flag bit), launching K1 for both layers on every frame;
  and K1 equals the plain packer on a base-mode frame's grid (952 slots
  per MB, its luma-DC unit empty), which equals the CPU's grid;
- the port's decoder plays the card's streams bit-exactly to the card's
  reconstruction: H264Encoder at speed 0 and both layers of SvcEncoder
  (through a base-mode IDR), at 128x96;
- `entry()` on the card gives the same outputs as `entry(device="cpu")`;
- the ("gop", "band") mesh on the card, with entries that all name
  cuda:0: `dryrun_multichip(8)` gives the CPU mesh's streams, and a
  (2, 2) mesh at 128x96 with two bands (IDR, P, P at speeds 2 and 0)
  gives the unsharded card run's bytes and reconstructions, launching K1
  once per shard and step; the pipelined loop (`encode_step_async` of
  step t + 1 before `finish_step(t)`) on that mesh gives the unsharded
  run's bytes; each shard issues on its own stream; the launch counts of
  a mesh step are exact with four shards launching at once; with two
  cards, a (2, 1) mesh over cuda:0 and cuda:1 gives the unsharded run's
  bytes, and the kernels' launch shapes are read from the card named;
- K2 (the CUDA deblocking kernel) equals `deblock_frame_plain` on the card
  on seeded inputs with bS 0 to 4 at the main paths' shapes: 16 frames of
  1080p (16, 8160), one frame with per-MB QPs (1, 8160), an SVC base
  layer (1, 2040), a mesh band whose top row has no upper neighbour (1,
  4080), 4 x 3 MBs, one MB high (6 x 1) and one MB wide (1 x 6); with
  per-MB availability as tensors on the card (`svc.base_mode_deblock`'s
  and a random one). Each input is launched 20 times, with equal outputs
  (rows on other SMs must never see stale pixels); one launch per call,
  and on the card `deblock_frame` calls neither `_frame_bs` nor
  `edge_qps`. K2 refuses CPU tensors, other dtypes and shapes,
  non-contiguous and misaligned inputs;
- K3 (the CUDA wavefront kernel) equals `_select_wavefront_plain` on the
  card on seeded inputs (`wavefront_inputs`: flat, chessboard, stripe and
  noise MBs) at the paths' shapes: 16 frames of 1080p (16, 8160), one
  frame with an inter candidate (1, 8160), an SVC base layer (1, 2040), a
  mesh band (1, 4080) with an inter candidate, 4 x 3 MBs at QPs 0 to 51,
  one MB high (6 x 1) and one MB wide (1 x 6), and the edges of K3's
  schedule: 7, 8, 9 and 17 MB rows, 1 and 2 MBs wide over 9 rows, 16
  frames of 4 x 9 MBs; each input launched 20 times, with equal outputs,
  one launch per call. The encode paths reach
  it: with `_select_wavefront_plain` refused, a GOP IDR step and a
  speed-0 P frame encode, launching K3, to the CPU's bytes. K3 refuses
  CPU tensors, other dtypes and shapes, non-contiguous and misaligned
  tiles, per-row QPs and half an inter candidate;
- K4 (the CUDA motion search, `ops/me.motion_search_tiles`) equals the
  plain `motion_search_dense` on the card on seeded inputs
  (`me_inputs`: flat, chessboard, shifted-noise, half-pel and unmatched
  MBs, previous MVs past the +-52 clip) at 4 x 3, 6 x 1, 1 x 6, 11 x 3
  (K4's 2 x 8 MB tiles cut at both edges) and 120 x 68 MBs, on 1 and 3
  frames, with lanes, bands at a row offset (9 x 5 MB bands deep in
  their frames), QPs 0 to 51, the sub-pel stage on and off, on planes
  whose guard is cut so that the window starts clamp, on planes cut so
  far that the strip origins clamp, and on stripes where two candidate
  centres tie (the first tried must win); K5 (`partition_tiles`, a warp
  per MB, one full-pel pass shared by the three geometries and a
  quarter-pel pass per geometry) equals the plain `partition_search` on
  K4's planes of the same inputs, with one launch a call. Each input is
  launched 20 times with equal outputs, one count per call. The encode
  paths reach them: with the plain searches refused, GOP P steps at
  speeds 2 and 0 and sequential P frames at speeds 0 and 10 encode to
  the CPU's bytes. Both refuse CPU tensors, other dtypes and shapes,
  non-contiguous and misaligned inputs;
- K6 (CAVLC symbolization, `ops/symbolize.symbolize_tiles`, three
  launches a call) equals `symbolize_plain` on the card, every output
  and every slot, on seeded `sym_inputs`: I and P slices at 16 x 1080p
  (16, 8160), one frame with a row QP plan (1, 8160), the SVC base layer
  (1, 2040), a mesh band (1, 4080), 4 x 3, 6 x 1, 1 x 6 and 11 x 3 MBs,
  with the base_mode_flag bit, and 16 P slices of 1080p in which every
  block codes all its positions (both level escapes, suffixLength up to
  6); each input launched 20 times, one count a call. K1's words from K6's grid equal its words from the plain grid.
  The encode paths reach it: with `symbolize_plain` refused, GOP steps
  (IDR, P) and sequential frames encode to the CPU's bytes, one count per
  `symbolize` call. K6 refuses CPU tensors, other dtypes and shapes,
  non-contiguous and misaligned inputs;
- the SVC base-mode frame: K6 in its base-mode slice kind equals
  `symbolize_plain` of that kind on seeded levels (8 x 6 MBs with MBs of
  cbp 0, 120 x 68 MBs, 1 x 6 and 6 x 1 MBs, a dense 120 x 68 slice), 20
  launches each; `svc.base_mode_symbols` on the card (one K7 launch, one
  K6 call) equals the same call on the CPU at 8 x 6, 120 x 68, 1 x 6 and
  6 x 1 MBs (grid, bit counts, recon, cbp, nnz); a two-layer stream with
  inter-layer prediction encodes to the CPU's bytes with the plain
  symbolizer, the plain inter residual and `cavlc.encode_blocks` refused;
  K6 refuses a base-mode call with an input it does not read, a row plan,
  a P slice or the base_mode_flag bit, and bad levels;
- K7 (the inter residual, `ops/residual.inter_tiles`, one launch a call)
  equals `inter_residual_plain` on the card, every output, on seeded
  `inter_residual_inputs`: 16 frames of 1080p over 16 lanes (16, 8160),
  one frame at speed 0 with K5's partitions and a row QP plan (1, 8160),
  an SVC base layer (1, 2040), a mesh band at a row offset (1, 4080)
  without quarter-pel, 4 x 3, 6 x 1, 1 x 6, 11 x 3 and 9 x 5 MBs, and 16
  frames of 119 x 68 MBs (tiles of 16 MBs that end short and cross
  frames; at 120 x 68 they divide the frame), every QP, MVs
  at the reach on the frames' edges and past it on planes with a noise
  guard (the uniform window clamps), and with the zero-block kills off;
  K8 (the parallel P select, `ops/residual.select_tiles`, one launch a
  call) equals `select_parallel_plain` on seeded
  `select_parallel_inputs` at the same shapes, with row QP plans, bands
  and seeded availability; each input launched 20 times, one count a
  call. Both equal their plain versions on a real P step's inputs, and
  the encode paths reach them: with the plain versions refused, GOP P
  steps at speeds 2 and 0 and sequential P frames at speeds 0 and 10
  encode to the CPU's bytes, one count per call. Both refuse CPU
  tensors, other dtypes and shapes, non-contiguous and misaligned
  inputs;
- K9 (the SVC 2x downsampling, `resample.downsample_k9`) equals
  `downsample2x` of each plane on 1080p planes, the base's, odd planes and
  2 x 2 pixels, and on 1920-, 960- and 64-wide planes at an odd address
  (its byte-wise path, no copy); K10 (the base-mode frame's upsampled prediction,
  `resample.upsample_k10`) equals `upsample_tiles_plain` on the 1080p
  base, a cropped base (120x90 in 8 x 6 MBs), one MB, one MB wide and high,
  a base of a few pixels, 18 MBs wide (a short last chunk of 8 MBs), crops
  that end inside a tile across (an odd width) and down, and an
  enhancement past twice its base; K10 refuses base tiles that are not
  16-byte aligned, which the stage entry copies (`resample._k10_tiles`),
  and a base-mode IDR's `up` stage hands K10 its tiles without that copy;
  K11 (the reference planes,
  `refplanes.planes_k11`) equals `prepare_reference_plain` on 16 lanes of
  1080p, one frame, the SVC base, 3 pictures of 4 x 3 MBs, one MB, one MB
  wide and high, CIF, and with no luma (`reference_chroma`); each input
  launched 20 times, one count a call. Tiles 4-byte but not 16-byte
  aligned are refused by `planes_k11` and copied by the stage entries,
  which then give the plain planes; the `ref` stage of a 1-lane and a
  16-lane GOP step hands K11 its tiles without that copy. K11 runs on
  the current stream. With
  the plain resampling and padding refused, a two-layer stream, GOP lanes
  and the sequential encoder encode to the CPU's bytes, launching K9 once
  per SVC frame, K10 once per base-mode IDR and K11 once per `ref` stage,
  and a (2, 2) mesh on cuda:0 launches K11 once per gop row and step. All
  three refuse CPU tensors, other dtypes and shapes, non-contiguous inputs,
  bad sizes, and K11 tiles that are not 16-byte aligned;
- K12 (the `pre` stage's padding and tiling, `pretile.tiles_k12` through
  `stages.source_tiles`) equals `source_tiles_plain` on 16 lanes of
  1080p uploaded through the pinned staging, 1080-row crops (1920 and
  1912 wide), a mesh block's rows, planes whose rows are a column crop
  of a wider card tensor (their pitch past their width), planes at an odd
  address and rows that are not contiguous (copied by the entry), 20
  launches each, one count a call; the stage of a GOP step, a sequential
  frame, a two-layer stream and a (2, 2) mesh reaches it with the plain
  padding refused (once per `pre`: per step, per layer and frame, per
  shard and step), and a pipelined loop (step t + 1 dispatched before
  step t is finished, the staging buffers reused) gives the bytes of the
  same steps finished one by one. K13 (the temporal denoise,
  `denoise.denoise_k13` through `denoise.denoise_planes`) equals
  `denoise_plane` of each plane at 1080p and at odd sizes (1 x 1, 2 x 3,
  37 x 51, 9 x 130, 1 x 17, 33 x 1000, 1079 x 1917, planes at an odd
  address), a 1080p frame whose cur and prev lie at four pairs of
  offsets past 16-byte boundaries, 20 launches each; the
  sequential encoder with `temporal_denoise_flag` at speeds 0 and 1
  encodes on the card to the CPU's bytes with `denoise_plane` refused,
  one K13 launch a frame after the first. Both refuse CPU tensors, other
  dtypes, shapes and bad sizes.
Tolerance: exact equality (integer arithmetic).
"""

import dataclasses

import numpy as np
import pytest
import torch

from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.decoder.decoder import H264Decoder
from h264lab_tpu_torch.entry import dryrun_multichip, entry
from h264lab_tpu_torch.models import mbscan, refstate, stages
from h264lab_tpu_torch.models.encoder import H264Encoder
from h264lab_tpu_torch.models.svc import (SvcEncoder, base_mode_frame_core,
                                          base_mode_symbols)
from h264lab_tpu_torch.models import wavefront as plan
from h264lab_tpu_torch.ops import (bitpack, cavlc, deblock, denoise, me,
                                   pretile, qpel, refplanes, resample,
                                   residual, tables, wavefront)
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
from h264lab_tpu_torch.ops import symbolize as k6
from h264lab_tpu_torch.parallel.gop import GopBandEncoder, make_mesh
from h264lab_tpu_torch.utils.synthetic import (chessboard_sequence,
                                               deblock_inputs,
                                               inter_residual_inputs,
                                               me_inputs,
                                               noise_pan_sequence,
                                               select_parallel_inputs,
                                               sym_inputs,
                                               wavefront_inputs)
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
    vals, lens = p.outs[0]["sym_vals"], p.outs[0]["sym_lens"]
    for cap in (enc.p_cap_words, 128):
        wk, nk = bitpack.pack_frames(vals, lens, cap)
        wp, np_ = bitpack.pack_frames_plain(vals.cpu(), lens.cpu(), cap)
        assert torch.equal(nk.cpu(), np_)
        assert torch.equal(wk.cpu(), wp)
    assert int(np_.max()) > 32 * 128
    enc.finish_step(p)


@pytest.mark.parametrize("speed", [0, 9, 10])
def test_card_sequential_equals_cpu(card, speed):
    """IDR, P, and a scene cut whose NALU overflows desired_nalu_bytes:
    the frame rolls back and re-encodes with more slices on both."""
    w, h = 64, 48
    cfg = EncoderConfig(width=w, height=h, gop=10, qp=26,
                        desired_nalu_bytes=400)
    run = RunConfig(qp_min=26, qp_max=26, encode_speed=speed)
    rng = np.random.default_rng(5)
    cut = (rng.integers(0, 256, (h, w), np.uint8),
           np.full((h // 2, w // 2), 128, np.uint8),
           np.full((h // 2, w // 2), 128, np.uint8))
    frames = list(chessboard_sequence(w, h, 2)) + [cut]
    on_card = H264Encoder(cfg)
    on_cpu = H264Encoder(cfg, device="cpu")
    assert on_card.device.type == "cuda"
    before = bitpack.LAUNCH_COUNTS["bitpack"]
    for f in frames:
        got = on_card.encode(*f, run, return_recon=True)
        want = on_cpu.encode(*f, run, return_recon=True)
        assert got.payload == want.payload
        for pa, pb in zip(got.recon + got.recon_unfiltered,
                          want.recon + want.recon_unfiltered):
            np.testing.assert_array_equal(pa, pb)
    # one K1 launch per encode, so the rollback added launches
    assert bitpack.LAUNCH_COUNTS["bitpack"] - before > len(frames)
    assert got.payload.count(b"\x00\x00\x01") > 1       # several slices


@pytest.mark.parametrize("kind", ["row_qps", "band_qps_denoise"])
def test_card_rate_control_and_denoise_equal_cpu(card, kind):
    """Fine rate control on the card: per-row QPs (mb_qp_delta, the QPs
    move inside a slice) at speed 2 on a 96x96 frame of weak and strong
    noise; per-band QPs with temporal denoising at speed 1 (64x64, two
    bands)."""
    if kind == "row_qps":
        w = h = 96
        rng = np.random.default_rng(3)
        base = np.concatenate([
            128 + rng.integers(-60, 61, (h // 2, w)),
            rng.integers(0, 256, (h // 2, w))]).astype(np.uint8)
        u = np.full((h // 2, w // 2), 128, np.uint8)
        frames = [(np.roll(base, 2 * t, axis=0), u, u) for t in range(4)]
        cfg = EncoderConfig(width=w, height=h, gop=5, qp=33,
                            fine_rate_control_flag=True)
        run = RunConfig(qp_min=20, qp_max=45, desired_frame_bytes=500,
                        encode_speed=2)
    else:
        frames = list(noise_pan_sequence(64, 64, 3))
        cfg = EncoderConfig(width=64, height=64, gop=8, qp=30,
                            slice_bands=2, fine_rate_control_flag=True,
                            temporal_denoise_flag=True)
        run = RunConfig(desired_frame_bytes=500, qp_min=20, qp_max=44,
                        encode_speed=1)
    on_card = H264Encoder(cfg)
    on_cpu = H264Encoder(cfg, device="cpu")
    qps = set()
    for f in frames:
        got = on_card.encode(*f, run, return_recon=True)
        want = on_cpu.encode(*f, run, return_recon=True)
        assert got.payload == want.payload
        for pa, pb in zip(got.recon, want.recon):
            np.testing.assert_array_equal(pa, pb)
        qps.add(got.qp)
    assert len(qps) > 1


@pytest.mark.parametrize("bands", [1, 2])
def test_k1_matches_plain_packer_on_sequential_grids(card, bands):
    """A P frame with a scene cut, so its bands overflow 128 words."""
    w, h = 128, 64
    cfg = EncoderConfig(width=w, height=h, gop=4, qp=20, slice_bands=bands)
    run = RunConfig(qp_min=20, qp_max=20, encode_speed=0)
    f0 = next(noise_pan_sequence(w, h, 1))
    rng = np.random.default_rng(8)
    cut = (rng.integers(0, 256, (h, w), np.uint8), f0[1], f0[2])
    enc = H264Encoder(cfg)
    enc.encode(*f0, run)
    p = enc.encode_async(*cut, run)
    assert p.ft_name == "P"
    vals, lens = p.out["sym_vals"], p.out["sym_lens"]
    assert vals.shape[0] == bands
    for cap in (p.out["cap_words"], 128):
        wk, nk = bitpack.pack_frames(vals, lens, cap)
        wp, np_ = bitpack.pack_frames_plain(vals.cpu(), lens.cpu(), cap)
        assert torch.equal(nk.cpu(), np_)
        assert torch.equal(wk.cpu(), wp)
    assert int(np_.max()) > 32 * 128
    enc.finish(p)


def test_card_svc_equals_cpu(card):
    w, h = 128, 96
    cfg = EncoderConfig(width=w, height=h, gop=10, qp=30, num_layers=2,
                        inter_layer_pred_flag=True)
    run = RunConfig(qp_min=30, qp_max=30, encode_speed=0)
    on_card = SvcEncoder(cfg)
    on_cpu = SvcEncoder(cfg, device="cpu")
    assert on_card.base.device.type == on_card.enh.device.type == "cuda"
    kinds = []
    for f in chessboard_sequence(w, h, 3):
        before = bitpack.LAUNCH_COUNTS["bitpack"]
        got = on_card.encode(*f, run, return_recon=True)
        assert bitpack.LAUNCH_COUNTS["bitpack"] - before == 2   # both layers
        want = on_cpu.encode(*f, run, return_recon=True)
        assert got.payload == want.payload
        for pa, pb in zip(got.recon + got.base_recon,
                          want.recon + want.base_recon):
            np.testing.assert_array_equal(pa, pb)
        kinds.append(got.frame_type)
    assert kinds == ["IDR", "P", "P"]


def test_k1_matches_plain_packer_on_a_base_mode_grid(card):
    mbw, mbh = 8, 6
    rng = np.random.default_rng(11)
    tiles = []
    for t in (16, 8, 8):
        src = rng.integers(0, 256, (1, mbw * mbh, t, t))
        noise = rng.integers(-40, 41, src.shape)
        tiles.append(src.astype(np.uint8))
        tiles.append(np.clip(src + noise, 0, 255).astype(np.uint8))
    ins = [torch.from_numpy(x) for x in tiles[0::2] + tiles[1::2]]
    out = base_mode_frame_core(*(x.to(card) for x in ins), [26], [26], mbw,
                               mbh)
    ref = base_mode_frame_core(*ins, [26], [26], mbw, mbh)
    vals, lens = out["sym_vals"], out["sym_lens"]
    assert vals.shape == (1, mbw * mbh, 952)
    assert torch.equal(vals.cpu(), ref["sym_vals"])
    assert torch.equal(lens.cpu(), ref["sym_lens"])
    assert not lens[..., 34:68].any()            # the empty luma-DC unit
    for cap in (bitpack.bucket_words(int(out["total_bits"][0])), 128):
        wk, nk = bitpack.pack_frames(vals, lens, cap)
        wp, np_ = bitpack.pack_frames_plain(vals.cpu(), lens.cpu(), cap)
        assert torch.equal(nk.cpu(), np_)
        assert torch.equal(wk.cpu(), wp)
    assert int(np_.max()) > 32 * 128


@pytest.mark.parametrize("kind", ["speed0", "svc"])
def test_card_streams_decode_to_the_card_recon(card, kind):
    """The port's decoder (numpy, on the host) plays the card's streams
    bit-exactly: H264Encoder at speed 0 (IDR, P, P) and SvcEncoder with
    inter-layer prediction at speed 2 (gop 2: IDR, P, a base-mode IDR),
    both layers, at 128x96."""
    w, h = 128, 96
    if kind == "speed0":
        enc = H264Encoder(EncoderConfig(width=w, height=h, gop=10, qp=30))
        run = RunConfig(qp_min=30, qp_max=30, encode_speed=0)
    else:
        enc = SvcEncoder(EncoderConfig(width=w, height=h, gop=2, qp=30,
                                       num_layers=2,
                                       inter_layer_pred_flag=True))
        run = RunConfig(qp_min=30, qp_max=30, encode_speed=2)
    res = [enc.encode(*f, run, return_recon=True)
           for f in chessboard_sequence(w, h, 3)]
    assert [r.frame_type for r in res] == \
        ["IDR", "P", "P" if kind == "speed0" else "IDR"]
    dec = H264Decoder()
    frames = dec.decode(b"".join(r.payload for r in res))
    layers = [(frames, [r.recon for r in res])]
    if kind == "svc":
        layers = [(frames, [r.base_recon for r in res]),
                  (dec.enh_frames, [r.recon for r in res])]
    for got, want in layers:
        assert len(got) == len(want) == 3
        for f, recon in zip(got, want):
            for pa, pb in zip(f.cropped(f.sps), recon):
                np.testing.assert_array_equal(pa, pb)


def test_entry_on_the_card_equals_cpu(card):
    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    got = fn(*args)
    cfn, cargs = entry(device="cpu")
    want = cfn(*cargs)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k


def test_dryrun_on_a_virtual_card_mesh(card):
    got = dryrun_multichip(8, devices=["cuda:0"] * 8)
    assert len(got) == 4
    assert got == dryrun_multichip(8, devices=["cpu"] * 8)


@pytest.mark.parametrize("speed", [2, 0])
def test_card_mesh_equals_unsharded_card_run(card, speed):
    w, h = 128, 96
    cfg = EncoderConfig(width=w, height=h, gop=3, qp=30, slice_bands=2)
    run = RunConfig(qp_min=30, qp_max=30, encode_speed=speed)
    frames = list(chessboard_sequence(w, h, 4))
    mesh = GopBandEncoder(cfg, n_gop=2, mesh=make_mesh(2, 2, ["cuda:0"] * 4))
    flat = GopBandEncoder(cfg, n_gop=2)
    for t in range(3):
        lanes = frames[t:t + 2]
        before = bitpack.LAUNCH_COUNTS["bitpack"]
        got = mesh.encode_step(lanes, run, return_recon=True)
        assert bitpack.LAUNCH_COUNTS["bitpack"] == before + 4
        want = flat.encode_step(lanes, run, return_recon=True)
        assert [r.frame_type for r in got] == [["IDR", "P", "P"][t]] * 2
        for a, b in zip(got, want):
            assert a.payload == b.payload
            for pa, pb in zip(a.recon, b.recon):
                np.testing.assert_array_equal(pa, pb)


def _mesh_case(speed=2):
    w, h = 128, 96
    cfg = EncoderConfig(width=w, height=h, gop=3, qp=30, slice_bands=2)
    run = RunConfig(qp_min=30, qp_max=30, encode_speed=speed)
    frames = list(chessboard_sequence(w, h, 8))
    return cfg, run, [frames[t:t + 2] for t in range(7)]


def test_card_mesh_pipelined_loop_equals_unsharded_run(card):
    """`encode_step_async` of step t + 1 before `finish_step(t)`, as the
    benchmark's loop runs, on a (2, 2) mesh of cuda:0: the bytes and recon
    of the unsharded encoder's steps run one by one."""
    cfg, run, steps = _mesh_case()
    mesh = GopBandEncoder(cfg, n_gop=2, mesh=make_mesh(2, 2, ["cuda:0"] * 4))
    got = []
    pending = mesh.encode_step_async(steps[0], run, return_recon=True)
    for lanes in steps[1:]:
        nxt = mesh.encode_step_async(lanes, run, return_recon=True)
        got.append(mesh.finish_step(pending))
        pending = nxt
    got.append(mesh.finish_step(pending))
    flat = GopBandEncoder(cfg, n_gop=2)
    for t, lanes in enumerate(steps):
        want = flat.encode_step(lanes, run, return_recon=True)
        assert [r.frame_type for r in got[t]] == [r.frame_type for r in want]
        for a, b in zip(got[t], want):
            assert a.payload == b.payload, t
            for pa, pb in zip(a.recon, b.recon):
                np.testing.assert_array_equal(pa, pb)


def test_card_mesh_shards_issue_on_their_own_streams(card, monkeypatch):
    cfg, run, steps = _mesh_case()
    mesh = GopBandEncoder(cfg, n_gop=2, mesh=make_mesh(2, 2, ["cuda:0"] * 4))
    streams = mesh.workers.streams
    default = torch.cuda.default_stream(0)
    assert len({s.cuda_stream for s in streams} | {default.cuda_stream}) == 5
    seen = {}
    stages_run = type(mesh.stages).run

    def recording(self, *args, **kwargs):
        seen[id(self)] = (torch.cuda.current_stream().cuda_stream,
                          torch.cuda.current_device())
        return stages_run(self, *args, **kwargs)

    monkeypatch.setattr(type(mesh.stages), "run", recording)
    mesh.encode_step(steps[0], run)
    for sh, s in zip(mesh.shards, streams):
        assert sh.stages.stream is s
        assert seen[id(sh.stages)] == (s.cuda_stream, 0)
    # the stage table of a shard synchronizes only its own stream
    mesh.stage_times = {}
    mesh.encode_step(steps[1], run)
    assert set(mesh.stage_times) == {"shard 0,0", "shard 0,1", "shard 1,0",
                                     "shard 1,1", "exchange", "host"}
    assert all(v["sym"] > 0 for k, v in mesh.stage_times.items()
               if k.startswith("shard"))


@pytest.mark.parametrize("speed", [2, 0])
def test_card_mesh_launch_counts_are_exact(card, speed):
    """Four shards launching at once: K1, K2 and K6 once per shard and
    step, K3 once per shard on the IDR step (and at speed 0 on P steps), K4
    and K7 once per shard on P steps and, at speed 0, K5, at speed 2
    K8; K11 once per gop row and step (the exchange, one device a row),
    K12 once per shard and step (its `pre`), no K9, K10 or K13."""
    cfg, run, steps = _mesh_case(speed)
    mesh = GopBandEncoder(cfg, n_gop=2, mesh=make_mesh(2, 2, ["cuda:0"] * 4))
    for t, lanes in enumerate(steps[:3]):
        before = dict(me.LAUNCH_COUNTS)
        mesh.encode_step(lanes, run)
        done = {k: me.LAUNCH_COUNTS[k] - before[k] for k in before}
        p = t > 0
        assert done == dict(bitpack=4, deblock=4,
                            wavefront=4 if not p or speed == 0 else 0,
                            me=4 if p else 0,
                            partition=4 if p and speed == 0 else 0,
                            symbolize=4, inter_residual=4 if p else 0,
                            select_parallel=4 if p and speed == 2 else 0,
                            resample_down=0, resample_up=0, refplanes=2,
                            pad_tiles=4, denoise=0), (t, done)


def test_card_mesh_over_distinct_cards(card):
    """A (2, 1) mesh over cuda:0 and cuda:1 (the second shard's kernels on
    a card that is not the current one of the calling thread): the
    unsharded run's bytes; the launch shapes on cuda:1 read from cuda:1."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    cfg, run, steps = _mesh_case(0)
    cfg = dataclasses.replace(cfg, slice_bands=1)
    mesh = GopBandEncoder(cfg, n_gop=2,
                          mesh=make_mesh(2, 1, ["cuda:0", "cuda:1"]))
    flat = GopBandEncoder(cfg, n_gop=2)
    for lanes in steps[:3]:
        got = mesh.encode_step(lanes, run, return_recon=True)
        want = flat.encode_step(lanes, run, return_recon=True)
        for a, b in zip(got, want):
            assert a.payload == b.payload
            for pa, pb in zip(a.recon, b.recon):
                np.testing.assert_array_equal(pa, pb)
    one = torch.device("cuda", 1)
    with torch.cuda.device(1):
        here = (wavefront.occupancy(120, 8, one), me.occupancy(one),
                me.partition_occupancy(one))
    assert torch.cuda.current_device() == 0
    assert (wavefront.occupancy(120, 8, one), me.occupancy(one),
            me.partition_occupancy(one)) == here


# (seed, frames, mb_width, mb_height, qp, per-MB QPs, band edges)
K2_CASES = [
    (11, 16, 120, 68, 33, False, False),   # the GOP lanes' 16-lane step
    (12, 1, 120, 68, 30, True, False),     # sequential, per-MB QPs
    (13, 1, 60, 34, 33, False, False),     # SVC base layer
    (14, 1, 120, 34, 33, False, True),     # mesh band, no row above
    (15, 3, 4, 3, 14, True, True),
    (17, 2, 6, 1, 28, True, False),        # one MB high
    (18, 2, 1, 6, 33, True, False),        # one MB wide
]
K2_REPEATS = 20


def _k2_inputs(card, case):
    seed, n, mbw, mbh, qp, per_mb, band = case
    return {k: torch.from_numpy(np.asarray(v)).to(card) for k, v in
            deblock_inputs(seed, n, mbw, mbh, qp, per_mb_qp=per_mb,
                           band=band).items()}, mbw, mbh


def _k2_repeats_equal_plain(d, mbw, mbh):
    """K2 through `deblock_frame` K2_REPEATS times: one launch each, every
    output equal to the plain filter's."""
    want = mbscan.deblock_frame_plain(**d, mb_width=mbw, mb_height=mbh)
    for _ in range(K2_REPEATS):
        before = deblock.LAUNCH_COUNTS["deblock"]
        got = mbscan.deblock_frame(**d, mb_width=mbw, mb_height=mbh)
        torch.cuda.synchronize()
        assert deblock.LAUNCH_COUNTS["deblock"] == before + 1
        for a, b in zip(got, want):
            assert a.dtype == torch.uint8 and torch.equal(a, b)


@pytest.mark.parametrize("case", K2_CASES,
                         ids=lambda c: f"{c[1]}x{c[2]}x{c[3]}")
def test_k2_matches_plain_deblock(card, case):
    _k2_repeats_equal_plain(*_k2_inputs(card, case))


@pytest.mark.parametrize("avail", ["base_mode", "random"])
def test_k2_per_mb_availability(card, avail):
    d, mbw, mbh = _k2_inputs(card, (19, 2, 7, 5, 30, True, False))
    idx = torch.arange(mbw * mbh, device=card)
    if avail == "base_mode":         # as svc.base_mode_deblock passes them
        d["avail_top"], d["avail_left"] = idx >= mbw, idx % mbw > 0
    else:
        rng = np.random.default_rng(19)
        d["avail_top"], d["avail_left"] = (
            torch.from_numpy(rng.random(mbw * mbh) < 0.6).to(card)
            for _ in range(2))
    _k2_repeats_equal_plain(d, mbw, mbh)


def test_k2_path_derives_bs_and_qps_in_the_kernel(card, monkeypatch):
    d, mbw, mbh = _k2_inputs(card, K2_CASES[4])
    want = mbscan.deblock_frame_plain(**d, mb_width=mbw, mb_height=mbh)

    def refused(*args, **kwargs):
        raise AssertionError("called on the card path")

    monkeypatch.setattr(mbscan, "_frame_bs", refused)
    monkeypatch.setattr(deblock, "edge_qps", refused)
    for _ in range(3):
        before = deblock.LAUNCH_COUNTS["deblock"]
        got = mbscan.deblock_frame(**d, mb_width=mbw, mb_height=mbh)
        assert deblock.LAUNCH_COUNTS["deblock"] == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_k2_rejects_bad_inputs(card):
    d, mbw, mbh = _k2_inputs(card, (16, 1, 4, 3, 30, True, True))
    args = list(mbscan.deblock_tiles_args(**d, mb_width=mbw,
                                          mb_height=mbh)[:-2])
    deblock.deblock_tiles(*args, mbw, mbh)
    shifted = torch.empty(args[4].numel() + 1, dtype=torch.int32,
                          device=card)[1:].view(args[4].shape)
    for i, bad, err in (
            (0, args[0].cpu(), ValueError),                 # on the CPU
            (9, args[9].cpu(), ValueError),
            (0, args[0].int(), TypeError),
            (3, args[3].long(), TypeError),
            (7, args[7].long(), TypeError),
            (10, args[10].bool(), TypeError),
            (1, args[1][:, :6], ValueError),                # shape
            (8, args[8][:, 0].contiguous(), ValueError),    # qpc per frame
            (9, args[9][:5], ValueError),
            (0, args[0].transpose(-1, -2), ValueError),     # not contiguous
            (4, shifted, ValueError)):                      # misaligned
        with pytest.raises(err):
            deblock.deblock_tiles(*args[:i], bad, *args[i + 1:], mbw, mbh)
    with pytest.raises(ValueError):                         # nmb != 4 x 3
        deblock.deblock_tiles(*args, mbw, mbh + 1)


# (seed, frames, mb_width, mb_height, qp, inter candidate)
K3_CASES = [
    (31, 16, 120, 68, 33, False),          # the GOP lanes' 16-lane IDR step
    (32, 1, 120, 68, 33, True),            # sequential speed-0 P frame
    (33, 1, 60, 34, 33, False),            # SVC base layer
    (34, 1, 120, 34, 30, True),            # mesh band
    (35, 3, 4, 3, 0, True),
    (36, 3, 4, 3, 11, False),
    (37, 3, 4, 3, 12, True),
    (38, 3, 4, 3, 51, False),
    (39, 2, 6, 1, 28, True),               # one MB high
    (40, 2, 1, 6, 33, True),               # one MB wide
    (42, 2, 4, 7, 30, True),               # the schedule's edges: rows,
    (43, 2, 4, 8, 33, False),              # narrow frames, many frames
    (44, 2, 5, 9, 20, True),
    (45, 1, 6, 17, 40, False),
    (46, 3, 1, 9, 28, True),
    (47, 3, 2, 9, 12, False),
    (48, 16, 4, 9, 33, True),
]
K3_REPEATS = 20


def _k3_args(card, case):
    """`_select_wavefront`'s arguments of a seeded case on the card."""
    seed, n, mbw, mbh, qp, inter = case
    d = wavefront_inputs(seed, n, mbw, mbh, qp, inter=inter)
    t = {k: torch.from_numpy(v).to(card) for k, v in d.items()}
    cand = {k: t[k] for k in ("inter_cost", "recon_y_inter",
                              "recon_u_inter", "recon_v_inter")} \
        if inter else None
    return (t["src_y_mb"], t["src_u_mb"], t["src_v_mb"], t["qp"], t["qpc"],
            plan.make_plan(mbw, mbh, 2).steps, d["avail_top"],
            d["avail_left"], mbw, cand)


@pytest.mark.parametrize("case", K3_CASES,
                         ids=lambda c: f"{c[1]}x{c[2]}x{c[3]}-qp{c[4]}"
                         + ("-P" if c[5] else "-I"))
def test_k3_matches_plain_wavefront(card, case):
    args = _k3_args(card, case)
    want = mbscan._select_wavefront_plain(*args)
    for _ in range(K3_REPEATS):
        before = wavefront.LAUNCH_COUNTS["wavefront"]
        got = mbscan._select_wavefront(*args)
        torch.cuda.synchronize()
        assert wavefront.LAUNCH_COUNTS["wavefront"] == before + 1
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_k3_serves_the_encode_paths(card, monkeypatch):
    cfg = EncoderConfig(width=64, height=48, gop=3, qp=33)
    frames = list(chessboard_sequence(64, 48, 3))
    run2 = RunConfig(qp_min=33, qp_max=33, encode_speed=2)
    run0 = RunConfig(qp_min=33, qp_max=33)
    want_gop = GopBandEncoder(cfg, n_gop=2, device="cpu").encode_step(
        frames[:2], run2)
    cpu_seq = H264Encoder(cfg, device="cpu")
    want_seq = [cpu_seq.encode(*f, run0).payload for f in frames[:2]]

    def refused(*args, **kwargs):
        raise AssertionError("the plain wavefront on the card path")

    monkeypatch.setattr(mbscan, "_select_wavefront_plain", refused)
    before = wavefront.LAUNCH_COUNTS["wavefront"]
    got = GopBandEncoder(cfg, n_gop=2).encode_step(frames[:2], run2)
    assert [a.payload for a in got] == [b.payload for b in want_gop]
    assert got[0].frame_type == "IDR"
    seq = H264Encoder(cfg)
    got_seq = [seq.encode(*f, run0).payload for f in frames[:2]]
    assert got_seq == want_seq                  # an IDR, then a speed-0 P
    assert wavefront.LAUNCH_COUNTS["wavefront"] == before + 3


def test_k3_rejects_bad_inputs(card):
    args = list(mbscan.select_wavefront_args(*_k3_args(
        card, (41, 2, 4, 3, 30, True))))
    wavefront.wavefront_tiles(*args)
    shifted = torch.empty(args[0].numel() + 1, dtype=torch.uint8,
                          device=card)[1:].view(args[0].shape)
    for i, bad, err in (
            (0, args[0].cpu(), ValueError),                 # on the CPU
            (7, args[7].cpu(), ValueError),
            (0, args[0].int(), TypeError),
            (3, args[3].long(), TypeError),
            (5, args[5].float(), TypeError),
            (7, args[7].bool(), TypeError),
            (9, args[9].long(), TypeError),
            (1, args[1][:, :6], ValueError),                # shape
            (3, args[3][:, None].expand(2, 3).contiguous(),
             ValueError),                                   # per-row QPs
            (8, args[8][:5], ValueError),
            (0, args[0].transpose(-1, -2), ValueError),     # not contiguous
            (0, shifted, ValueError),                       # misaligned
            (10, None, ValueError)):                        # half inter
        with pytest.raises(err):
            wavefront.wavefront_tiles(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError):                         # no whole rows
        wavefront.wavefront_tiles(*args[:13], 5, *args[14:])


# (seed, frames, mb_width, mb_height, qp, lanes, frame rows, sub-pel)
ME_CASES = [
    (71, 1, 4, 3, 33, 1, 3, True),
    (72, 3, 4, 3, 12, 2, 5, True),          # bands at a row offset
    (73, 3, 4, 3, 0, 1, 3, False),
    (74, 2, 6, 1, 51, 1, 2, True),          # one MB high
    (75, 2, 1, 6, 20, 2, 8, False),         # one MB wide, banded
    (76, 1, 120, 68, 33, 1, 68, True),      # a 1080p frame
    (77, 3, 120, 68, 30, 3, 68, False),
    (78, 2, 120, 34, 33, 2, 68, True),      # mesh bands
    (82, 2, 11, 3, 33, 2, 6, True),         # partial tiles at both edges
    (83, 3, 9, 5, 20, 1, 40, True),         # bands deep in their frames
]
ME_REPEATS = 20


def _me_case(card, case, cut=False, stripes=False):
    """A seeded K4 case on the card: (tensors, mb_width, mb_height,
    sub-pel); `cut` trims the planes' guard so that window starts clamp,
    `stripes` makes candidate centres tie (`me_inputs`)."""
    seed, n, mbw, mbh, qp, lanes, rows, subpel = case
    d = me_inputs(seed, n, mbw, mbh, qp, lanes=lanes, frame_rows=rows,
                  stripes=stripes)
    if cut:
        d["y_pad"] = np.ascontiguousarray(d["y_pad"][:, :-40, :-40])
        d["y4_pad"] = np.ascontiguousarray(d["y4_pad"][:, :-10, :-6])
        d["prev_my"][:] = 52
    return {k: torch.from_numpy(v).to(card) for k, v in d.items()}, mbw, \
        mbh, subpel


ME_ARGS = ("y_pad", "y4_pad", "cur_tiles", "lane", "row_offset", "qp",
           "prev_my", "prev_mx")


def _k4(t, mbw, mbh, subpel, search=me.motion_search_tiles):
    return search(*(t[k] for k in ME_ARGS), mbw, mbh, enable_subpel=subpel,
                  planes=subpel)


def _k4_equals_plain(t, mbw, mbh, subpel):
    want = _k4(t, mbw, mbh, subpel, me.motion_search_plain)
    for _ in range(ME_REPEATS):
        before = me.LAUNCH_COUNTS["me"]
        got = _k4(t, mbw, mbh, subpel)
        torch.cuda.synchronize()
        assert me.LAUNCH_COUNTS["me"] == before + 1
        for a, b, name in zip(got[:4], want[:4], ("mv_y", "mv_x", "cost",
                                                  "pred")):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        for k in ("cy4", "cx4", "full_my", "full_mx", "mvp_y", "mvp_x"):
            assert torch.equal(got[4][k], want[4][k]), k
        if subpel:
            assert torch.equal(got[4]["wins"], want[4]["wins"])
        else:
            assert got[4]["wins"] is None
    return got, want


@pytest.mark.parametrize("case", ME_CASES, ids=lambda c: (
    f"{c[1]}x{c[2]}x{c[3]}-qp{c[4]}" + ("" if c[7] else "-fullpel")))
def test_k4_matches_plain_search(card, case):
    _k4_equals_plain(*_me_case(card, case))


@pytest.mark.parametrize("subpel", [True, False])
def test_k4_clamps_windows_as_the_plain_search(card, subpel):
    _k4_equals_plain(*_me_case(card, (79, 2, 4, 3, 33, 2, 3, subpel),
                               cut=True))


@pytest.mark.parametrize("subpel", [True, False])
def test_k4_clamps_the_strip_origin(card, subpel):
    """Planes cut to 100 x 100, above and left of the last tiles of bands
    at row offsets 6 and 3: those tiles' strips start clamped."""
    t, mbw, mbh, subpel = _me_case(card, (86, 2, 11, 2, 33, 1, 8, subpel))
    t["row_offset"] = torch.tensor([6, 3], dtype=torch.int32, device=card)
    t["y_pad"] = t["y_pad"][:, :100, :100].contiguous()
    _k4_equals_plain(t, mbw, mbh, subpel)


@pytest.mark.parametrize("subpel", [True, False])
def test_k4_keeps_the_first_of_tied_centres(card, subpel):
    got, _ = _k4_equals_plain(*_me_case(card, (81, 2, 4, 3, 33, 1, 3,
                                                subpel), stripes=True))
    assert (got[4]["full_mx"][:, 0] == -4).all()


@pytest.mark.parametrize("case", [c for c in ME_CASES if c[7]], ids=lambda c: (
    f"{c[1]}x{c[2]}x{c[3]}-qp{c[4]}"))
def test_k5_matches_plain_partition_search(card, case):
    t, mbw, mbh, subpel = _me_case(card, case)
    got4 = _k4(t, mbw, mbh, subpel)
    kk = t["cur_tiles"].shape[0] * mbw * mbh
    tiles = t["cur_tiles"].reshape(kk, 16, 16)
    flat = [got4[4][k].reshape(kk) for k in ("full_my", "full_mx", "mvp_y",
                                             "mvp_x")]
    lam = me.lambda_me(t["qp"]).repeat_interleave(mbw * mbh)
    want = me.partition_plain(tiles, got4[4]["wins"], *flat, lam)
    for _ in range(ME_REPEATS):
        before = me.LAUNCH_COUNTS["partition"]
        got = me.partition_tiles(tiles, got4[4]["wins"], *flat, lam)
        torch.cuda.synchronize()
        assert me.LAUNCH_COUNTS["partition"] == before + 1
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_k4_and_k5_serve_the_encode_paths(card, monkeypatch):
    cfg = EncoderConfig(width=64, height=48, gop=4, qp=33)
    frames = list(chessboard_sequence(64, 48, 4))
    runs = {s: RunConfig(qp_min=33, qp_max=33, encode_speed=s)
            for s in (0, 2, 10)}

    def gop(device, speed):
        enc = GopBandEncoder(cfg, n_gop=2, device=device)
        return [a.payload for t in range(2)
                for a in enc.encode_step(frames[t:t + 2], runs[speed])]

    def seq(device, speed):
        enc = H264Encoder(cfg, device=device)
        return [enc.encode(*f, runs[speed]).payload for f in frames[:3]]

    want = {(f, s): f("cpu", s) for f, s in ((gop, 2), (gop, 0), (seq, 0),
                                             (seq, 10))}

    def refused(*args, **kwargs):
        raise AssertionError("a plain search on the card path")

    monkeypatch.setattr(me, "motion_search_dense", refused)
    monkeypatch.setattr(me, "partition_search", refused)
    before = dict(me.LAUNCH_COUNTS)
    for (f, s), payloads in want.items():
        assert f(card, s) == payloads, (f.__name__, s)
    # P steps / frames: GOP 1 + 1, sequential 2 + 2; partitions at speed 0
    assert me.LAUNCH_COUNTS["me"] - before["me"] == 6
    assert me.LAUNCH_COUNTS["partition"] - before["partition"] == 3


def test_k4_and_k5_reject_bad_inputs(card):
    t, mbw, mbh, subpel = _me_case(card, (80, 2, 4, 3, 30, 2, 4, True))
    args = [t[k] for k in ME_ARGS]
    out = me.motion_search_tiles(*args, mbw, mbh, planes=True)
    shifted = torch.empty(args[2].numel() + 1, dtype=torch.uint8,
                          device=card)[1:].view(args[2].shape)
    for i, bad, err in (
            (0, args[0].cpu(), ValueError),                 # on the CPU
            (2, args[2].cpu(), ValueError),
            (5, args[5].cpu(), ValueError),
            (2, args[2].int(), TypeError),                  # dtype
            (3, args[3].long(), TypeError),
            (6, args[6].long(), TypeError),
            (1, args[1][0], ValueError),                    # shape
            (1, args[1][:1], ValueError),                   # lanes
            (5, args[5][:1], ValueError),
            (6, args[6][:, :5], ValueError),
            (2, args[2].transpose(-1, -2), ValueError),     # not contiguous
            (0, args[0].transpose(1, 2), ValueError),
            (2, shifted, ValueError),                       # misaligned
            (7, None, ValueError)):                         # half prev
        with pytest.raises(err):
            me.motion_search_tiles(*args[:i], bad, *args[i + 1:], mbw, mbh)
    with pytest.raises(ValueError):                         # nmb != 4 x 3
        me.motion_search_tiles(*args, mbw, mbh + 1)
    with pytest.raises(ValueError):                         # planes, no qpel
        me.motion_search_tiles(*args, mbw, mbh, enable_subpel=False,
                               planes=True)
    kk = 2 * mbw * mbh
    pargs = [t["cur_tiles"].reshape(kk, 16, 16), out[4]["wins"]] + [
        out[4][k].reshape(kk) for k in ("full_my", "full_mx", "mvp_y",
                                        "mvp_x")] + [
        me.lambda_me(t["qp"]).repeat_interleave(mbw * mbh)]
    me.partition_tiles(*pargs)
    for i, bad, err in (
            (0, pargs[0].cpu(), ValueError),
            (1, pargs[1].int(), TypeError),
            (6, pargs[6].long(), TypeError),
            (1, pargs[1][:, :3], ValueError),
            (2, pargs[2][:5], ValueError),
            (0, pargs[0].transpose(1, 2), ValueError),
            (0, shifted.view(kk, 16, 16), ValueError),
            (1, torch.empty(pargs[1].numel() + 1, dtype=torch.uint8,
                            device=card)[1:].view(pargs[1].shape),
             ValueError)):                                   # misaligned
        with pytest.raises(err):
            me.partition_tiles(*pargs[:i], bad, *pargs[i + 1:])


# (seed, slices, mb_width, mb_height, P slices, row QP plan, base_mode bit)
K6_CASES = [
    (91, 16, 120, 68, True, False, False),   # the GOP lanes' P step
    (92, 16, 120, 68, False, False, False),  # their IDR step
    (93, 1, 120, 68, True, True, False),     # sequential, a row QP plan
    (94, 1, 60, 34, True, False, False),     # SVC base layer
    (95, 1, 120, 68, True, False, True),     # SVC enhancement, base_mode
    (96, 1, 120, 34, True, False, False),    # a mesh band
    (97, 3, 4, 3, True, True, False),
    (98, 2, 6, 1, False, True, False),       # one MB high
    (99, 2, 1, 6, True, False, True),        # one MB wide
    (100, 2, 11, 3, True, True, False),
    (101, 2, 11, 3, False, False, True),
    (102, 16, 120, 68, True, False, False, True),   # every position coded
]
K6_KEYS = ("sel", "mode16", "cmode", "i4sym_v", "i4sym_l", "mv4_y", "mv4_x",
           "shape", "dc_lev", "ac_lev", "lev_inter", "cdc_lev", "cac_lev")
K6_REPEATS = 20


def _k6_inputs(card, case):
    seed, n, mbw, mbh, has_inter, plan, flag = case[:7]
    d = sym_inputs(seed, n, mbw, mbh, has_inter, plan=plan,
                   dense=case[7:] == (True,))
    t = [torch.from_numpy(d[k]).to(card) for k in K6_KEYS]
    qp = None if d["qp_rows"] is None else torch.from_numpy(
        d["qp_rows"]).to(card)
    return t, dict(mb_width=mbw, mb_height=mbh, has_inter=has_inter,
                   qp_rows=qp, svc_base_mode_bit=flag)


def _k6_ids(c):
    return (f"{c[1]}x{c[2]}x{c[3]}-{'P' if c[4] else 'I'}"
            + ("-plan" if c[5] else "") + ("-bm" if c[6] else "")
            + ("-dense" if c[7:] == (True,) else ""))


@pytest.mark.parametrize("case", K6_CASES, ids=_k6_ids)
def test_k6_matches_plain_symbolize(card, case):
    t, kw = _k6_inputs(card, case)
    want = mbscan.symbolize_plain(*t, **kw)
    for _ in range(K6_REPEATS):
        before = k6.LAUNCH_COUNTS["symbolize"]
        got = mbscan.symbolize(*t, **kw)
        torch.cuda.synchronize()
        assert k6.LAUNCH_COUNTS["symbolize"] == before + 1
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k], v), k


def test_k6_grid_packs_as_the_plain_grid(card):
    """K1's words and bit counts from K6's grid equal those from the plain
    grid, and the counts equal `total_bits` less the tail."""
    t, kw = _k6_inputs(card, K6_CASES[0])
    want = mbscan.symbolize_plain(*t, **kw)
    got = mbscan.symbolize(*t, **kw)
    cap = bitpack.bucket_words(int(want["total_bits"].max()))
    words = [bitpack.pack_frames(o["sym_vals"], o["sym_lens"], cap)
             for o in (want, got)]
    assert torch.equal(words[0][0], words[1][0])
    assert torch.equal(words[0][1], words[1][1])
    assert torch.equal(words[1][1], got["total_bits"] - got["tail_len"])


def test_k6_serves_the_encode_paths(card, monkeypatch):
    cfg = EncoderConfig(width=64, height=48, gop=3, qp=33)
    frames = list(chessboard_sequence(64, 48, 3))
    run2 = RunConfig(qp_min=33, qp_max=33, encode_speed=2)
    run0 = RunConfig(qp_min=33, qp_max=33)
    cpu = GopBandEncoder(cfg, n_gop=2, device="cpu")
    want_gop = [cpu.encode_step(frames[t:t + 2], run2) for t in range(2)]
    cpu_seq = H264Encoder(cfg, device="cpu")
    want_seq = [cpu_seq.encode(*f, run0).payload for f in frames[:2]]

    def refused(*args, **kwargs):
        raise AssertionError("the plain symbolizer on the card path")

    calls = []
    symbolize = mbscan.symbolize

    def counted(*args, **kwargs):
        calls.append(1)
        return symbolize(*args, **kwargs)

    monkeypatch.setattr(mbscan, "symbolize_plain", refused)
    monkeypatch.setattr(mbscan, "symbolize", counted)
    before = k6.LAUNCH_COUNTS["symbolize"]
    gop = GopBandEncoder(cfg, n_gop=2)
    for t in range(2):                          # IDR, then P
        got = gop.encode_step(frames[t:t + 2], run2)
        assert [a.payload for a in got] == [b.payload for b in want_gop[t]]
    seq = H264Encoder(cfg)
    assert [seq.encode(*f, run0).payload for f in frames[:2]] == want_seq
    assert len(calls) >= 4
    assert k6.LAUNCH_COUNTS["symbolize"] == before + len(calls)


def test_k6_rejects_bad_inputs(card):
    t, kw = _k6_inputs(card, K6_CASES[6])
    args = list(mbscan.symbolize_args(*t, **kw))
    k6.symbolize_tiles(*args)
    shifted = torch.empty(args[9].numel() + 1, dtype=torch.int32,
                          device=card)[1:].view(args[9].shape)
    for i, bad, err in (
            (0, args[0].cpu(), ValueError),                 # on the CPU
            (9, args[9].cpu(), ValueError),
            (13, args[13].cpu(), ValueError),
            (0, args[0].long(), TypeError),                 # dtype
            (10, args[10].to(torch.int16), TypeError),
            (13, args[13].long(), TypeError),
            (5, args[5][:, :, 0], ValueError),              # shape
            (13, args[13][:, :1], ValueError),
            (12, args[12][:1], ValueError),
            (9, args[9].transpose(-1, -2), ValueError),     # not contiguous
            (9, shifted, ValueError)):                      # misaligned
        with pytest.raises(err):
            k6.symbolize_tiles(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError):                         # nmb != 4 x 3
        k6.symbolize_tiles(*args[:14], 4, 4, *args[16:])


# K7: (seed, frames, mb_width, mb_height, qp, lanes, lane frame rows, row
# plan, partitions, quarter-pel, reach, noisy guard)
K7_CASES = [
    (111, 16, 120, 68, 33, 16, None, False, False, True, 55, False),
    (112, 1, 120, 68, 30, 1, None, True, True, True, 55, False),
    (113, 1, 60, 34, 33, 1, None, False, False, True, 55, False),
    (114, 2, 120, 34, 20, 1, 68, False, False, False, 55, False),
    (115, 3, 4, 3, 0, 2, 6, False, True, True, 55, False),
    (116, 2, 6, 1, 51, 1, 4, True, False, True, 55, False),
    (117, 2, 1, 6, 12, 1, None, False, True, True, 55, False),
    (118, 2, 11, 3, 40, 2, 9, True, False, True, 55, False),
    (119, 9, 1, 6, 26, 1, None, True, False, True, 55, False),
    (120, 2, 4, 3, 28, 1, 6, False, False, True, 63, True),
    # 135 and 129,472 MBs: tiles of 16 MBs end short and cross frames
    (130, 3, 9, 5, 24, 3, None, False, False, True, 55, False),
    (131, 16, 119, 68, 33, 16, None, False, False, True, 55, False),
]
# K8: (seed, frames, mb_width, mb_height, qp, row plan, band)
K8_CASES = [
    (121, 16, 120, 68, 33, False, True),
    (122, 1, 120, 68, 30, True, False),
    (123, 1, 60, 34, 33, False, True),
    (124, 2, 120, 34, 20, False, True),
    (125, 3, 4, 3, 0, True, False),
    (126, 2, 6, 1, 51, False, False),
    (127, 2, 1, 6, 12, True, True),
    (128, 2, 11, 3, 40, False, False),
    (129, 9, 1, 6, 26, True, False),
    (132, 3, 9, 5, 24, False, False),
    (133, 16, 119, 68, 33, False, True),
]
RESIDUAL_REPEATS = 20


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def _k7_args(card, case, zero_thr=True):
    (seed, n, mbw, mbh, qp, lanes, rows, plan, parts, qpel, reach,
     noisy) = case
    d = inter_residual_inputs(seed, n, mbw, mbh, qp, lanes=lanes,
                              frame_rows=rows, plan=plan, parts=parts,
                              qpel=qpel, reach=reach, noisy_guard=noisy)
    p = d.pop("parts")
    t = {k: torch.from_numpy(v).to(card) for k, v in d.items()}
    return (t["src_y_mb"], t["src_u_mb"], t["src_v_mb"], t["u_pad"],
            t["v_pad"], t["lane"], t["row0"], t["qp"], t["qpc"], t["mv_y"],
            t["mv_x"], t["full_my"], t["full_mx"], t["cost16"], t["pred16"],
            None if p is None else {k: torch.from_numpy(v).to(card)
                                    for k, v in p.items()}, mbw, mbh,
            zero_thr)


def _k8_args(card, case):
    seed, n, mbw, mbh, qp, plan, band = case
    d = select_parallel_inputs(seed, n, mbw, mbh, qp, plan=plan, band=band)
    return (*(torch.from_numpy(d[k]).to(card) for k in (
        "src_y_mb", "src_u_mb", "src_v_mb", "qp", "qpc")),
        d["avail_top"], d["avail_left"],
        {k: torch.from_numpy(v).to(card) for k, v in d["inter"].items()},
        mbw)


def _repeats_equal_plain(entry, plain, args, count):
    want = plain(*args)
    for _ in range(RESIDUAL_REPEATS):
        before = residual.LAUNCH_COUNTS[count]
        got = entry(*args)
        torch.cuda.synchronize()
        assert residual.LAUNCH_COUNTS[count] == before + 1
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k], v), k


def _case_id(c):
    return "x".join(str(v) for v in c[1:4]) + f"-seed{c[0]}"


@pytest.mark.parametrize("case", K7_CASES, ids=_case_id)
def test_k7_matches_plain_inter_residual(card, case):
    _repeats_equal_plain(mbscan.inter_residual, mbscan.inter_residual_plain,
                         _k7_args(card, case), "inter_residual")


def test_k7_without_the_zero_block_kills(card):
    _repeats_equal_plain(mbscan.inter_residual, mbscan.inter_residual_plain,
                         _k7_args(card, K7_CASES[4], zero_thr=False),
                         "inter_residual")


@pytest.mark.parametrize("case", K8_CASES, ids=_case_id)
def test_k8_matches_plain_select(card, case):
    _repeats_equal_plain(mbscan.select_parallel, mbscan.select_parallel_plain,
                         _k8_args(card, case), "select_parallel")


def _recorded(monkeypatch, name, calls):
    fn = getattr(mbscan, name)

    def rec(*args):
        calls.append(args)
        return fn(*args)
    monkeypatch.setattr(mbscan, name, rec)


def test_k7_k8_match_plain_on_a_real_p_step(card, monkeypatch):
    cfg = EncoderConfig(width=352, height=288, gop=20, qp=33)
    frames = list(noise_pan_sequence(352, 288, 4))
    inter, select = [], []
    _recorded(monkeypatch, "inter_residual", inter)
    _recorded(monkeypatch, "select_parallel", select)
    gop = GopBandEncoder(cfg, n_gop=2)
    for t in range(2):
        gop.encode_step(frames[t:t + 2], RunConfig(qp_min=33, qp_max=33,
                                                   encode_speed=2))
    assert len(inter) == len(select) == 1
    monkeypatch.undo()
    _repeats_equal_plain(mbscan.inter_residual, mbscan.inter_residual_plain,
                         inter[0], "inter_residual")
    _repeats_equal_plain(mbscan.select_parallel, mbscan.select_parallel_plain,
                         select[0], "select_parallel")


def test_k7_k8_serve_the_encode_paths(card, monkeypatch):
    cfg = EncoderConfig(width=64, height=48, gop=3, qp=33)
    frames = list(chessboard_sequence(64, 48, 3))
    runs = {s: RunConfig(qp_min=33, qp_max=33, encode_speed=s)
            for s in (0, 2, 10)}
    want = {}
    for s in (2, 0):
        cpu = GopBandEncoder(cfg, n_gop=2, device="cpu")
        want["gop", s] = [[a.payload for a in cpu.encode_step(
            frames[t:t + 2], runs[s])] for t in range(2)]
    for s in (0, 10):
        cpu = H264Encoder(cfg, device="cpu")
        want["seq", s] = [cpu.encode(*f, runs[s]).payload
                          for f in frames[:2]]

    def refused(*args, **kwargs):
        raise AssertionError("a plain version on the card path")
    monkeypatch.setattr(mbscan, "inter_residual_plain", refused)
    monkeypatch.setattr(mbscan, "select_parallel_plain", refused)
    before = dict(residual.LAUNCH_COUNTS)
    for s in (2, 0):
        gop = GopBandEncoder(cfg, n_gop=2)
        assert [[a.payload for a in gop.encode_step(frames[t:t + 2],
                                                    runs[s])]
                for t in range(2)] == want["gop", s]
    for s in (0, 10):
        seq = H264Encoder(cfg)
        assert [seq.encode(*f, runs[s]).payload
                for f in frames[:2]] == want["seq", s]
    # P steps or frames: GOP speed 2 and 0, sequential 0 and 10
    assert residual.LAUNCH_COUNTS["inter_residual"] == before[
        "inter_residual"] + 4
    # the parallel select: GOP speed 2, sequential speed 10
    assert residual.LAUNCH_COUNTS["select_parallel"] == before[
        "select_parallel"] + 2


def test_k7_k8_reject_bad_inputs(card):
    args = list(mbscan.inter_residual_args(*_k7_args(card, K7_CASES[4])))
    residual.inter_tiles(*args)
    shifted = torch.empty(args[0].numel() + 1, dtype=torch.uint8,
                          device=card)[1:].view(args[0].shape)
    for i, bad, err in (
            (0, args[0].cpu(), ValueError),                 # on the CPU
            (3, args[3].cpu(), ValueError),
            (9, args[9].long(), TypeError),                 # dtype
            (14, args[14].int(), TypeError),
            (7, args[7][:1], ValueError),                   # shape
            (4, args[4][:, 1:], ValueError),
            (14, args[14].transpose(-1, -2), ValueError),   # not contiguous
            (0, shifted, ValueError)):                      # misaligned
        with pytest.raises(err):
            residual.inter_tiles(*args[:i], bad, *args[i + 1:])
    parts = list(args[15])
    for j, bad in ((3, parts[3].int()), (6, parts[6][1:])):
        with pytest.raises((TypeError, ValueError)):
            residual.inter_tiles(*args[:15], tuple(
                parts[:j] + [bad] + parts[j + 1:]), *args[16:])
    with pytest.raises(ValueError):                         # nmb != 4 x 4
        residual.inter_tiles(*args[:16], 4, 4)
    sargs = list(mbscan.select_parallel_args(*_k8_args(card, K8_CASES[4])))
    residual.select_tiles(*sargs)
    for i, bad, err in (
            (0, sargs[0].cpu(), ValueError),
            (5, sargs[5].bool(), TypeError),
            (6, sargs[6][:, :-1], ValueError),
            (11, sargs[11].transpose(-1, -2), ValueError)):
        with pytest.raises(err):
            residual.select_tiles(*sargs[:i], bad, *sargs[i + 1:])
    with pytest.raises(ValueError):                         # rows of 5 MBs
        residual.select_tiles(*sargs[:17], 5)


# ---------------------------------------------------------------------------
# the SVC base-mode frame: K7 with zero MVs and K6's base-mode slice kind
# ---------------------------------------------------------------------------

# K6 on base-mode slices: (seed, slices, mb_width, mb_height, dense), the
# levels of `sym_inputs`' P slices (their intra and quiet MBs have none:
# coded MBs of cbp 0)
K6_BASE_MODE_CASES = [(141, 1, 8, 6, False), (142, 1, 120, 68, False),
                      (143, 2, 1, 6, False), (144, 3, 6, 1, False),
                      (145, 1, 120, 68, True)]


def _k6_base_mode_inputs(card, case):
    seed, n, mbw, mbh, dense = case
    d = sym_inputs(seed, n, mbw, mbh, True, dense=dense)
    t = [None] * 10 + [torch.from_numpy(d[k]).to(card)
                       for k in ("lev_inter", "cdc_lev", "cac_lev")]
    return t, dict(mb_width=mbw, mb_height=mbh, has_inter=False,
                   base_mode=True)


@pytest.mark.parametrize("case", K6_BASE_MODE_CASES,
                         ids=lambda c: f"{c[1]}x{c[2]}x{c[3]}"
                         + ("-dense" if c[4] else ""))
def test_k6_base_mode_matches_plain_symbolize(card, case):
    t, kw = _k6_base_mode_inputs(card, case)
    want = mbscan.symbolize_plain(*t, **kw)
    assert (want["cbp"] == 0).any() != case[4]     # dense: no cbp 0
    for _ in range(K6_REPEATS):
        before = k6.LAUNCH_COUNTS["symbolize"]
        got = mbscan.symbolize(*t, **kw)
        torch.cuda.synchronize()
        assert k6.LAUNCH_COUNTS["symbolize"] == before + 1
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("mbw,mbh,qp", [(8, 6, 26), (120, 68, 33),
                                        (1, 6, 51), (6, 1, 10)])
def test_base_mode_symbols_on_the_card_equal_cpu(card, mbw, mbh, qp):
    """`svc.base_mode_symbols` on the card (one K7 launch, one K6 call)
    gives the CPU's grid, bit counts, recon, cbp and nnz."""
    rng = np.random.default_rng(mbw * mbh + qp)
    tiles = []
    for t in (16, 8, 8):
        src = rng.integers(100, 156, (1, mbw * mbh, 1, 1)) + rng.integers(
            -3, 4, (1, mbw * mbh, t, t))
        amp = rng.choice([0, 2, 40], (1, mbw * mbh, 1, 1))
        noise = rng.integers(-40, 41, src.shape).clip(-amp, amp)
        tiles.append((src.astype(np.uint8),
                       np.clip(src + noise, 0, 255).astype(np.uint8)))
    ins = [torch.from_numpy(x[0]) for x in tiles] + [
        torch.from_numpy(x[1]) for x in tiles]
    qpc = int(tables.QPC_FROM_QPY[qp])
    want = base_mode_symbols(*ins, [qp], [qpc], mbw, mbh)
    before = dict(k6.LAUNCH_COUNTS)
    got = base_mode_symbols(*(x.to(card) for x in ins), [qp], [qpc], mbw,
                            mbh)
    torch.cuda.synchronize()
    assert k6.LAUNCH_COUNTS["symbolize"] == before["symbolize"] + 1
    assert k6.LAUNCH_COUNTS["inter_residual"] == before["inter_residual"] + 1
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k].cpu(), v), k
    if (mbw, mbh) == (8, 6):
        assert (want["cbp"] == 0).any() and (want["cbp"] != 0).any()


def test_base_mode_frames_run_on_k6_and_k7(card, monkeypatch):
    """A two-layer stream with inter-layer prediction encodes on the card
    to the CPU's bytes with the plain symbolizer, the plain inter residual
    and the plain block coder refused: its base-mode IDR runs on K7 and
    K6."""
    cfg = EncoderConfig(width=128, height=96, gop=10, qp=30, num_layers=2,
                        inter_layer_pred_flag=True)
    run = RunConfig(qp_min=30, qp_max=30, encode_speed=2)
    frames = list(chessboard_sequence(128, 96, 2))
    on_cpu = SvcEncoder(cfg, device="cpu")
    want = [on_cpu.encode(*f, run).payload for f in frames]

    def refused(*args, **kwargs):
        raise AssertionError("a plain version on the card path")

    for mod, name in ((mbscan, "symbolize_plain"),
                      (mbscan, "inter_residual_plain"),
                      (cavlc, "encode_blocks")):
        monkeypatch.setattr(mod, name, refused)
    before = dict(k6.LAUNCH_COUNTS)
    on_card = SvcEncoder(cfg)
    got = on_card.encode(*frames[0], run)          # the base-mode IDR
    assert got.frame_type == "IDR" and got.payload == want[0]
    # the base layer's IDR and the enhancement's base-mode slice
    assert k6.LAUNCH_COUNTS["symbolize"] == before["symbolize"] + 2
    assert k6.LAUNCH_COUNTS["inter_residual"] == before["inter_residual"] + 1
    assert on_card.encode(*frames[1], run).payload == want[1]


def test_k6_base_mode_rejects_bad_inputs(card):
    t, kw = _k6_base_mode_inputs(card, K6_BASE_MODE_CASES[0])
    args = list(mbscan.symbolize_args(*t, **kw))
    k6.symbolize_tiles(*args)
    shifted = torch.empty(args[12].numel() + 1, dtype=torch.int32,
                          device=card)[1:].view(args[12].shape)
    for i, bad, err in (
            (0, torch.zeros(args[10].shape[:2], dtype=torch.int32,
                            device=card), ValueError),   # an unread input
            (9, args[10], ValueError),
            (10, args[10].cpu(), ValueError),            # on the CPU
            (11, args[11].long(), TypeError),            # dtype
            (12, args[12][:, :, :1], ValueError),        # shape
            (10, args[10].transpose(-1, -2), ValueError),  # not contiguous
            (12, shifted, ValueError),                   # misaligned
            (13, torch.zeros((1, 6), dtype=torch.int32, device=card),
             ValueError),                                # a row plan
            (16, True, ValueError),                      # a P slice
            (17, True, ValueError)):                     # the flag bit
        with pytest.raises(err):
            k6.symbolize_tiles(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError):                      # nmb != 6 x 6
        k6.symbolize_tiles(*args[:14], 6, 6, *args[16:])


# ---------------------------------------------------------------------------
# K9 and K10 (the SVC resampling) and K11 (the reference planes)
# ---------------------------------------------------------------------------

RESAMPLE_REPEATS = 20            # launches per check, all equal


def _border_plane(rng, h, w):
    """Seeded noise with 0 and 255 borders and a flat patch."""
    p = rng.integers(0, 256, (h, w), dtype=np.uint8)
    p[0], p[-1] = 0, 255
    p[:, 0], p[:, -1] = 255, 0
    p[h // 3:h // 3 + 5, w // 4:w // 4 + 7] = 128
    return p


def _as_tiles(plane, t):
    h, w = plane.shape
    return (plane.reshape(h // t, t, w // t, t).transpose(0, 2, 1, 3)
            .reshape(-1, t, t))


def _outputs(x):
    return list(x.items()) if isinstance(x, dict) else list(enumerate(x))


def _launches_equal_plain(entry, plain, args, count):
    """`entry` (one launch of its kernel a call) RESAMPLE_REPEATS times,
    each output equal to the plain version's (keys, dtypes, shapes)."""
    want = _outputs(plain(*args))
    for _ in range(RESAMPLE_REPEATS):
        before = LAUNCH_COUNTS[count]
        got = _outputs(entry(*args))
        torch.cuda.synchronize()
        assert LAUNCH_COUNTS[count] == before + 1
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.is_cuda and torch.equal(g, w), k


@pytest.mark.parametrize("h,w", [(1088, 1920), (544, 960), (1081, 1921),
                                 (37, 51), (3, 9), (2, 2)])
def test_k9_matches_plain_downsample(card, h, w):
    rng = np.random.default_rng(h + w)
    ch, cw = max(h // 2, 2), max(w // 2, 2)
    planes = [torch.from_numpy(_border_plane(rng, *s)).to(card)
              for s in ((h, w), (ch, cw), (ch, cw))]
    _launches_equal_plain(
        resample.downsample_planes,
        lambda *p: tuple(resample.downsample2x(x) for x in p), planes,
        "resample_down")


# (base width, base height): the 1080p base, a cropped base, one MB, one MB
# wide and high, a few pixels; K10's chunks of 8 MBs cut short (18 MBs
# wide), a crop that ends inside a tile across (an odd width: 8-byte
# stores of the padded chroma rows) and down
K10_CASES = ((960, 544), (120, 90), (16, 16), (16, 40), (40, 16), (12, 10),
             (144, 32), (100, 32), (32, 70))


def _k10_args(card, bw, bh, seed=5, size=None):
    """Seeded base tiles of a bw x bh base picture on the card and the
    sizes: the enhancement's MBs `size`, or as SvcEncoder sizes them."""
    rng = np.random.default_rng(seed + bw + 3 * bh)
    bmbw, bmbh = -(-bw // 16), -(-bh // 16)
    tiles = tuple(torch.from_numpy(_as_tiles(_border_plane(
        rng, bmbh * t, bmbw * t), t)).to(card) for t in (16, 8, 8))
    crops = ((bh, bw), (bh // 2, bw // 2), (bh // 2, bw // 2))
    mbw, mbh = size or (-(-2 * bw // 16), -(-2 * bh // 16))
    return tiles, bmbw, crops, mbw, mbh


@pytest.mark.parametrize("bw,bh", K10_CASES)
def test_k10_matches_plain_upsample(card, bw, bh):
    _launches_equal_plain(resample.upsample_tiles,
                          resample.upsample_tiles_plain,
                          _k10_args(card, bw, bh), "resample_up")


def test_k10_matches_plain_upsample_past_twice_the_base(card):
    """An enhancement of 11 x 6 MBs over a 40x24 base: K10's last chunk and
    MB rows lie wholly past twice the base and repeat its last pixels."""
    _launches_equal_plain(resample.upsample_tiles,
                          resample.upsample_tiles_plain,
                          _k10_args(card, 40, 24, size=(11, 6)),
                          "resample_up")


# (pictures, mb_width, mb_height): 16 lanes of 1080p, one frame, the SVC
# base, 3 pictures of 4 x 3 MBs, one MB, one MB wide and high, CIF
K11_CASES = ((16, 120, 68), (1, 120, 68), (1, 60, 34), (3, 4, 3), (1, 1, 1),
             (2, 1, 6), (2, 6, 1), (2, 22, 18))


def _k11_tiles(card, n, mbw, mbh, seed=9):
    rng = np.random.default_rng(seed + n * 1000 + mbw * 10 + mbh)
    return tuple(torch.from_numpy(np.stack([_as_tiles(_border_plane(
        rng, mbh * t, mbw * t), t) for _ in range(n)])).to(card)
        for t in (16, 8, 8))


@pytest.mark.parametrize("n,mbw,mbh", K11_CASES)
def test_k11_matches_plain_reference_planes(card, n, mbw, mbh):
    tiles = _k11_tiles(card, n, mbw, mbh)
    _launches_equal_plain(refstate.prepare_reference,
                          refstate.prepare_reference_plain,
                          tiles + (mbw, mbh), "refplanes")
    # the chroma planes alone (`reference_chroma`, K11 without luma)
    _launches_equal_plain(
        refstate.reference_chroma,
        lambda u, v, w, h: tuple(
            refstate.prepare_reference_plain(*tiles, w, h)[k]
            for k in ("u_pad", "v_pad")),
        tiles[1:] + (mbw, mbh), "refplanes")


def _shifted(t, by):
    """A copy of `t` at `by` bytes past a fresh allocation."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[by:by + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("n,mbw,mbh", [(2, 22, 18), (1, 7, 2)])
def test_k11_copies_tiles_that_are_not_16_byte_aligned(card, n, mbw, mbh):
    """Tiles 4-byte but not 16-byte aligned: `planes_k11` refuses them
    (K11 bulk-copies its tiles), and the stage entries copy them first
    (`refstate._k11_tiles`), then give the plain version's planes."""
    tiles = _k11_tiles(card, n, mbw, mbh)
    want = refstate.prepare_reference_plain(*tiles, mbw, mbh)
    for by in (4, 8, 12):
        odd = tuple(_shifted(t, by) for t in tiles)
        assert all(t.data_ptr() % 16 == by for t in odd)
        with pytest.raises(ValueError, match="16-byte"):
            refplanes.planes_k11(*odd, mbw, mbh)
        got = refstate.prepare_reference(*odd, mbw, mbh)
        for k, v in want.items():
            assert torch.equal(got[k], v), (by, k)
        u_pad, v_pad = refstate.reference_chroma(*odd[1:], mbw, mbh)
        assert torch.equal(u_pad, want["u_pad"])
        assert torch.equal(v_pad, want["v_pad"])


@pytest.mark.parametrize("bw,bh", [(960, 544), (120, 90)])
def test_k10_copies_tiles_that_are_not_16_byte_aligned(card, bw, bh):
    """Base tiles 4-byte but not 16-byte aligned: `upsample_k10` refuses
    them (K10 bulk-copies its window of tiles), and the stage entry copies
    them first (`resample._k10_tiles`), then gives the plain version's
    outputs."""
    tiles, bmbw, crops, mbw, mbh = _k10_args(card, bw, bh)
    want = resample.upsample_tiles_plain(tiles, bmbw, crops, mbw, mbh)
    for by in (4, 8, 12):
        odd = tuple(_shifted(t, by) for t in tiles)
        assert all(t.data_ptr() % 16 == by for t in odd)
        with pytest.raises(ValueError, match="16-byte"):
            resample.upsample_k10(*odd, bmbw, crops, mbw, mbh)
        got = resample.upsample_tiles(odd, bmbw, crops, mbw, mbh)
        for k, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), (by, k)


def test_k10_takes_the_base_mode_idr_tiles_without_a_copy(card,
                                                          monkeypatch):
    """The `up` stage of a base-mode IDR hands K10 the base layer's
    deblocked tiles as they are: `resample._k10_tiles` returns each tile
    tensor itself, 16-byte aligned, and K10 launches once."""
    seen = []
    keep = resample._k10_tiles

    def no_copy(tiles):
        out = keep(tiles)
        seen.append((out is tiles, tiles.data_ptr() % 16))
        return out
    monkeypatch.setattr(resample, "_k10_tiles", no_copy)
    cfg = EncoderConfig(width=128, height=96, gop=10, qp=30, num_layers=2,
                        inter_layer_pred_flag=True)
    run = RunConfig(qp_min=30, qp_max=30, encode_speed=2)
    before = LAUNCH_COUNTS["resample_up"]
    SvcEncoder(cfg).encode(*next(iter(chessboard_sequence(128, 96, 1))),
                           run)
    assert LAUNCH_COUNTS["resample_up"] == before + 1
    assert seen == [(True, 0)] * 3


@pytest.mark.parametrize("lanes", [1, 16])
def test_k11_takes_the_gop_steps_tiles_without_a_copy(card, monkeypatch,
                                                      lanes):
    """The `ref` stage of an IDR and a P step of `lanes` GOP lanes hands
    K11 the deblocked tiles as they are: `refstate._k11_tiles` returns
    every tile tensor itself, 16-byte aligned, and K11 launches once a
    step."""
    seen = []
    keep = refstate._k11_tiles

    def no_copy(tiles):
        out = keep(tiles)
        seen.append((out is tiles, tiles.data_ptr() % 16))
        return out
    monkeypatch.setattr(refstate, "_k11_tiles", no_copy)
    cfg = EncoderConfig(width=64, height=48, gop=10, qp=33)
    run = RunConfig(qp_min=33, qp_max=33, encode_speed=2)
    frames = list(chessboard_sequence(64, 48, lanes + 1))
    enc = GopBandEncoder(cfg, n_gop=lanes)
    before = LAUNCH_COUNTS["refplanes"]
    for t in range(2):
        enc.encode_step(frames[t:t + lanes], run)
    assert LAUNCH_COUNTS["refplanes"] == before + 2
    assert seen == [(True, 0)] * 6


def test_k11_launches_on_the_current_stream(card):
    """On a side stream (as a mesh shard's or another thread's), K11 reads
    tiles written on that stream and its planes are ready when that stream
    is."""
    side = torch.cuda.Stream()
    tiles = _k11_tiles(card, 4, 120, 68)
    want = refstate.prepare_reference_plain(*tiles, 120, 68)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        fresh = tuple(torch.empty_like(t) for t in tiles)
        for f, t in zip(fresh, tiles):
            f.copy_(t)
        got = refstate.prepare_reference(*fresh, 120, 68)
    side.synchronize()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("h,w", [(1088, 1920), (544, 960), (48, 64)])
def test_k9_takes_planes_at_an_odd_address(card, h, w):
    """Planes that are views of a larger buffer at offset 1 (K9's
    byte-wise path; aligned, these take the 16-byte path) give
    `downsample2x` of each plane, and are not copied."""
    rng = np.random.default_rng(h * 7 + w)
    planes = [_shifted(torch.from_numpy(_border_plane(rng, *s)).to(card), 1)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    assert all(p.data_ptr() % 2 == 1 for p in planes)
    _launches_equal_plain(
        resample.downsample_k9,
        lambda *p: tuple(resample.downsample2x(x) for x in p), planes,
        "resample_down")


def test_k9_k10_k11_reject_bad_inputs(card):
    y, u, v = (torch.zeros(s, dtype=torch.uint8, device=card)
               for s in ((16, 32), (8, 16), (8, 16)))
    resample.downsample_k9(y, u, v)
    for i, bad, err in ((0, y.cpu(), ValueError),               # on the CPU
                        (1, u.int(), TypeError),                 # dtype
                        (2, v[None], ValueError),                # shape
                        (0, y.t(), ValueError)):                 # layout
        args = [y, u, v]
        args[i] = bad
        with pytest.raises(err):
            resample.downsample_k9(*args)
    tiles, bmbw, crops, mbw, mbh = _k10_args(card, 120, 90)
    resample.upsample_k10(*tiles, bmbw, crops, mbw, mbh)
    for i, bad, err in ((0, tiles[0].cpu(), ValueError),
                        (1, tiles[1].int(), TypeError),
                        (2, tiles[2][:, :4], ValueError),
                        (1, tiles[1][:-1].contiguous(), ValueError),
                        (0, tiles[0].transpose(1, 2), ValueError)):
        args = list(tiles)
        args[i] = bad
        with pytest.raises(err):
            resample.upsample_k10(*args, bmbw, crops, mbw, mbh)
    for b, c in ((7, crops), (bmbw, ((97, 120),) + crops[1:]),
                 (bmbw, ((90, 0),) + crops[1:])):
        with pytest.raises(ValueError):                  # sizes, crops
            resample.upsample_k10(*tiles, b, c, mbw, mbh)
    y, u, v = _k11_tiles(card, 2, 4, 3)
    refplanes.planes_k11(y, u, v, 4, 3)
    shifted = torch.empty(u.numel() + 1, dtype=torch.uint8,
                          device=card)[1:].view(u.shape)
    shifted.copy_(u)
    for i, bad, err in ((0, y.cpu(), ValueError),
                        (1, u.cpu(), ValueError),
                        (0, y.int(), TypeError),
                        (2, v[:1], ValueError),
                        (1, u.transpose(2, 3), ValueError),
                        (1, shifted, ValueError)):               # aligned 4
        args = [y, u, v]
        args[i] = bad
        with pytest.raises(err):
            refplanes.planes_k11(*args, 4, 3)
    with pytest.raises(ValueError):                      # nmb != 3 x 3
        refplanes.planes_k11(y, u, v, 3, 3)
    with pytest.raises(ValueError):
        refplanes.planes_k11(None, u.cpu(), v.cpu(), 4, 3)


def test_k9_k10_k11_serve_the_encode_paths(card, monkeypatch):
    """With the plain resampling and padding refused, the two-layer stream
    (inter-layer prediction, a base-mode IDR and a P frame), the GOP lanes
    and the sequential encoder encode on the card to the CPU's bytes: K9
    once per SVC frame, K10 once per base-mode IDR, K11 once per `ref`
    stage."""
    svc_cfg = EncoderConfig(width=128, height=96, gop=10, qp=30,
                            num_layers=2, inter_layer_pred_flag=True)
    cfg = EncoderConfig(width=64, height=48, gop=10, qp=30)
    run = RunConfig(qp_min=30, qp_max=30, encode_speed=2)
    big = list(chessboard_sequence(128, 96, 2))
    small = list(chessboard_sequence(64, 48, 3))
    cpu_svc = SvcEncoder(svc_cfg, device="cpu")
    want_svc = [cpu_svc.encode(*f, run).payload for f in big]
    cpu_gop = GopBandEncoder(cfg, n_gop=2, device="cpu")
    want_gop = [[a.payload for a in cpu_gop.encode_step(small[t:t + 2], run)]
                for t in range(2)]
    cpu_seq = H264Encoder(cfg, device="cpu")
    want_seq = [cpu_seq.encode(*f, run).payload for f in small[:2]]

    def refused(*args, **kwargs):
        raise AssertionError("a plain version on the card path")
    for mod, name in ((resample, "downsample2x"),
                      (resample, "upsample2x_luma"),
                      (resample, "upsample2x_chroma"),
                      (resample, "upsample_tiles_plain"),
                      (refstate, "prepare_reference_plain"),
                      (qpel, "pad_guard"), (me, "downsample4")):
        monkeypatch.setattr(mod, name, refused)
    before = dict(LAUNCH_COUNTS)
    on_card = SvcEncoder(svc_cfg)
    assert [on_card.encode(*f, run).payload for f in big] == want_svc
    got = {k: LAUNCH_COUNTS[k] - before[k]
           for k in ("resample_down", "resample_up", "refplanes")}
    # K11: the base layer's two frames, the enhancement's P frame and its
    # base-mode IDR
    assert got == {"resample_down": 2, "resample_up": 1, "refplanes": 4}
    before = dict(LAUNCH_COUNTS)
    gop = GopBandEncoder(cfg, n_gop=2)
    assert [[a.payload for a in gop.encode_step(small[t:t + 2], run)]
            for t in range(2)] == want_gop
    seq = H264Encoder(cfg)
    assert [seq.encode(*f, run).payload for f in small[:2]] == want_seq
    assert LAUNCH_COUNTS["refplanes"] == before["refplanes"] + 4


def test_k11_once_per_gop_row_on_the_mesh(card):
    """A (2, 2) mesh of cuda:0 entries, two bands: the exchange runs K11
    once per gop row and step (one device a row), on the calling thread's
    stream, and the lanes' bytes equal the unsharded card run's."""
    cfg = EncoderConfig(width=128, height=96, gop=10, qp=33, slice_bands=2)
    run = RunConfig(qp_min=33, qp_max=33, encode_speed=2)
    frames = list(chessboard_sequence(128, 96, 3))
    flat = GopBandEncoder(cfg, n_gop=2)
    want = [[a.payload for a in flat.encode_step(frames[t:t + 2], run)]
            for t in range(2)]
    mesh = GopBandEncoder(cfg, n_gop=2,
                          mesh=make_mesh(2, 2, ["cuda:0"] * 4))
    before = LAUNCH_COUNTS["refplanes"]
    got = [[a.payload for a in mesh.encode_step(frames[t:t + 2], run)]
           for t in range(2)]
    assert got == want
    assert LAUNCH_COUNTS["refplanes"] == before + 4


# ---------------------------------------------------------------------------
# K12 (the `pre` stage's padding and tiling) and K13 (the temporal denoise)
# ---------------------------------------------------------------------------

def _k12_planes(card, lanes, shapes, seed):
    rng = np.random.default_rng(seed)
    return tuple(tuple(torch.from_numpy(_border_plane(rng, *s)).to(card)
                       for _ in range(lanes)) for s in shapes)


def _k12_check(planes, mbw, mbh):
    _launches_equal_plain(
        lambda p: stages.source_tiles(p, mbw, mbh),
        lambda p: stages.source_tiles_plain(p, mbw, mbh), (planes,),
        "pad_tiles")


def test_k12_matches_plain_on_16_staged_lanes_of_1080p(card):
    frames = list(chessboard_sequence(1920, 1088, 16))
    staging = stages.Staging(card)
    planes = tuple(zip(*staging.upload(frames)))
    assert all(p.is_cuda for lanes in planes for p in lanes)
    _k12_check(planes, 120, 68)


@pytest.mark.parametrize("w,h,lanes", [(1920, 1080, 2), (1912, 1080, 1),
                                       (352, 288, 3), (70, 40, 2),
                                       (16, 16, 66)])
def test_k12_matches_plain_on_crops(card, w, h, lanes):
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    _k12_check(_k12_planes(card, lanes, shapes, w + h), -(-w // 16),
               -(-h // 16))


def test_k12_matches_plain_on_a_mesh_block(card):
    """The second block of two of a 1080-row frame: its rows are views of
    the card planes at a row offset, fewer than the block's MB rows."""
    planes = _k12_planes(card, 2, ((1080, 1920), (540, 960), (540, 960)),
                         11)
    block = tuple(tuple(p[34 * t:68 * t] for p in lanes)
                  for lanes, t in zip(planes, (16, 8, 8)))
    _k12_check(block, 120, 34)


def test_k12_takes_column_crops_and_odd_addresses(card):
    """Planes cut from wider card tensors (their pitch past their width)
    and planes at an odd address are read where they lie; planes whose
    rows are not contiguous are copied by the entry."""
    wide = _k12_planes(card, 2, ((50, 100), (25, 50), (25, 50)), 12)
    crops = tuple(tuple(p[:, 3:3 + p.shape[1] // 2 + 1] for p in lanes)
                  for lanes in wide)
    assert all(not p.is_contiguous() for lanes in crops for p in lanes)
    _k12_check(crops, 4, 4)
    odd = tuple(tuple(_shifted(p, 1) for p in lanes) for lanes in wide)
    assert all(p.data_ptr() % 2 == 1 for lanes in odd for p in lanes)
    _k12_check(odd, 7, 4)
    cols = tuple(tuple(p.t() for p in lanes) for lanes in wide)
    _k12_check(cols, 4, 7)


def test_k12_serves_the_encode_paths(card, monkeypatch):
    """With the plain padding refused, GOP steps, sequential frames, a
    two-layer stream and a (2, 2) mesh encode on the card to the CPU's
    bytes, K12 once per `pre`."""
    cfg = EncoderConfig(width=64, height=48, gop=10, qp=30)
    svc_cfg = EncoderConfig(width=128, height=96, gop=10, qp=30,
                            num_layers=2, inter_layer_pred_flag=True)
    mesh_cfg = EncoderConfig(width=128, height=96, gop=10, qp=33,
                             slice_bands=2)
    run = RunConfig(qp_min=30, qp_max=30, encode_speed=2)
    small = list(chessboard_sequence(64, 48, 3))
    big = list(chessboard_sequence(128, 96, 3))
    want_gop = [[a.payload for a in GopBandEncoder(cfg, n_gop=2,
                                                   device="cpu")
                 .encode_step(small[:2], run)]]
    cpu_seq = H264Encoder(cfg, device="cpu")
    want_seq = [cpu_seq.encode(*f, run).payload for f in small[:2]]
    cpu_svc = SvcEncoder(svc_cfg, device="cpu")
    want_svc = [cpu_svc.encode(*f, run).payload for f in big[:2]]
    cpu_mesh = GopBandEncoder(mesh_cfg, n_gop=2, device="cpu")
    want_mesh = [[a.payload for a in cpu_mesh.encode_step(big[t:t + 2], run)]
                 for t in range(2)]

    def refused(*args, **kwargs):
        raise AssertionError("a plain version on the card path")
    monkeypatch.setattr(stages, "pad_to", refused)
    monkeypatch.setattr(stages, "source_tiles_plain", refused)
    before = LAUNCH_COUNTS["pad_tiles"]
    got = [[a.payload for a in GopBandEncoder(cfg, n_gop=2)
            .encode_step(small[:2], run)]]
    assert got == want_gop and LAUNCH_COUNTS["pad_tiles"] == before + 1
    seq = H264Encoder(cfg)
    assert [seq.encode(*f, run).payload for f in small[:2]] == want_seq
    assert LAUNCH_COUNTS["pad_tiles"] == before + 3
    on_card = SvcEncoder(svc_cfg)
    assert [on_card.encode(*f, run).payload for f in big[:2]] == want_svc
    assert LAUNCH_COUNTS["pad_tiles"] == before + 7
    mesh = GopBandEncoder(mesh_cfg, n_gop=2,
                          mesh=make_mesh(2, 2, ["cuda:0"] * 4))
    assert [[a.payload for a in mesh.encode_step(big[t:t + 2], run)]
            for t in range(2)] == want_mesh
    assert LAUNCH_COUNTS["pad_tiles"] == before + 15


@pytest.mark.parametrize("mesh", [False, True])
def test_pipelined_loop_reuses_the_staging(card, mesh):
    """Step t + 1 dispatched before step t is finished, over five steps
    of differing frames (the two pinned staging buffers each reused):
    the lanes' bytes equal those of the same steps finished one by one."""
    cfg = EncoderConfig(width=352, height=288, gop=10, qp=33,
                        slice_bands=2)
    run = RunConfig(qp_min=33, qp_max=33, encode_speed=2)
    frames = list(noise_pan_sequence(352, 288, 7))

    def encoder():
        return GopBandEncoder(cfg, n_gop=2, mesh=make_mesh(
            2, 2, ["cuda:0"] * 4) if mesh else None)
    one = encoder()
    want = [[a.payload for a in one.encode_step(frames[t:t + 2], run)]
            for t in range(5)]
    enc = encoder()
    got = []
    pending = enc.encode_step_async(frames[0:2], run)
    for t in range(1, 5):
        nxt = enc.encode_step_async(frames[t:t + 2], run)
        got.append([a.payload for a in enc.finish_step(pending)])
        pending = nxt
    got.append([a.payload for a in enc.finish_step(pending)])
    assert got == want


def _k13_frame(card, h, w, spread=40):
    """Seeded (cur, prev) planes of a frame on the card, |cur - prev| up to
    `spread`."""
    rng = np.random.default_rng(h * 3 + w)
    shapes = ((h, w), (max(h // 2, 1), max(w // 2, 1)),
              (max(h // 2, 1), max(w // 2, 1)))
    prev = [rng.integers(0, 256, s, dtype=np.int64) for s in shapes]
    cur = [np.clip(p + rng.integers(-spread, spread + 1, p.shape), 0, 255)
           for p in prev]
    return (tuple(torch.from_numpy(c.astype(np.uint8)).to(card) for c in cur),
            tuple(torch.from_numpy(p.astype(np.uint8)).to(card)
                  for p in prev))


def _k13_plain(c, p):
    return tuple(denoise.denoise_plane(x, y) for x, y in zip(c, p))


@pytest.mark.parametrize("h,w", [(1088, 1920), (1080, 1920), (37, 51),
                                 (1, 1), (2, 3), (9, 130), (1079, 1917),
                                 (33, 1000), (1, 17)])
def test_k13_matches_plain_denoise(card, h, w):
    cur, prev = _k13_frame(card, h, w)
    _launches_equal_plain(
        denoise.denoise_planes,
        lambda c, p: tuple(denoise.denoise_plane(x, y)
                           for x, y in zip(c, p)), (cur, prev), "denoise")
    odd = tuple(_shifted(p, 1) for p in cur)
    _launches_equal_plain(
        lambda c, p: denoise.denoise_k13(*c, *p),
        lambda c, p: tuple(denoise.denoise_plane(x, y)
                           for x, y in zip(c, p)), (odd, prev), "denoise")


@pytest.mark.parametrize("by", [(1, 1), (8, 0), (0, 3), (5, 12)])
def test_k13_at_odd_addresses_of_1080p(card, by):
    """A 1080p frame whose cur and prev planes lie `by` bytes past 16-byte
    boundaries (the byte path of every strip they touch), with small
    differences, so that the activity sets most gains."""
    cur, prev = _k13_frame(card, 1088, 1920, spread=6)
    cur = tuple(_shifted(x, by[0]) for x in cur)
    prev = tuple(_shifted(x, by[1]) for x in prev)
    assert all(x.data_ptr() % 16 == by[0] for x in cur)
    _launches_equal_plain(lambda c, p: denoise.denoise_k13(*c, *p),
                          _k13_plain, (cur, prev), "denoise")


@pytest.mark.parametrize("speed", [0, 1])
def test_k13_serves_the_denoise_path(card, monkeypatch, speed):
    """H264Encoder with temporal_denoise_flag at speeds 0 and 1 encodes on
    the card to the CPU's bytes with `denoise_plane` refused: one K13
    launch a frame after the first."""
    cfg = EncoderConfig(width=96, height=64, gop=10, qp=30,
                        temporal_denoise_flag=True)
    run = RunConfig(qp_min=30, qp_max=30, encode_speed=speed)
    frames = list(noise_pan_sequence(96, 64, 4))
    cpu = H264Encoder(cfg, device="cpu")
    want = [cpu.encode(*f, run).payload for f in frames]

    def refused(*args, **kwargs):
        raise AssertionError("a plain version on the card path")
    monkeypatch.setattr(denoise, "denoise_plane", refused)
    monkeypatch.setattr(stages, "pad_to", refused)
    before = LAUNCH_COUNTS["denoise"]
    enc = H264Encoder(cfg)
    assert [enc.encode(*f, run).payload for f in frames] == want
    assert LAUNCH_COUNTS["denoise"] == before + len(frames) - 1


def test_k12_k13_reject_bad_inputs(card):
    planes = _k12_planes(card, 2, ((16, 32), (8, 16), (8, 16)), 3)
    pretile.tiles_k12(planes, 2, 1)
    y, u, v = planes
    for bad, err in (((tuple(p.cpu() for p in y), u, v), ValueError),
                     (((y[0].int(), y[1]), u, v), TypeError),
                     (((y[0], y[1][:8]), u, v), ValueError),   # shapes
                     ((y[:1], u, v), ValueError),              # lanes
                     (((y[0][None], y[1][None]), u, v), ValueError),
                     (((y[0].t(), y[1].t()), u, v), ValueError)):
        with pytest.raises(err):
            pretile.tiles_k12(bad, 2, 1)
    for mbw, mbh in ((0, 1), (2, -1)):
        with pytest.raises(ValueError):
            pretile.tiles_k12(planes, mbw, mbh)
    c = (y[0], u[0], v[0])
    denoise.denoise_k13(*c, *c)
    for i, bad, err in ((0, y[0].cpu(), ValueError),
                        (1, u[0].int(), TypeError),
                        (4, u[0][:4], ValueError),
                        (2, v[0].t(), ValueError)):
        args = list(c + c)
        args[i] = bad
        with pytest.raises(err):
            denoise.denoise_k13(*args)
