"""The port's ("gop", "band") device mesh against the JAX package's mesh.

JAX's meshes run over the 8 virtual CPU devices of `tests/conftest.py`
(`make_mesh` of `h264lab_tpu.parallel.gop`), the port's over
`["cpu"] * n` (`h264lab_tpu_torch.parallel.gop.make_mesh`), on the same
seeded inputs and configurations. The encoder is integer arithmetic, so
the tolerance is equal bytes:
- GopBandEncoder on a (2, 2) mesh at 64x64 with two slice bands, lanes
  on different frames, at speeds 2 and 0 (partitions, Intra_4x4 in P
  through the wavefront); with fine (per-band) rate control and VBV
  stuffing; on a (2, 1) mesh with a VBV that turns some lanes' P frames
  into transparent all-skip frames. Every lane's bytes equal JAX's mesh
  and the port's unsharded encoder, and every lane decodes (the port's
  decoder) bit-exactly to its reconstruction; on a (1, 2) mesh whose
  shards hold two bands each, at speed 0, the bytes equal the port's
  unsharded encoder (which the cases above hold to JAX);
- `entry.dryrun_multichip` at 8 and 3 devices: its streams equal the JAX
  dryrun's encode on a JAX mesh of the same shape;
- `encode_stream(mesh=)` equals JAX's, and a last group of lanes that the
  mesh does not divide raises `ValueError` in both;
- `ShardedIntraEncoder.encode_batch` equals JAX's, output for output;
- the port raises `ValueError` where JAX refuses a mesh (too few devices,
  lanes or bands the mesh does not divide) and `TypeError` for a mesh
  that is none.
"""

import numpy as np
import pytest
import torch

import h264lab_tpu.config as jcfg
from h264lab_tpu.parallel import gop as jgop
from h264lab_tpu.parallel import sharding as jsh
from h264lab_tpu.utils.synthetic import chessboard_sequence, noise_pan_sequence
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.decoder.decoder import H264Decoder
from h264lab_tpu_torch.entry import dryrun_multichip
from h264lab_tpu_torch.parallel import gop as tgop
from h264lab_tpu_torch.parallel import sharding as tsh


def _cpus(n):
    return ["cpu"] * n


def _walk(w, h, n_gop, steps):
    """Lane g on chessboard frames g, g+1, ...: per step, the lanes'
    frames."""
    frames = list(chessboard_sequence(w, h, steps + n_gop - 1))
    return [[frames[g + t] for g in range(n_gop)] for t in range(steps)]


def _chess_and_noise(w, h, n_gop, steps):
    """Lane 0 on the chessboard, lane 1 on panning noise."""
    chess = list(chessboard_sequence(w, h, steps))
    noise = list(noise_pan_sequence(w, h, steps))
    return [[chess[t], noise[t]] for t in range(steps)]


# name: (width, height, slice bands, mesh shape, lanes, steps, lane
# inputs, EncoderConfig fields, RunConfig fields)
CASES = {
    "2x2_speed2": (64, 64, 2, (2, 2), 2, 3, _walk, dict(gop=3, qp=30),
                   dict(qp_min=30, qp_max=30, encode_speed=2)),
    "2x2_speed0": (64, 64, 2, (2, 2), 2, 3, _walk, dict(gop=3, qp=30),
                   dict(qp_min=30, qp_max=30, encode_speed=0)),
    "2x2_fine_rc": (64, 64, 2, (2, 2), 2, 3, _walk,
                    dict(gop=3, qp=33, fine_rate_control_flag=True,
                         vbv_size_bytes=3000,
                         vbv_underflow_stuffing_flag=True),
                    dict(desired_frame_bytes=400, qp_min=20, qp_max=40,
                         encode_speed=2)),
    "2x1_vbv_transparent": (64, 48, 1, (2, 1), 2, 4, _chess_and_noise,
                            dict(gop=0, qp=20, vbv_size_bytes=400,
                                 vbv_overflow_empty_frame_flag=True),
                            dict(desired_frame_bytes=100, qp_min=20,
                                 qp_max=24, encode_speed=5)),
}


def _encode(enc, steps, run, return_recon=False):
    """Per step, the lanes' FrameResults."""
    return [enc.encode_step(lanes, run, return_recon) for lanes in steps]


def _decode_equals_recon(stream, recons):
    dec = H264Decoder()
    frames = dec.decode(stream)
    assert len(frames) == len(recons)
    for t, df in enumerate(frames):
        for got, want in zip(df.cropped(dec.sps), recons[t]):
            np.testing.assert_array_equal(got, want, err_msg=f"frame {t}")


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_lanes_equal_jax_mesh_and_decode(case):
    w, h, bands, shape, n_gop, steps, lanes_of, cfg_kw, run_kw = CASES[case]
    kw = dict(width=w, height=h, slice_bands=bands, **cfg_kw)
    jenc = jgop.GopBandEncoder(jcfg.EncoderConfig(**kw), n_gop=n_gop,
                               mesh=jgop.make_mesh(*shape))
    tenc = tgop.GopBandEncoder(EncoderConfig(**kw), n_gop=n_gop,
                               mesh=tgop.make_mesh(*shape, _cpus(8)))
    flat = tgop.GopBandEncoder(EncoderConfig(**kw), n_gop=n_gop,
                               device="cpu")
    jrun, trun = jcfg.RunConfig(**run_kw), RunConfig(**run_kw)
    steps = lanes_of(w, h, n_gop, steps)
    want = _encode(jenc, steps, jrun)
    got = _encode(tenc, steps, trun, return_recon=True)
    unsharded = _encode(flat, steps, trun)
    for t in range(len(steps)):
        for g in range(n_gop):
            assert got[t][g].payload == want[t][g].payload, (t, g)
            assert got[t][g].payload == unsharded[t][g].payload, (t, g)
            assert (got[t][g].frame_type, got[t][g].qp) == \
                (want[t][g].frame_type, want[t][g].qp)
    streams = [b"".join(r[g].payload for r in got) for g in range(n_gop)]
    recons = [[r[g].recon for r in got] for g in range(n_gop)]
    sizes = [[len(x.payload) for x in r] for r in got]
    qps = {x.qp for r in got for x in r}
    for g in range(n_gop):
        _decode_equals_recon(streams[g], recons[g])
    if case == "2x2_fine_rc":
        assert len(qps) > 1                       # the QPs moved
    if case == "2x1_vbv_transparent":
        # some lane's P frame was an all-skip slice, and not every lane's
        p_sizes = np.asarray(sizes[1:])
        assert (p_sizes < 30).any() and (p_sizes >= 30).any(), sizes


def test_shards_of_two_bands_equal_unsharded():
    """A (1, 2) mesh over four bands: each shard encodes two bands, the
    second shard's from band 2 on, at speed 0 (the P wavefront with
    Intra_4x4, partitions)."""
    cfg = EncoderConfig(width=64, height=64, gop=3, qp=28, slice_bands=4)
    run = RunConfig(qp_min=28, qp_max=28, encode_speed=0)
    steps = _walk(64, 64, 1, 3)
    got = _encode(tgop.GopBandEncoder(cfg, n_gop=1, mesh=tgop.make_mesh(
        1, 2, _cpus(2))), steps, run, return_recon=True)
    want = _encode(tgop.GopBandEncoder(cfg, n_gop=1, device="cpu"), steps,
                   run)
    assert [r[0].payload for r in got] == [r[0].payload for r in want]
    assert [r[0].frame_type for r in got] == ["IDR", "P", "P"]
    _decode_equals_recon(b"".join(r[0].payload for r in got),
                         [r[0].recon for r in got])


@pytest.mark.parametrize("n_devices", [8, 3])
def test_dryrun_multichip_equals_jax_mesh(n_devices):
    got = dryrun_multichip(n_devices, devices=_cpus(n_devices))
    # the JAX dryrun's encode (`__graft_entry__.dryrun_multichip`)
    n_gop, n_band = ((n_devices // 2, 2) if n_devices % 2 == 0
                     else (n_devices, 1))
    w, h = 64, 32 * n_band
    jenc = jgop.GopBandEncoder(
        jcfg.EncoderConfig(width=w, height=h, gop=3, qp=30,
                           slice_bands=n_band),
        n_gop=n_gop, mesh=jgop.make_mesh(n_gop, n_band))
    run = jcfg.RunConfig(qp_min=30, qp_max=30, encode_speed=2)
    want = [b""] * n_gop
    for f in chessboard_sequence(w, h, 3):
        want = [s + r.payload
                for s, r in zip(want, jenc.encode_step([f] * n_gop, run))]
    assert len(got) == n_gop
    assert got == want


def test_encode_stream_mesh_equals_jax():
    w, h = 64, 64
    kw = dict(width=w, height=h, gop=3, qp=30, slice_bands=2)
    run_kw = dict(qp_min=30, qp_max=30, encode_speed=2)
    jcf, tcf = jcfg.EncoderConfig(**kw), EncoderConfig(**kw)
    jrun, trun = jcfg.RunConfig(**run_kw), RunConfig(**run_kw)
    frames = list(chessboard_sequence(w, h, 6))           # two GOPs
    got = tgop.encode_stream(frames, tcf, n_gop=2, run=trun,
                             mesh=tgop.make_mesh(2, 2, _cpus(4)))
    assert got == jgop.encode_stream(frames, jcf, n_gop=2, run=jrun,
                                     mesh=jgop.make_mesh(2, 2))
    assert got == tgop.encode_stream(frames, tcf, n_gop=2, run=trun,
                                     device="cpu")
    # three GOPs: the last group holds one lane, which a 2-row mesh
    # cannot split (JAX's device_put refuses it)
    frames = list(chessboard_sequence(w, h, 7))
    with pytest.raises(ValueError):
        jgop.encode_stream(frames, jcf, n_gop=2, run=jrun,
                           mesh=jgop.make_mesh(2, 2))
    with pytest.raises(ValueError):
        tgop.encode_stream(frames, tcf, n_gop=2, run=trun,
                           mesh=tgop.make_mesh(2, 2, _cpus(4)))


def test_sharded_intra_encoder_equals_jax():
    """(2, 4) frames x bands of 4x2 MBs over a 2x2 mesh: two bands per
    shard."""
    rng = np.random.default_rng(11)
    ty = rng.integers(0, 256, (2, 4, 8, 16, 16), dtype=np.uint8)
    tu = rng.integers(0, 256, (2, 4, 8, 8, 8), dtype=np.uint8)
    tv = rng.integers(0, 256, (2, 4, 8, 8, 8), dtype=np.uint8)
    want = jsh.ShardedIntraEncoder(jsh.make_mesh(2, 2), 4, 2).encode_batch(
        ty, tu, tv, 30, 29)
    got = tsh.ShardedIntraEncoder(tsh.make_mesh(2, 2, _cpus(4)), 4,
                                  2).encode_batch(ty, tu, tv, 30, 29)
    assert set(got) == set(want)
    for key, val in want.items():
        a = np.asarray(val).astype(np.int64)
        b = got[key].numpy().astype(np.int64)
        if np.asarray(val).dtype == np.uint32:
            b &= 0xFFFFFFFF
        assert b.shape == a.shape, key
        np.testing.assert_array_equal(b, a, err_msg=key)
    assert int(got["total_bits"].sum()) > 0


@pytest.mark.parametrize("shape,n_gop,bands", [
    ((2, 2), 2, 1),          # bands the mesh's band axis does not divide
    ((2, 1), 3, 1),          # lanes the gop axis does not divide
    ((2, 2), 1, 2),
])
def test_mesh_the_jax_mesh_refuses_raises(shape, n_gop, bands):
    kw = dict(width=64, height=64, gop=3, qp=30, slice_bands=bands)
    frame = next(chessboard_sequence(64, 64, 1))
    jenc = jgop.GopBandEncoder(jcfg.EncoderConfig(**kw), n_gop=n_gop,
                               mesh=jgop.make_mesh(*shape))
    with pytest.raises(ValueError):
        jenc.encode_step([frame] * n_gop, jcfg.RunConfig(
            qp_min=30, qp_max=30, encode_speed=2))
    with pytest.raises(ValueError):
        tgop.GopBandEncoder(EncoderConfig(**kw), n_gop=n_gop,
                            mesh=tgop.make_mesh(*shape, _cpus(8)))


def test_mesh_devices_and_refusals(monkeypatch):
    jmesh, tmesh = jgop.make_mesh(4, 2), tgop.make_mesh(4, 2, _cpus(8))
    assert tmesh.shape == dict(jmesh.shape) == {"gop": 4, "band": 2}
    assert tuple(tmesh.axis_names) == tuple(jmesh.axis_names)
    assert tmesh.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in tmesh.devices.flat)
    with pytest.raises(AssertionError):       # JAX asserts, the port raises
        jgop.make_mesh(3, 3)
    with pytest.raises(ValueError):
        tgop.make_mesh(3, 3, _cpus(8))
    assert tsh.make_mesh is tgop.make_mesh
    # a batch the mesh does not divide
    tiles = np.zeros((1, 2, 8, 16, 16), np.uint8)
    ctiles = np.zeros((1, 2, 8, 8, 8), np.uint8)
    with pytest.raises(ValueError):
        jsh.ShardedIntraEncoder(jsh.make_mesh(2, 2), 4, 2).encode_batch(
            tiles, ctiles, ctiles, 30, 29)
    with pytest.raises(ValueError):
        tsh.ShardedIntraEncoder(tmesh, 4, 2).encode_batch(
            tiles, ctiles, ctiles, 30, 29)
    cfg = EncoderConfig(width=64, height=64, slice_bands=2)
    with pytest.raises(TypeError):
        tsh.ShardedIntraEncoder(object(), 4, 2)
    with pytest.raises(ValueError):           # a mesh names its devices
        tgop.GopBandEncoder(cfg, n_gop=4, mesh=tmesh, device="cpu")
    # no devices given means the cards, and no card is an error
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError):
        tgop.make_mesh(1, 1)
    with pytest.raises(ValueError):
        dryrun_multichip(3)
