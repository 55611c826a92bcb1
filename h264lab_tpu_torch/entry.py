"""Entry points of the port: the counterparts of the JAX package's
`__graft_entry__.entry` and `__graft_entry__.dryrun_multichip`.

    fn, args = entry()            # on the CUDA card; entry("cpu") on the CPU
    out = fn(*args)
    dryrun_multichip(8)           # over 8 cards; devices=["cuda:0"] * 8
                                  # on one card, ["cpu"] * 8 on the CPU

`fn` is the wavefront intra frame encode (`mbscan.encode_intra_core`:
Intra_16x16, Intra_4x4 and chroma mode selection over the slope-2
wavefront, then CAVLC symbolization; no deblocking) at 128x96, and `args`
are the JAX entry point's example arguments, made the same way from
`np.random.default_rng(0)`, as tensors on the device. Without a card,
`entry()` and `dryrun_multichip(n)` raise; they never fall back to the
CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.decoder.decoder import H264Decoder
from h264lab_tpu_torch.models import mbscan, wavefront
from h264lab_tpu_torch.parallel.gop import GopBandEncoder, make_mesh
from h264lab_tpu_torch.utils.device import resolve_device
from h264lab_tpu_torch.utils.synthetic import chessboard_sequence


def entry(device=None):
    """Returns (fn, example_args) on `device` (the card when None)."""
    dev = resolve_device(device)
    mb_w, mb_h = 8, 6  # 128x96
    plan = wavefront.make_plan(mb_w, mb_h, slope=2)
    nmb = mb_w * mb_h
    rng = np.random.default_rng(0)
    r = np.arange(nmb) // mb_w
    c = np.arange(nmb) % mb_w

    def on(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    fn = functools.partial(mbscan.encode_intra_core,
                           mb_width=mb_w, mb_height=mb_h)
    example_args = (
        on(rng.integers(0, 256, (nmb, 16, 16), dtype=np.uint8)),
        on(rng.integers(0, 256, (nmb, 8, 8), dtype=np.uint8)),
        on(rng.integers(0, 256, (nmb, 8, 8), dtype=np.uint8)),
        on(30, torch.int32),
        on(30, torch.int32),
        on(plan.steps),
        on(r > 0),
        on(c > 0),
    )
    return fn, example_args


def dryrun_multichip(n_devices: int, devices=None) -> list:
    """Encode a short IPPP GOP over an n_devices ("gop", "band") mesh: an
    even count is (n/2, 2) with two slice bands, an odd one (n, 1); the
    frame is 64 x (32 * n_band), GOP 3, QP 30, speed 2, the chessboard on
    every lane. The whole step runs sharded (motion search, wavefront,
    deblocking, CAVLC, K1, the reference exchange). Lane 0's stream must
    decode (the port's decoder) bit-exactly to its reconstruction, and
    every lane's stream must equal lane 0's. `devices` as in `make_mesh`
    (None: the cards). Returns the lanes' streams."""
    if n_devices % 2 == 0:
        n_gop, n_band = n_devices // 2, 2
    else:
        n_gop, n_band = n_devices, 1
    mesh = make_mesh(n_gop, n_band, devices)

    w, h = 64, 32 * n_band          # 2 MB rows per band
    cfg = EncoderConfig(width=w, height=h, gop=3, qp=30, slice_bands=n_band)
    enc = GopBandEncoder(cfg, n_gop=n_gop, mesh=mesh)
    run = RunConfig(qp_min=30, qp_max=30, encode_speed=2)

    frames = list(chessboard_sequence(w, h, 3))
    streams = [b""] * n_gop
    recons = []
    for f in frames:
        results = enc.encode_step([f] * n_gop, run, return_recon=True)
        streams = [s + r.payload for s, r in zip(streams, results)]
        recons.append(results[0].recon)

    dec = H264Decoder()
    dec_frames = dec.decode(streams[0])
    if len(dec_frames) != len(frames):
        raise AssertionError(f"{len(dec_frames)} frames decoded, not "
                             f"{len(frames)}")
    for t, df in enumerate(dec_frames):
        for plane_dec, plane_enc in zip(df.cropped(dec.sps), recons[t]):
            if not np.array_equal(plane_dec, plane_enc):
                raise AssertionError(f"frame {t}: decoder/encoder recon "
                                     "mismatch")
    # identical lanes (same input, same config) must give byte-identical
    # independent streams
    if any(s != streams[0] for s in streams[1:]):
        raise AssertionError("identical lanes diverged")
    return streams
