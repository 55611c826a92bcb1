"""Command-line encoder driver — parity with the reference test app
(`src/minih264e_test.c:469-687`): YUV input or synthetic generation, QP or
bitrate mode, PSNR/stats reporting, Annex-B output.

PyTorch counterpart of `h264lab_tpu/cli.py`, with the same flags and
defaults and the same output bytes, plus `--device`: the encoder runs on
the CUDA card unless it names another torch device (`--device cpu`).

    python -m h264lab_tpu_torch.cli --input in_cif.yuv --output out.264
    python -m h264lab_tpu_torch.cli --gen --maxframes 60 --output gen.264 \
        --psnr
"""

from __future__ import annotations

import argparse
import sys
import time

from h264lab_tpu_torch.config import EncoderConfig, FrameType, RunConfig
from h264lab_tpu_torch.models.encoder import H264Encoder
from h264lab_tpu_torch.utils.metrics import PsnrAccumulator
from h264lab_tpu_torch.utils.synthetic import chessboard_sequence
from h264lab_tpu_torch.utils.yuv import YuvReader, guess_size_from_name

DEFAULT_GOP = 20
DEFAULT_QP = 33
DEFAULT_MAX_FRAMES = 99999


def build_parser():
    p = argparse.ArgumentParser(
        prog="h264lab_tpu_torch",
        description="H.264 baseline encoder (PyTorch, CUDA)")
    p.add_argument("--input", "-i", help="input YUV 4:2:0 file")
    p.add_argument("--output", "-o", default="out.264", help="output .264")
    p.add_argument("--gen", action="store_true",
                   help="generate synthetic input (rotating chessboard)")
    p.add_argument("--size", help="frame size WxH (default: guess from name)")
    p.add_argument("--gop", type=int, default=DEFAULT_GOP)
    p.add_argument("--qp", type=int, default=DEFAULT_QP)
    p.add_argument("--kbps", type=int, default=0,
                   help="bitrate mode (fps=30 assumed)")
    p.add_argument("--maxframes", type=int, default=DEFAULT_MAX_FRAMES)
    p.add_argument("--speed", type=int, default=0)
    p.add_argument("--denoise", action="store_true")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--psnr", action="store_true")
    p.add_argument("--threads", type=int, default=1,
                   help="slice bands per frame (encoded as one batch)")
    p.add_argument("--temporal-layers", type=int, default=0, metavar="L",
                   help="dyadic temporal scalability over a 2^L-frame "
                        "period via long-term references (the reference "
                        "driver's schedule, src/minih264e_test.c:606-638); "
                        "top-layer frames are droppable")
    p.add_argument("--device", default=None,
                   help="torch device to encode on (default: the CUDA card; "
                        "'cpu' runs on the CPU)")
    return p


class DyadicSchedule:
    """The reference driver's dyadic temporal-scalability schedule
    (`src/minih264e_test.c:606-638`), generalized over logmod L:
    frame i belongs to the highest layer `level` whose period bit is set;
    lower layers anchor in long-term slots, the top layer is droppable.

    Returns per frame: (frame_type, long_term_idx_use,
    long_term_idx_update)."""

    def __init__(self, logmod: int):
        self.logmod = logmod
        self.mod = 1 << logmod
        self.fresh = [-1] * (logmod + 2)

    def step(self, i: int):
        logmod = self.logmod
        level = logmod
        while level and (~i & (self.mod >> level)):
            level -= 1
        lt_update = level + 1
        if level == logmod and logmod > 0:
            lt_update = -1                    # top layer: droppable
        if level == logmod - 1 and logmod > 1:
            lt_update = 0                     # next layer: short-term only
        lt_use = self.fresh[level]
        for j in range(level, logmod + 1):
            self.fresh[j] = lt_update
        if i == 0:
            lt_use = -1                       # first frame: IDR
        return FrameType.CUSTOM, lt_use, lt_update


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.input and not args.gen:
        build_parser().print_help()
        return 1

    if args.gen:
        w, h = (1024, 768)
        if args.size:
            w, h = map(int, args.size.lower().split("x"))
        frames = chessboard_sequence(w, h, min(args.maxframes, 300))
    else:
        if args.size:
            w, h = map(int, args.size.lower().split("x"))
        else:
            w, h = guess_size_from_name(args.input)
        frames = iter(YuvReader(args.input, w, h))

    cfg = EncoderConfig(
        width=w, height=h, gop=args.gop, qp=min(max(args.qp, 10), 51),
        vbv_size_bytes=100000 // 8 if args.kbps else 0,
        temporal_denoise_flag=args.denoise,
        slice_bands=max(args.threads, 1),
        max_long_term_reference_frames=(
            max(1, args.temporal_layers) if args.temporal_layers else 0),
    )
    enc = H264Encoder(cfg, device=args.device)
    acc = PsnrAccumulator() if args.psnr else None

    out = open(args.output, "wb")
    n = 0
    t0 = time.time()
    schedule = (DyadicSchedule(args.temporal_layers)
                if args.temporal_layers else None)
    for (y, u, v) in frames:
        if n >= args.maxframes:
            break
        run = RunConfig(encode_speed=args.speed)
        if args.kbps:
            run.desired_frame_bytes = args.kbps * 1000 // 8 // 30
            run.qp_min, run.qp_max = 10, 50
        else:
            run.qp_min = run.qp_max = cfg.qp
        if schedule is not None:
            (run.frame_type, run.long_term_idx_use,
             run.long_term_idx_update) = schedule.step(n)
        res = enc.encode(y, u, v, run, return_recon=args.psnr)
        out.write(res.payload)
        if args.stats:
            print(f"frame={n}, bytes={len(res.payload)}, type={res.frame_type},"
                  f" qp={res.qp}")
        if acc is not None:
            acc.add((y, u, v), res.recon, len(res.payload))
        n += 1
    out.close()
    dt = time.time() - t0
    print(f"encoded {n} frames in {dt:.2f}s ({n / max(dt, 1e-9):.2f} fps)")
    if acc is not None and n:
        print(acc.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
