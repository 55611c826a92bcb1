"""The SVC base-mode IDR at 1080p, its stage times and seconds, in this tree
or in an earlier one, for comparisons in turns in one call.

    python tools/torch_svc_step.py [--tree DIR] [--frames N] [--out FILE]

SvcEncoder at 1920x1088 over 960x544 with inter-layer prediction,
chessboard input, QP 33, GOP 20, speed 2 (`chip_smoke.py`'s phase 11):
after an untimed IDR and a P frame, N forced FrameType.KEY frames, each a
base-mode IDR (the enhancement layer predicted from the upsampled base
layer), alternately with per-stage times (each stage between device
synchronizations; `base_mode` is the enhancement's TQ and CAVLC, `up`
and `down` the resampling, `ref` each layer's reference planes) and
without stage syncs (host wall time of `SvcEncoder.encode`). With the
tree's kernel launch counts (`cuda_build.LAUNCH_COUNTS`), the launches of
each timed frame, and the peak device memory of the run. Every frame's
bytes are hashed: two trees must print the same digest.

The package is imported from --tree (default: this tree), so an earlier
tree unpacked into a gitignored directory (`git archive <commit> | tar -x
-C _baseline/parent`) runs under the same script; run the trees in turns
in one call (parent, this, this, parent). Prints the card's name and
power limit, then one JSON line (also written to --out).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT, QP, GOP = 1920, 1088, 33, 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out")
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("torch_svc_step: no CUDA device", file=sys.stderr)
        return 2
    from h264lab_tpu_torch.config import EncoderConfig, FrameType, RunConfig
    from h264lab_tpu_torch.models.svc import SvcEncoder
    from h264lab_tpu_torch.ops import cuda_build
    from h264lab_tpu_torch.utils.synthetic import chessboard_sequence

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    cuda_build.build_all(sorted(cuda_build.CSRC.glob("*.cu")))
    cfg = EncoderConfig(width=WIDTH, height=HEIGHT, gop=GOP, qp=QP,
                        num_layers=2, inter_layer_pred_flag=True)
    run = RunConfig(qp_min=QP, qp_max=QP, encode_speed=2)
    key = dataclasses.replace(run, frame_type=FrameType.KEY)
    frames = list(chessboard_sequence(WIDTH, HEIGHT, 2 + opts.frames))
    torch.cuda.reset_peak_memory_stats()
    enc = SvcEncoder(cfg)
    digest = hashlib.sha256()
    for t in range(2):                          # first use: IDR, P
        digest.update(enc.encode(*frames[t], run).payload)
    staged, timed, launches = [], [], []
    for t in range(2, 2 + opts.frames):
        with_stages = t % 2 == 0
        enc.stage_times = {} if with_stages else None
        before = dict(cuda_build.LAUNCH_COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = enc.encode(*frames[t], key)
        s = time.perf_counter() - t0
        if res.frame_type != "IDR":
            print(f"torch_svc_step: frame {t} is {res.frame_type}",
                  file=sys.stderr)
            return 1
        digest.update(res.payload)
        launches.append({k: v - before[k]
                         for k, v in cuda_build.LAUNCH_COUNTS.items()
                         if v != before[k]})
        if with_stages:
            times = enc.stage_times
            staged.append(dict(
                s=s, base_mode_ms=1e3 * times["enh"]["base_mode"],
                up_ms=1e3 * times["svc"]["up"],
                down_ms=1e3 * times["svc"]["down"],
                ref_ms={layer: 1e3 * times[layer]["ref"]
                        for layer in ("base", "enh")},
                stages={layer: {k: 1e3 * v for k, v in st.items()}
                        for layer, st in times.items()}))
        else:
            timed.append(s)
    enc.stage_times = None
    result = dict(card=card, tree=tree, frames=opts.frames, staged=staged,
                  timed_s=timed, launches=launches,
                  base_mode_ms=[x["base_mode_ms"] for x in staged],
                  staged_s=[x["s"] for x in staged],
                  peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  bytes_sha256=digest.hexdigest())
    print(f"SVC base-mode IDR at {WIDTH}x{HEIGHT} [{card}], tree {tree}: "
          "with stage syncs " + ", ".join(
              f"{x['s']:.4f} s (base_mode {x['base_mode_ms']:.2f}, up "
              f"{x['up_ms']:.2f}, down {x['down_ms']:.2f}, ref base "
              f"{x['ref_ms']['base']:.2f}, enhancement "
              f"{x['ref_ms']['enh']:.2f} ms)"
              for x in staged)
          + "; without: " + ", ".join(f"{x:.4f}" for x in timed)
          + f" s (median {statistics.median(timed or [0]):.4f}); launches "
          f"a frame {launches[0]}; peak device memory "
          f"{result['peak_gib']:.2f} GiB; bytes sha256 "
          f"{digest.hexdigest()[:16]}")
    line = json.dumps(result)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
