"""The (2, 2) mesh's steps at 1080p, timed without stage syncs, in this
tree or in an earlier one, for comparisons in turns in one call.

    python tools/torch_mesh_step.py [--tree DIR] [--steps N] [--out FILE]
                                    [--free-threads]

GopBandEncoder at 1920x1088 with two slice bands over a (2, 2) mesh, two
lanes (lane g on chessboard frames g, g+1, ...), QP 33, speed 2: the mesh
of `chip_smoke.py`'s phase 15, on four distinct cards where four are
visible, else on 4 x cuda:0. After an untimed IDR and P step it times N P
steps one by one (host wall time from `encode_step_async` to the
finished bytes, no stage syncs), a forced IDR step, and N P steps of the
pipelined loop (`encode_step_async` of step t + 1 before `finish_step(t)`)
as a whole. The unsharded encoder (both lanes and bands on the first card)
runs the same steps, each beside the mesh's, and every mesh step's bytes
must equal its bytes. Where the tree's encoder keeps them
(`GopBandEncoder.workers.intervals`), each shard's host interval of issue
is printed for every mesh step. `--free-threads` drops the shards' issue
lock (`ShardWorkers.issue_lock`), so that the four workers issue their
stages at the same time and hand the interpreter lock over at every
operation: the measure of what the issue lock saves.

The package is imported from --tree (default: this tree), so an earlier
tree unpacked into a gitignored directory (`git archive <commit> | tar -x
-C _baseline/parent`) runs under the same script; run the trees in turns
in one call (parent, this, this, parent, ...). Prints the card's name and
power limit, then one JSON line (also written to --out).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT, QP, GOP = 1920, 1088, 33, 20
MESH = (2, 2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out")
    ap.add_argument("--free-threads", action="store_true")
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_step: no CUDA device", file=sys.stderr)
        return 2
    from h264lab_tpu_torch.config import EncoderConfig, FrameType, RunConfig
    from h264lab_tpu_torch.ops import cuda_build
    from h264lab_tpu_torch.parallel.gop import GopBandEncoder, make_mesh
    from h264lab_tpu_torch.utils.synthetic import chessboard_sequence

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    n_gop, n_band = MESH
    n = n_gop * n_band
    distinct = torch.cuda.device_count() >= n
    devices = None if distinct else ["cuda:0"] * n
    cuda_build.build_all(sorted(cuda_build.CSRC.glob("*.cu")))
    cfg = EncoderConfig(width=WIDTH, height=HEIGHT, gop=GOP, qp=QP,
                        slice_bands=n_band)
    run = RunConfig(qp_min=QP, qp_max=QP, encode_speed=2)
    key = dataclasses.replace(run, frame_type=FrameType.KEY)
    n_steps = 3 + 2 * opts.steps
    frames = list(chessboard_sequence(WIDTH, HEIGHT, n_steps + n_gop - 1))
    lanes = [[frames[g + t] for g in range(n_gop)] for t in range(n_steps)]
    mesh = GopBandEncoder(cfg, n_gop=n_gop,
                          mesh=make_mesh(n_gop, n_band, devices))
    if opts.free_threads:
        for sh in mesh.shards:
            sh.stages.issue_lock = None
    flat = GopBandEncoder(cfg, n_gop=n_gop)
    encs = dict(mesh=mesh, flat=flat)
    got = {name: [] for name in encs}
    times = {name: dict(P=[], IDR=[]) for name in encs}
    intervals = []

    def step(name, t, r):
        t0 = time.perf_counter()
        res = encs[name].finish_step(encs[name].encode_step_async(lanes[t],
                                                                  r))
        s = time.perf_counter() - t0
        got[name].append(res)
        if name == "mesh" and getattr(mesh, "workers", None) is not None:
            intervals.append([list(iv) for iv in mesh.workers.intervals])
        return s

    # untimed first use, then N P steps and a forced IDR step, each in
    # turns with the unsharded step
    plan = [(run, None)] * 2 + [(run, "P")] * opts.steps + [(key, "IDR")]
    for t, (r, kind) in enumerate(plan):
        for name in encs:
            s = step(name, t, r)
            if kind is not None:
                times[name][kind].append(s)
    # the pipelined loop
    t_first = len(plan)
    pipelined = {}
    for name, enc in encs.items():
        t0 = time.perf_counter()
        pending = enc.encode_step_async(lanes[t_first], run)
        for t in range(t_first + 1, t_first + opts.steps):
            nxt = enc.encode_step_async(lanes[t], run)
            got[name].append(enc.finish_step(pending))
            pending = nxt
        got[name].append(enc.finish_step(pending))
        pipelined[name] = (time.perf_counter() - t0) / opts.steps
    for t, (a, b) in enumerate(zip(got["mesh"], got["flat"])):
        if [x.payload for x in a] != [x.payload for x in b]:
            print(f"torch_mesh_step: mesh step {t} differs from the "
                  "unsharded step", file=sys.stderr)
            return 1
    what = (f"{n} distinct cards" if distinct else f"a virtual mesh, {n} x "
            "cuda:0")
    result = dict(
        card=card, tree=tree, mesh=what, steps=opts.steps,
        free_threads=opts.free_threads,
        p_s=times["mesh"]["P"], p_median_s=statistics.median(
            times["mesh"]["P"]), idr_s=times["mesh"]["IDR"],
        pipelined_p_s=pipelined["mesh"],
        flat_p_s=times["flat"]["P"], flat_p_median_s=statistics.median(
            times["flat"]["P"]), flat_idr_s=times["flat"]["IDR"],
        flat_pipelined_p_s=pipelined["flat"], intervals=intervals)
    print(f"mesh {n_gop}x{n_band} on {what} [{card}], tree {tree}"
          f"{', free threads' if opts.free_threads else ''}: P steps "
          f"without stage syncs {', '.join(f'{s:.3f}' for s in result['p_s'])}"
          f" s (median {result['p_median_s']:.3f}), forced IDR "
          f"{result['idr_s'][0]:.3f} s, pipelined P {pipelined['mesh']:.3f} "
          f"s a step; unsharded P {result['flat_p_median_s']:.3f}, IDR "
          f"{result['flat_idr_s'][0]:.3f}, pipelined "
          f"{pipelined['flat']:.3f} s; every mesh step's bytes == the "
          "unsharded step's")
    line = json.dumps(result)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
