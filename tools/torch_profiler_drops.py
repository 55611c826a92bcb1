"""How often a `torch.profiler` trace of one call of a hand kernel's
wrapper lacks one of the kernels that the call launched, traced three
ways (`chip_smoke.trace_kernels`): `none`, the call alone at the start of
the trace's window; `margin`, the call `chip_smoke.TRACE_MARGIN_S` inside
the window; `warm`, inside the window after a first call of the same
wrapper in the same trace, the second call's kernels counted.

    python tools/torch_profiler_drops.py [--seconds S] [--busy N]
                             [--after encode|k3 [--shared-cudart]]

For K6 (`ops/symbolize.symbolize_tiles`, three launches a call) on
`chip_smoke.py`'s seeded inputs (`K6_CASES`) and for K4
(`ops/me.motion_search_tiles`, one launch) on its 1080p input, it traces
one call of each input after another, each way in turns (in order, then
in reverse order), round after round until S seconds have
passed (the drops come and go). It prints, per round, the traces that
lacked a kernel each way and the least and the greatest lead
(`chip_smoke.trace_kernels`: the device start of a trace's first kept
kernel less the host start of the call; below 0 the device
clock reads early by more than a launch takes), then one JSON line of
the totals. Every call launches all its kernels (the wrappers count
launches), so a missing kernel is a record that the profiler dropped.

`--busy N` runs the rounds twice, S seconds each: first with the host
otherwise idle, then with N more processes each spinning a core (as
`chip_smoke.py`'s decode worker and the mesh's worker threads load the
host during its traces); it stops them before it exits. `--after
encode` then encodes a CIF IDR and P step on two GOP lanes on the card
(K1 to K4 and K6 launched, each kernel library loaded, as the paths
before `chip_smoke.py`'s phase 19 leave the process), `--after k3` only
launches K3 once (`chip_smoke.K3_CASES`' 4 x 3 MBs, a cluster launch),
and it runs the rounds again.
`--shared-cudart` then builds K6's and K4's sources once more with the
CUDA runtime linked as a shared library (`nvcc -cudart shared`; the
kernel libraries link it statically, each its own copy), loads those
builds in their wrappers' place (`cuda_build.Library.use`), runs the
rounds, loads the static builds back and runs them once more; it prints
the CUDA runtimes mapped into the process.

Needs a CUDA device; the first line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import multiprocessing
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _spin():
    while True:
        pass


def rounds_for(calls, ways, seconds, card, label):
    """Trace every call each way in turns, round after round, for
    `seconds`; print each round; return the totals."""
    import chip_smoke

    total = {w: collections.Counter() for w in ways}
    t0 = time.perf_counter()
    rounds = 0
    while rounds == 0 or time.perf_counter() - t0 < seconds:
        short = {w: [] for w in ways}
        leads = {w: [] for w in ways}
        order = list(ways) if rounds % 2 == 0 else list(ways)[::-1]
        for name, (fn, kernels) in calls.items():
            for w in order + order[::-1]:
                got, lead = chip_smoke.trace_kernels(fn, *ways[w])
                names = {k for k, _ in got}
                total[w]["traces"] += 1
                total[w]["short"] += not set(kernels) <= names
                total[w].update(f"lacking {k}" for k in kernels
                                if k not in names)
                if not set(kernels) <= names:
                    short[w].append(name)
                if lead is not None:
                    leads[w].append(lead)
        rounds += 1
        print(f"{label} round {rounds} at {time.perf_counter() - t0:.0f} s "
              f"[{card}]: " + "; ".join(
                  f"{w}: {len(short[w])} short traces {short[w]}, leads "
                  f"{min(leads[w], default=float('nan')):.1f} to "
                  f"{max(leads[w], default=float('nan')):.1f} us"
                  for w in ways))
    return {w: dict(c, rounds=rounds) for w, c in total.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_drops: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from h264lab_tpu_torch.models import mbscan
    from h264lab_tpu_torch.ops import cuda_build, me
    from h264lab_tpu_torch.ops import symbolize as k6

    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--busy", type=int, default=0)
    ap.add_argument("--after", choices=("encode", "k3"))
    ap.add_argument("--shared-cudart", action="store_true")
    opts = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    cuda_build.build_all([cuda_build.CSRC / "symbolize.cu",
                          cuda_build.CSRC / "me.cu"])
    calls = {}
    for what, *case in chip_smoke.K6_CASES:
        call = chip_smoke.to_device(chip_smoke.k6_case_call(*case), "cuda")
        args = mbscan.symbolize_args(*call)
        calls[f"K6, {what}"] = (lambda a=args: k6.symbolize_tiles(*a), (
            "sym_records_kernel", "sym_scan_kernel", "sym_codes_kernel"))
    what, *case = next(c for c in chip_smoke.K4_CASES if c[2] == 1 and c[8])
    args = chip_smoke.k4_case_args(*case)
    calls[f"K4, {what}"] = (lambda a=args: me.motion_search_tiles(*a),
                            ("search_kernel",))
    for fn, _ in calls.values():
        fn()
    torch.cuda.synchronize()
    # (margin, warm call) of each way of tracing
    ways = {"none": (0.0, False), "margin": (chip_smoke.TRACE_MARGIN_S, False),
            "warm": (chip_smoke.TRACE_MARGIN_S, True)}
    totals = {"idle": rounds_for(calls, ways, opts.seconds, card, "idle")}
    if opts.busy:
        ctx = multiprocessing.get_context("spawn")
        spinners = [ctx.Process(target=_spin, daemon=True)
                    for _ in range(opts.busy)]
        for p in spinners:
            p.start()
        try:
            totals[f"{opts.busy} busy"] = rounds_for(
                calls, ways, opts.seconds, card, f"{opts.busy} busy")
        finally:
            for p in spinners:
                p.terminate()
                p.join()
    if opts.after == "k3":
        from h264lab_tpu_torch.models import mbscan as mb

        what, *case = next(c for c in chip_smoke.K3_CASES
                           if c[0] == "4 x 3 MBs")
        mb._select_wavefront(*chip_smoke.k3_case_args(*case))
        torch.cuda.synchronize()
        print(f"launched K3 once ({what}); launches "
              f"{dict(cuda_build.LAUNCH_COUNTS)}")
        totals["after K3"] = rounds_for(calls, ways, opts.seconds, card,
                                        "after K3")
    if opts.after == "encode":
        from h264lab_tpu_torch.config import EncoderConfig, RunConfig
        from h264lab_tpu_torch.parallel.gop import GopBandEncoder
        from h264lab_tpu_torch.utils.synthetic import chessboard_sequence

        w, h = chip_smoke.CIF
        frames = list(chessboard_sequence(w, h, 3))
        enc = GopBandEncoder(EncoderConfig(width=w, height=h, gop=3,
                                           qp=chip_smoke.QP), n_gop=2)
        run = RunConfig(qp_min=chip_smoke.QP, qp_max=chip_smoke.QP,
                        encode_speed=2)
        for t in range(2):
            enc.encode_step(frames[t:t + 2], run)
        torch.cuda.synchronize()
        print(f"encoded a CIF IDR and P step; launches "
              f"{dict(cuda_build.LAUNCH_COUNTS)}")
        totals["after an encode"] = rounds_for(
            calls, ways, opts.seconds, card, "after an encode")
    if opts.after and opts.shared_cudart:
        libs = {k6._lib: cuda_build.CSRC / "symbolize.cu",
                me._lib: cuda_build.CSRC / "me.cu"}
        static = {lib: lib() for lib in libs}
        for lib, src in libs.items():
            out = cuda_build.BUILD_DIR / f"shared_cudart_{src.stem}.so"
            subprocess.run(
                ["/usr/local/cuda/bin/nvcc", "-gencode",
                 "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared",
                 "-Xlinker", "-rpath", "-Xlinker", "/usr/local/cuda/lib64",
                 "-o", str(out), str(src)], check=True)
            lib.use(out)
        with open("/proc/self/maps") as f:
            runtimes = sorted({line.split()[-1] for line in f
                               if "libcudart" in line})
        print(f"CUDA runtimes mapped: {runtimes}")
        totals[f"after {opts.after}, shared runtime"] = rounds_for(
            calls, ways, opts.seconds, card,
            f"after {opts.after}, shared runtime")
        for lib, handle in static.items():
            with lib._lock:
                lib._handle = handle
        totals[f"after {opts.after}, static again"] = rounds_for(
            calls, ways, opts.seconds, card,
            f"after {opts.after}, static again")
    print(json.dumps(dict(card=card, margin_s=chip_smoke.TRACE_MARGIN_S,
                          totals=totals)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
