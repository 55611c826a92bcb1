"""K3, the wavefront kernel (`h264lab_tpu_torch/csrc/wavefront.cu`), on the
CUDA card: its time per MB step at the shapes the encode paths give it,
and the phases of its MB steps.

    python tools/torch_k3_bench.py [--phases SRC] [--reps N]

The inputs are `chip_smoke.py`'s seeded K3 inputs at the four paths'
shapes (`utils.synthetic.wavefront_inputs`, packed by
`mbscan.select_wavefront_args`): 16 frames of 1080p (the GOP lanes' IDR
step), one 1080p frame with the inter candidate (the sequential speed-0 P
frame), the SVC base layer (1, 60 x 34 MBs) and a mesh band with the inter
candidate (1, 120 x 34 MBs). For each shape it prints K3's wrapper ms
(CUDA events over `--reps` calls after a warm-up) and its us per MB step
(ms over the chain of mbw + 2 (mbh - 1) MB steps), beside its ptxas
registers, shared memory and spills, the rows per cluster it takes
(`wavefront.cluster_rows`), its resident blocks per SM and its resident
clusters on the card.

`--phases SRC` names a copy of `csrc/wavefront.cu` with clock64() stamps
(not kept in the repository) that sums the cycles of each phase of its MB
steps into the slots of `PHASES`, then the count of MB steps, and exports
`int h264lab_wavefront_phases(unsigned long long* out)` to copy them out
and zero them. Its entry point and buffers are the current K3's. After a
warm-up, one launch per shape gives the mean cycles per MB step of each
phase and its share of the whole step: the wait for the records of the
row above (at MBs past the first, and at the first, where a row waits
for its start), the loads left after it, the Intra_4x4 warp (and in it
the wait for the top-right record and the waves' parts), the Intra_16x16
and chroma warp, compute up to the barrier after them, the selection and
output writes, and the publish of the MB's record units.

Needs a CUDA device; every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from h264lab_tpu_torch.models import mbscan  # noqa: E402
from h264lab_tpu_torch.ops import cuda_build, wavefront  # noqa: E402
from h264lab_tpu_torch.utils.device import card_label  # noqa: E402

# the phases' slots in `h264lab_wavefront_phases` (the MB steps follow)
PHASES = ("wait", "loads", "intra4", "intra16", "chroma", "compute",
          "select_writes", "publish", "step", "wait_first", "topright_wait",
          "i4_neighbours", "i4_predict_sad", "i4_decide", "i4_transform",
          "unused")


def path_inputs():
    """[(what, K3's packed arguments on the card, chain steps)] of the
    four paths' shapes."""
    out = []
    for what, seed, n, mbw, mbh, qp, inter in chip_smoke.K3_CASES[:4]:
        args = chip_smoke.k3_case_args(seed, n, mbw, mbh, qp, inter)
        out.append((what, mbscan.select_wavefront_args(*args),
                    mbw + 2 * (mbh - 1)))
    return out


def ptxas(log):
    """The registers, shared memory and spill lines of a ptxas log."""
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]


def wrapper_ms(k3_args, reps):
    """The mean ms of K3's wrapper on `k3_args` over `reps` calls after a
    warm-up call (CUDA events)."""
    wavefront.wavefront_tiles(*k3_args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        wavefront.wavefront_tiles(*k3_args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phases(src, inputs):
    """Mean cycles per MB step of each phase of the stamped copy `src` on
    each input. From here on the wrapper launches that copy."""
    path, log = cuda_build.build(src)
    lib = wavefront._lib.use(path)
    lib.h264lab_wavefront_phases.argtypes = [ctypes.c_void_p]
    lib.h264lab_wavefront_phases.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    print(f"phases of {src}: {ptxas(log)}")
    out = {}
    for what, k3_args, chain in inputs:
        for _ in range(2):           # a warm-up, then the measured launch
            cuda_build.check(lib.h264lab_wavefront_phases(buf), "phases")
            wavefront.wavefront_tiles(*k3_args)
            torch.cuda.synchronize()
        cuda_build.check(lib.h264lab_wavefront_phases(buf), "phases")
        steps = buf[len(PHASES)]
        cyc = {k: buf[i] / steps for i, k in enumerate(PHASES)}
        out[what] = dict(cycles_per_step=cyc, mb_steps=steps)
        print(f"  {what}: {steps} MB steps; cycles per MB step "
              + ", ".join(f"{k} {v:.0f} ({100 * v / cyc['step']:.1f}%)"
                          for k, v in cyc.items()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", metavar="SRC")
    ap.add_argument("--reps", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3_bench: no CUDA device", file=sys.stderr)
        return 2
    label = f"[{card_label()}]"
    print(label)
    _, log = cuda_build.build(wavefront._SRC)
    inputs = path_inputs()
    result = dict(card=label, ptxas=ptxas(log), k3={})
    print(f"K3: {ptxas(log)}")
    for what, k3_args, chain in inputs:
        n, nmb = k3_args[0].shape[:2]
        mbw = k3_args[13]
        dev = k3_args[0].device
        rows = wavefront.cluster_rows(n, mbw, nmb // mbw, dev)
        blocks, clusters = wavefront.occupancy(mbw, rows, dev)
        ms = wrapper_ms(k3_args, opts.reps)
        result["k3"][what] = dict(ms=ms, us_per_step=1e3 * ms / chain,
                                  chain=chain, cluster=rows,
                                  resident_blocks=blocks,
                                  resident_clusters=clusters)
        print(f"  K3 on {what} {label}: {ms:.3f} ms, "
              f"{1e3 * ms / chain:.2f} us per MB step ({chain} steps); "
              f"clusters of {rows} rows, {blocks} resident blocks per SM, "
              f"{clusters} resident clusters")
    if opts.phases:
        result["phases"] = phases(opts.phases, inputs)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
