"""The ("gop", "band") mesh phase of `chip_smoke.py` alone, on the visible
CUDA cards.

    python tools/torch_mesh_cards.py

It builds the kernels and runs `chip_smoke.mesh_phases` (phase 15): the
dryruns `dryrun_multichip(8)` and `(3)`, then GopBandEncoder at 1920x1088
with two slice bands over a (2, 2) mesh (two lanes, QP 33, speed 2, each
shard issued from its own worker thread on its own CUDA stream: an IDR
and a P step with per-shard stage tables, a P step timed without stage
syncs, each step's shard issue intervals; then a forced IDR, a P step and
the pipelined loop in turns with the unsharded encoder), held to the
unsharded run on the first card and that to the CPU, K1 against the plain
packer on a shard's grid, K2 against the plain filter and K3 against the
plain wavefront on a shard's inputs, K6 launched once for every shard and
step. A mesh whose entries fit on the
visible cards takes distinct cards (with four cards: the (2, 2) mesh and
the 3-entry dryrun); a larger one repeats cuda:0. Every card's name and
power limit is printed, then one JSON line. Any failed check exits
non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from h264lab_tpu_torch.ops import cuda_build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mesh_cards: no CUDA device", file=sys.stderr)
        return 2
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for line in cards:
        print(line)
    label = f"[{cards[0]} x {torch.cuda.device_count()}]"
    t0 = time.perf_counter()
    cuda_build.build_all(sorted(cuda_build.CSRC.glob("*.cu")))
    cfg, run, frames = chip_smoke.main_path_setup()
    numbers, k2_numbers, k3_numbers, me_calls, sym_calls = {}, {}, {}, {}, {}
    k1, k2, k3, k4, k6, err = chip_smoke.mesh_phases(
        cfg, run, frames, label, numbers, k2_numbers, k3_numbers, me_calls,
        sym_calls)
    print(f"mesh phase and set-up in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(dict(cards=cards, count=torch.cuda.device_count(),
                          k1_launches=k1, k2_launches=k2, k3_launches=k3,
                          k4_launches=k4, k6_launches=k6, max_abs_err=err,
                          k1=numbers["mesh"], k2=k2_numbers["mesh"],
                          k3=k3_numbers["mesh"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
