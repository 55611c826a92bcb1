"""Where an all-intra GOP-lane step of the PyTorch port spends its time on
the CUDA card.

    python tools/torch_trace_step.py

It runs `chip_smoke.py`'s main path (1920x1088 chessboard, gop=1, QP 33,
encode_speed 2, the same frame schedule) and prints a summary and one JSON
line. Two measurements:

1. lane scaling: one step at 1 lane and one at 16 lanes, each after a
   warm-up step, with per-stage wall times (each stage between device
   synchronizations). A stage whose time does not grow with the lanes is
   bound by kernel launches, not by device work;
2. launches: one more 1-lane step in which every stage runs under its own
   `torch.profiler` pass (CUDA activity only). Per stage: the device
   operations launched (kernels, copies, fills), per wavefront diagonal
   for `select` (slope 2) and `deblock` (slope 1), and the union of their
   device intervals (busy ms). The busy ms over the untraced stage time of
   measurement 1 estimates the share of the stage the device works.

Needs a CUDA device; every line names the card and its power limit.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from h264lab_tpu_torch.models import wavefront  # noqa: E402
from h264lab_tpu_torch.parallel.gop import GopBandEncoder  # noqa: E402
from h264lab_tpu_torch.utils.device import card_label  # noqa: E402


def _warm_encoder(lanes):
    cfg, run, frames = chip_smoke.main_path_setup()
    enc = GopBandEncoder(cfg, n_gop=lanes)
    enc.encode_step(chip_smoke.lane_frames(frames, 0, lanes), run)
    return enc, run, chip_smoke.lane_frames(frames, 1, lanes)


def lane_scaling(lane_counts=(1, chip_smoke.LANES)):
    out = {}
    for lanes in lane_counts:
        enc, run, frames = _warm_encoder(lanes)
        enc.stage_times = {}
        t0 = time.perf_counter()
        enc.encode_step(frames, run)
        out[lanes] = dict(step_ms=1e3 * (time.perf_counter() - t0),
                          stages_ms={k: 1e3 * v for k, v in
                                     enc.stage_times.items()})
    return out


def _busy_us(events):
    """Length of the union of the events' device intervals."""
    busy, end = 0, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def launch_counts():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    enc, run, frames = _warm_encoder(1)
    stage = enc._stage
    out = {}

    @contextlib.contextmanager
    def traced(name):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with stage(name):
                yield
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        out[name] = dict(device_ops=len(ops), busy_ms=_busy_us(ops) / 1e3)

    enc._stage = traced
    enc.encode_step(frames, run)
    cfg = enc.config
    for name, slope in (("select", 2), ("deblock", 1)):
        n_diag = wavefront.make_plan(cfg.mb_width, cfg.mb_height,
                                     slope).steps.shape[0]
        out[name].update(diagonals=n_diag,
                         ops_per_diagonal=out[name]["device_ops"] / n_diag)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_trace_step: no CUDA device", file=sys.stderr)
        return 2
    card = card_label()
    print(card)
    size = f"{chip_smoke.WIDTH}x{chip_smoke.HEIGHT}"
    scaling = lane_scaling()
    for lanes, r in scaling.items():
        print(f"{size} x {lanes:2d} lanes [{card}]: step "
              f"{r['step_ms']:.1f} ms; " + ", ".join(
                  f"{k} {v:.1f}" for k, v in r["stages_ms"].items()))
    counts = launch_counts()
    for name, r in counts.items():
        untraced = scaling[1]["stages_ms"][name]
        per_diag = (f", {r['ops_per_diagonal']:.1f} per diagonal of "
                    f"{r['diagonals']}" if "diagonals" in r else "")
        print(f"{size} x 1 lane [{card}]: {name:8s} {r['device_ops']:8d} "
              f"device ops{per_diag}; busy {r['busy_ms']:.1f} ms of "
              f"{untraced:.1f} ms untraced")
    print(json.dumps({"card": card, "frame": size,
                      "lane_scaling": scaling, "launches_1_lane": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
