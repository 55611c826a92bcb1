#!/usr/bin/env python3
"""Smoke run of the PyTorch port (h264lab_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. print the card's name and power limit (nvidia-smi);
  2. build the bit-pack kernel K1 from h264lab_tpu_torch/csrc/bitpack.cu;
  3. encode 1920x1088 chessboard input, all-intra, 16 GOP lanes in one
     dispatch at QP 33, encode_speed 2: one untimed step, two timed steps
     for frames/s (no synchronization inside a step), then one step with
     per-stage times (each stage between device synchronizations);
  4. hold K1 against the plain PyTorch packer on the last step's real
     (16, 1, 8160, 952) symbol grids, at the IDR capacity and at a small
     capacity that overflows: the words must be equal; the launch count
     of the encode steps must be > 0;
  5. encode lane 0's first frame with the port on the CPU: its bytes must
     equal lane 0 of the card's first step;
  6. print the kernels line (JSON), then the result line (JSON).

It imports torch, numpy and the port, nothing of JAX. Without a CUDA
device, or without the port beside it, it exits non-zero and prints no
result.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

WIDTH, HEIGHT, QP, LANES = 1920, 1088, 33, 16
TIMED_STEPS = 2
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)


def _require(ok: bool, what: str):
    """A failed phase ends the run with a non-zero exit (also under -O)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main_path_setup():
    """The main path's inputs: (EncoderConfig, RunConfig, LANES frames).
    Lane g encodes frames[(g + t) % LANES] at step t (`lane_frames`)."""
    from h264lab_tpu_torch.config import EncoderConfig, RunConfig
    from h264lab_tpu_torch.utils.synthetic import chessboard_sequence

    cfg = EncoderConfig(width=WIDTH, height=HEIGHT, gop=1, qp=QP)
    run = RunConfig(qp_min=QP, qp_max=QP, encode_speed=2)
    return cfg, run, list(chessboard_sequence(WIDTH, HEIGHT, LANES))


def lane_frames(frames, t, lanes=LANES):
    return [frames[(g + t) % len(frames)] for g in range(lanes)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from h264lab_tpu_torch.ops import bitpack
    from h264lab_tpu_torch.parallel.gop import GopBandEncoder
    from h264lab_tpu_torch.utils.device import card_label

    # 1. the card
    card = card_label()
    print(card)
    label = f"[{card}]"
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    # 2. build K1
    t0 = time.perf_counter()
    lib_path, log = bitpack.build()
    print(f"K1 built in {time.perf_counter() - t0:.1f} s: "
          f"{os.path.relpath(lib_path, ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # 3. the main path: 16 lanes of 1080p all-intra
    t0 = time.perf_counter()
    cfg, run, frames = main_path_setup()
    print(f"input: {LANES} frames {WIDTH}x{HEIGHT} in "
          f"{time.perf_counter() - t0:.1f} s")
    enc = GopBandEncoder(cfg, n_gop=LANES)

    def step(t):
        p = enc.encode_step_async(lane_frames(frames, t), run)
        res = enc.finish_step(p)
        _require(len(res) == LANES and all(len(r.payload) > 0 for r in res),
                 f"step {t} returned empty lanes")
        return p, res

    bitpack.LAUNCH_COUNTS["bitpack"] = 0
    t0 = time.perf_counter()
    _, first = step(0)
    print(f"step 0 (untimed, first use): {time.perf_counter() - t0:.2f} s")
    step_s = []
    for t in range(1, 1 + TIMED_STEPS):
        t0 = time.perf_counter()
        step(t)
        step_s.append(time.perf_counter() - t0)
    fps = LANES * TIMED_STEPS / sum(step_s)
    print(f"timed steps {label}: " + ", ".join(f"{s:.3f} s" for s in step_s)
          + f"; {fps:.3f} frames/s ({LANES} lanes x {TIMED_STEPS} steps)")
    # one more step with a device synchronization around every stage
    enc.stage_times = {}
    t0 = time.perf_counter()
    pending, res = step(1 + TIMED_STEPS)
    print(f"stage step {label}: {time.perf_counter() - t0:.3f} s")
    for name, s in enc.stage_times.items():
        print(f"  stage {name:8s} {1e3 * s:10.1f} ms {label}")
    launches = bitpack.LAUNCH_COUNTS["bitpack"]
    print(f"  bytes/frame lane 0: {len(res[0].payload)}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _require(launches > 0, "the main path never launched K1")

    # 4. K1 against the plain packer on the step's real symbol grids
    vals = pending.out["sym_vals"]
    lens = pending.out["sym_lens"]
    cap = enc.idr_cap_words
    print(f"symbol grid {tuple(vals.shape)}, cap_words {cap}, launches "
          f"in the encode steps: {launches}")
    max_err = 0
    for c in (cap, 1024):
        wk, nk = bitpack.pack_frames(vals, lens, c)
        wp, np_ = bitpack.pack_frames_plain(vals, lens, c)
        torch.cuda.synchronize()
        _require(torch.equal(nk, np_), "K1 bit counts differ")
        diff = (wk.long() & 0xFFFFFFFF) - (wp.long() & 0xFFFFFFFF)
        max_err = max(max_err, int(diff.abs().max()))
        _require(torch.equal(wk, wp), f"K1 words differ at cap {c}")
        overflow = int(nk.max()) > 32 * c
        print(f"  cap {c}: K1 == plain on all {nk.numel()} frames "
              f"(overflowing: {overflow})")
    _require(int(nk.max()) > 32 * 1024, "the small cap did not overflow")
    k1_ms = _cuda_ms(lambda: bitpack.pack_frames(vals, lens, cap), 20)
    plain_ms = _cuda_ms(lambda: bitpack.pack_frames_plain(vals, lens, cap), 2)
    # bytes the function must move on this step's data: every length, the
    # value of every slot that holds a symbol (an empty slot's value never
    # reaches the words), the words and bit counts written once
    n_frames = nk.numel()
    n_sym = int((lens > 0).sum())
    moved = 4 * (lens.numel() + n_sym
                 + n_frames * (cap + bitpack.SLACK_WORDS + 1))
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"  slots holding a symbol: {n_sym} of {lens.numel()} "
          f"({100 * n_sym / lens.numel():.2f}%)")

    # 5. lane 0's first frame on the CPU
    t0 = time.perf_counter()
    cpu = GopBandEncoder(cfg, n_gop=1, device="cpu").encode_step(
        [frames[0]], run)
    _require(cpu[0].payload == first[0].payload,
             "lane 0 bytes differ between the card and the CPU")
    print(f"lane 0 frame 0: card bytes == CPU bytes ({len(cpu[0].payload)} "
          f"B; CPU encode {time.perf_counter() - t0:.1f} s)")

    # 6. results
    kernels = [dict(
        name="bitpack", route="cuda",
        source="h264lab_tpu_torch/csrc/bitpack.cu",
        replaces="h264lab_tpu/ops/bitpack.py:152",
        launches=launches, equal=True, max_abs_err=max_err,
        ms=k1_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
        library_ms=None)]
    print(f"K1 {label}: {k1_ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms for {moved / 1e9:.3f} GB, "
          f"{100 * bound_ms / k1_ms:.0f}% of it reached)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
