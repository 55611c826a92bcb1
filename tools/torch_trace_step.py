"""Where a step of the PyTorch port's GOP-lane path spends its time on
the CUDA card.

    python tools/torch_trace_step.py [--k1-baseline SRC] [--k2-baseline SRC]
                                     [--sequential] [--escape] [--pack]
                                     [--scaling] [--tree DIR]

It runs `chip_smoke.py`'s main path (1920x1088 chessboard, IPPP with GOP
20, QP 33, encode_speed 2, the same frame schedule): each measurement
encodes the IDR of step 0 untimed and measures the P step that follows
(measurement 4: a forced IDR step). It prints a summary and one JSON
line. Four measurements, the third one first:

1. lane scaling: the P step at 1 lane and at 16 lanes, with per-stage wall
   times (each stage between device synchronizations), the peak device
   memory of each run and a SHA-256 digest of the P step's lane bytes. A
   stage whose time does not grow with the lanes is bound by kernel
   launches, not by device work;
2. launches: one more 1-lane P step under one `torch.profiler` pass (CPU
   and CUDA activity), with every stage (`pre`, `inter`, `select`, `sym`,
   `deblock`, `pack`, `ref`, `host`) between device synchronizations. Per
   stage: the device operations (kernels, copies, fills) that start
   inside its `stage:<name>` range (the hand kernels K1 in `pack`, K2 in
   `deblock`, K3 and K8's two kernels in `select`, K4, K5 and K7 in
   `inter`, K6's three kernels in `sym`, by their launch counts), their
   device ms summed (busy ms) and the device ms of the hand kernels. The
   busy ms over the untraced stage time of measurement 1 estimates the
   share of the stage the device works;
3. K1 on the symbol grid of one 16-lane IDR step at the IDR capacity, and
   K2 (the deblocking kernel) on the deblocking inputs of the 16-lane P
   step that follows: each wrapper's time from CUDA events (K1's zero
   fills, K2's output allocation included) beside the kernel's device
   time in a `torch.profiler` trace of one call. With
   `--k1-baseline SRC`, SRC is an earlier two-pass build of K1 (entry
   points `h264lab_bitpack_mb_words` and `h264lab_bitpack_stitch`): the
   script times each launch of its wrapper on its own, checks that its
   words equal the current K1's, and times the two wrappers in turns
   (old, new, new, old). With `--k2-baseline SRC`, SRC is an earlier K2
   that takes bS and the edge QPs (entry point `h264lab_deblock` with
   bs_v, bs_h and four edge-QP arrays, one block per frame and plane
   group): the script builds it, prepares its arguments as its stage did
   (`mbscan._frame_bs`, `deblock.edge_qps`), checks that its tiles equal
   the current K2's, and times in turns (old, new, new, old) the two
   kernels (their wrappers on prepared arguments) and the two `deblock`
   stages (the preparation and the kernel), on the 16-lane P step's
   deblocking inputs and on lane 0's frame of them;
4. the IDR step, at 1 lane and at 16 lanes: after the untimed IDR of
   step 0, one forced IDR step with per-stage wall times, then the next
   under one `torch.profiler` pass as in measurement 2. Per stage of the
   traced step: device operations, busy ms and hand-kernel ms, beside the
   untraced stage ms (the wavefront `select`: K3 and its packing).

With `--sequential` it measures only the sequential encoder
(`H264Encoder`, `chip_smoke.py`'s 1080p speed-0 setting): after an IDR
and a P frame (untimed: the first use of the P path), one P frame with
per-stage times between syncs, and the next P frame under one profiler
pass as in measurement 2 (its `select`, the wavefront
with the inter candidate, is one K3 launch and a few operations).

With `--escape` it measures only what NAL escaping costs the GOP steps'
`host` stage (16 lanes): after the untimed IDR and P steps, four P steps
and then four forced IDR steps with per-stage times (their `host` stage
and step ms), escaping with `chip_smoke.escape_loop` (the port's earlier
per-byte loop) and with `nal.escape_rbsp` (numpy) in turns (loop, numpy,
numpy, loop). With `--pack` it does the same with the RBSP packer:
`chip_smoke.pack_per_bit` (the port's earlier per-bit packer) and
`BitWriter.to_bytes` (word-level) in turns (per-bit, words, words,
per-bit); then it times the host copy of one more IDR step's K1 words,
the whole capacity buffer against the used words that `finish_step`
copies.

With `--scaling` it measures only the lane scaling (measurement 1). With
`--tree DIR` it imports the port and `chip_smoke.py` from DIR, an earlier
tree unpacked into a gitignored directory (`git archive <commit> | tar -x
-C _baseline/parent`), so that two trees run under the same script in
turns in one call (parent, this, this, parent).

Needs a CUDA device; every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# --tree is read before the imports below, which come from that tree
TREE = os.path.abspath(sys.argv[sys.argv.index("--tree") + 1]
                       if "--tree" in sys.argv[:-1] else ROOT)
sys.path.insert(0, TREE)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from h264lab_tpu_torch.models import mbscan  # noqa: E402
from h264lab_tpu_torch.models.encoder import H264Encoder  # noqa: E402
from h264lab_tpu_torch.ops import bitpack, cuda_build, deblock  # noqa: E402
from h264lab_tpu_torch.parallel.gop import GopBandEncoder  # noqa: E402
from h264lab_tpu_torch.utils.device import card_label  # noqa: E402
from h264lab_tpu_torch.utils.synthetic import chessboard_sequence  # noqa: E402


def _warm_encoder(lanes):
    """An encoder past its IDR step, and the lanes of its first P step."""
    cfg, run, frames = chip_smoke.main_path_setup()
    enc = GopBandEncoder(cfg, n_gop=lanes)
    enc.encode_step(chip_smoke.lane_frames(frames, 0, lanes), run)
    return enc, run, chip_smoke.lane_frames(frames, 1, lanes)


def lane_scaling(lane_counts=(1, chip_smoke.LANES)):
    out = {}
    for lanes in lane_counts:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        enc, run, frames = _warm_encoder(lanes)
        enc.stage_times = {}
        t0 = time.perf_counter()
        res = enc.encode_step(frames, run)
        digest = hashlib.sha256(b"".join(r.payload for r in res))
        out[lanes] = dict(step_ms=1e3 * (time.perf_counter() - t0),
                          stages_ms={k: 1e3 * v for k, v in
                                     enc.stage_times.items()},
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          bytes_sha256=digest.hexdigest())
        del enc
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


# the hand kernels' names in a trace, and their launch counts
KERNELS = {"K1": ("pack_kernel",), "K2": ("deblock_kernel",),
           "K3": ("wavefront_kernel",),
           "K4": ("search_kernel",),
           "K5": ("partition_kernel",),
           "K6": ("sym_records_kernel", "sym_scan_kernel",
                  "sym_codes_kernel"),
           "K7": ("inter_residual_kernel",),
           "K8": ("select_parallel_kernel",),
           "K9": ("downsample_kernel",), "K10": ("upsample_kernel",),
           "K11": ("reference_planes_kernel",)}
HAND_LAUNCHES = {"K1": "bitpack", "K2": "deblock", "K3": "wavefront",
                 "K4": "me", "K5": "partition", "K6": "symbolize",
                 "K7": "inter_residual", "K8": "select_parallel",
                 "K9": "resample_down", "K10": "resample_up",
                 "K11": "refplanes"}


def _is(kernel, name):
    """Whether a trace event's name is one of hand kernel `kernel`'s."""
    return any(k in name for k in KERNELS[kernel])


def _kernel_us(ops, kernel):
    return sum(e.time_range.end - e.time_range.start for e in ops
               if _is(kernel, e.name))


def _stage_ops(timer, stages, drive):
    """Run `drive()` under one `torch.profiler` pass (CPU and CUDA
    activity) with `timer`'s stage times on. A device operation is charged
    to the stage whose `stage:<name>` range encloses the CPU event that
    launched it (the profiler hands each CPU event its device operations).
    The hand kernels, launched through ctypes, have no such event: each is
    charged to the stage of `stages` in which its launch count rose. Per
    stage: device operations, their device ms summed (busy ms: one stream)
    and hand-kernel ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stage, launched = stages.stage, {}

    @contextlib.contextmanager
    def counted(name):
        before = dict(cuda_build.LAUNCH_COUNTS)
        with stage(name):
            yield
        for k, key in HAND_LAUNCHES.items():     # (an earlier tree has
            if cuda_build.LAUNCH_COUNTS.get(key, 0) > before.get(key, 0):
                launched[k] = name                # fewer kernels)

    stages.stage = counted
    timer.stage_times = {}
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            drive()
            torch.cuda.synchronize()
    finally:
        timer.stage_times = None
        del stages.stage
    events = prof.events()

    def stage_of(e):
        while e is not None and not e.name.startswith("stage:"):
            e = e.cpu_parent
        return e.name[len("stage:"):] if e is not None else "unattributed"

    out = {}

    def charge(name, kernels):
        r = out.setdefault(name, dict(device_ops=0, busy_ms=0.0,
                                      kernel_ms={k: 0.0 for k in KERNELS}))
        for kern_name, us in kernels:
            r["device_ops"] += 1
            r["busy_ms"] += us / 1e3
            for k in KERNELS:
                if _is(k, kern_name):
                    r["kernel_ms"][k] += us / 1e3

    placed, attached = 0, set()
    for e in events:
        if e.device_type == DeviceType.CPU and e.kernels:
            charge(stage_of(e), [(k.name, k.duration) for k in e.kernels])
            placed += len(e.kernels)
            attached.update(k for k in KERNELS for kern in e.kernels
                            if _is(k, kern.name))
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("stage:")]
    for e in device:
        hand = [k for k in KERNELS if _is(k, e.name) and k not in attached]
        if hand and hand[0] in launched:
            charge(launched[hand[0]], [(e.name, e.time_range.end
                                        - e.time_range.start)])
            placed += 1
    if len(device) > placed:
        out["unattributed"] = dict(device_ops=len(device) - placed,
                                   busy_ms=0.0, kernel_ms={})
    return out


def launch_counts():
    enc, run, frames = _warm_encoder(1)
    return _stage_ops(enc, enc.stages,
                      lambda: enc.encode_step(frames, run))


def idr_counts(lane_counts=(1, chip_smoke.LANES)):
    """Measurement 4: per lane count, a forced IDR step's stage ms (between
    syncs, untraced) and the next one's traced counts."""
    from h264lab_tpu_torch.config import FrameType

    out = {}
    for lanes in lane_counts:
        enc, run, frames = _warm_encoder(lanes)
        key = dataclasses.replace(run, frame_type=FrameType.KEY)
        enc.stage_times = {}
        t0 = time.perf_counter()
        enc.encode_step(frames, key)
        step_ms = 1e3 * (time.perf_counter() - t0)
        stage_ms = {k: 1e3 * v for k, v in enc.stage_times.items()}
        enc.stage_times = None
        out[lanes] = dict(step_ms=step_ms, stages_ms=stage_ms,
                          traced=_stage_ops(enc, enc.stages,
                                            lambda: enc.encode_step(
                                                frames, key)))
    return out


def sequential_counts():
    """H264Encoder at `chip_smoke.py`'s 1080p sequential setting (speed 0):
    an IDR and a P frame (untimed: first use), one P frame with per-stage
    times between syncs, then the next P frame with every stage traced.
    Returns (stage ms, traced counts)."""
    cfg, run, _ = chip_smoke.main_path_setup()
    run = dataclasses.replace(run, encode_speed=chip_smoke.SEQ_SPEED)
    frames = list(chessboard_sequence(chip_smoke.WIDTH, chip_smoke.HEIGHT, 4))
    enc = H264Encoder(cfg)
    for f in frames[:2]:
        enc.encode(*f, run)
    enc.stage_times = {}
    enc.encode(*frames[2], run)
    stage_ms = {k: 1e3 * v for k, v in enc.stage_times.items()}
    enc.stage_times = None
    return stage_ms, _stage_ops(enc, enc.stages,
                                lambda: enc.encode(*frames[3], run))


def _host_turns(fns, install):
    """The 16-lane GOP steps with two host variants in turns (a, b, b, a):
    after the untimed IDR and P steps, four P steps and then four forced
    IDR steps with per-stage times, `install(fns[name])` before each.
    Returns ({"P"|"IDR": {name: {"host": [ms, ms], "step": [ms, ms]}}},
    the encoder, the run of the IDR steps and the frames)."""
    from h264lab_tpu_torch.config import FrameType

    cfg, run, frames = chip_smoke.main_path_setup()
    enc = GopBandEncoder(cfg, n_gop=chip_smoke.LANES)
    for t in range(2):
        enc.encode_step(chip_smoke.lane_frames(frames, t), run)
    (a, _), (b, _) = fns.items()
    key = dataclasses.replace(run, frame_type=FrameType.KEY)
    out = {}
    try:
        for kind, r in (("P", run), ("IDR", key)):
            out[kind] = {n: dict(host=[], step=[]) for n in fns}
            for i, name in enumerate((a, b, b, a)):
                install(fns[name])
                enc.stage_times = {}
                t0 = time.perf_counter()
                res = enc.encode_step(chip_smoke.lane_frames(frames, 2 + i),
                                      r)
                out[kind][name]["step"].append(
                    1e3 * (time.perf_counter() - t0))
                chip_smoke._require(res[0].frame_type == kind,
                                    f"{kind} step is {res[0].frame_type}")
                out[kind][name]["host"].append(
                    1e3 * enc.stage_times["host"])
    finally:
        install(fns[b])
        enc.stage_times = None
    return out, enc, key, frames


def escape_turns():
    """The GOP steps' `host` stage with the per-byte loop and the numpy
    NAL escape in turns (module docstring)."""
    from h264lab_tpu_torch.bitstream import nal

    def install(fn):
        nal.escape_rbsp = fn

    return _host_turns(dict(loop=chip_smoke.escape_loop,
                            numpy=nal.escape_rbsp), install)[0]


def pack_turns():
    """The GOP steps' `host` stage with the per-bit and the word-level RBSP
    packer in turns, then the host copy of one IDR step's K1 words, the
    whole capacity buffer against the used words (module docstring)."""
    from h264lab_tpu_torch.bitstream.bitwriter import BitWriter

    def install(fn):
        BitWriter.to_bytes = fn

    host, enc, key, frames = _host_turns(
        {"per-bit": chip_smoke.pack_per_bit, "words": BitWriter.to_bytes},
        install)
    p = enc.encode_step_async(chip_smoke.lane_frames(frames, 6), key)
    words, nbits = p.outs[0]["words"], p.outs[0]["nbits"]
    n_used = (int(nbits.max()) + 31) // 32
    copy = {}
    for name, w in (("whole", words), ("used", words[..., :n_used])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w.cpu()
        copy[name] = dict(ms=1e3 * (time.perf_counter() - t0),
                          mib=w.numel() * 4 / 2**20)
    enc.finish_step(p)
    return host, copy


def _baseline_k1(src, vals, lens, cap):
    """The wrapper of the two-pass K1 built from `src`, as its launches in
    order (name -> function; they share one set of buffers) and the whole
    wrapper, which returns (words, nbits)."""
    lib = ctypes.CDLL(str(bitpack.build(src)[0]))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.h264lab_bitpack_mb_words.argtypes = [vp, vp, ll, ci, vp, vp, vp]
    lib.h264lab_bitpack_stitch.argtypes = [vp, vp, ll, ci, ll, vp, vp]
    n_frames, (nmb, nslots) = vals.shape[:-2].numel(), vals.shape[-2:]
    n_out = cap + bitpack.SLACK_WORDS
    stream = torch.cuda.current_stream().cuda_stream
    b = {}

    def mb_words_kernel():
        b["mb_words"] = torch.empty((n_frames, nmb, 128), dtype=torch.int32,
                                    device=vals.device)
        b["mb_bits"] = torch.empty((n_frames, nmb), dtype=torch.int32,
                                   device=vals.device)
        cuda_build.check(lib.h264lab_bitpack_mb_words(
            vals.data_ptr(), lens.data_ptr(), n_frames * nmb, nslots,
            b["mb_words"].data_ptr(), b["mb_bits"].data_ptr(), stream),
            "baseline mb_words")

    def cumsum_sub():
        b["offs"] = (torch.cumsum(b["mb_bits"], dim=1, dtype=torch.int32)
                     - b["mb_bits"])

    def zeros():
        b["words"] = torch.zeros((n_frames, n_out), dtype=torch.int32,
                                 device=vals.device)

    def stitch_kernel():        # ORs the same bits again when repeated
        cuda_build.check(lib.h264lab_bitpack_stitch(
            b["mb_words"].data_ptr(), b["offs"].data_ptr(), n_frames, nmb,
            n_out, b["words"].data_ptr(), stream), "baseline stitch")

    def total():
        b["nbits"] = b["mb_bits"].sum(1, dtype=torch.int32)

    launches = dict(mb_words_kernel=mb_words_kernel, cumsum_sub=cumsum_sub,
                    zeros=zeros, stitch_kernel=stitch_kernel, sum=total)

    def whole():
        for fn in launches.values():
            fn()
        return b["words"], b["nbits"]
    return launches, whole


def _baseline_k2(src):
    """The earlier K2 built from `src`, as three functions: prepare(*args)
    derives bS and the edge QPs from `deblock_frame`'s arguments as that
    K2's stage did, kernel(prepared) launches it on them, and stage(*args)
    does both. Returns (prepare, kernel, stage)."""
    lib = ctypes.CDLL(str(cuda_build.build(src)[0]))
    vp = ctypes.c_void_p
    lib.h264lab_deblock.argtypes = [vp] * 15 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]
    lib.h264lab_deblock.restype = ctypes.c_int

    def prepare(recon_y, recon_u, recon_v, sel, nnz_blk, mv4_y, mv4_x, qp,
                qpc, avail_top, avail_left, mb_width, mb_height):
        n, nmb = sel.shape
        dev = recon_y.device
        bs = mbscan._frame_bs(sel, nnz_blk, mv4_y, mv4_x, avail_top,
                              avail_left, mb_width, mb_height)

        def u8(x, t):
            return x.reshape(n, nmb, t, t).to(torch.uint8).contiguous()

        qs = deblock.edge_qps(torch.as_tensor(qp, dtype=torch.int32,
                                              device=dev),
                              torch.as_tensor(qpc, dtype=torch.int32,
                                              device=dev), n, mb_width,
                              mb_height)
        return ((u8(recon_y, 16), u8(recon_u, 8), u8(recon_v, 8),
                 u8(bs[0], 4), u8(bs[1], 4),
                 *(q.contiguous() for q in qs)), n, mb_width, mb_height)

    def kernel(prepared):
        tensors, n, mbw, mbh = prepared
        outs = [torch.empty_like(x) for x in tensors[:3]]
        cuda_build.check(lib.h264lab_deblock(
            *(x.data_ptr() for x in tensors[:3]),
            *(o.data_ptr() for o in outs),
            *(x.data_ptr() for x in tensors[3:]),
            *(t.ctypes.data for t in deblock._HOST_TABLES), n, mbw, mbh,
            torch.cuda.current_stream().cuda_stream), "baseline deblock")
        return tuple(outs)

    return prepare, kernel, lambda *args: kernel(prepare(*args))


def k2_turns(src, args, reps):
    """The earlier K2 (`src`) against the current one on `deblock_frame`'s
    arguments `args`: equal tiles, then the two kernels and the two stages
    in turns (old, new, new, old)."""
    prepare, old_kernel, old_stage = _baseline_k2(src)
    prepared = prepare(*args)
    packed = mbscan.deblock_tiles_args(*args)
    want = mbscan.deblock_frame(*args)
    equal = all(torch.equal(a, b) for a, b in zip(old_stage(*args), want))
    out = dict(inputs=list(args[3].shape), baseline_equal=equal)
    for what, old, new in (
            ("kernel", lambda: old_kernel(prepared),
             lambda: deblock.deblock_tiles(*packed)),
            ("stage", lambda: old_stage(*args),
             lambda: mbscan.deblock_frame(*args))):
        turns = [chip_smoke._cuda_ms(fn, reps) for fn in (old, new, new,
                                                          old)]
        out[f"{what}_turns_ms"] = dict(old=[turns[0], turns[3]],
                                       new=[turns[1], turns[2]])
    out["bound_ms"] = chip_smoke.k2_bytes(packed) / (
        chip_smoke.HBM_BYTES_PER_S * 1e-3)
    return out


def _kernel_timing(kernel, fn, reps):
    """A wrapper's ms from CUDA events over `reps` calls, and one call's
    device ops, busy ms and kernel ms in a `torch.profiler` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = dict(ms=chip_smoke._cuda_ms(fn, reps))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out.update(trace_kernel_ms=_kernel_us(ops, kernel) / 1e3,
               trace_busy_ms=_busy_us(ops) / 1e3, trace_device_ops=len(ops))
    return out


def kernel_timing(baseline=None, k2_baseline=None, reps=20):
    """Measurement 3: K1 on the 16-lane IDR step's grid (and against an
    earlier build), K2 on the next P step's deblocking inputs (and against
    an earlier build, there and on lane 0's frame)."""
    cfg, run, frames = chip_smoke.main_path_setup()
    enc = GopBandEncoder(cfg, n_gop=chip_smoke.LANES)
    p = enc.encode_step_async(chip_smoke.lane_frames(frames, 0), run)
    grid = p.outs[0]          # the one shard of an encoder without a mesh
    vals, lens, cap = grid["sym_vals"], grid["sym_lens"], enc.idr_cap_words
    new = lambda: bitpack.pack_frames(vals, lens, cap)  # noqa: E731
    out = dict(grid=list(vals.shape), cap_words=cap,
               **_kernel_timing("K1", new, reps))
    if baseline:
        launches, old = _baseline_k1(baseline, vals, lens, cap)
        wo, no = old()
        wn, nn = new()
        out["baseline_equal"] = bool(torch.equal(wo.reshape(wn.shape), wn)
                                     and torch.equal(no.reshape(nn.shape), nn))
        out["baseline_launch_ms"] = {name: chip_smoke._cuda_ms(fn, reps)
                                     for name, fn in launches.items()}
        turns = [chip_smoke._cuda_ms(fn, reps) for fn in (old, new, new, old)]
        out["turns_ms"] = dict(old=[turns[0], turns[3]],
                               new=[turns[1], turns[2]])
    enc.finish_step(p)
    calls = []
    with chip_smoke.recorded_calls("deblock_frame", calls):
        enc.encode_step(chip_smoke.lane_frames(frames, 1), run)
    k2_args = mbscan.deblock_tiles_args(*calls[0])
    k2 = dict(inputs=list(k2_args[0].shape[:2]), **_kernel_timing(
        "K2", lambda: deblock.deblock_tiles(*k2_args), reps))
    if k2_baseline:
        frame = tuple(x[:1] if isinstance(x, torch.Tensor) and x.ndim > 0
                      and x.shape[0] == chip_smoke.LANES else x
                      for x in calls[0])
        k2["baseline"] = [k2_turns(k2_baseline, a, reps)
                          for a in (calls[0], frame)]
    return out, k2


def _hand(r):
    """The hand kernels' device ms of one stage's traced counts."""
    return "".join(f"; {k} {v:.3f} ms" for k, v in r["kernel_ms"].items()
                   if v)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k1-baseline", metavar="SRC",
                    help="an earlier two-pass K1 source to time against")
    ap.add_argument("--k2-baseline", metavar="SRC",
                    help="an earlier K2 source (bS and edge QPs as inputs) "
                         "to time against")
    ap.add_argument("--sequential", action="store_true",
                    help="trace the sequential encoder's 1080p speed-0 P "
                         "frame instead")
    ap.add_argument("--escape", action="store_true",
                    help="time the GOP steps' host stage with the per-byte "
                         "and the numpy NAL escape instead")
    ap.add_argument("--pack", action="store_true",
                    help="time the GOP steps' host stage with the per-bit "
                         "and the word-level RBSP packer instead")
    ap.add_argument("--scaling", action="store_true",
                    help="measure only the lane scaling (measurement 1)")
    ap.add_argument("--tree", default=ROOT,
                    help="import the port and chip_smoke.py from this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_trace_step: no CUDA device", file=sys.stderr)
        return 2
    card = card_label()
    print(card)
    size = f"{chip_smoke.WIDTH}x{chip_smoke.HEIGHT}"
    result = {"card": card, "frame": size}
    if args.escape or args.pack:
        if args.escape:
            host = escape_turns()
        else:
            host, copy = pack_turns()
            for name, c in copy.items():
                print(f"{size} {chip_smoke.LANES}-lane IDR step's K1 words "
                      f"to the host, {name} ({c['mib']:.1f} MiB) [{card}]: "
                      f"{c['ms']:.1f} ms")
            result["words_copy"] = copy
        for kind, r in host.items():
            (a, ra), (b, rb) = r.items()
            for what in ("host", "step"):
                print(f"{size} {chip_smoke.LANES}-lane {kind} step, {what} "
                      f"ms (stage syncs inside) [{card}], in turns {a}, {b},"
                      f" {b}, {a}: {ra[what][0]:.1f}, {rb[what][0]:.1f}, "
                      f"{rb[what][1]:.1f}, {ra[what][1]:.1f}")
        result["host_turns_ms"] = host
        print(json.dumps(result))
        return 0
    if args.sequential:
        stage_ms, counts = sequential_counts()
        for name, r in counts.items():
            print(f"{size} sequential speed-{chip_smoke.SEQ_SPEED} P frame "
                  f"[{card}]: {name:8s} {r['device_ops']:8d} device ops; "
                  f"busy {r['busy_ms']:.1f} ms of "
                  f"{stage_ms.get(name, 0.0):.1f} ms untraced"
                  + _hand(r))
        result.update(sequential_stage_ms=stage_ms, sequential=counts)
        print(json.dumps(result))
        return 0
    result["tree"] = TREE
    if not args.scaling:
        k1, k2 = kernel_timing(args.k1_baseline,   # first: a fresh profiler
                               args.k2_baseline)
    scaling = lane_scaling()
    for lanes, r in scaling.items():
        print(f"{size} P step x {lanes:2d} lanes [{card}], tree {TREE}: "
              f"step {r['step_ms']:.1f} ms; " + ", ".join(
                  f"{k} {v:.1f}" for k, v in r["stages_ms"].items())
              + f"; peak device memory {r['peak_gib']:.2f} GiB; bytes "
              f"sha256 {r['bytes_sha256'][:16]}")
    if args.scaling:
        result.update(lane_scaling=scaling)
        print(json.dumps(result))
        return 0
    counts = launch_counts()
    for name, r in counts.items():
        untraced = scaling[1]["stages_ms"].get(name, 0.0)
        print(f"{size} P step x 1 lane [{card}]: {name:8s} "
              f"{r['device_ops']:8d} device ops; busy {r['busy_ms']:.1f} ms "
              f"of {untraced:.1f} ms untraced" + _hand(r))
    idr = idr_counts()
    for lanes, r in idr.items():
        print(f"{size} IDR step x {lanes:2d} lanes [{card}]: step "
              f"{r['step_ms']:.1f} ms; " + ", ".join(
                  f"{k} {v:.1f}" for k, v in r["stages_ms"].items()))
        for name, t in r["traced"].items():
            print(f"  traced: {name:8s} {t['device_ops']:8d} device ops; "
                  f"busy {t['busy_ms']:.1f} ms of "
                  f"{r['stages_ms'].get(name, 0.0):.1f} ms untraced"
                  + _hand(t))
    result.update(lane_scaling=scaling, launches_1_lane=counts,
                  idr_steps=idr)
    print(f"K1 {k1['grid']} cap {k1['cap_words']} [{card}]: {k1['ms']:.3f} "
          f"ms (events, fills included); trace: kernel "
          f"{k1['trace_kernel_ms']:.3f} ms, {k1['trace_device_ops']} device "
          f"ops busy {k1['trace_busy_ms']:.3f} ms")
    if args.k1_baseline:
        print(f"  baseline launches [{card}]: " + ", ".join(
            f"{k} {v:.3f}" for k, v in k1["baseline_launch_ms"].items())
            + f" ms; words equal: {k1['baseline_equal']}")
        print(f"  in turns old, new, new, old [{card}]: "
              f"{k1['turns_ms']['old'][0]:.3f}, {k1['turns_ms']['new'][0]:.3f}"
              f", {k1['turns_ms']['new'][1]:.3f}, "
              f"{k1['turns_ms']['old'][1]:.3f} ms")
    print(f"K2 on the P step's deblocking inputs {k2['inputs']} [{card}]: "
          f"{k2['ms']:.3f} ms (events, output allocation included); trace: "
          f"kernel {k2['trace_kernel_ms']:.3f} ms, {k2['trace_device_ops']} "
          f"device ops busy {k2['trace_busy_ms']:.3f} ms")
    for b in k2.get("baseline", []):
        for what in ("kernel", "stage"):
            t = b[f"{what}_turns_ms"]
            print(f"  K2 baseline on {b['inputs']}, {what} in turns old, new,"
                  f" new, old [{card}]: {t['old'][0]:.3f}, {t['new'][0]:.3f}"
                  f", {t['new'][1]:.3f}, {t['old'][1]:.3f} ms; tiles equal: "
                  f"{b['baseline_equal']}; bound {b['bound_ms']:.4f} ms")
    result.update(k1=k1, k2=k2)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
