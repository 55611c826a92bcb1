"""GOP-lane x slice-band encoding on CUDA devices, over a ("gop", "band")
device mesh or on one device.

PyTorch counterpart of `h264lab_tpu/parallel/gop.py`: G independent GOP
lanes advance in lockstep, each encoding one frame per step against its
own reference picture, and every frame is cut into B slice bands. The
(lane, band) pairs form one leading batch axis of G*B frames that every
stage runs over at once, where the JAX package vmapped twice.

A step is the device stages — tiling (`pre`); for P frames the dense
motion search, chroma MC and inter transform (`inter`); mode selection
(`select`: the slope-2 wavefront for I frames, the fully parallel path
for P frames); CAVLC symbolization (`sym`); deblocking (`deblock`); the
bit-pack kernel (`pack`, `ops/bitpack.py`); the next reference pictures
and MV candidates (`ref`) — and the host stage `finish_step` (slice
headers, NAL escaping, rate control, transparent frames).

The device stages are `models/stages.py`'s, which `H264Encoder` runs too.

The mesh (`make_mesh`). JAX runs one SPMD program and lets XLA partition
it; the port gives each mesh entry (i, j) its own block of the batch:
lanes i*G/n_gop .. (i+1)*G/n_gop - 1 and bands j*B/n_band ..
(j+1)*B/n_band - 1, run by its own `FrameStages` on `mesh.devices[i, j]`
(the shard's planes, QPs, reference slots and MV candidates stay there).
The shards run at once, as JAX's do: each mesh entry has one worker
thread and, on a card, one CUDA stream for the encoder's lifetime
(`ShardWorkers`); the entries issue one stage at a time (the interpreter
lock allows no more, `ShardWorkers`), while the other entries' device
work runs on their streams. The one collective is JAX's too: after a
step each gop row gathers its bands into every device of the row
(`refstate.exchange`), because motion vectors read the whole reference
picture; it runs in the calling thread, ordered after the shards'
streams. K1 packs each shard's grid on its device, and `finish_step`
writes the slices in (lane, band) order. Without a mesh the encoder is the 1 x 1 case on one device, run
in the caller's thread on its current stream. A mesh entry may repeat a
device (JAX's `--xla_force_host_platform_device_count`): then the shards
share it, each on its own stream.

Frame types: IDR, I, P, GOLDEN, RECOVERY, DROPPABLE and CUSTOM, with
lane-batched reference slots (0 = short-term, 1..N = long-term). P frames
run the toolset of their speed as the JAX GOP encoder maps it: partitions
at speed 0, Intra_4x4 in P through the wavefront at speeds 0 and 1,
quarter-pel ME below 9, full-pel at 9. Speeds 8 and 10 raise
`NotImplementedError`: the JAX GOP encoder turns deblocking off there but
writes a slice header that says it is on (a fault its streams have), and
the port does not copy it. A lane or band count that the mesh does not
divide raises `ValueError` (JAX's `device_put` refuses such a sharding),
a `mesh` that is no `Mesh` `TypeError`, temporal denoising `ValueError`,
as in the JAX GOP encoder.

With fixed QP, lane streams are byte-identical to the JAX package's, with
or without a mesh.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import threading
import time
from typing import ClassVar

import numpy as np
import torch

from h264lab_tpu_torch.bitstream import BitWriter, headers
from h264lab_tpu_torch.bitstream.nal import annexb_nal
from h264lab_tpu_torch.config import EncoderConfig, FrameType, RunConfig
from h264lab_tpu_torch.models import refstate, wavefront
from h264lab_tpu_torch.models.encoder import (PIC_INIT_QP, FrameResult,
                                              long_term_policy)
from h264lab_tpu_torch.models.stages import FrameStages, StageTimer, Toolset
from h264lab_tpu_torch.ops import bitpack, qpel
from h264lab_tpu_torch.rc.ratecontrol import RateControl, filler_nal
from h264lab_tpu_torch.utils.device import resolve_device

# worst-case packed words per MB: spec 7.4.5 caps macroblock_layer() at
# 3200 bits; 128 words = 4096 bits of headroom
WORDS_PER_MB = 128

# encode speeds the GOP encoder runs: 8 and 10 turn deblocking off, and
# the JAX GOP encoder's slice headers do not say so
SPEEDS = (0, 1, 2, 3, 4, 5, 6, 7, 9)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ("gop", "band") grid of devices (`make_mesh`): `devices` is an
    (n_gop, n_band) numpy object array of `torch.device`."""
    devices: np.ndarray
    axis_names: ClassVar[tuple] = ("gop", "band")

    @property
    def shape(self) -> dict:
        """{"gop": n_gop, "band": n_band}, as JAX's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_gop: int, n_band: int, devices=None) -> Mesh:
    """An (n_gop, n_band) mesh over the first n_gop * n_band `devices`,
    row-major as in JAX's `make_mesh`. None means the visible CUDA cards;
    a list may repeat an entry (`["cpu"] * 8`, `["cuda:0"] * 4`). Too few
    devices raise `ValueError`; there is no fallback to the CPU."""
    if devices is None:
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_gop * n_band
    if n_gop < 1 or n_band < 1 or n > len(devices):
        raise ValueError(f"mesh {n_gop}x{n_band} needs {n} devices, "
                         f"have {len(devices)}")
    grid = np.empty((n_gop, n_band), dtype=object)
    for k in range(n):
        grid[k // n_band, k % n_band] = devices[k]
    return Mesh(grid)


class ShardWorkers:
    """One worker thread and, on a card, one CUDA stream per mesh entry,
    for the owner's lifetime: the shards of a mesh step run at once, as
    the shards of the JAX mesh's one SPMD program do.

    `run(fns)` calls fns[k] on entry k's worker with the entry's device
    and stream current, so that every operation and kernel it issues goes
    there, and returns the results in order once every entry has
    finished. An exception of any entry is raised from `run` after all
    have finished (the others' as notes on it).

    Host issue. Entries that issue PyTorch operations at the same time
    hand CPython's interpreter lock over at every operation (PyTorch
    drops it for each one's dispatch and launch), and every handover is a
    thread wake-up: four free-running entries of a 1080p mesh step on an
    H100 took about 4x the time of the same shards issued in turns from
    one thread (`PERF.md` §6). So the work functions hold `issue_lock`
    while they issue a stage (`StageTimer.stage` takes it, and
    `ShardedIntraEncoder` around its encode): one entry issues at a time,
    stage by stage, while the device work of the others runs on their
    streams.

    Order between streams. Before the entries start, each entry's stream
    waits for its device's current stream in the calling thread (the
    inputs that thread made: references, MV fields); after they finish,
    that current stream waits for each entry's stream, so that whatever
    the calling thread issues next (the exchange, reads to the host, state
    updates, frees) follows the entries' work. This also keeps the caching
    allocator safe without `record_stream`: an entry's stream allocates
    only inside `run`, after its wait, and its blocks that another stream
    reads (the outputs) are freed by the calling thread outside `run`, so
    their reuse on the entry's stream follows every use issued on the
    current streams before it; a block of the current stream that an
    entry read is freed only after the current stream has waited for
    that entry.

    `intervals`: per entry, the host start and end of its last call, in
    seconds from the start of `run`."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]
        self._pools = [concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix=f"mesh-entry-{k}")
            for k in range(len(self.devices))]
        self.issue_lock = threading.Lock()
        self.intervals = []

    def run(self, fns) -> list:
        """fns[k]() on entry k's worker, all at once; their results."""
        t0 = time.perf_counter()
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(d))
        futures = [pool.submit(self._call, k, fn, t0)
                   for k, (pool, fn) in enumerate(zip(self._pools, fns))]
        concurrent.futures.wait(futures)
        for d, s in zip(self.devices, self.streams):
            if s is not None:
                torch.cuda.current_stream(d).wait_stream(s)
        errors = [e for e in (f.exception() for f in futures)
                  if e is not None]
        if errors:
            for e in errors[1:]:
                errors[0].add_note(f"another mesh entry failed: {e!r}")
            raise errors[0]
        results = [f.result() for f in futures]
        self.intervals = [iv for _, iv in results]
        return [r for r, _ in results]

    def _call(self, k: int, fn, t0: float):
        start = time.perf_counter() - t0
        if self.streams[k] is None:
            r = fn()
        else:
            with torch.cuda.device(self.devices[k]), \
                    torch.cuda.stream(self.streams[k]):
                r = fn()
        return r, (start, time.perf_counter() - t0)


@dataclasses.dataclass
class _Shard:
    """Mesh entry (i, j): the lanes from g0 and the bands from b0 (the
    encoder's block of lanes x bands), run by `stages` on its device."""
    name: str
    g0: int
    b0: int
    stages: FrameStages


@dataclasses.dataclass
class _PendingStep:
    outs: list                   # per shard, its `FrameStages.run` dict
    df: tuple                    # per plane, the G lanes' deblocked tiles
    qps: list                    # frame-level QP per lane
    band_qps: list               # per-lane [per-band QP] (fine RC)
    is_idr: bool
    run: RunConfig
    n_bands: int
    frame_num: int
    return_recon: bool
    transparent: list = None     # per-lane: emit an all-skip frame
    old_refs: list = None        # per shard, the reference predicted from
    is_intra: bool = True        # I or IDR
    ft_name: str = "IDR"
    lt_use: int = 0              # long-term policy for the slice headers
    lt_update: int = 0
    hdr_st_used: bool = False    # pre-marking DPB flags
    hdr_lt_in_use: bool = False


class GopBandEncoder:
    """G lockstep GOP lanes x B slice bands, batched on one device or
    split over a ("gop", "band") `mesh` (module docstring).

    Every lane is an independent H.264 stream (closed GOPs). All lanes
    share the frame schedule but carry their own rate-control state and
    reference pictures.

    `device`: None means the CUDA card (and raises without one); pass
    "cpu" to run the same code on the CPU. With a `mesh`, the devices are
    the mesh's and `device` stays None. `stage_times`: set it to a dict
    to have each stage synchronize the device and add its wall seconds
    under its name (pre, inter, select, sym, deblock, pack, ref, host);
    with a mesh the dict holds one such dict per shard ("shard i,j":
    pre .. pack, timed on the shard's own stream while the other shards
    run) beside "exchange" (the all-gather and the reference planes) and
    "host". With a mesh, `workers` (`ShardWorkers`) runs the shards and
    keeps their host intervals of the last step.
    """

    @property
    def stage_times(self):
        return self.timer.stage_times

    @stage_times.setter
    def stage_times(self, value):
        self.timer.stage_times = value
        if self.mesh is not None:
            for sh in self.shards:
                sh.stages.stage_times = (None if value is None else
                                         value.setdefault(sh.name, {}))

    def __init__(self, config: EncoderConfig, n_gop: int | None = None,
                 mesh: Mesh | None = None, idr_pic_id_base: int = 0,
                 per_lane_idr_pic_id: bool = False, device=None):
        cfg = config
        self.config = cfg
        self.n_gop = n_gop = (cfg.gop_parallel if n_gop is None else n_gop)
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.gop.Mesh (make_mesh), "
                            f"not {type(mesh).__name__}")
        if cfg.mb_height % cfg.slice_bands:
            raise ValueError("slice_bands must divide mb_height")
        if cfg.temporal_denoise_flag:
            raise ValueError(
                "GopBandEncoder does not support temporal denoising; "
                "pre-filter the input or use H264Encoder")
        self.n_bands = cfg.slice_bands
        self.band_rows = cfg.mb_height // cfg.slice_bands
        if mesh is None:
            grid = np.empty((1, 1), dtype=object)
            grid[0, 0] = resolve_device(device)
        else:
            if device is not None:
                raise ValueError("a mesh names its devices; leave device "
                                 "None")
            grid = mesh.devices
            if n_gop % grid.shape[0] or self.n_bands % grid.shape[1]:
                raise ValueError(
                    f"{n_gop} lanes x {self.n_bands} bands do not split over "
                    f"a {grid.shape[0]}x{grid.shape[1]} mesh: the lanes must "
                    f"divide by {grid.shape[0]} and the bands by "
                    f"{grid.shape[1]}")
        self.mesh = mesh
        self.device = grid[0, 0]
        gl, bl = n_gop // grid.shape[0], self.n_bands // grid.shape[1]
        self._block = (gl, bl)
        self._mesh_shape = grid.shape
        self.shards = [
            _Shard(f"shard {i},{j}", i * gl, j * bl,
                   FrameStages(grid[i, j], cfg.mb_width, bl * self.band_rows))
            for i in range(grid.shape[0]) for j in range(grid.shape[1])]
        self.stages = self.shards[0].stages
        # without a mesh the one shard runs in the caller's thread
        self.workers = None if mesh is None else ShardWorkers(
            grid.reshape(-1))
        if self.workers is not None:
            for sh, stream in zip(self.shards, self.workers.streams):
                sh.stages.stream = stream
                sh.stages.issue_lock = self.workers.issue_lock
        # without a mesh the one shard's timer also times `ref` and `host`
        self.timer = (self.stages if mesh is None
                      else StageTimer(*grid.reshape(-1)))
        # standalone lanes all use `idr_pic_id_base`; `encode_stream` sets
        # per_lane_idr_pic_id so lane g's IDR uses (base + g) mod 16
        self.idr_pic_id_base = idr_pic_id_base
        self.per_lane_idr_pic_id = per_lane_idr_pic_id
        self.max_cap_words = 1 << int(np.ceil(np.log2(
            self.band_rows * cfg.mb_width * WORDS_PER_MB)))
        # I/IDR frames pack at the spec worst-case bucket; P frames start at
        # a typical bucket and re-pack on overflow (finish_step)
        self.idr_cap_words = self.max_cap_words
        self.p_cap_words = max(
            1024, 1 << int(np.ceil(np.log2(
                self.band_rows * cfg.mb_width * 8 + 1))))
        self.frame_num = 0
        self.step_idx = 0
        # per shard, the previous-frame full-pel MV fields (Gl*Bl,
        # nmb_band), the ME's third candidate centre; None right after an
        # intra frame
        self._prev_mv = None
        self.rc = [RateControl(cfg.n_mb, cfg.gop, cfg.vbv_size_bytes, cfg.qp)
                   for _ in range(n_gop)]
        # reference slots, lane-batched: 0 = short-term, 1..N = long-term
        # (slot k holds LongTermFrameIdx k-1 on every lane); each slot is a
        # list of per-shard reference dicts, on the shards' devices
        self._refs = {}
        self._gop_pos = 0
        self._most_recent_idx = 0
        self._short_term_used = False
        self._lt_used = [False] * cfg.max_long_term_reference_frames
        self._force_transparent = [False] * n_gop
        self._sps = headers.SpsParams(
            width=cfg.width, height=cfg.height,
            mb_width=cfg.mb_width, mb_height=cfg.mb_height,
            sps_id=cfg.sps_id,
            num_ref_frames=1 + cfg.max_long_term_reference_frames,
            vbv_size_bytes=cfg.vbv_size_bytes)

    def encode_step(self, frames, run: RunConfig | None = None,
                    return_recon: bool = False):
        """Encode one frame on every lane. frames: list of G (y, u, v)
        uint8 planes. Returns list of G FrameResult."""
        return self.finish_step(
            self.encode_step_async(frames, run, return_recon))

    def _frame_type(self, run: RunConfig):
        """Frame-type -> long-term-slot policy shared by all lanes
        (reference `src/h264-lab.h:6726-6754`). Returns (ftype, lt_use,
        lt_update)."""
        cfg = self.config
        ftype = run.frame_type
        if ftype == FrameType.DEFAULT:
            if self.step_idx == 0 or not self._refs:
                ftype = FrameType.KEY
            elif cfg.gop and self._gop_pos >= cfg.gop:
                ftype = FrameType.KEY
            else:
                ftype = FrameType.P
        return long_term_policy(ftype, run, cfg.max_long_term_reference_frames,
                                self._most_recent_idx, self._refs)

    def _shard_frames(self, frames, sh: _Shard):
        """The shard's lanes, cut to its bands' rows (views)."""
        gl, bl = self._block
        y0, n = sh.b0 * self.band_rows, bl * self.band_rows
        return [tuple(p[y0 * t:(y0 + n) * t] for p, t in zip(f, (16, 8, 8)))
                for f in frames[sh.g0:sh.g0 + gl]]

    def _exchange(self, outs):
        """`refstate.exchange` for every gop row. Returns (per shard its
        lanes' reference planes, per plane the G lanes' deblocked
        whole-frame tiles)."""
        gl, n_band = self._block[0], self._mesh_shape[1]
        refs, df = [], ([], [], [])
        with self.timer.stage("ref" if self.mesh is None else "exchange"):
            for k in range(0, len(self.shards), n_band):
                row = range(k, k + n_band)
                r, tiles = refstate.exchange(
                    [outs[s]["df"] for s in row],
                    [self.shards[s].stages.device for s in row], gl,
                    self.config.mb_width, self.config.mb_height)
                refs += r
                for d, t in zip(df, tiles):
                    d.extend(t.unbind(0))
        return refs, df

    def encode_step_async(self, frames, run: RunConfig | None = None,
                          return_recon: bool = False) -> _PendingStep:
        """Queue the device work for one frame on every lane and return;
        `finish_step` waits for it and writes the bitstreams."""
        cfg = self.config
        run = run or RunConfig(qp_min=cfg.qp, qp_max=cfg.qp)
        G, B = self.n_gop, self.n_bands
        gl, bl = self._block
        if len(frames) != G:
            raise ValueError(f"expected {G} lane frames, got {len(frames)}")
        if run.encode_speed not in SPEEDS:
            raise NotImplementedError(
                f"encode_speed {run.encode_speed} turns deblocking off, and "
                "the JAX GOP encoder then still writes "
                "disable_deblocking_filter_idc 0 or 2 into its slice headers "
                "(h264lab_tpu/parallel/gop.py:434,544): a fault the port does "
                "not copy; H264Encoder runs these speeds")
        ftype, lt_use, lt_update = self._frame_type(run)
        is_idr = ftype == FrameType.KEY
        is_intra = ftype in (FrameType.KEY, FrameType.I)
        has_inter = not is_intra

        # VBV overflow policy per lane: the lane's frame is replaced by an
        # all-skip transparent frame in finish_step (the batched step still
        # computes it; its payload and reference are discarded)
        transparent = [self._force_transparent[g] and has_inter
                       and cfg.vbv_overflow_empty_frame_flag
                       for g in range(G)]
        self._force_transparent = [False] * G

        qmin = int(np.clip(run.qp_min, 10, 51))
        qmax = int(np.clip(run.qp_max, 10, 51))
        qps, band_qps = [], []
        for g in range(G):
            qp = self.rc[g].frame_start(is_intra, run.desired_frame_bytes,
                                        qmin, qmax)
            qps.append(qp)
            if cfg.fine_rate_control_flag and B > 1:
                band_qps.append(self.rc[g].band_qp_offsets(
                    B, is_intra, run.desired_frame_bytes, qmin, qmax))
            else:
                band_qps.append([qp] * B)
        qp_grid = np.asarray(band_qps, np.int32)                   # (G, B)

        # the previous-MV candidate is valid only on the short-term chain
        # (zeros otherwise)
        prev_mv = self._prev_mv if has_inter and lt_use == 0 else None
        ref_used = self._refs.get(max(lt_use, 0)) if has_inter else None
        cap = self.idr_cap_words if is_intra else self.p_cap_words
        tools = Toolset.for_speed(run.encode_speed, is_intra)

        def run_shard(k: int, sh: _Shard) -> dict:
            out = sh.stages.run(
                self._shard_frames(frames, sh), bl,
                qp_grid[sh.g0:sh.g0 + gl, sh.b0:sh.b0 + bl].reshape(-1),
                None if ref_used is None else ref_used[k],
                None if prev_mv is None else prev_mv[k], tools, cap,
                band0=sh.b0)
            for key in ("words", "nbits", "tail_val", "tail_len",
                        "sym_vals", "sym_lens"):
                out[key] = out[key].reshape((gl, bl) + out[key].shape[1:])
            return out

        if self.workers is None:
            outs = [run_shard(0, self.shards[0])]
        else:
            outs = self.workers.run([functools.partial(run_shard, k, sh)
                                     for k, sh in enumerate(self.shards)])
        new_refs, df = self._exchange(outs)

        # pre-marking DPB flags go into the slice headers (finish_step)
        hdr_st_used = self._short_term_used
        hdr_lt_in_use = (self._lt_used[lt_update - 1]
                         if lt_update > 0 else False)
        n_lt = cfg.max_long_term_reference_frames
        if is_idr:
            self._refs = {}
            self._short_term_used = False
            self._lt_used = [False] * n_lt
        # per shard, its lanes' transparent flags
        masks = [torch.as_tensor(transparent[sh.g0:sh.g0 + gl],
                                 device=sh.stages.device)
                 for sh in self.shards] if any(transparent) else None
        if lt_update >= 0:
            old_slot = self._refs.get(lt_update)
            if masks and old_slot is not None:
                # transparent lanes keep the slot's previous picture
                new_refs = [{k: torch.where(
                    m.reshape((gl,) + (1,) * (v.ndim - 1)), old[k], v)
                    for k, v in new.items()}
                    for m, old, new in zip(masks, old_slot, new_refs)]
            self._refs[lt_update] = new_refs
            self._most_recent_idx = lt_update
            if lt_update == 0:
                self._short_term_used = True
            else:
                self._lt_used[lt_update - 1] = True

        if is_intra or lt_use != 0:
            self._prev_mv = None
        else:
            new_prev = [(o["pmv_y"], o["pmv_x"]) for o in outs]
            if masks:
                # transparent lanes keep their previous MV field too
                old_prev = self._prev_mv or [
                    tuple(torch.zeros_like(x) for x in n) for n in new_prev]
                new_prev = [tuple(
                    torch.where(m.repeat_interleave(bl)[:, None], o, n)
                    for o, n in zip(old, new))
                    for m, old, new in zip(masks, old_prev, new_prev)]
            self._prev_mv = new_prev

        self.step_idx += 1
        self._gop_pos = 1 if is_idr else self._gop_pos + 1
        fn_use = 0 if is_idr else self.frame_num
        self.frame_num = (fn_use + 1) % (1 << headers.FRAME_NUM_BITS)
        return _PendingStep(outs=outs, df=df, qps=qps, band_qps=band_qps,
                            is_idr=is_idr, run=run, n_bands=B,
                            frame_num=fn_use, return_recon=return_recon,
                            transparent=transparent, old_refs=ref_used,
                            is_intra=is_intra,
                            ft_name=("IDR" if is_idr else
                                     ("I" if is_intra else "P")),
                            lt_use=lt_use, lt_update=lt_update,
                            hdr_st_used=hdr_st_used,
                            hdr_lt_in_use=hdr_lt_in_use)

    def finish_step(self, p: _PendingStep):
        """Wait for a dispatched step and write per-lane Annex-B bytes."""
        with self.timer.stage("host"):
            return self._finish_step(p)

    def _host(self, p: _PendingStep, key: str,
              n: int | None = None) -> np.ndarray:
        """Every shard's (Gl, Bl, ...) `key` on the host, joined into the
        (G, B, ...) array of the lanes and bands; with `n`, only the first
        n entries of the last axis are copied."""
        n_band = self._mesh_shape[1]
        parts = [(o[key] if n is None else o[key][..., :n]).cpu().numpy()
                 for o in p.outs]
        return np.concatenate([np.concatenate(parts[k:k + n_band], axis=1)
                               for k in range(0, len(parts), n_band)])

    def _finish_step(self, p: _PendingStep):
        cfg = self.config
        G, B = self.n_gop, p.n_bands
        gl = self._block[0]
        nbits = self._host(p, "nbits")                           # (G, B)
        # capacity overflow (P frames only; IDR packs at the spec
        # worst-case bucket): re-pack the kept symbol grids at a larger
        # bucket, no re-encode
        while (not p.is_intra
               and int(nbits.max(initial=0)) > 32 * self.p_cap_words):
            if self.p_cap_words >= self.max_cap_words:
                raise RuntimeError("packed stream exceeds spec bound")
            need = int(nbits.max()) // 32 + 2
            while self.p_cap_words < min(need * 2, self.max_cap_words):
                self.p_cap_words *= 2
            for o in p.outs:
                o["words"], o["nbits"] = bitpack.pack_frames(
                    o["sym_vals"], o["sym_lens"], self.p_cap_words)
            nbits = self._host(p, "nbits")
        # only the words that hold bits: (G, B, ceil(max nbits / 32))
        words = self._host(p, "words", (int(nbits.max(initial=0)) + 31) // 32)
        tails_v = self._host(p, "tail_val")
        tails_l = self._host(p, "tail_len")
        deblock_idc = 2 if B > 1 else 0
        n_band = self._mesh_shape[1]
        results = []
        for g in range(G):
            is_transparent = bool(p.transparent and p.transparent[g])
            payload = b""
            band_bytes = []
            if p.is_idr:
                payload += headers.sps_nal(self._sps)
                payload += headers.pps_nal(cfg.sps_id, 0, PIC_INIT_QP)
            if is_transparent:
                payload += self._transparent_nal(p.frame_num, p.qps[g])
            else:
                for b in range(B):
                    nal = self._slice_nal(p, g, b, words[g, b],
                                          int(nbits[g, b]),
                                          int(tails_v[g, b]),
                                          int(tails_l[g, b]), deblock_idc)
                    payload += nal
                    band_bytes.append(len(nal))
            actions = self.rc[g].frame_end(
                p.is_intra, len(payload), p.run.desired_frame_bytes,
                band_bytes=band_bytes or None)
            if (actions["stuffing_bytes"]
                    and cfg.vbv_underflow_stuffing_flag):
                payload += filler_nal(actions["stuffing_bytes"])
            if actions["overflow"]:
                self._force_transparent[g] = True
            recon = None
            if p.return_recon:
                if is_transparent:
                    # recon == the lane's (unchanged) reference picture,
                    # held by the first shard of its gop row
                    ref = p.old_refs[g // gl * n_band]
                    gy, gc = qpel.GUARD, qpel.GUARD // 2
                    planes = [ref[k][g % gl, gd:-gd, gd:-gd].cpu().numpy()
                              for k, gd in (("y_pad", gy), ("u_pad", gc),
                                            ("v_pad", gc))]
                else:
                    planes = [wavefront.tiles_to_plane(
                        d[g].cpu().numpy(), cfg.mb_height, cfg.mb_width)
                        for d in p.df]
                recon = (planes[0][:cfg.height, :cfg.width],
                         planes[1][:cfg.height // 2, :cfg.width // 2],
                         planes[2][:cfg.height // 2, :cfg.width // 2])
            results.append(FrameResult(payload=payload, frame_type=p.ft_name,
                                       qp=p.qps[g], recon=recon))
        return results

    def _slice_nal(self, p: _PendingStep, g: int, b: int, words, mb_bits: int,
                   tail_val: int, tail_len: int, deblock_idc: int) -> bytes:
        """One band's slice NAL: header, the packed MB bits, the trailing
        skip run and the RBSP trailing bits."""
        cfg = self.config
        bw = BitWriter(capacity=1 << 16)
        shp = headers.SliceHeaderParams(
            slice_type=(headers.SLICE_TYPE_I if p.is_intra
                        else headers.SLICE_TYPE_P),
            is_idr=p.is_idr,
            frame_num=p.frame_num,
            first_mb=b * self.band_rows * cfg.mb_width,
            pps_id=cfg.sps_id * 4,
            idr_pic_id=(self.idr_pic_id_base
                        + (g if self.per_lane_idr_pic_id else 0)) % 16,
            slice_qp=p.band_qps[g][b],
            pic_init_qp=PIC_INIT_QP,
            disable_deblocking_filter_idc=deblock_idc,
            long_term_idx_use=(max(p.lt_use, 0) if not p.is_intra else 0),
            long_term_idx_update=p.lt_update,
            short_term_used=p.hdr_st_used,
            lt_slot_in_use=p.hdr_lt_in_use,
            max_long_term_frames=cfg.max_long_term_reference_frames)
        headers.write_slice_header_rbsp(bw, shp)
        bw.append_words(words, mb_bits)
        if tail_len:
            bw.u(tail_len, tail_val & 0xFFFFFFFF)
        bw.rbsp_trailing_bits()
        ref_idc, nal_type = headers.slice_nal_header_byte(shp)
        return annexb_nal(ref_idc, nal_type, bw.to_bytes())

    def _transparent_nal(self, frame_num: int, qp: int) -> bytes:
        """All-skip P frame for one lane: one slice covering the picture,
        whose reconstruction equals the reference picture exactly."""
        cfg = self.config
        bw = BitWriter()
        shp = headers.SliceHeaderParams(
            slice_type=headers.SLICE_TYPE_P,
            is_idr=False,
            frame_num=frame_num,
            pps_id=cfg.sps_id * 4,
            slice_qp=qp,
            pic_init_qp=PIC_INIT_QP,
            disable_deblocking_filter_idc=1,
            long_term_idx_update=0,
            max_long_term_frames=cfg.max_long_term_reference_frames)
        headers.write_slice_header_rbsp(bw, shp)
        bw.ue(cfg.n_mb)          # mb_skip_run covering the whole picture
        bw.rbsp_trailing_bits()
        ref_idc, nal_type = headers.slice_nal_header_byte(shp)
        return annexb_nal(ref_idc, nal_type, bw.to_bytes())


def encode_stream(frames, config: EncoderConfig, n_gop: int | None = None,
                  run: RunConfig | None = None, mesh: Mesh | None = None,
                  device=None):
    """Encode a frame sequence with GOP-parallel lanes and return the
    in-order Annex-B stream. Lane g takes GOP g, g+n_gop, ...; with fixed
    QP the output equals sequential encoding. With a `mesh`, every group
    of lanes must split over it, the last one too (JAX's `device_put`
    refuses a last group of fewer lanes than the mesh's gop axis divides:
    `ValueError`, as here)."""
    cfg = config
    n_gop = cfg.gop_parallel if n_gop is None else n_gop
    gop = cfg.gop or len(frames)
    n_gops_total = (len(frames) + gop - 1) // gop
    chunks = [frames[i * gop:(i + 1) * gop] for i in range(n_gops_total)]
    payloads = [[] for _ in range(n_gops_total)]
    for base in range(0, n_gops_total, n_gop):
        group = chunks[base:base + n_gop]
        enc = GopBandEncoder(cfg, n_gop=len(group), mesh=mesh,
                             idr_pic_id_base=base % 16,
                             per_lane_idr_pic_id=True, device=device)
        for t in range(max(len(c) for c in group)):
            lanes = [c[min(t, len(c) - 1)] for c in group]
            results = enc.encode_step(lanes, run)
            for gi, r in enumerate(results):
                if t < len(group[gi]):
                    payloads[base + gi].append(r.payload)
    return b"".join(b"".join(p) for p in payloads)
