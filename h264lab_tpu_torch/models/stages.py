"""The device stages of one encode step, shared by the two encoders.

`H264Encoder` (one frame, cut into B slice bands) and `GopBandEncoder`
(G lanes of one frame each, every frame cut into B bands) run the same
stages over a leading axis of N = G * B bands:

  pre      upload the planes (numpy ones through pinned memory,
           `Staging`) and pad and tile them into band MB tiles
           (`source_tiles`: on the card one launch of K12);
  inter    P frames: motion search, partitions, chroma MC, inter TQ
           (`mbscan.inter_stage_core`);
  select   mode selection and intra TQ (`mbscan.select_stage_core`);
  sym      CAVLC symbolization (`mbscan.symbolize`);
  deblock  the in-loop filter, or the recon itself at speeds 8 and 10;
  pack     the bit-pack kernel K1 (`bitpack.pack_frames`);
  ref      the next reference planes and MV candidates.

In the JAX package these are `mbscan.encode_frame_banded_staged` and
`parallel/gop.py` `_gop_banded_staged`. `stage_times`, when set to a dict,
makes each stage synchronize the device (a mesh shard: its own stream)
and add its wall seconds under its name.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import time

import numpy as np
import torch

from h264lab_tpu_torch.models import mbscan, refstate, wavefront
from h264lab_tpu_torch.ops import bitpack, pretile, tables


@dataclasses.dataclass(frozen=True)
class Toolset:
    """What an encode speed turns on (the reference's speed presets)."""
    enable_i4x4: bool          # Intra_4x4 (always on I frames)
    enable_partitions: bool    # 16x8 / 8x16 / 8x8 inter partitions
    enable_qpel: bool          # quarter-pel ME (else full-pel)
    enable_deblock: bool       # in-loop deblocking

    @classmethod
    def for_speed(cls, encode_speed: int, is_intra: bool) -> "Toolset":
        return cls(enable_i4x4=is_intra or encode_speed < 2,
                   enable_partitions=encode_speed < 1,
                   enable_qpel=encode_speed < 9,
                   enable_deblock=encode_speed not in (8, 10))


def pad_to(planes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Edge-replicate (G, h0, w0) planes to (G, h, w) (`wavefront.pad_plane`
    on the device)."""
    h0, w0 = planes.shape[-2:]
    dev = planes.device
    iy = torch.arange(h, device=dev).clamp(max=h0 - 1)
    ix = torch.arange(w, device=dev).clamp(max=w0 - 1)
    return planes.index_select(-2, iy).index_select(-1, ix)


def source_tiles(planes, mb_width: int, mb_height: int):
    """The `pre` stage's tiling: planes (Y, U, V), each G 2-D uint8 planes
    of one shape on one device (at most the padded size, else cropped),
    edge-replicated to the padded (mb_height t, mb_width t) and cut into
    (G, mb_width mb_height, t, t) MB tiles in raster order (t = 16, 8, 8).
    On CUDA tensors one launch of K12 (`pretile.tiles_k12`; a plane whose
    rows are not contiguous copied first); on CPU tensors
    `source_tiles_plain`."""
    if planes[0][0].device.type == "cpu":
        return source_tiles_plain(planes, mb_width, mb_height)
    return pretile.tiles_k12(tuple(tuple(_rows(x) for x in lanes)
                                   for lanes in planes), mb_width, mb_height)


def _rows(plane):
    """A plane as K12 takes it: itself where its rows are contiguous (any
    pitch), else a contiguous copy."""
    h, w = plane.shape
    if (w > 1 and plane.stride(1) != 1) or (h > 1 and plane.stride(0) < w):
        return plane.contiguous()
    return plane


def source_tiles_plain(planes, mb_width: int, mb_height: int):
    """`source_tiles` in plain PyTorch, the reference K12 is held against:
    the lanes stacked, `pad_to` and the tiling."""
    out = []
    for lanes, t in zip(planes, (16, 8, 8)):
        p = pad_to(torch.stack(list(lanes)), mb_height * t, mb_width * t)
        out.append(p.reshape(len(lanes), mb_height, t, mb_width, t)
                   .permute(0, 1, 3, 2, 4).reshape(len(lanes), -1, t, t))
    return tuple(out)


class Staging:
    """Uploads of frames' planes to `device`, the one way numpy planes
    reach it (`FrameStages.tiles`, `H264Encoder._device_planes`).

    `upload(frames)` takes G (y, u, v) planes, numpy arrays or tensors,
    and returns them as 2-D uint8 tensors on the device: a tensor there as
    it is, one on another card copied, and every numpy plane (or CPU
    tensor) copied once on the host, straight into its lane's slot of a
    staging buffer, then, on a card, sent with one non-blocking `copy_`
    on the current stream into a fresh device buffer that the returned
    planes are views of (contiguous, each 16-byte aligned). On a card the
    staging buffers are pinned host memory: two that alternate, each with
    a CUDA event recorded after its copy, which the host waits for before
    it writes into that buffer again, so that a step dispatched before
    the last one is finished (`encode_step_async`) never overwrites bytes
    still in flight. The buffers grow together (each waited for first),
    so that the step after the first does not pin memory again. A failed
    pin, copy or event raises; there is no pageable fallback. On the CPU
    the staging buffers are plain memory and the returned planes a copy of
    them (the same slots and layout). The host copies of a fill of at
    least `PARALLEL_BYTES` run on `threads` threads of the staging's own
    pool (numpy releases the interpreter lock while it copies).

    `fill` (the host copy) and `send` (the device buffer and its copy)
    are `upload`'s two halves, timed apart by `chip_smoke.py`. One
    `Staging` serves one thread (each mesh entry's `FrameStages` has its
    own, on its own stream)."""

    SLOTS = 2
    PARALLEL_BYTES = 8 << 20
    threads = 4

    def __init__(self, device):
        self.device = torch.device(device)
        self._pool = None
        self._host = [None] * self.SLOTS
        self._events = [None] * self.SLOTS
        self._next = 0

    def upload(self, frames) -> list:
        """G (y, u, v) planes on the device (class docstring)."""
        return self.send(self.fill(frames))

    def fill(self, frames):
        """The host half of `upload`: the planes to stage copied into the
        next staging buffer (after waiting for its last copy). Returns
        what `send` takes."""
        dev = self.device
        out = [list(f) for f in frames]
        jobs, at = [], 0
        for g, f in enumerate(frames):
            for p, x in enumerate(f):
                if isinstance(x, torch.Tensor):
                    if x.device.type != "cpu" or dev.type == "cpu":
                        out[g][p] = x.to(dev)   # itself where it is
                        continue
                    x = x.numpy()
                a = np.asarray(x)
                if a.ndim != 2:
                    raise ValueError(f"lane {g} plane {p} of shape "
                                     f"{a.shape}, not (h, w)")
                jobs.append((g, p, a, at))
                at += -(-a.size // 16) * 16
        if not jobs:
            return out, None, []
        k = self._next
        self._next = (k + 1) % self.SLOTS
        self._wait(k)
        if self._host[k] is None or self._host[k].numel() < at:
            size = -(-at // (1 << 20)) << 20
            for j in range(self.SLOTS):
                self._wait(j)
                self._host[j] = None
                self._host[j] = torch.empty(size, dtype=torch.uint8,
                                            pin_memory=dev.type == "cuda")
        h = self._host[k].numpy()

        def copy(job):
            _, _, a, off = job
            np.copyto(h[off:off + a.size].reshape(a.shape), a,
                      casting="unsafe")
        if self.threads > 1 and len(jobs) > 1 and at >= self.PARALLEL_BYTES:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    self.threads, thread_name_prefix="staging")
            list(self._pool.map(copy, jobs))
        else:
            for job in jobs:
                copy(job)
        return out, (k, at), jobs

    def _wait(self, k: int):
        """Wait for staging buffer k's last copy."""
        if self._events[k] is not None:
            self._events[k].synchronize()
            self._events[k] = None

    def send(self, filled) -> list:
        """The device half of `upload`: the staged bytes into a fresh
        device buffer (one non-blocking copy on the current stream, its
        event recorded), and the planes as views of it."""
        out, slot, jobs = filled
        if slot is not None:
            k, at = slot
            host = self._host[k][:at]
            if self.device.type == "cuda":
                buf = torch.empty(at, dtype=torch.uint8, device=self.device)
                buf.copy_(host, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(buf.device))
                self._events[k] = event
            else:
                buf = host.clone()
            for g, p, a, off in jobs:
                out[g][p] = buf[off:off + a.size].view(a.shape)
        return [tuple(f) for f in out]


class StageTimer:
    """Named stages on `device` (and on the `more` devices a stage also
    uses): `stage(name)` brackets one (module docstring).

    A mesh shard's stages (`parallel/gop.ShardWorkers`) set two more:
    `stream`, the one CUDA stream they are issued on, which the timer then
    synchronizes alone, so that the other shards on the card do not
    count; and `issue_lock`, which each stage holds while it is issued
    and timed, so that one shard issues at a time (`ShardWorkers`)."""

    def __init__(self, device: torch.device, *more: torch.device):
        self.device = device
        self._sync_devices = list(dict.fromkeys(
            d for d in (device,) + more if d.type == "cuda"))
        self.stage_times = None
        self.stream = None
        self.issue_lock = None

    @contextlib.contextmanager
    def stage(self, name: str):
        """Bracket a stage for `torch.profiler` and, with `stage_times`
        set, time it between device synchronizations."""
        with self.issue_lock or contextlib.nullcontext(), \
                torch.profiler.record_function(f"stage:{name}"):
            if self.stage_times is None:
                yield
                return
            self._sync()
            t0 = time.perf_counter()
            yield
            self._sync()
            self.stage_times[name] = (self.stage_times.get(name, 0.0)
                                      + time.perf_counter() - t0)

    def _sync(self):
        if self.stream is not None:
            self.stream.synchronize()
            return
        for d in self._sync_devices:
            torch.cuda.synchronize(d)


class FrameStages(StageTimer):
    """The stages of one step on `device` for frames of mb_width x
    mb_height MBs (module docstring)."""

    def __init__(self, device: torch.device, mb_width: int, mb_height: int):
        super().__init__(device)
        self.mb_width = mb_width
        self.mb_height = mb_height
        self._plans = {}
        self.staging = Staging(device)

    def tiles(self, frames):
        """The `pre` stage of G frames (`run`'s frames): their planes
        uploaded (`Staging`) and cut into (G, nmb, t, t) tiles of the
        padded picture (`source_tiles`: on a card one launch of K12)."""
        planes = self.staging.upload(frames)
        return source_tiles(tuple(zip(*planes)), self.mb_width,
                            self.mb_height)

    def plan(self, band_rows: int):
        """(steps, avail_top, avail_left) of a band: the slope-2 wavefront
        plan (Intra_4x4's top-right dependency) and the in-band neighbour
        availability of each MB."""
        if band_rows not in self._plans:
            nmb = band_rows * self.mb_width
            r = np.arange(nmb) // self.mb_width
            c = np.arange(nmb) % self.mb_width
            self._plans[band_rows] = (
                wavefront.make_plan(self.mb_width, band_rows, 2).steps,
                r > 0, c > 0)
        return self._plans[band_rows]

    def run(self, frames, n_bands: int, qp: np.ndarray, ref, prev_mv,
            tools: Toolset, cap_words: int | None = None,
            svc_base_mode_bit: bool = False,
            band0: int | None = None) -> dict:
        """Encode G frames of B = n_bands equal bands each.

        frames: G (y, u, v) uint8 planes, numpy arrays or tensors on the
        device, at most the padded size (edge-replicated up to it); qp: the
        (G * B,) band QPs, or a (G * B, band_rows) per-row plan (fine rate
        control through `mb_qp_delta`, parallel P path only); ref: the
        lanes' reference planes (`refstate.prepare_reference`, leading G)
        or None for I frames; prev_mv: the (G * B, nmb_band) full-pel MV
        candidates (pair) or None; cap_words: the packed capacity of every
        band, or None to read the bands' bits and pack at the bucket of the
        largest; svc_base_mode_bit: `mbscan.symbolize`'s flag (an SVC
        enhancement layer with inter-layer prediction); band0: None for
        whole frames, or, for a mesh shard, the global index of the first
        band of a block of bands: the frames are then the block's rows
        (mb_height of this `FrameStages` is the block's), ref still the
        lanes' whole reference pictures, and the `ref` stage is left to
        the caller (`refstate.exchange`, which needs every band of a lane).

        Returns a dict: per band (leading G * B) words, nbits (the packed
        bits), mb_bits and tail_val/tail_len (host numpy with cap_words
        None, else device), row_bits, sym_vals, sym_lens; per lane
        (leading G) refs (dict), df and recon (3-tuples of (nmb, t, t)
        tiles, deblocked and not); pmv_y/pmv_x the next step's MV
        candidates; cap_words. With band0 set, df holds the deblocked
        band tiles (leading G * B) and there is no refs or recon."""
        G, B = len(frames), n_bands
        dev = self.device
        mbw = self.mb_width
        rows = self.mb_height // B
        N, nmb = G * B, rows * mbw
        has_inter = ref is not None
        qp_np = np.asarray(qp, np.int32)

        with self.stage("pre"):
            # (G, H / t * W / t, t, t) -> (G*B, nmb, t, t): band rows are
            # contiguous
            src = [x.reshape(N, nmb, t, t) for x, t in
                   zip(self.tiles(frames), (16, 8, 8))]
            qpt = torch.as_tensor(qp_np, device=dev)
            qpc = torch.as_tensor(tables.QPC_FROM_QPY[qp_np], device=dev)
            lane = torch.arange(G, device=dev).repeat_interleave(B)
            row0 = ((band0 or 0) + torch.arange(B, dtype=torch.int32,
                                                 device=dev)) * rows
            row0 = row0.repeat(G)
        steps, a_top, a_left = self.plan(rows)
        inter = None
        if has_inter:
            with self.stage("inter"):
                if prev_mv is None:
                    z = torch.zeros((N, nmb), dtype=torch.int32, device=dev)
                    prev_mv = (z, z)
                inter = mbscan.inter_stage_core(
                    src[0], src[1], src[2], ref, lane, qpt, qpc, row0,
                    prev_mv[0], prev_mv[1], mbw, rows,
                    enable_partitions=tools.enable_partitions,
                    enable_qpel=tools.enable_qpel)
        with self.stage("select"):
            st = mbscan.select_stage_core(
                src[0], src[1], src[2], qpt, qpc, steps, a_top, a_left,
                inter, mbw, rows, enable_i4x4=tools.enable_i4x4)
        del inter                # its recon planes are not needed past here
        with self.stage("sym"):
            sym = mbscan.symbolize(
                st["sel"], st["mode16"], st["cmode"], st["i4sym_v"],
                st["i4sym_l"], st["mv4_y"], st["mv4_x"], st["shape"],
                st["dc_lev"], st["ac_lev"], st["lev_inter"], st["cdc_lev"],
                st["cac_lev"], mbw, rows, has_inter,
                qp_rows=qpt if qpt.ndim == 2 else None,
                svc_base_mode_bit=svc_base_mode_bit)
        recon = (st["recon_y"], st["recon_u"], st["recon_v"])
        if tools.enable_deblock:
            with self.stage("deblock"):
                if "qp_dec" in sym:       # the decoded per-MB QPs
                    qp_db = sym["qp_dec"]
                    qpc_db = torch.as_tensor(tables.QPC_FROM_QPY,
                                             device=dev)[qp_db.long()]
                else:
                    qp_db, qpc_db = qpt, qpc
                df = mbscan.deblock_stage_core(
                    *recon, st["sel"], st["lev_inter"], st["mv4_y"],
                    st["mv4_x"], qp_db, qpc_db, a_top, a_left, mbw, rows)
        else:
            df = recon
        out = dict(row_bits=sym["row_bits"], sym_vals=sym["sym_vals"],
                   sym_lens=sym["sym_lens"], tail_val=sym["tail_val"],
                   tail_len=sym["tail_len"])
        with self.stage("pack"):
            if cap_words is None:
                # one read of every band's bits sizes the bucket
                bits = torch.stack([sym["total_bits"],
                                    sym["tail_len"]]).cpu().numpy()
                out["mb_bits"] = bits[0] - bits[1]
                out["tail_val"] = sym["tail_val"].cpu().numpy()
                out["tail_len"] = bits[1]
                cap_words = bitpack.bucket_words(int(out["mb_bits"].max()))
            out["words"], out["nbits"] = bitpack.pack_frames(
                sym["sym_vals"], sym["sym_lens"], cap_words)
            out["cap_words"] = cap_words
        if band0 is not None:
            out["df"] = df
            out["pmv_y"], out["pmv_x"] = st["mv_y"] >> 2, st["mv_x"] >> 2
            return out
        with self.stage("ref"):
            out["refs"], out["df"], out["pmv_y"], out["pmv_x"] = \
                refstate.ref_stage(*df, st["mv_y"], st["mv_x"], G, mbw,
                                   self.mb_height)
            out["recon"] = tuple(x.reshape((G, -1) + x.shape[2:])
                                 for x in recon)
        return out
