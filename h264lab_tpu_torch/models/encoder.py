"""H264Encoder — the sequential single-stream encoder, and the per-frame
result type and stream constants shared with the GOP-lane encoder.

PyTorch counterpart of `h264lab_tpu/models/encoder.py`: IDR, I and P
frames with every speed preset (partitions, Intra_4x4 in P, quarter- or
full-pel ME, deblocking on or off), the long-term reference policy,
multi-slice bands sized from `desired_nalu_bytes` and enforced by rolling a
frame back and re-encoding it with more slices, two-level rate control
(per-band QPs, and per-row QPs through `mb_qp_delta`) with VBV filler and
transparent frames, temporal denoising, a host-side state snapshot, and
the SVC enhancement-layer syntax that `models/svc.py` turns on. Frames
are numpy planes or uint8 tensors (SvcEncoder passes planes it keeps on
the device). The device stages are `models/stages.py`'s; every frame's
bands are packed by one launch of the bit-pack kernel K1 on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from h264lab_tpu_torch.bitstream import BitWriter, headers
from h264lab_tpu_torch.bitstream.nal import annexb_nal
from h264lab_tpu_torch.config import EncoderConfig, FrameType, RunConfig
from h264lab_tpu_torch.models import wavefront
from h264lab_tpu_torch.models.stages import FrameStages, Toolset
from h264lab_tpu_torch.ops import denoise
from h264lab_tpu_torch.rc.ratecontrol import RateControl, filler_nal
from h264lab_tpu_torch.utils.device import resolve_device

PIC_INIT_QP = 26


@dataclasses.dataclass
class FrameResult:
    payload: bytes                  # Annex-B bytes for this frame
    frame_type: str                 # "IDR" | "I" | "P"
    qp: int
    recon: tuple | None = None      # (y, u, v) deblocked recon if requested
    recon_unfiltered: tuple | None = None


def long_term_policy(ftype: FrameType, run: RunConfig, n_lt: int,
                     most_recent_idx: int, refs: dict):
    """The reference-slot policy of a frame type (reference
    `src/h264-lab.h:6726-6754`): returns (ftype, lt_use, lt_update), the
    slot predicted from (-1 = intra) and the slot written (-1 = none; 0 =
    short-term, k = long-term index k - 1). A frame without a usable
    reference becomes an IDR."""
    if ftype == FrameType.I:
        lt_use, lt_update = -1, 0
    elif ftype == FrameType.KEY:
        lt_use, lt_update = -1, (1 if n_lt > 0 else 0)
    elif ftype == FrameType.GOLDEN:
        lt_use, lt_update = 1, 1
    elif ftype == FrameType.RECOVERY:
        lt_use, lt_update = 1, 0
    elif ftype == FrameType.DROPPABLE:
        lt_use, lt_update = most_recent_idx, -1
    elif ftype == FrameType.CUSTOM:
        lt_use = run.long_term_idx_use or most_recent_idx
        lt_update = run.long_term_idx_update
        if lt_use < 0:
            ftype = FrameType.KEY
            lt_update = 1 if n_lt > 0 else 0
    else:  # P
        lt_use, lt_update = most_recent_idx, 0
    if ftype not in (FrameType.KEY, FrameType.I) \
            and refs.get(max(lt_use, 0)) is None:
        ftype = FrameType.KEY                # no usable reference yet
        lt_use, lt_update = -1, (1 if n_lt > 0 else 0)
    return ftype, lt_use, lt_update


@dataclasses.dataclass
class PendingFrame:
    """An encoded frame whose Annex-B bytes are not written yet (see
    `encode_async`)."""
    out: dict                       # the stage driver's output
    run: RunConfig
    band_hdrs: list                 # per band (BitWriter, slice header)
    sps_pps: bytes
    qp: int
    is_intra: bool
    ft_name: str
    return_recon: bool
    # NALU-size enforcement (desired_nalu_bytes): the original inputs and a
    # snapshot of the state before the frame, so finish() can roll back and
    # re-encode the frame with more slices when a NALU overflows
    inputs: tuple = None
    rollback: dict = None


def host_planes(tiles, cfg: EncoderConfig):
    """(y, u, v) MB tiles (nmb, t, t) -> cropped host planes."""
    h, w = cfg.height, cfg.width
    out = [wavefront.tiles_to_plane(np.asarray(t), cfg.mb_height,
                                    cfg.mb_width) for t in tiles]
    return (out[0][:h, :w], out[1][:h // 2, :w // 2],
            out[2][:h // 2, :w // 2])


class H264Encoder:
    """Stream-level encoder: IDR/I/P frames (Intra_16x16, Intra_4x4, inter
    16x16/16x8/8x16/8x8 with quarter-pel ME), long-term reference
    policies, multi-slice bands, two-level rate control with VBV, temporal
    denoising and in-loop deblocking; the single-stream counterpart of
    `parallel.gop.GopBandEncoder`.

    `device`: None means the CUDA card (and raises without one); pass
    "cpu" to run the same code on the CPU. `stage_times`: set it to a dict
    to have each stage synchronize the device and add its wall seconds
    under its name (`models/stages.py`; `host` is `finish`).
    """

    def __init__(self, config: EncoderConfig, device=None):
        cfg = self.config = config
        self.device = resolve_device(device)
        self.stages = FrameStages(self.device, cfg.mb_width, cfg.mb_height)
        self.frame_num = 0
        self.idr_pic_id = 0
        self.frames_encoded = 0
        self._gop_pos = 0
        self._ref = None      # the most recent reference planes
        # reference slots: 0 = short-term, 1..N = long-term (slot k holds
        # LongTermFrameIdx k-1), each `refstate.prepare_reference` planes
        # with a leading axis of 1
        self._refs = {}
        self._most_recent_idx = 0
        self._short_term_used = False
        self._lt_used = [False] * cfg.max_long_term_reference_frames
        self._last_tiles = None       # the last frame's deblocked tiles
        # the previous P frame's full-pel MV field (n_bands, my, mx), each
        # (n_bands, nmb_band): the ME's third candidate centre, kept only
        # for the same band count
        self._prev_mv = None
        self._force_transparent = False
        self._last_frame_bytes = 0
        self._in_flight = 0           # encoded frames not yet finished
        self._denoise_prev = None     # the previous denoised planes
        # set by SvcEncoder on its enhancement layer when
        # inter_layer_pred_flag is on: slices carry the scalable-extension
        # header tail and P frames a base_mode_flag bit per coded MB
        self._svc_ext = False
        self.rc = RateControl(cfg.n_mb, cfg.gop, cfg.vbv_size_bytes, cfg.qp)
        self._sps = headers.SpsParams(
            width=cfg.width, height=cfg.height,
            mb_width=cfg.mb_width, mb_height=cfg.mb_height,
            sps_id=cfg.sps_id,
            num_ref_frames=1 + cfg.max_long_term_reference_frames,
            vbv_size_bytes=cfg.vbv_size_bytes)
        self._pps_id = cfg.sps_id * 4

    @property
    def stage_times(self):
        return self.stages.stage_times

    @stage_times.setter
    def stage_times(self, value):
        self.stages.stage_times = value

    # ------------------------------------------------------------------
    def _frame_type(self, run: RunConfig) -> FrameType:
        if run.frame_type != FrameType.DEFAULT:
            return run.frame_type
        gop = self.config.gop
        if self.frames_encoded == 0 or self._ref is None:
            return FrameType.KEY
        if gop and self._gop_pos >= gop:
            return FrameType.KEY
        return FrameType.P

    def _bands(self, run: RunConfig, force: int | None = None):
        """Slice bands as (first_mb_row, n_rows): cfg.slice_bands, or more
        from desired_nalu_bytes and the previous frame's size; `finish`
        enforces the bound by re-encoding with `force` bands. The count
        snaps to a divisor of mb_height (all bands equal): down from the
        estimate, up from `force`, so re-encodes never lose slices."""
        cfg = self.config
        if force is not None:
            n = max(1, min(force, cfg.mb_height))
            while cfg.mb_height % n:   # smallest divisor >= requested
                n += 1
        else:
            n = cfg.slice_bands
            nalu = run.desired_nalu_bytes or cfg.desired_nalu_bytes
            if nalu > 0 and self._last_frame_bytes:
                est = max(1, round(self._last_frame_bytes / nalu))
                n = max(n, min(est, cfg.mb_height))
            n = max(1, min(n, cfg.mb_height))
            while cfg.mb_height % n:   # largest divisor <= requested
                n -= 1
        rows = cfg.mb_height // n
        return [(i * rows, rows) for i in range(n)]

    def _device_planes(self, y, u, v) -> tuple:
        """A frame's planes on the device, numpy ones uploaded through the
        stages' pinned staging (`stages.Staging`)."""
        return self.stages.staging.upload([(y, u, v)])[0]

    # ------------------------------------------------------------------
    def encode(self, y, u, v, run: RunConfig | None = None,
               return_recon: bool = False) -> FrameResult:
        """Encode one frame: `encode_async` then `finish`."""
        return self.finish(self.encode_async(y, u, v, run, return_recon))

    def encode_async(self, y, u, v, run: RunConfig | None = None,
                     return_recon: bool = False,
                     _force_bands: int | None = None) -> PendingFrame:
        """Run the device stages of one frame, K1 included, and return
        before the bytes are written (`finish`). With desired_nalu_bytes
        set, `finish` may roll the stream state back and re-encode the
        frame with more slices, so finish each frame before the next."""
        cfg = self.config
        run = run or RunConfig(qp_min=cfg.qp, qp_max=cfg.qp)

        nalu_target = run.desired_nalu_bytes or cfg.desired_nalu_bytes
        rollback = None
        inputs = None
        if nalu_target > 0:
            inputs = (y, u, v)
            rollback = dict(
                frame_num=self.frame_num, idr_pic_id=self.idr_pic_id,
                frames_encoded=self.frames_encoded, gop_pos=self._gop_pos,
                refs=dict(self._refs), ref=self._ref,
                most_recent=self._most_recent_idx,
                short_term=self._short_term_used,
                lt_used=list(self._lt_used),
                last_tiles=self._last_tiles, prev_mv=self._prev_mv,
                denoise_prev=self._denoise_prev,
                force_transparent=self._force_transparent,
                last_frame_bytes=self._last_frame_bytes)

        n_lt = cfg.max_long_term_reference_frames
        ftype, lt_use, lt_update = long_term_policy(
            self._frame_type(run), run, n_lt, self._most_recent_idx,
            self._refs)
        is_idr = ftype == FrameType.KEY
        is_intra_frame = ftype in (FrameType.KEY, FrameType.I)

        # VBV overflow policy: replace this frame with an all-skip
        # "transparent" frame (reference `src/h264-lab.h:6497-6508`)
        if (self._force_transparent and not is_intra_frame
                and cfg.vbv_overflow_empty_frame_flag):
            self._force_transparent = False
            return self._encode_transparent(run, return_recon)

        qmin = int(np.clip(run.qp_min, 10, 51))
        qmax = int(np.clip(run.qp_max, 10, 51))
        qp = self.rc.frame_start(is_intra_frame, run.desired_frame_bytes,
                                 qmin, qmax)
        bands = self._bands(run, force=_force_bands)
        n_bands = len(bands)
        # fine rate control: per-band QP offsets over several bands, or
        # per-MB-row QPs through mb_qp_delta on one band of a P frame on
        # the parallel path (speed >= 2)
        if cfg.fine_rate_control_flag and n_bands > 1:
            band_qps = self.rc.band_qp_offsets(
                n_bands, is_intra_frame, run.desired_frame_bytes, qmin, qmax)
        else:
            band_qps = [qp] * n_bands
        qp_arg = np.asarray(band_qps, np.int32)
        if (cfg.fine_rate_control_flag and n_bands == 1
                and not is_intra_frame and run.encode_speed >= 2
                and run.desired_frame_bytes > 0):
            row_plan = self.rc.row_qp_offsets(
                cfg.mb_height, False, run.desired_frame_bytes, qmin, qmax)
            if any(q != row_plan[0] for q in row_plan):
                band_qps = [row_plan[0]]     # slice_qp = first row's QP
                qp_arg = np.asarray([row_plan], np.int32)

        # temporal denoise pre-filter (reference gating: flag set and
        # speed < 2, `src/h264-lab.h:6684-6697`; on the card one launch of
        # K13 for the three planes)
        if cfg.temporal_denoise_flag and run.encode_speed < 2:
            with self.stages.stage("denoise"):
                planes = self._device_planes(y, u, v)
                if self._denoise_prev is not None:
                    planes = denoise.denoise_planes(planes,
                                                    self._denoise_prev)
            self._denoise_prev = planes
            y, u, v = planes

        tools = Toolset.for_speed(run.encode_speed, is_intra_frame)
        # multi-slice: deblocking must not cross slice borders (idc 2,
        # reference multithread mode `src/h264-lab.h:4315-4323`)
        deblock_idc = (1 if not tools.enable_deblock
                       else (2 if n_bands > 1 else 0))

        payload = b""
        if is_idr:
            self.frame_num = 0
            payload += headers.sps_nal(self._sps)
            payload += headers.pps_nal(cfg.sps_id, 0, PIC_INIT_QP)

        ref = prev = None
        if not is_intra_frame:
            ref = self._refs[max(lt_use, 0)]
            # previous-frame MV candidate centre; zeros at GOP start, on
            # reference switches and after a change of band count
            if (lt_use == 0 and self._prev_mv is not None
                    and self._prev_mv[0] == n_bands):
                prev = self._prev_mv[1:]
        out = self.stages.run([(y, u, v)], n_bands, qp_arg, ref, prev,
                              tools, svc_base_mode_bit=(
                                  self._svc_ext and not is_intra_frame))
        self._prev_mv = (None if is_intra_frame or lt_use != 0 else
                         (n_bands, out["pmv_y"], out["pmv_x"]))

        mbw = cfg.mb_width
        band_hdrs = []
        for bi, (row0, _) in enumerate(bands):
            bw = BitWriter(capacity=1 << 16)
            shp = headers.SliceHeaderParams(
                slice_type=(headers.SLICE_TYPE_I if is_intra_frame
                            else headers.SLICE_TYPE_P),
                is_idr=is_idr,
                frame_num=self.frame_num,
                first_mb=row0 * mbw,
                pps_id=self._pps_id,
                idr_pic_id=self.idr_pic_id,
                slice_qp=band_qps[bi],
                pic_init_qp=PIC_INIT_QP,
                disable_deblocking_filter_idc=deblock_idc,
                long_term_idx_use=max(lt_use, 0) if not is_intra_frame else 0,
                long_term_idx_update=lt_update,
                short_term_used=self._short_term_used,
                lt_slot_in_use=(self._lt_used[lt_update - 1]
                                if lt_update > 0 else False),
                max_long_term_frames=n_lt,
                svc_ilp=self._svc_ext)
            headers.write_slice_header_rbsp(bw, shp)
            band_hdrs.append((bw, shp))

        # stream state
        if is_idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 16
            self._gop_pos = 1
        else:
            self._gop_pos += 1
        self.frame_num = (self.frame_num + 1) % (1 << headers.FRAME_NUM_BITS)
        self.frames_encoded += 1

        # the reference slot takes the deblocked reconstruction
        if is_idr:
            self._refs = {}
            self._short_term_used = False
            self._lt_used = [False] * n_lt
        if lt_update >= 0:
            self._refs[lt_update] = self._ref = out["refs"]
            self._most_recent_idx = lt_update
            if lt_update == 0:
                self._short_term_used = True
            else:
                self._lt_used[lt_update - 1] = True
        self._last_tiles = tuple(d[0] for d in out["df"])

        self._in_flight += 1
        return PendingFrame(
            out=out, run=run, band_hdrs=band_hdrs, sps_pps=payload, qp=qp,
            is_intra=is_intra_frame,
            ft_name="IDR" if is_idr else ("I" if is_intra_frame else "P"),
            return_recon=return_recon, inputs=inputs, rollback=rollback)

    def finish(self, pending: PendingFrame) -> FrameResult:
        """Write the frame's Annex-B bytes (host side)."""
        if isinstance(pending, FrameResult):
            return pending      # transparent frames are produced directly
        with self.stages.stage("host"):
            return self._finish(pending)

    def _finish(self, pending: PendingFrame) -> FrameResult:
        self._in_flight -= 1
        cfg = self.config
        run = pending.run
        out = pending.out
        # only the words that hold bits
        words = out["words"][:, :(int(out["mb_bits"].max()) + 31) // 32]
        words = words.cpu().numpy()
        nals = []
        for b, (bw, shp) in enumerate(pending.band_hdrs):
            bw.append_words(words[b], int(out["mb_bits"][b]))
            if out["tail_len"][b]:
                bw.u(int(out["tail_len"][b]),
                     int(out["tail_val"][b]) & 0xFFFFFFFF)
            bw.rbsp_trailing_bits()
            ref_idc, nal_type = headers.slice_nal_header_byte(shp)
            nals.append(annexb_nal(ref_idc, nal_type, bw.to_bytes()))
        band_bytes = [len(n) for n in nals]

        # NALU-size enforcement (reference on-the-fly split,
        # `src/h264-lab.h:6418-6424`): if a slice NALU overflows the
        # target, roll the stream state back and re-encode the frame with
        # more slices; the slice count grows until one MB row per slice
        nalu_target = run.desired_nalu_bytes or cfg.desired_nalu_bytes
        if (nalu_target > 0 and pending.rollback is not None
                and len(nals) < cfg.mb_height
                and max(band_bytes) > nalu_target):
            rb = pending.rollback
            self.frame_num = rb["frame_num"]
            self.idr_pic_id = rb["idr_pic_id"]
            self.frames_encoded = rb["frames_encoded"]
            self._gop_pos = rb["gop_pos"]
            self._refs = rb["refs"]
            self._ref = rb["ref"]
            self._most_recent_idx = rb["most_recent"]
            self._short_term_used = rb["short_term"]
            self._lt_used = rb["lt_used"]
            self._last_tiles = rb["last_tiles"]
            self._prev_mv = rb["prev_mv"]
            self._denoise_prev = rb["denoise_prev"]
            self._force_transparent = rb["force_transparent"]
            self._last_frame_bytes = rb["last_frame_bytes"]
            need = max(len(nals) + 1,
                       -(-sum(band_bytes) // max(nalu_target, 1)))
            again = self.encode_async(*pending.inputs, run,
                                      pending.return_recon,
                                      _force_bands=need)
            return (again if isinstance(again, FrameResult)
                    else self._finish(again))

        payload = pending.sps_pps
        for nal in nals:
            payload += nal
            if run.nalu_callback:
                run.nalu_callback(nal, self.frames_encoded - 1)
        self._last_frame_bytes = len(payload)

        # rate control accounting + VBV actions (incl. the per-MB-row bits
        # that drive the next frame's mb_qp_delta plan)
        self.rc.note_row_bits(out["row_bits"].cpu().numpy().reshape(-1))
        actions = self.rc.frame_end(pending.is_intra, len(payload),
                                    run.desired_frame_bytes,
                                    band_bytes=band_bytes)
        if actions["stuffing_bytes"] and cfg.vbv_underflow_stuffing_flag:
            payload += filler_nal(actions["stuffing_bytes"])
        if actions["overflow"]:
            self._force_transparent = True

        recon = recon_unf = None
        if pending.return_recon:
            recon = host_planes((d[0].cpu() for d in out["df"]), cfg)
            recon_unf = host_planes((r[0].cpu() for r in out["recon"]), cfg)
        return FrameResult(payload=payload, frame_type=pending.ft_name,
                           qp=pending.qp, recon=recon,
                           recon_unfiltered=recon_unf)

    # ------------------------------------------------------------------
    # checkpoint / resume: stream counters, RC state and the reference
    # pictures, as host numpy arrays in the JAX package's shapes
    def get_state(self) -> dict:
        """Snapshot of all mutable encoder state. Host numpy arrays only,
        so it pickles. Not between `encode_async` and `finish`: the stream
        counters have advanced there but the rate control has not."""
        if self._in_flight:
            raise RuntimeError(
                "get_state() with a frame in flight: call finish() on the "
                "pending frame first")

        def host(t):
            return t.cpu().numpy()
        pm = self._prev_mv
        if pm is not None:        # one band: (nmb,) fields, as JAX keeps
            pm = (pm[0],) + tuple(host(a[0] if pm[0] == 1 else a)
                                  for a in pm[1:])
        return {
            "frame_num": self.frame_num,
            "idr_pic_id": self.idr_pic_id,
            "frames_encoded": self.frames_encoded,
            "gop_pos": self._gop_pos,
            "most_recent_idx": self._most_recent_idx,
            "short_term_used": self._short_term_used,
            "lt_used": list(self._lt_used),
            "force_transparent": self._force_transparent,
            "last_frame_bytes": self._last_frame_bytes,
            "refs": {k: {n: host(a[0]) for n, a in st.items()}
                     for k, st in self._refs.items()},
            "last_tiles": (None if self._last_tiles is None else
                           tuple(host(t) for t in self._last_tiles)),
            "prev_mv": pm,
            "denoise_prev": (None if self._denoise_prev is None else
                             tuple(host(p) for p in self._denoise_prev)),
            "rc": self.rc.get_state(),
        }

    def set_state(self, st: dict):
        """Restore a snapshot of `get_state` on an encoder of the same
        configuration, its arrays placed on this encoder's device; the
        stream continues bit-compatibly from that point."""
        def dev(a):
            return torch.as_tensor(np.array(a), device=self.device)
        self.frame_num = st["frame_num"]
        self.idr_pic_id = st["idr_pic_id"]
        self.frames_encoded = st["frames_encoded"]
        self._gop_pos = st["gop_pos"]
        self._most_recent_idx = st["most_recent_idx"]
        self._short_term_used = st["short_term_used"]
        self._lt_used = list(st["lt_used"])
        self._force_transparent = st["force_transparent"]
        self._last_frame_bytes = st["last_frame_bytes"]
        self._refs = {k: {n: dev(a)[None] for n, a in s.items()}
                      for k, s in st["refs"].items()}
        self._ref = self._refs.get(self._most_recent_idx)
        lt = st.get("last_tiles")
        self._last_tiles = None if lt is None else tuple(dev(t) for t in lt)
        pm = st.get("prev_mv")
        self._prev_mv = (None if pm is None else
                         (pm[0],) + tuple(dev(a).reshape(pm[0], -1)
                                          for a in pm[1:]))
        dp = st.get("denoise_prev")
        self._denoise_prev = None if dp is None else tuple(dev(p)
                                                           for p in dp)
        self.rc.set_state(st["rc"])

    # ------------------------------------------------------------------
    def _encode_transparent(self, run: RunConfig,
                            return_recon: bool) -> FrameResult:
        """All-skip P frame: every MB P_Skip with a zero predictor chain,
        so the reconstruction equals the reference picture exactly."""
        cfg = self.config
        bw = BitWriter()
        shp = headers.SliceHeaderParams(
            slice_type=headers.SLICE_TYPE_P,
            is_idr=False,
            frame_num=self.frame_num,
            pps_id=self._pps_id,
            slice_qp=self.rc.qp,
            pic_init_qp=PIC_INIT_QP,
            disable_deblocking_filter_idc=1,
            long_term_idx_update=0,
            max_long_term_frames=cfg.max_long_term_reference_frames)
        headers.write_slice_header_rbsp(bw, shp)
        bw.ue(cfg.n_mb)          # mb_skip_run covering the whole picture
        bw.rbsp_trailing_bits()
        ref_idc, nal_type = headers.slice_nal_header_byte(shp)
        payload = annexb_nal(ref_idc, nal_type, bw.to_bytes())
        self.frame_num = (self.frame_num + 1) % (1 << headers.FRAME_NUM_BITS)
        self._gop_pos += 1
        self.frames_encoded += 1
        self.rc.frame_end(False, len(payload), run.desired_frame_bytes)
        recon = None
        if return_recon and self._last_tiles is not None:
            recon = host_planes((t.cpu() for t in self._last_tiles), cfg)
        return FrameResult(payload=payload, frame_type="P", qp=self.rc.qp,
                           recon=recon)
