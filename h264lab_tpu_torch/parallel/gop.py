"""GOP-lane x slice-band encoding on one CUDA device.

PyTorch counterpart of `h264lab_tpu/parallel/gop.py`: G independent GOP
lanes advance in lockstep, each encoding one frame per step, and every
frame is cut into B slice bands. The (lane, band) pairs form one leading
batch axis of G*B frames that every stage runs over at once, where the
JAX package vmapped twice.

This slice of the port encodes all-intra streams: every step is an IDR
(or an I frame on request). A step is four device stages — tiling, the
slope-2 wavefront mode selection, CAVLC symbolization and deblocking —
then the bit-pack kernel (`ops/bitpack.py`), and the host stage
`finish_step` (slice headers, NAL escaping, rate control). Requests the
slice does not implement raise `NotImplementedError`: P frames (from
`gop` > 1 or a P-type `FrameType`), a device `mesh`, temporal denoising,
and the speeds that turn deblocking off (8, 10).

With fixed QP, lane streams are byte-identical to the JAX package's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from h264lab_tpu_torch.bitstream import BitWriter, headers
from h264lab_tpu_torch.bitstream.nal import annexb_nal
from h264lab_tpu_torch.config import EncoderConfig, FrameType, RunConfig
from h264lab_tpu_torch.models import mbscan, wavefront
from h264lab_tpu_torch.models.encoder import PIC_INIT_QP, FrameResult
from h264lab_tpu_torch.ops import bitpack, tables
from h264lab_tpu_torch.rc.ratecontrol import RateControl, filler_nal
from h264lab_tpu_torch.utils.device import resolve_device

# worst-case packed words per MB: spec 7.4.5 caps macroblock_layer() at
# 3200 bits; 128 words = 4096 bits of headroom
WORDS_PER_MB = 128


@dataclasses.dataclass
class _PendingStep:
    out: dict
    qps: list                    # frame-level QP per lane
    band_qps: list               # per-lane [per-band QP] (fine RC)
    is_idr: bool
    run: RunConfig
    n_bands: int
    frame_num: int
    return_recon: bool
    is_intra: bool = True        # I or IDR
    ft_name: str = "IDR"
    lt_use: int = 0              # long-term policy for the slice headers
    lt_update: int = 0
    hdr_st_used: bool = False    # pre-marking DPB flags
    hdr_lt_in_use: bool = False


class GopBandEncoder:
    """G lockstep GOP lanes x B slice bands in one batched dispatch.

    Every lane is an independent H.264 stream (closed GOPs). All lanes
    share the frame schedule but carry their own rate-control state.

    `device`: None means the CUDA card (and raises without one); pass
    "cpu" to run the same code on the CPU. `stage_times`: set it to a
    dict to have each stage synchronize the device and add its wall
    seconds under its name (pre, select, sym, deblock, pack, host).
    """

    def __init__(self, config: EncoderConfig, n_gop: int | None = None,
                 mesh=None, idr_pic_id_base: int = 0,
                 per_lane_idr_pic_id: bool = False, device=None):
        cfg = config
        self.config = cfg
        self.n_gop = n_gop = (cfg.gop_parallel if n_gop is None else n_gop)
        if mesh is not None:
            raise NotImplementedError(
                "the PyTorch GopBandEncoder runs on one device; a (gop, "
                "band) mesh is not ported yet")
        if cfg.mb_height % cfg.slice_bands:
            raise ValueError("slice_bands must divide mb_height")
        if cfg.temporal_denoise_flag:
            raise NotImplementedError(
                "GopBandEncoder does not support temporal denoising")
        self.device = resolve_device(device)
        # standalone lanes all use `idr_pic_id_base`; `encode_stream` sets
        # per_lane_idr_pic_id so lane g's IDR uses (base + g) mod 16
        self.idr_pic_id_base = idr_pic_id_base
        self.per_lane_idr_pic_id = per_lane_idr_pic_id
        self.n_bands = cfg.slice_bands
        self.band_rows = cfg.mb_height // cfg.slice_bands
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
        self.rc = [RateControl(cfg.n_mb, cfg.gop, cfg.vbv_size_bytes, cfg.qp)
                   for _ in range(n_gop)]
        # DPB slots holding a picture (0 = short-term, 1..N = long-term);
        # the port keeps no reference pictures until the P slice lands
        self._ref_slots = set()
        self._gop_pos = 0
        self._most_recent_idx = 0
        self._short_term_used = False
        self._lt_used = [False] * cfg.max_long_term_reference_frames
        self._sps = headers.SpsParams(
            width=cfg.width, height=cfg.height,
            mb_width=cfg.mb_width, mb_height=cfg.mb_height,
            sps_id=cfg.sps_id,
            num_ref_frames=1 + cfg.max_long_term_reference_frames,
            vbv_size_bytes=cfg.vbv_size_bytes)
        nmb = cfg.mb_width * self.band_rows
        plan = wavefront.make_plan(cfg.mb_width, self.band_rows, 2)
        r = np.arange(nmb) // cfg.mb_width
        c = np.arange(nmb) % cfg.mb_width
        self._plan = (plan.steps, r > 0, c > 0)
        self.stage_times = None

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Bracket a stage for `torch.profiler` and, with `stage_times`
        set, time it between device synchronizations."""
        with torch.profiler.record_function(f"stage:{name}"):
            if self.stage_times is None:
                yield
                return
            sync = (torch.cuda.synchronize if self.device.type == "cuda"
                    else (lambda *_: None))
            sync(self.device)
            t0 = time.perf_counter()
            yield
            sync(self.device)
            self.stage_times[name] = (self.stage_times.get(name, 0.0)
                                      + time.perf_counter() - t0)

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
        n_lt = cfg.max_long_term_reference_frames
        ftype = run.frame_type
        if ftype == FrameType.DEFAULT:
            if self.step_idx == 0 or not self._ref_slots:
                ftype = FrameType.KEY
            elif cfg.gop and self._gop_pos >= cfg.gop:
                ftype = FrameType.KEY
            else:
                ftype = FrameType.P
        if ftype == FrameType.I:
            lt_use, lt_update = -1, 0
        elif ftype == FrameType.KEY:
            lt_use, lt_update = -1, (1 if n_lt > 0 else 0)
        elif ftype == FrameType.GOLDEN:
            lt_use, lt_update = 1, 1
        elif ftype == FrameType.RECOVERY:
            lt_use, lt_update = 1, 0
        elif ftype == FrameType.DROPPABLE:
            lt_use, lt_update = self._most_recent_idx, -1
        elif ftype == FrameType.CUSTOM:
            lt_use = run.long_term_idx_use or self._most_recent_idx
            lt_update = run.long_term_idx_update
            if lt_use < 0:
                ftype = FrameType.KEY
                lt_update = 1 if n_lt > 0 else 0
        else:  # P
            lt_use, lt_update = self._most_recent_idx, 0
        if ftype not in (FrameType.KEY, FrameType.I) \
                and max(lt_use, 0) not in self._ref_slots:
            ftype = FrameType.KEY
            lt_use, lt_update = -1, (1 if n_lt > 0 else 0)
        return ftype, lt_use, lt_update

    def encode_step_async(self, frames, run: RunConfig | None = None,
                          return_recon: bool = False) -> _PendingStep:
        """Queue the device work for one frame on every lane and return;
        `finish_step` waits for it and writes the bitstreams."""
        cfg = self.config
        run = run or RunConfig(qp_min=cfg.qp, qp_max=cfg.qp)
        G, B = self.n_gop, self.n_bands
        if len(frames) != G:
            raise ValueError(f"expected {G} lane frames, got {len(frames)}")
        ftype, lt_use, lt_update = self._frame_type(run)
        is_idr = ftype == FrameType.KEY
        is_intra = ftype in (FrameType.KEY, FrameType.I)
        if not is_intra:
            raise NotImplementedError(
                f"frame type {ftype.name} needs inter prediction, which the "
                "PyTorch port does not implement yet (all-intra only: "
                "gop=1 or FrameType.KEY/I)")
        if run.encode_speed in (8, 10):
            raise NotImplementedError(
                "encode_speed 8 and 10 (deblocking off) are not ported")

        qmin = int(np.clip(run.qp_min, 10, 51))
        qmax = int(np.clip(run.qp_max, 10, 51))
        qps, band_qps = [], []
        for g in range(G):
            qp = self.rc[g].frame_start(True, run.desired_frame_bytes,
                                        qmin, qmax)
            qps.append(qp)
            if cfg.fine_rate_control_flag and B > 1:
                band_qps.append(self.rc[g].band_qp_offsets(
                    B, True, run.desired_frame_bytes, qmin, qmax))
            else:
                band_qps.append([qp] * B)

        out = self._encode_intra(frames, np.asarray(band_qps, np.int32),
                                 self.idr_cap_words)

        hdr_st_used = self._short_term_used
        hdr_lt_in_use = (self._lt_used[lt_update - 1]
                         if lt_update > 0 else False)
        n_lt = cfg.max_long_term_reference_frames
        if is_idr:
            self._ref_slots = set()
            self._short_term_used = False
            self._lt_used = [False] * n_lt
        if lt_update >= 0:
            self._ref_slots.add(lt_update)
            self._most_recent_idx = lt_update
            if lt_update == 0:
                self._short_term_used = True
            else:
                self._lt_used[lt_update - 1] = True

        self.step_idx += 1
        self._gop_pos = 1 if is_idr else self._gop_pos + 1
        fn_use = 0 if is_idr else self.frame_num
        self.frame_num = (fn_use + 1) % (1 << headers.FRAME_NUM_BITS)
        return _PendingStep(out=out, qps=qps, band_qps=band_qps,
                            is_idr=is_idr, run=run, n_bands=B,
                            frame_num=fn_use, return_recon=return_recon,
                            is_intra=is_intra,
                            ft_name="IDR" if is_idr else "I",
                            lt_use=lt_use, lt_update=lt_update,
                            hdr_st_used=hdr_st_used,
                            hdr_lt_in_use=hdr_lt_in_use)

    def _encode_intra(self, frames, band_qps: np.ndarray, cap_words: int):
        """Device stages of one all-intra step. band_qps (G, B)."""
        cfg = self.config
        G, B = self.n_gop, self.n_bands
        dev = self.device
        mbw, rows = cfg.mb_width, self.band_rows
        N, nmb = G * B, rows * mbw
        ph, pw = cfg.padded_height, cfg.padded_width

        def upload(i, h, w):
            return torch.from_numpy(np.stack([
                wavefront.pad_plane(np.asarray(f[i], np.uint8), h, w)
                for f in frames])).to(dev)

        with self._stage("pre"):
            src = []
            for i, t in ((0, 16), (1, 8), (2, 8)):
                p = upload(i, ph * t // 16, pw * t // 16)
                # (G, H, W) -> (G*B, nmb, t, t): band rows are contiguous
                src.append(p.reshape(G, B * rows, t, mbw, t)
                           .permute(0, 1, 3, 2, 4).reshape(N, nmb, t, t))
            qp = torch.as_tensor(band_qps.reshape(-1), device=dev)
            qpc = torch.as_tensor(tables.QPC_FROM_QPY[band_qps.reshape(-1)],
                                  device=dev)
        steps, a_top, a_left = self._plan
        with self._stage("select"):
            st = mbscan.select_stage_core(src[0], src[1], src[2], qp, qpc,
                                          steps, a_top, a_left, mbw)
        with self._stage("sym"):
            sym = mbscan.symbolize(
                st["sel"], st["mode16"], st["cmode"], st["i4sym_v"],
                st["i4sym_l"], st["dc_lev"], st["ac_lev"], st["cdc_lev"],
                st["cac_lev"], mbw, rows)
        with self._stage("deblock"):
            df = mbscan.deblock_stage_core(
                st["recon_y"], st["recon_u"], st["recon_v"], st["sel"],
                qp, qpc, a_top, a_left, mbw, rows)
        with self._stage("pack"):
            words, nbits = bitpack.pack_frames(sym["sym_vals"],
                                               sym["sym_lens"], cap_words)

        def lanes(x):
            return x.reshape((G, B) + x.shape[1:])

        def lane_tiles(x):
            return x.reshape((G, B * nmb) + x.shape[2:])

        return dict(words=lanes(words), nbits=lanes(nbits),
                    tail_val=lanes(sym["tail_val"]),
                    tail_len=lanes(sym["tail_len"]),
                    df_y=lane_tiles(df[0]), df_u=lane_tiles(df[1]),
                    df_v=lane_tiles(df[2]),
                    sym_vals=lanes(sym["sym_vals"]),
                    sym_lens=lanes(sym["sym_lens"]))

    def finish_step(self, p: _PendingStep):
        """Wait for a dispatched step and write per-lane Annex-B bytes."""
        with self._stage("host"):
            return self._finish_step(p)

    def _finish_step(self, p: _PendingStep):
        cfg = self.config
        G, B = self.n_gop, p.n_bands
        nbits = p.out["nbits"].cpu().numpy()                     # (G, B)
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
            words, nb = bitpack.pack_frames(
                p.out["sym_vals"], p.out["sym_lens"], self.p_cap_words)
            p.out["words"], p.out["nbits"] = words, nb
            nbits = nb.cpu().numpy()
        words = p.out["words"].cpu().numpy()          # (G, B, cap + 256)
        tails_v = p.out["tail_val"].cpu().numpy()
        tails_l = p.out["tail_len"].cpu().numpy()
        deblock_idc = 2 if B > 1 else 0
        results = []
        for g in range(G):
            payload = b""
            band_bytes = []
            if p.is_idr:
                payload += headers.sps_nal(self._sps)
                payload += headers.pps_nal(cfg.sps_id, 0, PIC_INIT_QP)
            for b in range(B):
                bw = BitWriter(capacity=1 << 16)
                shp = headers.SliceHeaderParams(
                    slice_type=(headers.SLICE_TYPE_I if p.is_intra
                                else headers.SLICE_TYPE_P),
                    is_idr=p.is_idr,
                    frame_num=p.frame_num,
                    first_mb=b * self.band_rows * cfg.mb_width,
                    pps_id=cfg.sps_id * 4,
                    idr_pic_id=(self.idr_pic_id_base
                                + (g if self.per_lane_idr_pic_id
                                   else 0)) % 16,
                    slice_qp=p.band_qps[g][b],
                    pic_init_qp=PIC_INIT_QP,
                    disable_deblocking_filter_idc=deblock_idc,
                    long_term_idx_use=(max(p.lt_use, 0)
                                       if not p.is_intra else 0),
                    long_term_idx_update=p.lt_update,
                    short_term_used=p.hdr_st_used,
                    lt_slot_in_use=p.hdr_lt_in_use,
                    max_long_term_frames=cfg.max_long_term_reference_frames)
                headers.write_slice_header_rbsp(bw, shp)
                mb_bits = int(nbits[g, b])
                bw.append_bits_bytes(
                    bitpack.words_to_bytes(words[g, b], mb_bits), mb_bits)
                if int(tails_l[g, b]):
                    bw.u(int(tails_l[g, b]), int(tails_v[g, b]))
                bw.rbsp_trailing_bits()
                ref_idc, nal_type = headers.slice_nal_header_byte(shp)
                nal = annexb_nal(ref_idc, nal_type, bw.to_bytes())
                payload += nal
                band_bytes.append(len(nal))
            actions = self.rc[g].frame_end(
                p.is_intra, len(payload), p.run.desired_frame_bytes,
                band_bytes=band_bytes or None)
            if (actions["stuffing_bytes"]
                    and cfg.vbv_underflow_stuffing_flag):
                payload += filler_nal(actions["stuffing_bytes"])
            recon = None
            if p.return_recon:
                planes = [wavefront.tiles_to_plane(
                    p.out[k][g].cpu().numpy(), cfg.mb_height, cfg.mb_width)
                    for k in ("df_y", "df_u", "df_v")]
                recon = (planes[0][:cfg.height, :cfg.width],
                         planes[1][:cfg.height // 2, :cfg.width // 2],
                         planes[2][:cfg.height // 2, :cfg.width // 2])
            results.append(FrameResult(payload=payload, frame_type=p.ft_name,
                                       qp=p.qps[g], recon=recon))
        return results


def encode_stream(frames, config: EncoderConfig, n_gop: int | None = None,
                  run: RunConfig | None = None, device=None):
    """Encode a frame sequence with GOP-parallel lanes and return the
    in-order Annex-B stream. Lane g takes GOP g, g+n_gop, ...; with fixed
    QP the output equals sequential encoding."""
    cfg = config
    n_gop = cfg.gop_parallel if n_gop is None else n_gop
    gop = cfg.gop or len(frames)
    n_gops_total = (len(frames) + gop - 1) // gop
    chunks = [frames[i * gop:(i + 1) * gop] for i in range(n_gops_total)]
    payloads = [[] for _ in range(n_gops_total)]
    for base in range(0, n_gops_total, n_gop):
        group = chunks[base:base + n_gop]
        enc = GopBandEncoder(cfg, n_gop=len(group),
                             idr_pic_id_base=base % 16,
                             per_lane_idr_pic_id=True, device=device)
        for t in range(max(len(c) for c in group)):
            lanes = [c[min(t, len(c) - 1)] for c in group]
            results = enc.encode_step(lanes, run)
            for gi, r in enumerate(results):
                if t < len(group[gi]):
                    payloads[base + gi].append(r.payload)
    return b"".join(b"".join(p) for p in payloads)
