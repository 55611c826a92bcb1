"""SVC Scalable-Baseline two-layer spatial scalability.

PyTorch counterpart of `h264lab_tpu/models/svc.py` (reference: chained
per-layer encoders `H264E_init` `src/h264-lab.h:6375-6407`, base-layer
drive, prefix NALs and scalable-extension slice headers `:6813-6851`,
`:4192-4242`):

- base layer: the 2x downsampled input as a half-resolution AVC stream
  (SPS profile 66, PPS), each slice preceded by a prefix NAL (type 14);
- enhancement layer: full-resolution slices in NAL type 20 with the
  scalable extension header (dependency_id 1), a subset SPS (profile 83)
  and its own PPS. Without inter-layer prediction its MB layer is plain
  baseline coding.

With `inter_layer_pred_flag`, enhancement I/IDR frames are base-mode
frames (reference `src/h264-lab.h:5754-5764`, `:6839-6844`): the base
layer's deblocked reconstruction is upsampled (`ops/resample.py`) and
every MB predicts from its co-located block, `base_mode_flag=1`, residual
coded inter-style with no prediction-mode syntax. Prediction has no
neighbour dependency, so the frame's TQ and CAVLC run in one parallel
batch (`base_mode_symbols`) with no wavefront: the P step's inter
residual with zero MVs (on the card K7) and CAVLC in its base-mode slice
kind (K6), then the slope-1 deblock (`base_mode_deblock`, K2); its symbol
grid is packed by the bit-pack kernel K1. P frames keep inter coding,
with the
scalable-extension slice-header tail and a base_mode_flag=0 bit per coded
MB (`H264Encoder._svc_ext`).

Both layers are `H264Encoder`s on one device; the input is uploaded once
and downsampled there (`resample.downsample_planes`: on the card one
launch of K9), and the base recon that the base-mode frame predicts from
stays there (`resample.upsample_tiles`: on the card one launch of K10
writes the prediction tiles and the guard-padded chroma planes).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from h264lab_tpu_torch.bitstream import BitWriter, headers
from h264lab_tpu_torch.bitstream.nal import annexb_nal, split_annexb
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import mbscan, refstate
from h264lab_tpu_torch.models.encoder import (PIC_INIT_QP, H264Encoder,
                                              host_planes)
from h264lab_tpu_torch.models.stages import StageTimer
from h264lab_tpu_torch.ops import bitpack, resample, tables
from h264lab_tpu_torch.utils.device import resolve_device

I32 = torch.int32
START = b"\x00\x00\x00\x01"


def _prefix_nal(is_idr: bool) -> bytes:
    """Prefix NAL unit (type 14) announcing the base layer to SVC decoders
    (reference `src/h264-lab.h:4196-4231`)."""
    bw = BitWriter()
    bw.u(8, (1 << 7) | (int(is_idr) << 6))   # reserved_one | idr | priority
    bw.u1(1)       # no_inter_layer_pred_flag
    bw.u(3, 0)     # dependency_id
    bw.u(4, 0)     # quality_id
    bw.u(3, 0)     # temporal_id
    bw.u1(1)       # use_ref_base_pic_flag
    bw.u1(0)       # discardable_flag
    bw.u1(1)       # output_flag
    bw.u(2, 3)     # reserved_three_2bits
    bw.u1(0)       # store_ref_base_pic_flag
    if not is_idr:
        bw.u1(0)   # adaptive_ref_base_pic_marking_mode_flag
    bw.u1(0)       # additional_prefix_nal_unit_extension_flag
    bw.rbsp_trailing_bits()
    return annexb_nal(2, headers.NAL_PREFIX, bw.to_bytes())


def _scalable_ext_header(bw: BitWriter, is_idr: bool,
                         inter_layer_pred: bool):
    """nal_unit_header_svc_extension for enhancement slices (NAL 20)."""
    bw.u(8, (1 << 7) | (int(is_idr) << 6))
    bw.u1(0 if inter_layer_pred else 1)   # no_inter_layer_pred_flag
    bw.u(3, 1)     # dependency_id
    bw.u(4, 0)     # quality_id
    bw.u(3, 0)     # temporal_id
    bw.u1(0)       # use_ref_base_pic_flag
    bw.u1(1)       # discardable_flag
    bw.u1(1)       # output_flag
    bw.u(2, 3)


def _with_prefix_nals(payload: bytes, is_idr: bool) -> bytes:
    """The base layer's Annex-B bytes with a prefix NAL before each slice."""
    out = b""
    for nal in split_annexb(payload):
        if nal[0] & 0x1F in (headers.NAL_SLICE, headers.NAL_IDR):
            out += _prefix_nal(is_idr)
        out += START + nal
    return out


# ---------------------------------------------------------------------------
# base-mode (inter-layer intra) frames, fully parallel
# ---------------------------------------------------------------------------

def base_mode_frame_core(src_y, src_u, src_v, pred_y, pred_u, pred_v, qp,
                         qpc, mb_width: int, mb_height: int) -> dict:
    """`base_mode_symbols` then `base_mode_deblock`: the counterpart of
    the JAX package's `_base_mode_frame_core` over a leading frame axis N
    (the returned dict's keys are both functions')."""
    out = base_mode_symbols(src_y, src_u, src_v, pred_y, pred_u, pred_v, qp,
                            qpc, mb_width, mb_height)
    df = base_mode_deblock(out, mb_width, mb_height)
    return dict(out, df_y=df[0], df_u=df[1], df_v=df[2])


def base_mode_symbols(src_y, src_u, src_v, pred_y, pred_u, pred_v, qp,
                      qpc, mb_width: int, mb_height: int, u_pad=None,
                      v_pad=None) -> dict:
    """Encode N enhancement I/IDR frames whose MBs are all base-mode:
    prediction = the co-located upsampled base-layer recon (G.8.6.2),
    residual inter-style TQ without the zero-block kills (reference
    QDQ_MODE_INTER `src/h264-lab.h:4426`), syntax per MB =
    base_mode_flag(1) + CBP (inter map) + dQP + residual.

    It is the P step's two stage entries: the TQ is
    `mbscan.inter_residual` with zero MVs, the luma prediction as the
    16x16 search's winner and the chroma prediction as the reference
    planes (the bilinear at a zero MV reads its sample: (64 A + 32) >> 6
    = A), with `zero_thr` off; the CAVLC is `mbscan.symbolize` in its
    base-mode slice kind. On the card that is one launch of K7 and K6's
    two of that kind.

    src_*/pred_* (N, nmb, t, t) uint8 tiles; qp, qpc (N,); u_pad and
    v_pad the chroma prediction as planes guard-padded by GUARD // 2 (N,
    8 mb_height + GUARD, 8 mb_width + GUARD), as `resample.upsample_tiles`
    writes them, or None to build them from pred_u and pred_v
    (`refstate.reference_chroma`: on the card a chroma-only K11). Returns
    sym_vals/sym_lens (N, nmb, 952) int32 (values as uint32 bit patterns)
    in `mbscan.symbolize`'s unit layout, whose luma-DC unit (unit 1) stays
    empty, so K1 packs it; JAX's grid is the 918 slots without that unit,
    which moves no offset and crosses no drop boundary. Also total_bits
    (N,), recon_* (N, nmb, t, t) before deblocking, cbp (N, nmb), and
    what `base_mode_deblock` needs: nnz (N, nmb, 4, 4), qp and qpc (N,)."""
    N, nmb = src_y.shape[:2]
    dev = src_y.device
    qp = torch.as_tensor(qp, dtype=I32, device=dev).reshape(N)
    qpc = torch.as_tensor(qpc, dtype=I32, device=dev).reshape(N)
    # zero_thr off: inter-layer intra residual is structured (upsampling
    # error), not noise; block kills cost real texture here
    zero = torch.zeros((N, nmb), dtype=I32, device=dev)
    lanes = torch.arange(N, dtype=I32, device=dev)
    if u_pad is None or v_pad is None:
        u_pad, v_pad = refstate.reference_chroma(pred_u, pred_v, mb_width,
                                                 mb_height)
    tq = mbscan.inter_residual(
        src_y, src_u, src_v, u_pad, v_pad, lanes, lanes * 0, qp, qpc, zero,
        zero, zero, zero, zero, pred_y, None, mb_width, mb_height,
        zero_thr=False)
    sym = mbscan.symbolize(
        *(None,) * 10, tq["lev_inter"], tq["cdc_inter"], tq["cac_inter"],
        mb_width, mb_height, False, base_mode=True)
    return dict(sym_vals=sym["sym_vals"], sym_lens=sym["sym_lens"],
                total_bits=sym["total_bits"], recon_y=tq["recon_y_inter"],
                recon_u=tq["recon_u_inter"], recon_v=tq["recon_v_inter"],
                cbp=sym["cbp"],
                nnz=(tq["lev_inter"] != 0).sum((-2, -1), dtype=I32),
                qp=qp, qpc=qpc)


def base_mode_deblock(out: dict, mb_width: int, mb_height: int):
    """Deblock `base_mode_symbols`' recon: base-mode MBs are intra (bS 4
    on MB edges) with zero MVs, at the frame QP. Returns (df_y, df_u,
    df_v) (N, nmb, t, t)."""
    N, nmb = out["nnz"].shape[:2]
    dev = out["nnz"].device
    idx = torch.arange(nmb, device=dev)
    zmv = torch.zeros((N, nmb, 4, 4), dtype=I32, device=dev)
    return mbscan.deblock_frame(
        out["recon_y"], out["recon_u"], out["recon_v"],
        torch.full((N, nmb), mbscan.SEL_I16, dtype=I32, device=dev),
        out["nnz"], zmv, zmv, out["qp"], out["qpc"], idx >= mb_width,
        idx % mb_width > 0, mb_width, mb_height)


# ---------------------------------------------------------------------------
# the two-layer encoder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SvcFrameResult:
    payload: bytes
    base_payload: bytes
    enh_payload: bytes
    frame_type: str
    recon: tuple | None = None       # enhancement-layer recon
    base_recon: tuple | None = None


class SvcEncoder:
    """Two-layer spatial-scalable encoder (Scalable Baseline).

    `device`: None means the CUDA card (and raises without one); pass
    "cpu" to run on the CPU. `stage_times`: set it to a dict to time the
    stages (each between device synchronizations); the dict then holds
    "base" and "enh", the two layers' `H264Encoder` stages (on a
    base-mode frame "enh" holds `base_mode`, its TQ and CAVLC, and
    `deblock`), and "svc", the resampling: `down`
    (the upload of the input with its 2x downsampling) and `up`."""

    def __init__(self, config: EncoderConfig, device=None):
        if config.num_layers != 2:
            raise ValueError("SvcEncoder needs num_layers=2")
        self.config = config
        self.device = resolve_device(device)
        self.ilp = config.inter_layer_pred_flag
        base_cfg = dataclasses.replace(
            config, width=config.width // 2, height=config.height // 2,
            num_layers=1, inter_layer_pred_flag=False,
            vbv_size_bytes=config.vbv_size_bytes // 4)
        self.base = H264Encoder(base_cfg, device=self.device)
        enh_cfg = dataclasses.replace(config, num_layers=1,
                                      inter_layer_pred_flag=False,
                                      sps_id=config.sps_id + 1)
        self.enh = H264Encoder(enh_cfg, device=self.device)
        # inter-layer prediction: enhancement slices carry scalable-ext
        # syntax (header tail + per-MB base_mode_flag)
        self.enh._svc_ext = self.ilp
        # the enhancement SPS is a subset SPS (profile 83)
        self.enh._sps = dataclasses.replace(
            self.enh._sps, profile_idc=headers.PROFILE_SCALABLE_BASELINE)
        self.timer = StageTimer(self.device)

    @property
    def stage_times(self):
        if self.timer.stage_times is None:
            return None
        return dict(base=self.base.stage_times, enh=self.enh.stage_times,
                    svc=self.timer.stage_times)

    @stage_times.setter
    def stage_times(self, value):
        if value is not None:
            value.update(base={}, enh={}, svc={})
        for name, t in (("base", self.base), ("enh", self.enh),
                        ("svc", self.timer)):
            t.stage_times = None if value is None else value[name]

    def encode(self, y, u, v, run: RunConfig | None = None,
               return_recon: bool = False) -> SvcFrameResult:
        with self.timer.stage("down"):
            full = self.enh._device_planes(y, u, v)
            low = resample.downsample_planes(*full)
        # with inter-layer prediction the base recon is always requested,
        # as the JAX package does
        base_res = self.base.encode(*low, run,
                                    return_recon=return_recon or self.ilp)
        is_idr = base_res.frame_type == "IDR"
        if self.ilp and base_res.frame_type in ("IDR", "I"):
            return self._encode_ilp_intra(full, run, base_res, return_recon)
        enh_res = self.enh.encode(*full, run, return_recon=return_recon)

        # enhancement layer: slice NALs rewrapped as NAL 20, the scalable
        # extension header inserted before the already-escaped payload
        ext = BitWriter()
        _scalable_ext_header(ext, is_idr, self.ilp)
        ext = ext.to_bytes()
        enh_out = b""
        for nal in split_annexb(enh_res.payload):
            if nal[0] & 0x1F in (headers.NAL_SLICE, headers.NAL_IDR):
                ref_idc = nal[0] >> 5
                enh_out += (START + bytes([(ref_idc << 5)
                                          | headers.NAL_SLICE_SCALABLE])
                            + ext + nal[1:])
            else:
                enh_out += START + nal
        base_out = _with_prefix_nals(base_res.payload, is_idr)
        return SvcFrameResult(
            payload=base_out + enh_out, base_payload=base_out,
            enh_payload=enh_out, frame_type=base_res.frame_type,
            recon=enh_res.recon, base_recon=base_res.recon)

    # ------------------------------------------------------------------
    def _encode_ilp_intra(self, full, run, base_res,
                          return_recon: bool) -> SvcFrameResult:
        """Enhancement I/IDR frame with inter-layer intra prediction: every
        MB base-mode from the upsampled base recon (reference
        `src/h264-lab.h:5754-5764`, upsampling drive `:6839-6844`). The
        enhancement encoder's stream state moves as the JAX package moves
        it: its previous-MV candidate, denoise planes and transparent-frame
        flag stay as they were."""
        enh = self.enh
        cfg = enh.config
        st = enh.stages
        run = run or RunConfig(qp_min=cfg.qp, qp_max=cfg.qp)
        is_idr = base_res.frame_type == "IDR"
        qp = enh.rc.frame_start(
            True, run.desired_frame_bytes,
            int(np.clip(run.qp_min, 10, 51)),
            int(np.clip(run.qp_max, 10, 51)))
        qpc = int(tables.QPC_FROM_QPY[qp])

        # the base layer's deblocked recon, cropped to the base picture,
        # upsampled and edge-padded to the enhancement's padded size, and
        # its chroma planes guard-padded for the base-mode prediction
        with self.timer.stage("up"):
            bc = self.base.config
            crops = ((bc.height, bc.width),) + ((bc.height // 2,
                                                 bc.width // 2),) * 2
            *pred, u_pad, v_pad = resample.upsample_tiles(
                self.base._last_tiles, bc.mb_width, crops, cfg.mb_width,
                cfg.mb_height)
        with st.stage("pre"):
            src = st.tiles([full])
        with st.stage("base_mode"):
            out = base_mode_symbols(*src, *pred, [qp], [qpc], cfg.mb_width,
                                    cfg.mb_height, u_pad, v_pad)
        with st.stage("deblock"):
            df = base_mode_deblock(out, cfg.mb_width, cfg.mb_height)
        with st.stage("pack"):
            total_bits = int(out["total_bits"][0])
            words, _ = bitpack.pack_frames(out["sym_vals"], out["sym_lens"],
                                           bitpack.bucket_words(total_bits))
        with st.stage("ref"):
            state = refstate.prepare_reference(*df, cfg.mb_width,
                                               cfg.mb_height)
        with st.stage("host"):
            enh_out = self._ilp_slice(
                words[0, :(total_bits + 31) // 32].cpu().numpy(), total_bits,
                qp, is_idr)
            # the enhancement stream state, as H264Encoder keeps it
            n_lt = cfg.max_long_term_reference_frames
            if is_idr:
                enh.idr_pic_id = (enh.idr_pic_id + 1) % 16
                enh._gop_pos = 1
                enh._refs = {}
                enh._short_term_used = False
                enh._lt_used = [False] * n_lt
            else:
                enh._gop_pos += 1
            enh.frame_num = (enh.frame_num + 1) % (1 << headers.FRAME_NUM_BITS)
            enh.frames_encoded += 1
            enh._refs[0] = enh._ref = state
            enh._most_recent_idx = 0
            enh._short_term_used = True
            enh._last_tiles = tuple(d[0] for d in df)
            enh._last_frame_bytes = len(enh_out)
            enh.rc.frame_end(True, len(enh_out), run.desired_frame_bytes)
            base_out = _with_prefix_nals(base_res.payload, is_idr)
            recon = (host_planes((d[0].cpu() for d in df), cfg)
                     if return_recon else None)
        return SvcFrameResult(
            payload=base_out + enh_out, base_payload=base_out,
            enh_payload=enh_out, frame_type=base_res.frame_type,
            recon=recon,
            base_recon=base_res.recon if return_recon else None)

    def _ilp_slice(self, words: np.ndarray, total_bits: int, qp: int,
                   is_idr: bool) -> bytes:
        """The base-mode frame's NAL units: on an IDR the subset SPS and
        the PPS, then one NAL-20 slice with the inter-layer header fields
        and the packed MB bits."""
        enh = self.enh
        cfg = enh.config
        if is_idr:
            enh.frame_num = 0
        shp = headers.SliceHeaderParams(
            slice_type=headers.SLICE_TYPE_I,
            is_idr=is_idr,
            frame_num=enh.frame_num,
            pps_id=enh._pps_id,
            idr_pic_id=enh.idr_pic_id,
            slice_qp=qp,
            pic_init_qp=PIC_INIT_QP,
            disable_deblocking_filter_idc=0,
            max_long_term_frames=cfg.max_long_term_reference_frames,
            svc_ilp=True)
        bw = BitWriter(capacity=1 << 16)
        headers.write_slice_header_rbsp(bw, shp)
        bw.append_words(words, total_bits)
        bw.rbsp_trailing_bits()
        ext = BitWriter()
        _scalable_ext_header(ext, is_idr, True)
        out = b""
        if is_idr:
            out += headers.sps_nal(enh._sps)
            out += headers.pps_nal(cfg.sps_id, 0, PIC_INIT_QP)
        return out + annexb_nal(3, headers.NAL_SLICE_SCALABLE,
                                ext.to_bytes() + bw.to_bytes())
