"""Independent scalar H.264 baseline decoder (numpy, on the host).

The port's copy of `h264lab_tpu/decoder/decoder.py`, so that the streams
the card writes decode where there is no jax: encoder recon must match
decoder output bit-exactly. It keeps the JAX package's structure, results
and exceptions (unsupported syntax raises the same type with the same
message); its checks also hold under `python -O`.

Supported: baseline profile, CAVLC, I slices (Intra_16x16 + Intra_4x4) and
P slices (16x16/16x8/8x16/8x8 partitions, qpel, P_Skip), deblocking.
Implemented incrementally; unsupported syntax raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from h264lab_tpu_torch.bitstream.nal import split_annexb, unescape_rbsp
from h264lab_tpu_torch.decoder.bitreader import BitReader
from h264lab_tpu_torch.decoder import cavlc_dec, deblock_dec, interpolate
from h264lab_tpu_torch.ops.tables import (
    CBP_TO_CODENUM, QPC_FROM_QPY, BLOCK_SCAN_4x4, DEQUANT_V, POS_CLASS,
)

# inverse of Table 9-4 mapping: codenum -> cbp
CODENUM_TO_CBP_INTRA = np.zeros(48, dtype=np.int32)
CODENUM_TO_CBP_INTER = np.zeros(48, dtype=np.int32)
for _cbp in range(48):
    CODENUM_TO_CBP_INTRA[CBP_TO_CODENUM[_cbp][0]] = _cbp
    CODENUM_TO_CBP_INTER[CBP_TO_CODENUM[_cbp][1]] = _cbp


def _require(ok: bool, *message):
    """The JAX decoder's `assert`, kept under `python -O` (some of them
    read the bit they check)."""
    if not ok:
        raise AssertionError(*message)


@dataclasses.dataclass
class Sps:
    profile_idc: int
    level_idc: int
    sps_id: int
    log2_max_frame_num: int
    poc_type: int
    num_ref_frames: int
    mb_width: int
    mb_height: int
    crop: tuple

    @property
    def width(self):
        return self.mb_width * 16 - 2 * (self.crop[0] + self.crop[1])

    @property
    def height(self):
        return self.mb_height * 16 - 2 * (self.crop[2] + self.crop[3])


@dataclasses.dataclass
class Pps:
    pps_id: int
    sps_id: int
    pic_init_qp: int
    chroma_qp_index_offset: int
    deblocking_filter_control_present: bool


def parse_sps(rbsp: bytes) -> Sps:
    br = BitReader(rbsp)
    profile = br.u(8)
    br.u(8)  # constraints
    level = br.u(8)
    sps_id = br.ue()
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        chroma_format = br.ue()
        _require(chroma_format == 1)
        br.ue()  # bit_depth_luma
        br.ue()  # bit_depth_chroma
        br.u1()  # transform bypass
        _require(br.u1() == 0)  # scaling matrix
    log2_mfn = br.ue() + 4
    poc_type = br.ue()
    if poc_type == 0:
        br.ue()
    elif poc_type == 1:
        raise NotImplementedError("poc_type 1")
    num_ref = br.ue()
    br.u1()  # gaps allowed
    mbw = br.ue() + 1
    mbh = br.ue() + 1
    frame_mbs_only = br.u1()
    _require(frame_mbs_only == 1)
    br.u1()  # direct_8x8
    crop = (0, 0, 0, 0)
    if br.u1():
        crop = (br.ue(), br.ue(), br.ue(), br.ue())
    vui = br.u1()
    return Sps(profile, level, sps_id, log2_mfn, poc_type, num_ref,
               mbw, mbh, crop)


def parse_pps(rbsp: bytes) -> Pps:
    br = BitReader(rbsp)
    pps_id = br.ue()
    sps_id = br.ue()
    _require(br.u1() == 0, "CABAC unsupported")
    br.u1()  # pic_order_present
    _require(br.ue() == 0, "slice groups unsupported")
    br.ue()  # num_ref_idx_l0
    br.ue()  # num_ref_idx_l1
    _require(br.u1() == 0, "weighted pred")
    br.u(2)
    pic_init_qp = br.se() + 26
    br.se()  # qs
    cqo = br.se()
    dbf = br.u1()
    br.u1()  # constrained intra
    br.u1()  # redundant
    return Pps(pps_id, sps_id, pic_init_qp, cqo, bool(dbf))


def clip255(x):
    return np.clip(x, 0, 255)


def idct4x4_core(d: np.ndarray) -> np.ndarray:
    tmp = np.zeros((4, 4), dtype=np.int64)
    d = d.astype(np.int64)
    for i in range(4):
        d0, d1, d2, d3 = d[i]
        e0, e1 = d0 + d2, d0 - d2
        e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
        tmp[i] = [e0 + e3, e1 + e2, e1 - e2, e0 - e3]
    out = np.zeros((4, 4), dtype=np.int64)
    for j in range(4):
        f0, f1, f2, f3 = tmp[0, j], tmp[1, j], tmp[2, j], tmp[3, j]
        g0, g1 = f0 + f2, f0 - f2
        g2, g3 = (f1 >> 1) - f3, f1 + (f3 >> 1)
        out[:, j] = [g0 + g3, g1 + g2, g1 - g2, g0 - g3]
    return (out + 32) >> 6


def dequant4x4(levels: np.ndarray, qp: int) -> np.ndarray:
    v = DEQUANT_V[qp % 6][POS_CLASS].reshape(4, 4).astype(np.int64)
    return (levels.astype(np.int64) * v) << (qp // 6)


H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]],
              dtype=np.int64)


def dequant_luma_dc(levels: np.ndarray, qp: int) -> np.ndarray:
    f = H4 @ levels.astype(np.int64) @ H4.T
    v00 = int(DEQUANT_V[qp % 6, 0])
    div6 = qp // 6
    if div6 >= 2:
        return (f * v00) << (div6 - 2)
    return (f * v00 + (1 << (1 - div6))) >> (2 - div6)


H2 = np.array([[1, 1], [1, -1]], dtype=np.int64)


def dequant_chroma_dc(levels: np.ndarray, qpc: int) -> np.ndarray:
    # spec 8.5.11 with flat scaling (LevelScale = 16*V00, >>5) simplified
    f = H2 @ levels.astype(np.int64) @ H2.T
    v00 = int(DEQUANT_V[qpc % 6, 0])
    return ((f * v00) << (qpc // 6)) >> 1


class DecodedFrame:
    def __init__(self, sps: Sps):
        self.y = np.zeros((sps.mb_height * 16, sps.mb_width * 16), np.uint8)
        self.u = np.zeros((sps.mb_height * 8, sps.mb_width * 8), np.uint8)
        self.v = np.zeros((sps.mb_height * 8, sps.mb_width * 8), np.uint8)

    def cropped(self, sps: Sps):
        w, h = sps.width, sps.height
        return (self.y[:h, :w], self.u[:h // 2, :w // 2],
                self.v[:h // 2, :w // 2])


class H264Decoder:
    """Stateful stream decoder. Feed NAL units via `decode(stream)`."""

    def __init__(self, coeff_scan: str = "zigzag"):
        # "zigzag" (normative) or "transposed_raster" (reference-fork compat)
        self.coeff_scan = coeff_scan
        self.sps: Sps | None = None
        self.pps: Pps | None = None
        self._sps_by_id = {}
        self._pps_by_id = {}
        self.frames: list[DecodedFrame] = []
        self._cur: DecodedFrame | None = None
        # per-picture context
        self._nnz_luma = None       # (4*mbh, 4*mbw)
        self._nnz_chroma = None     # (2, 2*mbh, 2*mbw)
        self._mb_intra = None       # (mbh, mbw) bool
        self._mb_avail = None       # (mbh, mbw) bool (decoded yet)
        self._mv = None             # (mbh, mbw, 2) int32 (y, x)
        self._ref_planes = None     # (luma planes tuple, u_pad, v_pad)
        # DPB per dependency layer (0 = base/AVC, 1 = SVC enhancement):
        # "short" = most recent short-term ref; lt[k] = long-term k
        self._dpbs = {0: {"short": None, "lt": {}},
                      1: {"short": None, "lt": {}}}
        # SVC enhancement-layer decode state
        self.enh_frames: list[DecodedFrame] = []
        self._layer = 0
        self._adaptive_base_mode = False
        self._base_up = None        # upsampled base planes (y, u, v)
        self._interp_cache = {}     # id(frame planes) -> interp planes
        self._i4_modes = None       # (4*mbh, 4*mbw) int32, -1 = not i4x4
        self._mb_qp = None          # (mbh, mbw) int32
        self._mb_slice = None       # (mbh, mbw) int32 slice index
        self._cur_slice_id = 0
        self._n_decoded = 0
        self._deblock_idc = 0

    # ---------------- public ----------------
    def decode(self, stream: bytes) -> list[DecodedFrame]:
        for nal in split_annexb(stream):
            header = nal[0]
            nal_type = header & 0x1F
            rbsp = unescape_rbsp(nal[1:])
            if nal_type in (7, 15):          # SPS / subset SPS
                sps = parse_sps(rbsp)
                self._sps_by_id[sps.sps_id] = sps
                if nal_type == 7:
                    self.sps = sps
            elif nal_type == 8:
                pps = parse_pps(rbsp)
                self._pps_by_id[pps.pps_id] = pps
                if self.pps is None:
                    self.pps = pps
            elif nal_type in (1, 5):
                self._decode_slice(rbsp, nal_type == 5, (header >> 5) & 3)
            elif nal_type == 20:
                # scalable-extension slice: 3-byte SVC ext header
                # (G.7.3.1.1: idr_flag in byte 0, no_inter_layer_pred /
                # dependency_id in byte 1), then a normal slice
                # header/data with the scalable additions
                idr_flag = bool((rbsp[0] >> 6) & 1)
                no_ilp = bool((rbsp[1] >> 7) & 1)
                self._decode_slice(rbsp[3:], idr_flag, (header >> 5) & 3,
                                   layer=1, ilp=not no_ilp)
            elif nal_type in (6, 9, 12):
                continue  # SEI / AUD / filler
            elif nal_type == 14:
                continue  # SVC prefix (announces the base layer)
            else:
                raise NotImplementedError(f"NAL type {nal_type}")
        return self.frames

    # ---------------- slice ----------------
    def _decode_slice(self, rbsp: bytes, is_idr: bool, nal_ref_idc: int,
                      layer: int = 0, ilp: bool = False):
        br = BitReader(rbsp)
        first_mb = br.ue()
        slice_type = br.ue()
        if slice_type >= 5:
            slice_type -= 5
        pps_id = br.ue()
        pps = self._pps_by_id.get(pps_id, self.pps)
        sps = self._sps_by_id.get(pps.sps_id, self.sps)
        self.pps, self.sps = pps, sps
        br.u(sps.log2_max_frame_num)  # frame_num
        if is_idr:
            br.ue()  # idr_pic_id
        if sps.poc_type == 0:
            raise NotImplementedError("poc_type 0 slice bits")
        use_lt = None                    # long_term_pic_num to predict from
        if slice_type == 0:  # P
            num_ref_override = br.u1()
            if num_ref_override:
                br.ue()
            if br.u1():  # ref_pic_list_modification_flag_l0
                while True:
                    idc = br.ue()
                    if idc == 3:
                        break
                    val = br.ue()
                    if idc == 2:
                        use_lt = val
                    else:
                        raise NotImplementedError("pic_num modification")
        marking = {"idr_lt": False, "mmco": []}
        if nal_ref_idc > 0:  # dec_ref_pic_marking
            if is_idr:
                br.u1()  # no_output_of_prior
                marking["idr_lt"] = bool(br.u1())
            else:
                if br.u1():  # adaptive marking
                    while True:
                        op = br.ue()
                        if op == 0:
                            break
                        if op in (1, 2, 4, 6):
                            marking["mmco"].append((op, br.ue()))
                        elif op == 3:
                            marking["mmco"].append((op, br.ue(), br.ue()))
        slice_qp = pps.pic_init_qp + br.se()
        disable_deblock = 0
        if pps.deblocking_filter_control_present:
            disable_deblock = br.ue()
            if disable_deblock != 1:
                br.se()
                br.se()
        adaptive_base_mode = False
        if layer == 1 and ilp:
            # slice_header_in_scalable_extension tail (G.7.3.3.4, the
            # subset the reference emits at `src/h264-lab.h:4335-4370`)
            br.ue()            # ref_layer_dq_id
            br.ue()            # disable_inter_layer_deblocking_filter_idc
            br.ue()
            br.ue()
            br.u1()            # constrained_intra_resampling_flag
            if br.u1():        # slice_skip_flag
                raise NotImplementedError("slice_skip_flag")
            adaptive_base_mode = bool(br.u1())
            if not adaptive_base_mode:
                if br.u1():    # default_base_mode_flag
                    raise NotImplementedError("default_base_mode_flag")
            br.u1()            # adaptive_motion_prediction_flag
            br.u1()            # default_motion_prediction_flag
            br.u1()            # adaptive_residual_prediction_flag
            br.u1()            # default_residual_prediction_flag

        if first_mb == 0:
            self._layer = layer
            self._start_picture(slice_type == 0)
            self._marking = marking
            self._nal_ref_idc = nal_ref_idc
            self._is_idr = is_idr
            self._base_up = None
            if layer == 1 and ilp and self.frames:
                self._base_up = self._upsample_base(self.frames[-1])
        self._adaptive_base_mode = adaptive_base_mode
        if slice_type == 0:
            self._select_reference(use_lt)
        self._deblock_idc = disable_deblock
        self._cur_slice_id += 1
        self._parse_slice_data(br, slice_type, first_mb, slice_qp,
                               disable_deblock)
        if self._n_decoded >= sps.mb_width * sps.mb_height:
            if self._deblock_idc != 1:
                deblock_dec.deblock_picture(
                    self._cur, self._mb_intra, self._mb_avail, self._mv4,
                    self._nnz_luma, self._mb_qp,
                    sps.mb_width, sps.mb_height,
                    self.pps.chroma_qp_index_offset,
                    mb_slice=self._mb_slice,
                    skip_slice_edges=self._deblock_idc == 2)
            self._finish_picture()

    def _select_reference(self, use_lt):
        """Build interpolation planes for the P reference (DPB front or a
        long-term picture selected by ref list modification)."""
        dpb = self._dpbs[self._layer]
        if use_lt is not None:
            frame = dpb["lt"].get(use_lt)
        else:
            frame = dpb["short"] or next(
                iter(dpb["lt"].values()), None)
        if frame is None:
            raise ValueError("P slice without a reference picture")
        key = id(frame)
        if key not in self._interp_cache:
            g = interpolate.GUARD
            y_pad = interpolate.pad(frame.y, g)
            planes = (y_pad,) + interpolate.half_planes(y_pad)
            self._interp_cache = {key: (
                planes,
                interpolate.pad(frame.u, g // 2),
                interpolate.pad(frame.v, g // 2))}
        self._ref_planes = self._interp_cache[key]

    def _finish_picture(self):
        """Apply reference marking for the completed picture."""
        if self._nal_ref_idc == 0:
            return
        cur = self._cur
        if self._is_idr:
            self._dpbs[self._layer] = {"short": None, "lt": {}}
            if self._marking["idr_lt"]:
                self._dpbs[self._layer]["lt"][0] = cur
            else:
                self._dpbs[self._layer]["short"] = cur
            return
        dpb = self._dpbs[self._layer]
        mmco = self._marking["mmco"]
        if not mmco:
            dpb["short"] = cur
            return
        for op in mmco:
            if op[0] == 1:
                dpb["short"] = None
            elif op[0] == 2:
                dpb["lt"].pop(op[1], None)
            elif op[0] == 4:
                maxidx = op[1] - 1
                dpb["lt"] = {k: v for k, v in dpb["lt"].items()
                             if k <= maxidx}
            elif op[0] == 6:
                dpb["lt"][op[1]] = cur
            else:
                raise NotImplementedError(f"MMCO {op[0]}")

    def _start_picture(self, is_p: bool):
        sps = self.sps
        self._cur = DecodedFrame(sps)
        self._nnz_luma = np.zeros((4 * sps.mb_height, 4 * sps.mb_width),
                                  np.int32)
        self._nnz_chroma = np.zeros((2, 2 * sps.mb_height, 2 * sps.mb_width),
                                    np.int32)
        self._mb_intra = np.zeros((sps.mb_height, sps.mb_width), bool)
        self._mb_avail = np.zeros((sps.mb_height, sps.mb_width), bool)
        self._mv = np.zeros((sps.mb_height, sps.mb_width, 2), np.int32)
        self._mv4 = np.zeros((4 * sps.mb_height, 4 * sps.mb_width, 2),
                             np.int32)
        self._i4_modes = np.full((4 * sps.mb_height, 4 * sps.mb_width), -1,
                                 np.int32)
        self._mb_qp = np.zeros((sps.mb_height, sps.mb_width), np.int32)
        self._mb_slice = np.full((sps.mb_height, sps.mb_width), -1, np.int32)
        self._cur_slice_id = -1
        self._n_decoded = 0
        self._cur.sps = sps
        (self.frames if self._layer == 0 else self.enh_frames) \
            .append(self._cur)

    def _upsample_base(self, base_frame):
        """Upsampled base-layer planes for inter-layer intra prediction
        (G.8.6.2 dyadic case: 4-tap luma phases 4/12, bilinear chroma —
        the scalar twin of ops/resample.py), edge-padded to the current
        (enhancement) padded frame size."""
        sps = self.sps

        def up_luma(p):
            def axis(x):
                x = x.astype(np.int64)
                pad = np.pad(x, ((2, 2), (0, 0)), mode="edge")
                n = x.shape[0]
                even = (-3 * pad[1:1 + n] + 28 * pad[2:2 + n]
                        + 8 * pad[3:3 + n] - 1 * pad[4:4 + n])
                odd = (-1 * pad[1:1 + n] + 8 * pad[2:2 + n]
                       + 28 * pad[3:3 + n] - 3 * pad[4:4 + n])
                out = np.empty((2 * n,) + x.shape[1:], np.int64)
                out[0::2] = even
                out[1::2] = odd
                return out
            t = axis(axis(p).T).T
            return np.clip((t + 512) >> 10, 0, 255).astype(np.uint8)

        def up_chroma(p):
            def axis(x):
                x = x.astype(np.int64)
                pad = np.pad(x, ((1, 1), (0, 0)), mode="edge")
                n = x.shape[0]
                even = 3 * pad[1:1 + n] + pad[0:n]
                odd = 3 * pad[1:1 + n] + pad[2:2 + n]
                out = np.empty((2 * n,) + x.shape[1:], np.int64)
                out[0::2] = even
                out[1::2] = odd
                return out
            t = axis(axis(p).T).T
            return np.clip((t + 8) >> 4, 0, 255).astype(np.uint8)

        by, bu, bv = base_frame.cropped(base_frame.sps)

        def pad_to(p, h, w):
            return np.pad(p, ((0, h - p.shape[0]), (0, w - p.shape[1])),
                          mode="edge")

        return (pad_to(up_luma(by), 16 * sps.mb_height, 16 * sps.mb_width),
                pad_to(up_chroma(bu), 8 * sps.mb_height, 8 * sps.mb_width),
                pad_to(up_chroma(bv), 8 * sps.mb_height, 8 * sps.mb_width))

    # ---------------- macroblocks ----------------
    def _parse_slice_data(self, br: BitReader, slice_type: int,
                          first_mb: int, slice_qp: int, disable_deblock: int):
        sps = self.sps
        nmb = sps.mb_width * sps.mb_height
        qp = slice_qp
        mb = first_mb
        # slice-local availability: predictors can't cross slice start
        slice_start = first_mb
        while mb < nmb:
            if slice_type == 2:  # I slice
                if self._adaptive_base_mode and br.u1():
                    qp = self._decode_base_mode_mb(br, mb, qp)
                else:
                    mb_type = br.ue()
                    qp = self._decode_intra_mb(br, mb, mb_type, qp,
                                               slice_start)
                mb += 1
            else:                # P slice
                skip_run = br.ue()
                for _ in range(skip_run):
                    if mb >= nmb:
                        raise ValueError("skip run past end of picture")
                    self._decode_skip_mb(mb, qp)
                    mb += 1
                if mb >= nmb or not br.more_rbsp_data():
                    break
                if self._adaptive_base_mode and br.u1():
                    qp = self._decode_base_mode_mb(br, mb, qp)
                    mb += 1
                    if not br.more_rbsp_data():
                        break
                    continue
                mb_type = br.ue()
                if mb_type >= 5:
                    qp = self._decode_intra_mb(br, mb, mb_type - 5, qp,
                                               slice_start)
                else:
                    qp = self._decode_p_mb(br, mb, mb_type, qp)
                mb += 1
            if not br.more_rbsp_data():
                break

    def _avail_mb(self, mbr: int, mbc: int) -> bool:
        """MB available for prediction: decoded and in the current slice."""
        sps = self.sps
        if not (0 <= mbr < sps.mb_height and 0 <= mbc < sps.mb_width):
            return False
        return self._mb_slice[mbr, mbc] == self._cur_slice_id

    def _nc_luma(self, by: int, bx: int, slice_start_mb: int) -> int:
        """nC context for luma block at block-grid (by, bx)."""
        sps = self.sps
        avail_a = bx > 0 and self._avail_mb(by // 4, (bx - 1) // 4)
        avail_b = by > 0 and self._avail_mb((by - 1) // 4, bx // 4)
        na = self._nnz_luma[by, bx - 1] if avail_a else 0
        nb = self._nnz_luma[by - 1, bx] if avail_b else 0
        if avail_a and avail_b:
            return (int(na) + int(nb) + 1) >> 1
        if avail_a:
            return int(na)
        if avail_b:
            return int(nb)
        return 0

    def _nc_chroma(self, plane: int, by: int, bx: int) -> int:
        avail_a = bx > 0 and self._avail_mb(by // 2, (bx - 1) // 2)
        avail_b = by > 0 and self._avail_mb((by - 1) // 2, bx // 2)
        na = self._nnz_chroma[plane, by, bx - 1] if avail_a else 0
        nb = self._nnz_chroma[plane, by - 1, bx] if avail_b else 0
        if avail_a and avail_b:
            return (int(na) + int(nb) + 1) >> 1
        if avail_a:
            return int(na)
        if avail_b:
            return int(nb)
        return 0

    def _decode_intra_mb(self, br: BitReader, mb: int, mb_type: int,
                         qp: int, slice_start_mb: int) -> int:
        sps, pps = self.sps, self.pps
        mbw = sps.mb_width
        r, c = divmod(mb, mbw)
        self._mb_slice[r, c] = self._cur_slice_id
        if mb_type == 0:
            return self._decode_i4x4_mb(br, mb, qp)
        if not (1 <= mb_type <= 24):
            raise NotImplementedError(f"I mb_type {mb_type}")
        t = mb_type - 1
        pred_mode = t % 4
        cbp_chroma = (t // 4) % 3
        cbp_luma = 15 if t >= 12 else 0

        chroma_mode = br.ue()
        dqp = br.se()
        qp = (qp + dqp) % 52
        qpc = int(QPC_FROM_QPY[np.clip(qp + pps.chroma_qp_index_offset, 0, 51)])

        avail_top = self._avail_mb(r - 1, c)
        avail_left = self._avail_mb(r, c - 1)

        # ---- luma prediction ----
        y = self._cur.y
        top = y[16 * r - 1, 16 * c:16 * c + 16].astype(np.int32) if avail_top else None
        left = y[16 * r:16 * r + 16, 16 * c - 1].astype(np.int32) if avail_left else None
        pred = self._pred16(pred_mode, top, left)

        # ---- luma residual ----
        # DC block
        nc = self._nc_luma(4 * r, 4 * c, slice_start_mb)
        dc_scan, _ = cavlc_dec.decode_block(br, nc, 16)
        dc_raster = np.array(cavlc_dec.scan_to_raster4x4(dc_scan, self.coeff_scan),
                             np.int64).reshape(4, 4)
        dc_deq = dequant_luma_dc(dc_raster, qp)

        recon = np.zeros((16, 16), np.int64)
        ac = np.zeros((16, 16), np.int64)  # per block raster
        nnz_store = np.zeros((4, 4), np.int32)
        if cbp_luma:
            blocks = {}
            for k in BLOCK_SCAN_4x4:
                bb, bc = divmod(int(k), 4)
                nc = self._nc_luma(4 * r + bb, 4 * c + bc, slice_start_mb)
                lv_scan, total = cavlc_dec.decode_block(br, nc, 15)
                nnz_store[bb, bc] = total
                self._nnz_luma[4 * r + bb, 4 * c + bc] = total
                lv = np.array(cavlc_dec.scan_to_raster4x4([0] + lv_scan, self.coeff_scan),
                              np.int64).reshape(4, 4)
                blocks[int(k)] = lv
        else:
            blocks = {k: np.zeros((4, 4), np.int64) for k in range(16)}
            self._nnz_luma[4 * r:4 * r + 4, 4 * c:4 * c + 4] = 0

        for k in range(16):
            bb, bc = divmod(k, 4)
            deq = dequant4x4(blocks[k], qp)
            deq[0, 0] = dc_deq[bb, bc]
            res = idct4x4_core(deq)
            py = pred[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4]
            recon[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4] = clip255(res + py)
        y[16 * r:16 * r + 16, 16 * c:16 * c + 16] = recon.astype(np.uint8)

        # ---- chroma ----
        for plane_idx, plane in enumerate((self._cur.u, self._cur.v)):
            ctop = (plane[8 * r - 1, 8 * c:8 * c + 8].astype(np.int32)
                    if avail_top else None)
            cleft = (plane[8 * r:8 * r + 8, 8 * c - 1].astype(np.int32)
                     if avail_left else None)
            cpred = self._pred_chroma(chroma_mode, ctop, cleft)
            setattr(self, f"_cpred{plane_idx}", cpred)

        # chroma residuals: DC for both planes, then AC for both planes
        cdc_deq = []
        for plane_idx in range(2):
            if cbp_chroma >= 1:
                lv_scan, _ = cavlc_dec.decode_block(br, -1, 4)
                lv = np.array(lv_scan, np.int64).reshape(2, 2)
            else:
                lv = np.zeros((2, 2), np.int64)
            cdc_deq.append(dequant_chroma_dc(lv, qpc))
        for plane_idx, plane in enumerate((self._cur.u, self._cur.v)):
            cpred = getattr(self, f"_cpred{plane_idx}")
            crecon = np.zeros((8, 8), np.int64)
            for k in range(4):
                bb, bc = divmod(k, 2)
                if cbp_chroma == 2:
                    nc = self._nc_chroma(plane_idx, 2 * r + bb, 2 * c + bc)
                    lv_scan, total = cavlc_dec.decode_block(br, nc, 15)
                    self._nnz_chroma[plane_idx, 2 * r + bb, 2 * c + bc] = total
                    lv = np.array(cavlc_dec.scan_to_raster4x4([0] + lv_scan, self.coeff_scan),
                                  np.int64).reshape(4, 4)
                else:
                    self._nnz_chroma[plane_idx, 2 * r + bb, 2 * c + bc] = 0
                    lv = np.zeros((4, 4), np.int64)
                deq = dequant4x4(lv, qpc)
                deq[0, 0] = cdc_deq[plane_idx][bb, bc]
                res = idct4x4_core(deq)
                pc = cpred[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4]
                crecon[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4] = clip255(res + pc)
            plane[8 * r:8 * r + 8, 8 * c:8 * c + 8] = crecon.astype(np.uint8)

        self._mb_intra[r, c] = True
        self._mb_avail[r, c] = True
        self._mb_slice[r, c] = self._cur_slice_id
        self._mv[r, c] = 0
        self._mv4[4 * r:4 * r + 4, 4 * c:4 * c + 4] = 0
        self._mb_qp[r, c] = qp
        self._n_decoded += 1
        return qp

    # ---------------- intra 4x4 ----------------
    # raster blocks whose top-right sample must be replicated (not yet
    # decoded in coded order, or outside the MB on rows > 0)
    _NO_TR = frozenset({5, 7, 11, 13, 15})

    def _decode_i4x4_mb(self, br: BitReader, mb: int, qp: int) -> int:
        sps, pps = self.sps, self.pps
        mbw = sps.mb_width
        r, c = divmod(mb, mbw)
        self._mb_slice[r, c] = self._cur_slice_id
        y = self._cur.y
        gm = self._i4_modes

        # 1. prediction modes, coded block order
        modes = np.zeros(16, np.int32)
        for b in BLOCK_SCAN_4x4:
            bi, bj = divmod(int(b), 4)
            gy, gx = 4 * r + bi, 4 * c + bj
            # spec 8.3.1.1: an unavailable neighbour block forces DC; an
            # available non-Intra4x4 neighbour (gm == -1) counts as DC
            # inside the min
            av_a = bj > 0 or self._avail_mb(r, c - 1)
            av_b = bi > 0 or self._avail_mb(r - 1, c)
            if not av_a or not av_b:
                pred = 2
            else:
                ma = int(gm[gy, gx - 1])
                mbm = int(gm[gy - 1, gx])
                pred = min(2 if ma < 0 else ma, 2 if mbm < 0 else mbm)
            if br.u1():
                mode = pred
            else:
                rem = br.u(3)
                mode = rem if rem < pred else rem + 1
            modes[b] = mode
            gm[gy, gx] = mode

        chroma_mode = br.ue()
        cbp = int(CODENUM_TO_CBP_INTRA[br.ue()])
        cbp_luma = cbp & 15
        cbp_chroma = cbp >> 4
        if cbp:
            qp = (qp + br.se()) % 52
        qpc = int(QPC_FROM_QPY[np.clip(qp + pps.chroma_qp_index_offset,
                                       0, 51)])

        # 2. per-block predict + residual + recon, coded order
        for b in BLOCK_SCAN_4x4:
            b = int(b)
            bi, bj = divmod(b, 4)
            by, bx = 16 * r + 4 * bi, 16 * c + 4 * bj
            a_top = bi > 0 or self._avail_mb(r - 1, c)
            a_left = bj > 0 or self._avail_mb(r, c - 1)
            if bi > 0 and bj > 0:
                a_tl = True
            elif bi == 0 and bj == 0:
                a_tl = self._avail_mb(r - 1, c - 1)
            elif bi == 0:
                a_tl = self._avail_mb(r - 1, c)
            else:
                a_tl = self._avail_mb(r, c - 1)
            if b in self._NO_TR:
                tr_ok = False
            elif bi == 0 and bj == 3:
                tr_ok = self._avail_mb(r - 1, c + 1)
            elif bi == 0:
                tr_ok = self._avail_mb(r - 1, c)
            else:
                tr_ok = True
            t = y[by - 1, bx:bx + 4].astype(np.int32) if a_top else np.zeros(4, np.int32)
            l = y[by:by + 4, bx - 1].astype(np.int32) if a_left else np.zeros(4, np.int32)
            tl = int(y[by - 1, bx - 1]) if a_tl else 0
            if tr_ok and a_top:
                tr = y[by - 1, bx + 4:bx + 8].astype(np.int32)
            else:
                tr = np.full(4, t[3], np.int32)
            mode = int(modes[b])
            pred = self._pred4x4(mode, t, l, tl, tr, a_top, a_left)

            grp = (bi // 2) * 2 + (bj // 2)
            if cbp_luma & (1 << grp):
                nc = self._nc_luma(4 * r + bi, 4 * c + bj, 0)
                lv_scan, total = cavlc_dec.decode_block(br, nc, 16)
                self._nnz_luma[4 * r + bi, 4 * c + bj] = total
                lv = np.array(cavlc_dec.scan_to_raster4x4(lv_scan, self.coeff_scan),
                              np.int64).reshape(4, 4)
                res = idct4x4_core(dequant4x4(lv, qp))
            else:
                self._nnz_luma[4 * r + bi, 4 * c + bj] = 0
                res = np.zeros((4, 4), np.int64)
            y[by:by + 4, bx:bx + 4] = clip255(res + pred).astype(np.uint8)

        # 3. chroma, same structure as Intra_16x16 path
        avail_top = self._avail_mb(r - 1, c)
        avail_left = self._avail_mb(r, c - 1)
        for plane_idx, plane in enumerate((self._cur.u, self._cur.v)):
            ctop = (plane[8 * r - 1, 8 * c:8 * c + 8].astype(np.int32)
                    if avail_top else None)
            cleft = (plane[8 * r:8 * r + 8, 8 * c - 1].astype(np.int32)
                     if avail_left else None)
            setattr(self, f"_cpred{plane_idx}",
                    self._pred_chroma(chroma_mode, ctop, cleft))
        cdc_deq = []
        for plane_idx in range(2):
            if cbp_chroma >= 1:
                lv_scan, _ = cavlc_dec.decode_block(br, -1, 4)
                lv = np.array(lv_scan, np.int64).reshape(2, 2)
            else:
                lv = np.zeros((2, 2), np.int64)
            cdc_deq.append(dequant_chroma_dc(lv, qpc))
        for plane_idx, plane in enumerate((self._cur.u, self._cur.v)):
            cpred = getattr(self, f"_cpred{plane_idx}")
            crecon = np.zeros((8, 8), np.int64)
            for k in range(4):
                bb, bc = divmod(k, 2)
                if cbp_chroma == 2:
                    nc = self._nc_chroma(plane_idx, 2 * r + bb, 2 * c + bc)
                    lv_scan, total = cavlc_dec.decode_block(br, nc, 15)
                    self._nnz_chroma[plane_idx, 2 * r + bb, 2 * c + bc] = total
                    lv = np.array(cavlc_dec.scan_to_raster4x4([0] + lv_scan, self.coeff_scan),
                                  np.int64).reshape(4, 4)
                else:
                    self._nnz_chroma[plane_idx, 2 * r + bb, 2 * c + bc] = 0
                    lv = np.zeros((4, 4), np.int64)
                deq = dequant4x4(lv, qpc)
                deq[0, 0] = cdc_deq[plane_idx][bb, bc]
                res = idct4x4_core(deq)
                pc = cpred[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4]
                crecon[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4] = clip255(res + pc)
            plane[8 * r:8 * r + 8, 8 * c:8 * c + 8] = crecon.astype(np.uint8)

        self._mb_intra[r, c] = True
        self._mb_avail[r, c] = True
        self._mb_slice[r, c] = self._cur_slice_id
        self._mv[r, c] = 0
        self._mv4[4 * r:4 * r + 4, 4 * c:4 * c + 4] = 0
        self._mb_qp[r, c] = qp
        self._n_decoded += 1
        return qp

    @staticmethod
    def _pred4x4(mode, t, l, tl, tr, avail_top, avail_left):
        """Scalar 4x4 intra prediction (spec 8.3.1.2). DC handles partial
        availability; other modes assume the caller ensured availability."""
        if mode == 2:
            if avail_top and avail_left:
                dc = (int(t.sum()) + int(l.sum()) + 4) >> 3
            elif avail_top:
                dc = (int(t.sum()) + 2) >> 2
            elif avail_left:
                dc = (int(l.sum()) + 2) >> 2
            else:
                dc = 128
            return np.full((4, 4), dc, np.int64)
        from h264lab_tpu_torch.decoder.intra_pred import pred4 as _p4
        return _p4(mode, t, l, tl, tr).astype(np.int64)

    # ---------------- inter (P) ----------------
    def _blk_mv(self, gy: int, gx: int, cur_rc=None):
        """Block-level neighbour: (mv(2,), ref0, avail). cur_rc marks the
        MB currently being decoded (its already-written blocks count as
        available; callers only use decode-order-valid offsets)."""
        sps = self.sps
        if not (0 <= gy < 4 * sps.mb_height and 0 <= gx < 4 * sps.mb_width):
            return np.zeros(2, np.int32), False, False
        mbr, mbc = gy // 4, gx // 4
        if (mbr, mbc) != cur_rc and not self._avail_mb(mbr, mbc):
            return np.zeros(2, np.int32), False, False
        if self._mb_intra[mbr, mbc] and (mbr, mbc) != cur_rc:
            return np.zeros(2, np.int32), False, True
        if (mbr, mbc) == cur_rc and self._mb_intra[mbr, mbc]:
            return np.zeros(2, np.int32), False, True
        return self._mv4[gy, gx].copy(), True, True

    def _mvp_part(self, r: int, c: int, a_off, b_off, c_off, d_off,
                  directional=None):
        """Spec 8.4.1.3 predictor for a partition; offsets are
        (dy, dx) in 4x4-block units relative to the MB origin, or None
        for statically unavailable C."""
        cur = (r, c)

        def at(off):
            if off is None:
                return np.zeros(2, np.int32), False, False
            return self._blk_mv(4 * r + off[0], 4 * c + off[1], cur)

        mva, refa, ava = at(a_off)
        mvb, refb, avb = at(b_off)
        mvc, refc, avc = at(c_off)
        if not avc:
            mvc, refc, avc = at(d_off)
        if not avb and not avc and ava:
            mvb, refb = mva, refa
            mvc, refc = mva, refa
        if directional == "A" and refa:
            return mva
        if directional == "B" and refb:
            return mvb
        if directional == "C" and refc:
            return mvc
        cnt = int(refa) + int(refb) + int(refc)
        if cnt == 1:
            if refa:
                return mva
            if refb:
                return mvb
            return mvc
        return np.median(np.stack([mva, mvb, mvc]), axis=0).astype(np.int32)

    def _mvp(self, r: int, c: int):
        """Median MV predictor (spec 8.4.1.3) for a 16x16 partition."""
        return self._mvp_part(r, c, (0, -1), (-1, 0), (-1, 4), (-1, -1))

    def _skip_mv(self, r: int, c: int):
        mva, refa, ava = self._blk_mv(4 * r, 4 * c - 1)
        mvb, refb, avb = self._blk_mv(4 * r - 1, 4 * c)
        if (not ava or not avb
                or (refa and mva[0] == 0 and mva[1] == 0)
                or (refb and mvb[0] == 0 and mvb[1] == 0)):
            return np.zeros(2, np.int32)
        return self._mvp(r, c)

    def _mc_predict(self, r: int, c: int, mv):
        planes, u_pad, v_pad = self._ref_planes
        g = interpolate.GUARD
        py = interpolate.mc_luma_block(planes, g + 16 * r, g + 16 * c,
                                       int(mv[0]), int(mv[1]))
        pu = interpolate.mc_chroma_block(u_pad, g // 2 + 8 * r,
                                         g // 2 + 8 * c, int(mv[0]), int(mv[1]))
        pv = interpolate.mc_chroma_block(v_pad, g // 2 + 8 * r,
                                         g // 2 + 8 * c, int(mv[0]), int(mv[1]))
        return py, pu, pv

    def _decode_skip_mb(self, mb: int, qp: int):
        sps = self.sps
        r, c = divmod(mb, sps.mb_width)
        self._mb_slice[r, c] = self._cur_slice_id
        mv = self._skip_mv(r, c)
        py, pu, pv = self._mc_predict(r, c, mv)
        self._cur.y[16 * r:16 * r + 16, 16 * c:16 * c + 16] = py
        self._cur.u[8 * r:8 * r + 8, 8 * c:8 * c + 8] = pu
        self._cur.v[8 * r:8 * r + 8, 8 * c:8 * c + 8] = pv
        self._mv[r, c] = mv
        self._mv4[4 * r:4 * r + 4, 4 * c:4 * c + 4] = mv
        self._mb_intra[r, c] = False
        self._mb_avail[r, c] = True
        self._mb_slice[r, c] = self._cur_slice_id
        self._nnz_luma[4 * r:4 * r + 4, 4 * c:4 * c + 4] = 0
        self._nnz_chroma[:, 2 * r:2 * r + 2, 2 * c:2 * c + 2] = 0
        self._mb_qp[r, c] = qp
        self._n_decoded += 1

    # partition layouts per P mb_type: (block_y, block_x), (bh, bw) in
    # 4x4-block units, predictor neighbour offsets (A, B, C, D) and the
    # directional preference of spec 8.4.1.3 (None = median)
    _P_PARTS = {
        0: [((0, 0), (4, 4), ((0, -1), (-1, 0), (-1, 4), (-1, -1)), None)],
        1: [((0, 0), (2, 4), ((0, -1), (-1, 0), (-1, 4), (-1, -1)), "B"),
            ((2, 0), (2, 4), ((2, -1), (1, 0), None, (1, -1)), "A")],
        2: [((0, 0), (4, 2), ((0, -1), (-1, 0), (-1, 2), (-1, -1)), "A"),
            ((0, 2), (4, 2), ((0, 1), (-1, 2), (-1, 4), (-1, 1)), "C")],
        3: [((0, 0), (2, 2), ((0, -1), (-1, 0), (-1, 2), (-1, -1)), None),
            ((0, 2), (2, 2), ((0, 1), (-1, 2), (-1, 4), (-1, 1)), None),
            ((2, 0), (2, 2), ((2, -1), (1, 0), (1, 2), (1, -1)), None),
            ((2, 2), (2, 2), ((2, 1), (1, 2), None, (1, 1)), None)],
    }

    def _decode_base_mode_mb(self, br: BitReader, mb: int, qp: int) -> int:
        """I_BL macroblock (base_mode_flag=1): prediction is the
        co-located upsampled base-layer block (G.8.6.2); residual is
        coded inter-style — CBP from the inter map, 16-coefficient luma
        blocks, no prediction-mode syntax. Counts as intra for
        deblocking."""
        sps, pps = self.sps, self.pps
        if self._base_up is None:
            raise ValueError("base_mode_flag without a decoded base layer")
        r, c = divmod(mb, sps.mb_width)
        self._mb_slice[r, c] = self._cur_slice_id
        self._mb_intra[r, c] = True
        self._mb_avail[r, c] = True
        self._mv[r, c] = 0
        self._mv4[4 * r:4 * r + 4, 4 * c:4 * c + 4] = 0

        cbp = int(CODENUM_TO_CBP_INTER[br.ue()])
        cbp_luma = cbp & 15
        cbp_chroma = cbp >> 4
        if cbp:
            qp = (qp + br.se()) % 52
        qpc = int(QPC_FROM_QPY[np.clip(qp + pps.chroma_qp_index_offset,
                                       0, 51)])

        up_y, up_u, up_v = self._base_up
        py = up_y[16 * r:16 * r + 16, 16 * c:16 * c + 16]
        recon = py.astype(np.int64).copy()
        for k in BLOCK_SCAN_4x4:
            bb, bc = divmod(int(k), 4)
            grp = (bb // 2) * 2 + (bc // 2)
            if cbp_luma & (1 << grp):
                nc = self._nc_luma(4 * r + bb, 4 * c + bc, 0)
                lv_scan, total = cavlc_dec.decode_block(br, nc, 16)
                self._nnz_luma[4 * r + bb, 4 * c + bc] = total
                lv = np.array(cavlc_dec.scan_to_raster4x4(
                    lv_scan, self.coeff_scan), np.int64).reshape(4, 4)
                res = idct4x4_core(dequant4x4(lv, qp))
                blk = recon[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4]
                recon[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4] = \
                    clip255(blk + res)
            else:
                self._nnz_luma[4 * r + bb, 4 * c + bc] = 0
        self._cur.y[16 * r:16 * r + 16, 16 * c:16 * c + 16] = \
            recon.astype(np.uint8)

        cdc_deq = []
        for plane_idx in range(2):
            if cbp_chroma >= 1:
                lv_scan, _ = cavlc_dec.decode_block(br, -1, 4)
                lv = np.array(lv_scan, np.int64).reshape(2, 2)
            else:
                lv = np.zeros((2, 2), np.int64)
            cdc_deq.append(dequant_chroma_dc(lv, qpc))
        for plane_idx, (plane, up) in enumerate(
                ((self._cur.u, up_u), (self._cur.v, up_v))):
            cpred = up[8 * r:8 * r + 8, 8 * c:8 * c + 8]
            crec = np.zeros((8, 8), np.int64)
            for k in range(4):
                bb, bc = divmod(k, 2)
                if cbp_chroma == 2:
                    nc = self._nc_chroma(plane_idx, 2 * r + bb, 2 * c + bc)
                    lv_scan, total = cavlc_dec.decode_block(br, nc, 15)
                    self._nnz_chroma[plane_idx, 2 * r + bb,
                                     2 * c + bc] = total
                    lv = np.array(cavlc_dec.scan_to_raster4x4(
                        [0] + lv_scan, self.coeff_scan),
                        np.int64).reshape(4, 4)
                else:
                    self._nnz_chroma[plane_idx, 2 * r + bb, 2 * c + bc] = 0
                    lv = np.zeros((4, 4), np.int64)
                deq = dequant4x4(lv, qpc)
                deq[0, 0] = cdc_deq[plane_idx][bb, bc]
                res = idct4x4_core(deq)
                pc = cpred[4 * bb:4 * bb + 4,
                           4 * bc:4 * bc + 4].astype(np.int64)
                crec[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4] = \
                    clip255(res + pc)
            plane[8 * r:8 * r + 8, 8 * c:8 * c + 8] = crec.astype(np.uint8)
        self._mb_qp[r, c] = qp
        self._n_decoded += 1
        return qp

    def _decode_p_mb(self, br: BitReader, mb: int, mb_type: int,
                     qp: int) -> int:
        sps, pps = self.sps, self.pps
        if mb_type > 4:
            raise NotImplementedError(f"P mb_type {mb_type}")
        if mb_type == 4:
            mb_type = 3      # P_8x8ref0 == P_8x8 with a single reference
        r, c = divmod(mb, sps.mb_width)
        self._mb_slice[r, c] = self._cur_slice_id
        parts = self._P_PARTS[mb_type]
        if mb_type == 3:
            for _ in range(4):
                sub = br.ue()
                if sub != 0:
                    raise NotImplementedError("sub-8x8 partitions")
        self._mb_intra[r, c] = False
        for (by, bx), (bh, bw), offs, direc in parts:
            mvd_x = br.se()
            mvd_y = br.se()
            mvp = self._mvp_part(r, c, offs[0], offs[1], offs[2], offs[3],
                                 direc)
            mv = np.array([mvp[0] + mvd_y, mvp[1] + mvd_x], np.int32)
            self._mv4[4 * r + by:4 * r + by + bh,
                      4 * c + bx:4 * c + bx + bw] = mv
        self._mv[r, c] = self._mv4[4 * r, 4 * c]
        self._mb_avail[r, c] = True
        self._mb_slice[r, c] = self._cur_slice_id

        cbp = int(CODENUM_TO_CBP_INTER[br.ue()])
        cbp_luma = cbp & 15
        cbp_chroma = cbp >> 4
        if cbp:
            dqp = br.se()
            qp = (qp + dqp) % 52
        qpc = int(QPC_FROM_QPY[np.clip(qp + pps.chroma_qp_index_offset,
                                       0, 51)])

        # motion compensation per partition
        planes, u_pad, v_pad = self._ref_planes
        g = interpolate.GUARD
        py = np.zeros((16, 16), np.uint8)
        pu = np.zeros((8, 8), np.uint8)
        pv = np.zeros((8, 8), np.uint8)
        for (by, bx), (bh, bw), _, _ in parts:
            mv = self._mv4[4 * r + by, 4 * c + bx]
            py[4 * by:4 * by + 4 * bh, 4 * bx:4 * bx + 4 * bw] = \
                interpolate.mc_luma_block(
                    planes, g + 16 * r + 4 * by, g + 16 * c + 4 * bx,
                    int(mv[0]), int(mv[1]), 4 * bh, 4 * bw)
            pu[2 * by:2 * by + 2 * bh, 2 * bx:2 * bx + 2 * bw] = \
                interpolate.mc_chroma_block(
                    u_pad, g // 2 + 8 * r + 2 * by, g // 2 + 8 * c + 2 * bx,
                    int(mv[0]), int(mv[1]), 2 * bh, 2 * bw)
            pv[2 * by:2 * by + 2 * bh, 2 * bx:2 * bx + 2 * bw] = \
                interpolate.mc_chroma_block(
                    v_pad, g // 2 + 8 * r + 2 * by, g // 2 + 8 * c + 2 * bx,
                    int(mv[0]), int(mv[1]), 2 * bh, 2 * bw)

        recon = py.astype(np.int64).copy()
        for k in BLOCK_SCAN_4x4:
            bb, bc = divmod(int(k), 4)
            grp = (bb // 2) * 2 + (bc // 2)
            if cbp_luma & (1 << grp):
                nc = self._nc_luma(4 * r + bb, 4 * c + bc, 0)
                lv_scan, total = cavlc_dec.decode_block(br, nc, 16)
                self._nnz_luma[4 * r + bb, 4 * c + bc] = total
                lv = np.array(cavlc_dec.scan_to_raster4x4(
                    lv_scan, self.coeff_scan), np.int64).reshape(4, 4)
                res = idct4x4_core(dequant4x4(lv, qp))
                blk = recon[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4]
                recon[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4] = \
                    clip255(blk + res)
            else:
                self._nnz_luma[4 * r + bb, 4 * c + bc] = 0
        self._cur.y[16 * r:16 * r + 16, 16 * c:16 * c + 16] = \
            recon.astype(np.uint8)

        # chroma: DC both planes, then AC both planes
        cdc_deq = []
        for plane_idx in range(2):
            if cbp_chroma >= 1:
                lv_scan, _ = cavlc_dec.decode_block(br, -1, 4)
                lv = np.array(lv_scan, np.int64).reshape(2, 2)
            else:
                lv = np.zeros((2, 2), np.int64)
            cdc_deq.append(dequant_chroma_dc(lv, qpc))
        for plane_idx, (plane, cpred) in enumerate(
                ((self._cur.u, pu), (self._cur.v, pv))):
            crec = np.zeros((8, 8), np.int64)
            for k in range(4):
                bb, bc = divmod(k, 2)
                if cbp_chroma == 2:
                    nc = self._nc_chroma(plane_idx, 2 * r + bb, 2 * c + bc)
                    lv_scan, total = cavlc_dec.decode_block(br, nc, 15)
                    self._nnz_chroma[plane_idx, 2 * r + bb, 2 * c + bc] = total
                    lv = np.array(cavlc_dec.scan_to_raster4x4(
                        [0] + lv_scan, self.coeff_scan),
                        np.int64).reshape(4, 4)
                else:
                    self._nnz_chroma[plane_idx, 2 * r + bb, 2 * c + bc] = 0
                    lv = np.zeros((4, 4), np.int64)
                deq = dequant4x4(lv, qpc)
                deq[0, 0] = cdc_deq[plane_idx][bb, bc]
                res = idct4x4_core(deq)
                pc = cpred[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4].astype(np.int64)
                crec[4 * bb:4 * bb + 4, 4 * bc:4 * bc + 4] = clip255(res + pc)
            plane[8 * r:8 * r + 8, 8 * c:8 * c + 8] = crec.astype(np.uint8)
        self._mb_qp[r, c] = qp
        self._n_decoded += 1
        return qp

    # ---------------- predictions ----------------
    @staticmethod
    def _pred16(mode: int, top, left) -> np.ndarray:
        if mode == 0:  # V
            _require(top is not None)
            return np.tile(top, (16, 1))
        if mode == 1:  # H
            _require(left is not None)
            return np.tile(left[:, None], (1, 16))
        if mode == 2:  # DC
            if top is not None and left is not None:
                dc = (int(top.sum()) + int(left.sum()) + 16) >> 5
            elif top is not None:
                dc = (int(top.sum()) + 8) >> 4
            elif left is not None:
                dc = (int(left.sum()) + 8) >> 4
            else:
                dc = 128
            return np.full((16, 16), dc, np.int32)
        raise NotImplementedError("I16 plane mode")

    @staticmethod
    def _pred_chroma(mode: int, top, left) -> np.ndarray:
        if mode == 1:  # H
            _require(left is not None)
            return np.tile(left[:, None], (1, 8))
        if mode == 2:  # V
            _require(top is not None)
            return np.tile(top, (8, 1))
        if mode == 0:  # DC per quadrant
            out = np.zeros((8, 8), np.int32)

            def seg(arr, lo):
                return int(arr[lo:lo + 4].sum()) if arr is not None else None

            st0, st1 = seg(top, 0), seg(top, 4)
            sl0, sl1 = seg(left, 0), seg(left, 4)

            def q(sum_t, sum_l, prefer):
                if prefer == "both":
                    if sum_t is not None and sum_l is not None:
                        return (sum_t + sum_l + 4) >> 3
                    if sum_t is not None:
                        return (sum_t + 2) >> 2
                    if sum_l is not None:
                        return (sum_l + 2) >> 2
                    return 128
                if prefer == "top":
                    if sum_t is not None:
                        return (sum_t + 2) >> 2
                    if sum_l is not None:
                        return (sum_l + 2) >> 2
                    return 128
                if sum_l is not None:
                    return (sum_l + 2) >> 2
                if sum_t is not None:
                    return (sum_t + 2) >> 2
                return 128

            out[0:4, 0:4] = q(st0, sl0, "both")
            out[0:4, 4:8] = q(st1, sl0, "top")
            out[4:8, 0:4] = q(st0, sl1, "left")
            out[4:8, 4:8] = q(st1, sl1, "both")
            return out
        raise NotImplementedError("chroma plane mode")
