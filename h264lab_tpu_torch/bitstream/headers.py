"""High-level H.264 syntax: SPS, PPS and slice headers (baseline profile).

Behavioral parity with the reference's `encode_sps` / `encode_pps` /
`encode_slice_header` (`src/h264-lab.h:4040-4372`):

- pic_order_cnt_type = 2 (decode order == output order; no POC bits)
- log2_max_frame_num_minus4 = 1 → 5-bit frame_num
- level chosen from frame size / VBV / DPB via the Annex-A limit table
- long-term references driven by MMCO marking ops in the slice header
"""

from __future__ import annotations

import dataclasses

from h264lab_tpu_torch.bitstream.bitwriter import BitWriter
from h264lab_tpu_torch.bitstream.nal import annexb_nal

LOG2_MAX_FRAME_NUM_MINUS4 = 1
FRAME_NUM_BITS = 4 + LOG2_MAX_FRAME_NUM_MINUS4

PROFILE_BASELINE = 66
PROFILE_SCALABLE_BASELINE = 83

SLICE_TYPE_P = 0
SLICE_TYPE_I = 2

NAL_SLICE = 1
NAL_IDR = 5
NAL_SPS = 7
NAL_PPS = 8
NAL_PREFIX = 14
NAL_SLICE_SCALABLE = 20
NAL_FILLER = 12

# Annex-A level limits: (level_idc, constraint_byte, max_frame_size_mbs,
# max_cpb_kbits, max_dpb_mbs). Mirrors the table the reference embeds at
# `src/h264-lab.h:4050-4067` (values are ITU-T H.264 Table A-1).
LEVEL_LIMITS = (
    (10, 0xE0, 99, 175, 396),
    (10, 0xF0, 99, 350, 396),       # level 1b
    (11, 0xE0, 396, 500, 900),
    (12, 0xE0, 396, 1000, 2376),
    (13, 0xE0, 396, 2000, 2376),
    (20, 0xE0, 396, 2000, 2376),
    (21, 0xE0, 792, 4000, 4752),
    (22, 0xE0, 1620, 4000, 8100),
    (30, 0xE0, 1620, 10000, 8100),
    (31, 0xE0, 3600, 14000, 18000),
    (32, 0xE0, 5120, 20000, 20480),
    (40, 0xE0, 8192, 25000, 32768),
    (41, 0xE0, 8192, 62500, 32768),
    (42, 0xE0, 8704, 62500, 34816),
    (50, 0xE0, 22080, 135000, 110400),
    (51, 0xE0, 36864, 240000, 184320),
)


def select_level(n_mb: int, vbv_size_bytes: int, n_ref_frames: int):
    """Pick the smallest level satisfying frame size, VBV and DPB limits
    (reference: `src/h264-lab.h:4068-4076`)."""
    for level, constraints, max_fs, max_cpb_kbit, max_dpb in LEVEL_LIMITS:
        if (n_mb <= max_fs
                and vbv_size_bytes * 8 <= max_cpb_kbit * 1000
                and n_mb * n_ref_frames <= max_dpb):
            return level, constraints
    return LEVEL_LIMITS[-1][0], LEVEL_LIMITS[-1][1]


@dataclasses.dataclass(frozen=True)
class SpsParams:
    width: int                  # display width (pre-padding)
    height: int
    mb_width: int
    mb_height: int
    sps_id: int = 0
    num_ref_frames: int = 1     # 1 + max long-term references
    vbv_size_bytes: int = 0
    profile_idc: int = PROFILE_BASELINE

    @property
    def cropping(self):
        return (self.mb_width * 16 != self.width
                or self.mb_height * 16 != self.height)


def write_sps_rbsp(bw: BitWriter, p: SpsParams):
    level, constraints = select_level(
        p.mb_width * p.mb_height, p.vbv_size_bytes, p.num_ref_frames)
    bw.u(8, p.profile_idc)
    # constraint_set flags byte; the reference emits constraint_set2 only for
    # plain baseline (`src/h264-lab.h:4080`)
    bw.u(8, constraints & (4 * (p.profile_idc != PROFILE_SCALABLE_BASELINE)))
    bw.u(8, level)
    bw.ue(p.sps_id)
    if p.profile_idc == PROFILE_SCALABLE_BASELINE:
        bw.ue(1)   # chroma_format_idc 4:2:0
        bw.ue(0)   # bit_depth_luma_minus8
        bw.ue(0)   # bit_depth_chroma_minus8
        bw.u1(0)   # qpprime_y_zero_transform_bypass_flag
        bw.u1(0)   # seq_scaling_matrix_present_flag
    bw.ue(LOG2_MAX_FRAME_NUM_MINUS4)
    bw.ue(2)                     # pic_order_cnt_type
    bw.ue(p.num_ref_frames)      # max_num_ref_frames
    bw.u1(0)                     # gaps_in_frame_num_value_allowed_flag
    bw.ue(p.mb_width - 1)
    bw.ue(p.mb_height - 1)
    bw.u1(1)                     # frame_mbs_only_flag
    bw.u1(1)                     # direct_8x8_inference_flag
    bw.u1(1 if p.cropping else 0)
    if p.cropping:
        bw.ue(0)
        bw.ue((p.mb_width * 16 - p.width) // 2)    # frame_crop_right (in 2-px units)
        bw.ue(0)
        bw.ue((p.mb_height * 16 - p.height) // 2)  # frame_crop_bottom
    bw.u1(0)                     # vui_parameters_present_flag
    if p.profile_idc == PROFILE_SCALABLE_BASELINE:
        bw.u1(1)     # inter_layer_deblocking_filter_control_present_flag
        bw.u(2, 0)   # extended_spatial_scalability
        bw.u1(0)     # chroma_phase_x_plus1_flag
        bw.u(2, 0)   # chroma_phase_y_plus1
        bw.u1(0)     # seq_tcoeff_level_prediction_flag
        bw.u1(1)     # slice_header_restriction_flag
        bw.u1(0)     # svc_vui_parameters_present_flag
        bw.u1(0)     # additional_extension2_flag
    bw.rbsp_trailing_bits()


def sps_nal(p: SpsParams) -> bytes:
    bw = BitWriter()
    write_sps_rbsp(bw, p)
    nal_type = NAL_SPS | (8 if p.profile_idc == PROFILE_SCALABLE_BASELINE else 0)
    # reference emits 0x67 (ref_idc=3) / 0x6F for subset SPS
    return annexb_nal(3, nal_type, bw.to_bytes())


def write_pps_rbsp(bw: BitWriter, sps_id: int, pps_id: int, pic_init_qp: int,
                   chroma_qp_index_offset: int = 0):
    bw.ue(sps_id * 4 + pps_id)   # pic_parameter_set_id (reference numbering)
    bw.ue(sps_id)
    bw.u1(0)    # entropy_coding_mode_flag: CAVLC
    bw.u1(0)    # bottom_field_pic_order_in_frame_present_flag
    bw.ue(0)    # num_slice_groups_minus1
    bw.ue(0)    # num_ref_idx_l0_default_active_minus1
    bw.ue(0)    # num_ref_idx_l1_default_active_minus1
    bw.u1(0)    # weighted_pred_flag
    bw.u(2, 0)  # weighted_bipred_idc
    bw.se(pic_init_qp - 26)
    bw.se(0)    # pic_init_qs_minus26
    bw.se(chroma_qp_index_offset)
    bw.u1(1)    # deblocking_filter_control_present_flag
    bw.u1(0)    # constrained_intra_pred_flag
    bw.u1(0)    # redundant_pic_cnt_present_flag
    bw.rbsp_trailing_bits()


def pps_nal(sps_id: int, pps_id: int, pic_init_qp: int) -> bytes:
    bw = BitWriter()
    write_pps_rbsp(bw, sps_id, pps_id, pic_init_qp)
    return annexb_nal(3, NAL_PPS, bw.to_bytes())


@dataclasses.dataclass
class SliceHeaderParams:
    slice_type: int              # SLICE_TYPE_P / SLICE_TYPE_I
    is_idr: bool
    frame_num: int
    first_mb: int = 0
    pps_id: int = 0              # full pic_parameter_set_id value
    idr_pic_id: int = 0
    slice_qp: int = 26
    pic_init_qp: int = 26
    disable_deblocking_filter_idc: int = 0
    # long-term reference machinery (reference `src/h264-lab.h:4263-4311`)
    long_term_idx_use: int = 0       # >0: predict from LTR slot (use-1)
    long_term_idx_update: int = 0    # -1 droppable, 0 short-term, >0 LTR slot
    short_term_used: bool = False
    lt_slot_in_use: bool = False     # target LTR slot currently marked used
    max_long_term_frames: int = 0
    # slice_header_in_scalable_extension tail for an enhancement slice
    # with inter-layer prediction (G.7.3.3.4; reference
    # `src/h264-lab.h:4335-4370`): announces adaptive per-MB
    # base_mode_flag signalling in the slice data
    svc_ilp: bool = False


def write_slice_header_rbsp(bw: BitWriter, p: SliceHeaderParams):
    bw.ue(p.first_mb)
    bw.ue(p.slice_type)
    bw.ue(p.pps_id)
    bw.u(FRAME_NUM_BITS, p.frame_num & ((1 << FRAME_NUM_BITS) - 1))
    if p.is_idr:
        bw.ue(p.idr_pic_id)
    if p.slice_type == SLICE_TYPE_P:
        bw.u1(0)  # num_ref_idx_active_override_flag
        mod = 1 if p.long_term_idx_use > 0 else 0
        bw.u1(mod)  # ref_pic_list_modification_flag_l0
        if mod:
            bw.ue(2)  # modification_of_pic_nums_idc: long_term_pic_num
            bw.ue(p.long_term_idx_use - 1)
            bw.ue(3)  # end of modification loop
    if p.long_term_idx_update >= 0:   # current picture is a reference
        if p.is_idr:
            bw.u1(0)  # no_output_of_prior_pics_flag
            bw.u1(1 if p.max_long_term_frames > 0 else 0)  # long_term_reference_flag
        else:
            adaptive = p.long_term_idx_update > 0
            bw.u1(1 if adaptive else 0)
            if adaptive:
                if p.short_term_used:
                    bw.ue(1)  # MMCO 1: unmark short-term
                    bw.ue(0)  # difference_of_pic_nums_minus1
                if p.lt_slot_in_use:
                    bw.ue(2)  # MMCO 2: unmark long-term slot
                    bw.ue(p.long_term_idx_update - 1)
                else:
                    bw.ue(4)  # MMCO 4: max_long_term_frame_idx_plus1
                    bw.ue(p.max_long_term_frames)
                bw.ue(6)  # MMCO 6: mark current as long-term
                bw.ue(p.long_term_idx_update - 1)
                bw.ue(0)  # end MMCO loop
    bw.se(p.slice_qp - p.pic_init_qp)
    bw.ue(p.disable_deblocking_filter_idc)
    if p.disable_deblocking_filter_idc != 1:
        bw.se(0)  # slice_alpha_c0_offset_div2
        bw.se(0)  # slice_beta_offset_div2
    if p.svc_ilp:
        # inter-layer prediction fields of
        # slice_header_in_scalable_extension (bit-compatible with the
        # reference's NAL-20 headers, `src/h264-lab.h:4335-4370`)
        bw.ue(0)   # ref_layer_dq_id (base dependency 0, quality 0)
        bw.ue(0)   # disable_inter_layer_deblocking_filter_idc
        bw.ue(0)   # inter-layer filter offset fields (reference emits
        bw.ue(0)   #   two further ue(0) here)
        bw.u1(0)   # constrained_intra_resampling_flag
        bw.u1(0)   # slice_skip_flag
        bw.u1(1)   # adaptive_base_mode_flag: per-MB base_mode_flag
        bw.u1(0)   # adaptive_motion_prediction_flag
        bw.u1(0)   # default_motion_prediction_flag
        bw.u1(0)   # adaptive_residual_prediction_flag
        bw.u1(0)   # default_residual_prediction_flag


def slice_nal_header_byte(p: SliceHeaderParams) -> tuple[int, int]:
    """(nal_ref_idc, nal_unit_type) for a slice of this kind."""
    nal_type = NAL_IDR if p.is_idr else NAL_SLICE
    ref_idc = 3 if p.long_term_idx_update >= 0 else 0
    return ref_idc, nal_type
