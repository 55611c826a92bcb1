"""Rate-distortion tuning constants, collected in one place.

The reference keeps its empirically-fitted RD tables behind the
`ADJUSTABLE` macro so an external training app can re-fit them
(`src/h264-lab.h:787-790`, deadzones/thresholds/lambdas `:989-1120`).
These are this encoder's equivalents, fitted against the RD-parity
harness (tests/test_rd_parity.py; results in RD_COMPARE.md). Every
constant can be overridden through an `H264LAB_TUNE_<NAME>` environment
variable — the fitting hook the ablation sweeps use (tools/rd_sweep.py).
"""

import os as _os


def _tune(name: str, default: int) -> int:
    return int(_os.environ.get(f"H264LAB_TUNE_{name}", default))


# quantizer deadzone rounding, in 1/256ths of the quantization step.
# The reference's fitted rounding tables sit near 0.37 (intra) / 0.23
# (inter) of the step at mid QPs (`g_deadzonei`/`g_rnd_inter`,
# `src/h264-lab.h:989-1120`, Q16 scale) — noticeably above the JM 1/3
# and 1/6 defaults; these match the reference's operating point.
INTRA_DEADZONE_Q8 = _tune("INTRA_DEADZONE_Q8", 94)
# 72 measured best-of-sweep on the RD ladder (RD_COMPARE.md: 59 -> +0.48
# worst delta, 66 -> +0.73, 72 -> +0.93, 80 -> +1.23 but further from
# the reference's fitted 0.23-of-step scale; 72 keeps margin without
# chasing the extreme of one synthetic fixture)
INTER_DEADZONE_Q8 = _tune("INTER_DEADZONE_Q8", 72)

# zero-block thresholding on the inter path (reference `zero_smallq`
# mechanism, `src/h264-lab.h:2491-2534`; per-coefficient thresholds in
# quantization steps, Q8): a 4x4 block whose transform coefficients all
# sit at or below THR steps is zeroed wholesale, an 8x8 quarter below
# THR2 likewise — scattered small levels on noise-like residual cost
# CAVLC bits far above their distortion value. 0 disables. Defaults
# fitted on the two-content RD ladder (RD_COMPARE.md).
INTER_ZERO_THR_Q8 = _tune("INTER_ZERO_THR_Q8", 186)
INTER_ZERO_THR2_Q8 = _tune("INTER_ZERO_THR2_Q8", 282)

# mode-decision side-info bit charges (lambda-weighted), reference
# lambda/cost experiment log `src/h264-lab.h:4862-4874`
INTRA_IN_P_PENALTY_BITS = _tune("INTRA_IN_P_PENALTY_BITS", 24)
# The reference charges Intra_4x4 a large fitted block-kind penalty
# (`g_lambda_i4_q4`, ~lambda*74 bits at mid QP); matching it here was
# worth ~0.6 dB on the RD ladder (see RD_COMPARE.md ablations).
I4_PENALTY_BITS = _tune("I4_PENALTY_BITS", 74)
PART_16X8_PENALTY_BITS = _tune("PART_16X8_PENALTY_BITS", 12)
PART_8X8_PENALTY_BITS = _tune("PART_8X8_PENALTY_BITS", 30)

# ---------------------------------------------------------------------
# early-skip bias (reference `g_skip_thr_inter`-class gates,
# `src/h264-lab.h:5306-5350`): a sub-pel ME position equal to the spatial
# predictor whose SAD is below SKIP_THR_BASE + qp * SKIP_THR_QP gets a
# SKIP_BIAS_BITS bits bonus — steering the search toward exactly-skippable
# MVs. The authoritative skip decision (cbp==0 and mv==exact skip
# predictor, chroma included — the reference's chroma confirmation) is
# made in the post-scan symbolization (models/mbscan.py).
SKIP_THR_BASE = _tune("SKIP_THR_BASE", 0)
SKIP_THR_QP = _tune("SKIP_THR_QP", 8)
# ~ saved mb_type/cbp/mvd syntax of a skip MB
SKIP_BIAS_BITS = _tune("SKIP_BIAS_BITS", 10)
