"""Two-level rate control with a VBV buffer model.

Re-implementation of the reference's rate-control capability surface
(`rc_frame_start` `src/h264-lab.h:5924-6070`, `rc_frame_end` `:6075-6141`,
MB-level `rc_mb_end` `:6146-6179`):

- per-frame QP chosen from an adaptive per-QP bits/MB LUT plus VBV-drift
  feedback (the reference's fitted `bits_per_mb` LUT `src/h264-lab.h:933`,
  re-fitted online rather than transcribed)
- qp_min/qp_max clamping from the run params
- VBV fullness tracking with the reference's two policies:
  overflow -> "transparent" all-skip frame, underflow -> filler NALUs
- fine (sub-frame) rate control at slice-band granularity: the parallel
  analog of `rc_mb_end`'s along-the-scan QP correction. Bands encode in
  parallel, so the drift loop runs on *predicted* per-band bits (the
  previous frame's measured band shares scaled by the QP step law) and
  assigns each band a QP offset before dispatch — same control law,
  prediction instead of running feedback (see band_qp_offsets).

The a-priori model is an exponential fit (bits halve every 6 QP steps,
the H.264 quantizer-step doubling law) with separate I/P scales; the LUT
adapts it per QP from actual frame sizes.
"""

from __future__ import annotations

import math


def _model_bits_per_mb(qp: int, is_intra: bool) -> float:
    """A-priori bits/MB estimate at a given QP."""
    base = 1400.0 if is_intra else 700.0   # bits per MB at QP 10
    return base * 2.0 ** ((10 - qp) / 6.0)


QP_MIN_TAB, QP_MAX_TAB = 10, 51


class VbvState:
    def __init__(self, size_bits: int = 0, fullness: float = 0.0):
        self.size_bits = size_bits      # 0 = VBV disabled
        self.fullness = fullness        # bits currently in the buffer

    def configured(self) -> bool:
        return self.size_bits > 0


class RateControl:
    """Frame-level + band-level rate control. One instance per stream."""

    def __init__(self, n_mb: int, gop: int, vbv_size_bytes: int = 0,
                 initial_qp: int = 33):
        self.n_mb = n_mb
        self.gop = max(gop, 1)
        self.qp = initial_qp
        self.prev_qp = initial_qp
        self.vbv = VbvState(size_bits=vbv_size_bytes * 8,
                            fullness=vbv_size_bytes * 4)  # start half full
        # adaptive bits/MB LUT, one per frame class, indexed by QP:
        # lut[qp] = measured/a-priori correction factor (log domain)
        self._lut = {True: [0.0] * (QP_MAX_TAB + 1),
                     False: [0.0] * (QP_MAX_TAB + 1)}
        self._band_shares = None        # prev frame per-band bit fractions
        self._row_shares = None         # prev frame per-MB-row bit fractions

    # ------------------------------------------------------------------
    def _bits_per_mb(self, qp: int, is_intra: bool) -> float:
        return (_model_bits_per_mb(qp, is_intra)
                * math.exp(self._lut[is_intra][qp]))

    def frame_start(self, is_intra: bool, desired_frame_bytes: int,
                    qp_min: int, qp_max: int) -> int:
        """Pick the frame QP. Returns the QP to use."""
        if desired_frame_bytes <= 0 or qp_min == qp_max:
            self.qp = max(qp_min, min(qp_max, self.qp))
            return self.qp

        target_bits = desired_frame_bytes * 8
        # I frames get a larger budget, amortized over the GOP (the
        # reference budgets I/P jointly for equal quality)
        if is_intra and self.gop > 1:
            target_bits *= min(4.0, 1.0 + self.gop / 8.0)

        # VBV pressure: drain what the channel removes per frame and bias
        # the target toward the half-full point
        if self.vbv.configured():
            half = self.vbv.size_bits / 2
            target_bits += 0.25 * (half - self.vbv.fullness)
            target_bits = max(target_bits, self.n_mb)  # floor

        # invert the LUT-corrected bits model for qp (first QP at or
        # below the per-MB budget; the LUT keeps the model near-monotone)
        per_mb = target_bits / self.n_mb
        best_qp = qp_min
        for q in range(qp_min, qp_max + 1):
            best_qp = q
            if self._bits_per_mb(q, is_intra) <= per_mb:
                break
        # limit frame-to-frame QP swing (reference dqp adaptation)
        best_qp = max(self.prev_qp - 3, min(self.prev_qp + 3, best_qp))
        self.qp = max(qp_min, min(qp_max, best_qp))
        return self.qp

    # ------------------------------------------------------------------
    def _scan_qp_plan(self, shares, n: int, is_intra: bool,
                      desired_frame_bytes: int,
                      qp_min: int, qp_max: int) -> list:
        """Shared fine-RC planner: simulate the scan over `n` segments
        with `shares` (previous frame's measured per-segment bit
        fractions) as the bits predictor — the parallel analog of the
        reference's `rc_mb_end` along-the-scan QP correction
        (`src/h264-lab.h:6146-6179`). A segment predicted to push the
        running total over the pro-rata budget encodes at a higher QP,
        and vice versa (offsets within +-2 of the frame QP)."""
        qp = self.qp
        if (desired_frame_bytes <= 0 or n < 2 or qp_min == qp_max
                or shares is None or len(shares) != n):
            return [max(qp_min, min(qp_max, qp))] * n

        target = desired_frame_bytes * 8
        if is_intra and self.gop > 1:
            target *= min(4.0, 1.0 + self.gop / 8.0)
        frame_pred = self._bits_per_mb(qp, is_intra) * self.n_mb
        qps = []
        cum_spent = 0.0
        cum_budget = 0.0
        for b in range(n):
            drift = (cum_spent - cum_budget) / max(target, 1.0)
            dqp = max(-2, min(2, round(8.0 * drift)))
            q = max(qp_min, min(qp_max, qp + dqp))
            qps.append(q)
            # predicted bits of this segment at its adjusted QP
            seg_pred = (frame_pred * shares[b] * 2.0 ** ((qp - q) / 6.0))
            cum_spent += seg_pred
            cum_budget += target / n
        return qps

    def band_qp_offsets(self, n_bands: int, is_intra: bool,
                        desired_frame_bytes: int,
                        qp_min: int, qp_max: int) -> list:
        """Per-band (slice) QP plan: each band is its own slice, so the
        plan is plain slice_qp syntax. Uniform without history/target."""
        return self._scan_qp_plan(self._band_shares, n_bands, is_intra,
                                  desired_frame_bytes, qp_min, qp_max)

    def row_qp_offsets(self, n_rows: int, is_intra: bool,
                       desired_frame_bytes: int,
                       qp_min: int, qp_max: int) -> list:
        """Per-MB-row QP plan inside ONE slice — emitted as real
        `mb_qp_delta` syntax by the MB engine (mbscan.symbolize), so
        fine rate control works at slice_bands=1. Feed measured per-row
        bits back via `note_row_bits`."""
        return self._scan_qp_plan(self._row_shares, n_rows, is_intra,
                                  desired_frame_bytes, qp_min, qp_max)

    def note_row_bits(self, row_bits) -> None:
        """Record measured per-MB-row bits (the `row_bits` output of the
        MB engine) as next frame's fine-RC predictor."""
        tot = float(sum(int(b) for b in row_bits))
        if tot > 0:
            self._row_shares = [int(b) / tot for b in row_bits]

    # ------------------------------------------------------------------
    def frame_end(self, is_intra: bool, actual_bytes: int,
                  desired_frame_bytes: int,
                  band_bytes: list | None = None) -> dict:
        """Account the coded frame. Returns VBV actions:
        {"stuffing_bytes": int, "overflow": bool}."""
        actual_bits = actual_bytes * 8
        self.prev_qp = self.qp

        # adapt the LUT at the encoded QP (EWMA in log domain), and
        # propagate a damped copy to the neighbours so rarely-visited
        # QPs track as well
        model = _model_bits_per_mb(self.qp, is_intra) * self.n_mb
        if model > 0 and actual_bits > 0:
            err = math.log(min(max(actual_bits / model, 0.1), 10.0))
            lut = self._lut[is_intra]
            lut[self.qp] = 0.75 * lut[self.qp] + 0.25 * err
            for dq in (-2, -1, 1, 2):
                q = self.qp + dq
                if QP_MIN_TAB <= q <= QP_MAX_TAB:
                    lut[q] = 0.9 * lut[q] + 0.1 * err

        if band_bytes and sum(band_bytes) > 0:
            tot = float(sum(band_bytes))
            self._band_shares = [b / tot for b in band_bytes]

        out = {"stuffing_bytes": 0, "overflow": False}
        if self.vbv.configured() and desired_frame_bytes > 0:
            drain = desired_frame_bytes * 8
            self.vbv.fullness += actual_bits - drain
            if self.vbv.fullness > self.vbv.size_bits:
                out["overflow"] = True
                self.vbv.fullness = self.vbv.size_bits
            if self.vbv.fullness < 0:
                # channel starved: emit filler to keep CBR timing
                out["stuffing_bytes"] = int(-self.vbv.fullness) // 8
                self.vbv.fullness = 0.0
        return out

    # ------------------------------------------------------------------
    def set_vbv_state(self, fullness_bits: float):
        """Equivalent of the reference's H264E_set_vbv_state
        (`src/h264-lab.h:6898-6912`)."""
        self.vbv.fullness = fullness_bits

    # ------------------------------------------------------------------
    def get_state(self) -> dict:
        """Snapshot of all mutable RC state (checkpoint/resume)."""
        return {"qp": self.qp, "prev_qp": self.prev_qp,
                "vbv_fullness": self.vbv.fullness,
                "lut_i": list(self._lut[True]),
                "lut_p": list(self._lut[False]),
                "band_shares": (None if self._band_shares is None
                                else list(self._band_shares)),
                "row_shares": (None if self._row_shares is None
                               else list(self._row_shares))}

    def set_state(self, st: dict):
        self.qp = st["qp"]
        self.prev_qp = st["prev_qp"]
        self.vbv.fullness = st["vbv_fullness"]
        self._lut = {True: list(st["lut_i"]), False: list(st["lut_p"])}
        bs = st.get("band_shares")
        self._band_shares = None if bs is None else list(bs)
        rs = st.get("row_shares")
        self._row_shares = None if rs is None else list(rs)


def filler_nal(n_payload_bytes: int) -> bytes:
    """Filler data NAL (type 12): 0xFF payload bytes + stop bit pattern
    (spec 7.3.2.7; the reference's stuffing at `src/h264-lab.h:6109-6127`)."""
    from h264lab_tpu_torch.bitstream.nal import annexb_nal
    n = max(n_payload_bytes, 1)
    return annexb_nal(0, 12, b"\xff" * (n - 1) + b"\x80")
