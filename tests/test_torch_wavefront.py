"""The port's slope-2 intra wavefront against the JAX package's, on the CPU.

`h264lab_tpu_torch.models.mbscan._select_wavefront` on CPU tensors runs
its plain version (`_select_wavefront_plain`); on CUDA tensors it launches
K3 (`csrc/wavefront.cu`), which `tests/test_torch_cuda.py` and
`chip_smoke.py` hold against that plain version on the card. Here, on
seeded inputs (`utils.synthetic.wavefront_inputs`: flat, gradient,
chessboard, diagonal-stripe and noise MBs; N = 3 frames at different QPs
around 0, 11, 12, 33 and 51; I frames, and P frames with an inter
candidate; whole frames, a band without a row above, per-MB
availability; 4 x 3, 6 x 1 and 1 x 6 MBs):
- the port's `select_stage_core` (the plain wavefront, and the merge of
  the inter fields) equals JAX's `select_stage_core`, frame by frame, and
  every case has MBs where Intra_16x16 and Intra_4x4 win, and inter too
  on P frames;
- K3's schedule, emulated in torch with the port's intra operations: one
  worker per MB row of each frame that takes its MBs in order, keeps the
  left MB in its own state as K3 keeps it in shared memory, reads the
  48-byte records of the MBs above (top-left, top, top-right) from a
  buffer whose unwritten records are poisoned (0xAB), and zeros for an
  unavailable neighbour, as K3 does. The workers take their MB steps in
  a seeded random order that K3's rule allows (row r takes MB c once row
  r - 1 has finished MB min(c + 1, mbw - 1)), half of the steps the
  lowest row's, which runs as close behind the row above as the rule
  lets it: a rule that waited on MB c only would read a poisoned record
  (frames 1 MB wide or high have no such neighbour). It takes the
  arguments that `mbscan.select_wavefront_args` packs and equals the
  plain version;
- `select_wavefront_args` packs K3's arguments: dtypes, shapes and
  contiguity as `wavefront.k3_inputs` lists them, the tiles aligned, lam
  and the intra-in-P penalty from `lambda_me`, the availability as uint8;
  it refuses availability on the first row or column;
- CPU tensors never reach K3: CPU encodes through the wavefront launch
  nothing, and `wavefront_tiles` refuses CPU tensors.
Tolerance: exact equality (integer arithmetic).
"""
import jax
import numpy as np
import pytest
import torch

from h264lab_tpu.models import mbscan as jmb
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.models import wavefront as plan
from h264lab_tpu_torch.models.encoder import H264Encoder
from h264lab_tpu_torch.ops import intra, intra4, wavefront
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
from h264lab_tpu_torch.ops.me import lambda_me
from h264lab_tpu_torch.ops.tuning import (I4_PENALTY_BITS, INTRA_DEADZONE_Q8,
                                          INTRA_IN_P_PENALTY_BITS)
from h264lab_tpu_torch.parallel.gop import GopBandEncoder
from h264lab_tpu_torch.utils.synthetic import chessboard_sequence, \
    wavefront_inputs

# one compile per (shape, inter); QPs and availability are traced
_jax_select = jax.jit(jmb.select_stage_core, static_argnames=(
    "mb_width", "mb_height", "has_inter", "enable_i4x4"))

# (seed, frames, mb_width, mb_height, qp, inter, availability)
CASES = [
    (1, 3, 4, 3, 0, False, "frame"),
    (2, 3, 4, 3, 11, True, "frame"),
    (3, 3, 4, 3, 12, False, "frame"),
    (4, 3, 4, 3, 33, True, "frame"),
    (5, 3, 4, 3, 51, False, "frame"),
    (6, 3, 4, 3, 51, True, "per_mb"),
    (7, 3, 4, 3, 33, False, "no_top"),      # a band without a row above
    (8, 3, 6, 1, 30, True, "frame"),
    (9, 3, 1, 6, 30, True, "frame"),
    (10, 3, 6, 1, 20, False, "frame"),
    (11, 3, 1, 6, 40, False, "frame"),
]
INTER_KEYS = ("inter_cost", "recon_y_inter", "recon_u_inter",
              "recon_v_inter")


def _inputs(case):
    """Numpy inputs of one case (`wavefront_inputs`, its availability, and
    on P frames every stage-1 field that `select_stage_core` merges)."""
    seed, n, mbw, mbh, qp, inter, avail = case
    d = wavefront_inputs(seed, n, mbw, mbh, qp, inter=inter)
    nmb = mbw * mbh
    rng = np.random.default_rng(seed + 100)
    if avail == "no_top":
        d["avail_top"] = np.zeros(nmb, bool)
    elif avail == "per_mb":
        d["avail_top"] &= rng.random(nmb) < 0.6
        d["avail_left"] &= rng.random(nmb) < 0.6
    if inter:
        def ints(lo, hi, shape):
            return rng.integers(lo, hi, (n, nmb) + shape, dtype=np.int32)
        d.update(mv_y=ints(-64, 65, ()), mv_x=ints(-64, 65, ()),
                 mv4_y=ints(-64, 65, (4, 4)), mv4_x=ints(-64, 65, (4, 4)),
                 shape=ints(0, 4, ()), lev_inter=ints(-3, 4, (4, 4, 4, 4)),
                 cdc_inter=ints(-9, 10, (2, 2, 2)),
                 cac_inter=ints(-3, 4, (2, 2, 2, 4, 4)))
    return d, mbw, mbh, inter


_STAGE1 = INTER_KEYS + ("mv_y", "mv_x", "mv4_y", "mv4_x", "shape",
                        "lev_inter", "cdc_inter", "cac_inter")


def _port_args(d, mbw, mbh, inter):
    """`_select_wavefront`'s arguments (CPU tensors) of a case."""
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    cand = {k: t[k] for k in INTER_KEYS} if inter else None
    return (t["src_y_mb"], t["src_u_mb"], t["src_v_mb"], t["qp"], t["qpc"],
            plan.make_plan(mbw, mbh, 2).steps, d["avail_top"],
            d["avail_left"], mbw, cand)


def _jax_frames(d, mbw, mbh, inter):
    steps = plan.make_plan(mbw, mbh, 2).steps
    out = []
    for i in range(d["qp"].shape[0]):
        cand = {k: d[k][i] for k in _STAGE1} if inter else None
        out.append(_jax_select(
            d["src_y_mb"][i], d["src_u_mb"][i], d["src_v_mb"][i],
            np.int32(d["qp"][i]), np.int32(d["qpc"][i]), steps,
            d["avail_top"], d["avail_left"], cand, mb_width=mbw,
            mb_height=mbh, has_inter=inter, enable_i4x4=True))
    return out


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"seed{c[0]}-{c[2]}x{c[3]}-qp{c[4]}"
                         + ("-P" if c[5] else "-I") + f"-{c[6]}")
def test_select_stage_matches_jax(case):
    d, mbw, mbh, inter = _inputs(case)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    args = _port_args(d, mbw, mbh, inter)
    got = tmb.select_stage_core(
        *args[:8], {k: t[k] for k in _STAGE1} if inter else None, mbw, mbh,
        enable_i4x4=True)
    for i, want in enumerate(_jax_frames(d, mbw, mbh, inter)):
        assert set(got) <= set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(
                np.asarray(want[k]).astype(np.int64), v[i].numpy(),
                err_msg=f"frame {i} {k}")
    sels = set(got["sel"].unique().tolist())
    assert sels == ({0, 1, 2} if inter else {1, 2}), sels


def _mb_step(args, f, r, c, records, left, mbw):
    """One MB step of K3 on its packed arguments `args`: MB (r, c) of frame
    f, the row above's 48-byte records from `records` (N, nmb, 48), the
    left MB from `left` (a dict, None on column 0). Returns the MB's
    outputs (the plain version's names, no leading axes), its record and
    the left state for the next MB."""
    (src_y, src_u, src_v, qp, qpc, lam, pen, at, al, inter_cost, ry_i, ru_i,
     rv_i, _, dz, i4_pen) = args
    i = r * mbw + c
    a_top = bool(at[i]) and r > 0
    a_left = bool(al[i]) and c > 0
    a_tl, a_tr = a_top and a_left, a_top and c < mbw - 1
    zero = torch.zeros(48, dtype=torch.uint8)
    top = records[f, i - mbw] if a_top else zero
    tl = records[f, i - mbw - 1][15] if a_tl else zero[0]
    tr = records[f, i - mbw + 1][0:4] if a_tr else zero[0:4]
    if left is None:
        left = dict(y=torch.zeros(16, 16, dtype=torch.uint8),
                    u=torch.zeros(8, 8, dtype=torch.uint8),
                    v=torch.zeros(8, 8, dtype=torch.uint8),
                    em_r=torch.full((4,), 2, dtype=torch.int32))
    b = [torch.tensor([x]) for x in (a_top, a_left, a_tl, a_tr)]
    q, qc, lm = qp[f:f + 1], qpc[f:f + 1], lam[f:f + 1]
    sy = src_y[f, i][None]
    # Intra_16x16
    preds, valid = intra.predict_16x16(top[None, 0:16], left["y"][None, :, 15],
                                       b[0], b[1])
    m16, pred16, cost16 = intra.select_mode(sy, preds, valid)
    dc_lev, ac16, rec16 = tmb._encode_luma_i16(sy, pred16, q)
    # Intra_4x4
    i4 = intra4.encode_i4x4_mb(
        sy, top[None, 0:16], left["y"][None, :, 15], tl[None], tr[None], *b,
        left["em_r"][None], top[None, 32:36].to(torch.int32), q, dz, lm)
    cost4 = i4["cost"] + lm * i4_pen
    # chroma, U and V on the batch axis
    preds_c, valid_c = intra.predict_chroma(
        torch.stack([top[16:24], top[24:32]]),
        torch.stack([left["u"][:, 7], left["v"][:, 7]]), b[0].repeat(2),
        b[1].repeat(2))
    src_c = torch.stack([src_u[f, i], src_v[f, i]])
    ccost = intra.sad(src_c[:, None], preds_c)
    ccost = torch.where(valid_c[:1], ccost[:1] + ccost[1:], 1 << 30)
    cm = ccost.argmin(dim=1).to(torch.int32)
    cdc, cac, rec_c = tmb._encode_chroma(src_c, intra.pick(preds_c, cm.repeat(
        2)), qc.repeat(2), dz)
    # the selection over (inter, I16, I4)
    ci = inter_cost[f, i:i + 1] if inter_cost is not None else torch.tensor(
        [1 << 30])
    sel = int(torch.stack([ci, cost16 + pen[f], cost4 + pen[f]],
                          dim=1).argmin())
    rec = dict(y=(i4["recon"][0], rec16[0])[sel == 1], u=rec_c[0],
               v=rec_c[1])
    if sel == 0:
        rec = dict(y=ry_i[f, i], u=ru_i[f, i], v=rv_i[f, i])
    modes = i4["modes"][0]
    em_b = modes[12:16] if sel == 2 else torch.full((4,), 2)
    em_r = modes[3::4] if sel == 2 else torch.full((4,), 2)
    record = torch.cat([rec["y"][15], rec["u"][7], rec["v"][7],
                        em_b.to(torch.uint8),
                        torch.zeros(12, dtype=torch.uint8)])
    outs = dict(sel=torch.tensor(sel), mode16=m16[0], cmode=cm[0],
                dc_lev=dc_lev[0], ac_lev=(i4["levels"][0], ac16[0])[sel != 2],
                cdc_lev=cdc, cac_lev=cac, recon_y=rec["y"], recon_u=rec["u"],
                recon_v=rec["v"], i4modes=modes,
                i4sym_v=i4["mode_sym_val"][0], i4sym_l=i4["mode_sym_len"][0])
    return outs, record, dict(rec, em_r=em_r.to(torch.int32))


def emulate_k3(args, seed):
    """K3's schedule in torch on the arguments that `select_wavefront_args`
    packs (module docstring). Returns the plain version's output dict."""
    src_y, mbw = args[0], args[13]
    n, nmb = src_y.shape[:2]
    mbh = nmb // mbw
    rng = np.random.default_rng(seed)
    out = {name: torch.zeros((n, nmb) + shape, dtype=dtype)
           for name, dtype, shape in wavefront.OUTPUTS}
    records = torch.full((n, nmb, wavefront.REC_BYTES), 0xAB,
                         dtype=torch.uint8)
    progress = np.zeros((n, mbh), np.int64)
    workers = [dict(f=f, r=r, c=0, left=None) for r in range(mbh)
               for f in range(n)]

    def ready(w):
        i = w["r"] * mbw + w["c"]
        if w["r"] == 0 or not bool(args[7][i]):
            return True
        return progress[w["f"], w["r"] - 1] >= min(w["c"] + 2, mbw)

    while workers:
        live = [w for w in workers if ready(w)]
        if rng.random() < 0.5:      # the lowest row, as close behind the
            w = max(live, key=lambda w: (w["r"], w["f"]))   # row above as
        else:                       # the rule lets it run
            w = live[rng.integers(len(live))]
        f, r, c = w["f"], w["r"], w["c"]
        outs, record, w["left"] = _mb_step(args, f, r, c, records, w["left"],
                                           mbw)
        for k, v in outs.items():
            out[k][f, r * mbw + c] = v
        records[f, r * mbw + c] = record
        w["c"] += 1
        progress[f, r] = w["c"]
        if w["c"] == mbw:
            workers.remove(w)
    return out


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[3], CASES[5],
                                  CASES[6], CASES[8], CASES[9]],
                         ids=lambda c: f"seed{c[0]}-{c[2]}x{c[3]}-{c[6]}")
def test_k3_schedule_matches_plain(case):
    d, mbw, mbh, inter = _inputs(case)
    args = _port_args(d, mbw, mbh, inter)
    want = tmb._select_wavefront_plain(*args)
    got = emulate_k3(tmb.select_wavefront_args(*args), seed=case[0])
    for k, v in want.items():
        assert v.dtype == got[k].dtype, k
        assert torch.equal(v, got[k]), k


@pytest.mark.parametrize("inter", [False, True], ids=["I", "P"])
def test_packed_k3_args(inter):
    d, mbw, mbh, _ = _inputs((12, 2, 4, 3, 33, inter, "per_mb"))
    args = _port_args(d, mbw, mbh, inter)
    packed = tmb.select_wavefront_args(*args)
    n, nmb = 2, mbw * mbh
    tensors = packed[:13] if inter else packed[:9]
    for x, (name, dtype, shape) in zip(tensors, wavefront.k3_inputs(
            n, nmb, inter)):
        assert x.dtype == dtype and tuple(x.shape) == shape, name
        assert x.is_contiguous(), name
        assert name not in wavefront.TILES or x.data_ptr() % 16 == 0, name
    if not inter:
        assert packed[9:13] == (None,) * 4
    assert packed[13:] == (mbw, INTRA_DEADZONE_Q8, I4_PENALTY_BITS)
    qp = torch.from_numpy(d["qp"])
    assert torch.equal(packed[5], lambda_me(qp))
    assert torch.equal(packed[6], lambda_me(qp) * (
        INTRA_IN_P_PENALTY_BITS if inter else 0))
    for a, b in zip(packed[7:9], (d["avail_top"], d["avail_left"])):
        assert torch.equal(a, torch.from_numpy(b.astype(np.uint8)))
    # bools and numpy arrays alike; the first row and column never set
    for k in ("avail_top", "avail_left"):
        bad = list(args)
        flags = np.ones(nmb, bool)
        bad[6 if k == "avail_top" else 7] = flags
        with pytest.raises(ValueError, match="first"):
            tmb.select_wavefront_args(*bad)


def test_cpu_tensors_never_reach_k3():
    before = dict(LAUNCH_COUNTS)
    cfg = EncoderConfig(width=64, height=48, gop=3, qp=33)
    frames = list(chessboard_sequence(64, 48, 2))
    enc = GopBandEncoder(cfg, n_gop=2, device="cpu")
    enc.stage_times = {}
    res = enc.encode_step(frames, RunConfig(qp_min=33, qp_max=33,
                                            encode_speed=2))
    assert res[0].frame_type == "IDR" and "select" in enc.stage_times
    seq = H264Encoder(cfg, device="cpu")        # speed 0: I4 in P frames
    for f in frames:
        seq.encode(*f, RunConfig(qp_min=33, qp_max=33))
    assert LAUNCH_COUNTS == before and LAUNCH_COUNTS["wavefront"] == 0
    d, mbw, mbh, inter = _inputs(CASES[1])
    packed = tmb.select_wavefront_args(*_port_args(d, mbw, mbh, inter))
    with pytest.raises(ValueError, match="CUDA"):
        wavefront.wavefront_tiles(*packed)
    assert LAUNCH_COUNTS == before
