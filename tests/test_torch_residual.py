"""The P step's residual coding and parallel mode decision: the plain
versions and the lane schedules of their CUDA kernels K7
(`csrc/inter.cu`) and K8 (`csrc/select.cu`), emulated on the CPU.

`inter_residual_plain` (the port's `mbscan.inter_residual` on CPU tensors,
the version K7 is held against on the card) equals the JAX package's
composition of the same steps (`h264lab_tpu/models/mbscan.py:221-293`:
the partition shape and MV grid, `qpel.mc_chroma_uniform` or
`mc_chroma_grid`, `_encode_inter_luma` and `_encode_chroma`) on
`utils.synthetic.inter_residual_inputs` cases: speeds 2 (one MV an MB),
0 (K5's partitions, each shape winning, ties to the first) and 9 (no
quarter-pel); QPs 0-51 and per-row QP plans; 4x4 blocks exactly at
either kill threshold; full-pel winners at the +-55 reach on every MB of
the frames' four edges, at band offsets in taller lane frames, and past
it (the uniform window clamps into the plane); 4 x 3, 6 x 1, 1 x 6 and
11 x 3 MBs. `select_parallel_plain` (the port's `mbscan.select_parallel`
on CPU tensors, the version K8 is held against) equals JAX's
`select_stage_core` on its parallel P branch, fed the same seeded
inter-stage dict (`utils.synthetic.select_parallel_inputs`: MBs that want
intra in clusters across a row end, along the first row and the last
column, and alone; flat, chessboard and stripe sources on which the modes
tie; per-row QP plans; per-MB availability), every output. JAX runs one
frame at a time, one trace per case shape. `inter_stage_core` itself
equals JAX's at speeds 2, 0 and 9 with a per-row QP plan.

A CUDA kernel cannot run here, so `emulate_k7` and `emulate_k8` do in
numpy what the kernels do, lane by lane in their layout (`_warps`: a
block of 4 warps a tile of 16 consecutive MBs, a group of 8 lanes an MB,
lanes the columns of (warps, 32) arrays; the lanes past the batch's end
compute and write nothing): K7's group loading each MB's two chroma
windows as 9 rows of three aligned words and each lane predicting its
4x4 block from them at the window's byte shift (the per-pixel path for
K5's partitions and for windows past the plane's edge), two luma blocks
a lane with the quarter kill as shuffles across lane ^ 1 and lane ^ 4,
one chroma block a lane with the DC Hadamard across lane ^ 1 and lane ^
2; K8's one launch ("wants intra" of each MB from a lane's two rows of
SADs summed over the group, for the tile's MBs and its halo, the MBs
above them and the MB before the tile; the decision from them), the
luma edges from those loads and the chroma edges as the lanes gather
them, the chroma
SADs a lane two rows of a plane, the luma DCs as residual sums through
the group's Hadamard (`tq_hadamard4`: a column pass across lane ^ 4, a
butterfly across lane ^ 2 and ^ 1, one shuffle to each output's lane;
checked against `transform.hadamard4x4` alone), its chroma quadrant DCs.
The helpers are transcribed from `csrc/tq.h`, the tables from
`csrc/tq_tables.h`. Each equals its plain version on every case, and
faults of the schedules each make it fail: a quarter paired across lane
^ 2, the kill compared with `<`, the uniform window left unclamped, the
window read without its byte shift, the chroma blocks' lanes transposed
(K7); the neighbours' bytes read across a frame's start, read without
their availability, the top-right chroma quadrant preferring the left
edge, the Hadamard's outputs left on the butterfly's lanes (K8).
Tolerance: exact equality (integer arithmetic).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264lab_tpu.models import mbscan as jmb
from h264lab_tpu.models import refstate as jrs
from h264lab_tpu.models import wavefront as jwf
from h264lab_tpu.ops import me as jme
from h264lab_tpu.ops import qpel as jqp
from h264lab_tpu.ops import tables as jtb
from h264lab_tpu.ops.tuning import (INTER_DEADZONE_Q8, INTER_ZERO_THR2_Q8,
                                    INTER_ZERO_THR_Q8, INTRA_DEADZONE_Q8,
                                    INTRA_IN_P_PENALTY_BITS,
                                    PART_16X8_PENALTY_BITS,
                                    PART_8X8_PENALTY_BITS)
from h264lab_tpu.utils.synthetic import noise_pan_sequence
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.models import refstate as trs
from h264lab_tpu_torch.models.encoder import H264Encoder
from h264lab_tpu_torch.ops import residual, tables
from h264lab_tpu_torch.ops import transform as ttr
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
from h264lab_tpu_torch.ops.me import LAMBDA_ME
from h264lab_tpu_torch.parallel.gop import GopBandEncoder
from h264lab_tpu_torch.utils.synthetic import (chessboard_sequence,
                                               inter_residual_inputs,
                                               select_parallel_inputs)

# K7: (name, seed, frames, mb_width, mb_height, qp, lanes, lane frame
# rows, row plan, partitions, quarter-pel, full-pel reach)
K7_CASES = [
    ("4x3-speed2-bands", 201, 3, 4, 3, 30, 2, 6, False, False, True, 55),
    ("4x3-speed0", 202, 3, 4, 3, 12, 1, None, False, True, True, 55),
    ("4x3-speed9", 203, 2, 4, 3, 51, 1, None, False, False, False, 55),
    ("11x3-plan-bands", 204, 2, 11, 3, 0, 2, 9, True, False, True, 55),
    ("6x1-speed0-bands", 205, 3, 6, 1, 45, 1, 4, False, True, True, 55),
    ("1x6-plan", 206, 2, 1, 6, 20, 1, None, True, False, True, 55),
    ("11x3-speed0-plan", 207, 2, 11, 3, 33, 2, 6, True, True, True, 55),
    ("1x6-every-qp", 209, 9, 1, 6, 26, 1, None, True, False, True, 55),
]
# past the reach, on planes whose guard ring is noise: the uniform window
# clamps into the plane (where JAX's `lax.dynamic_slice` would wrap a
# negative start; the P path never gets there)
K7_CLAMP = ("4x3-past-the-reach", 208, 2, 4, 3, 28, 1, 6, False, False, True,
            63)
# K8: (name, seed, frames, mb_width, mb_height, qp, row plan, band)
K8_CASES = [
    ("4x3", 301, 3, 4, 3, 30, False, False),
    ("4x3-plan-band", 302, 2, 4, 3, 0, True, True),
    ("11x3", 303, 2, 11, 3, 51, False, False),
    ("6x1-plan", 304, 3, 6, 1, 12, True, False),
    ("1x6-band", 305, 2, 1, 6, 24, False, True),
    ("11x3-plan", 306, 2, 11, 3, 40, True, False),
    ("1x6-every-qp", 307, 9, 1, 6, 7, True, False),
]
K7_OUT = tuple(name for name, _, _ in residual.K7_OUTPUTS)
TAB = {m.group(1): [int(v) for v in m.group(2).split(",")]
       for m in re.finditer(r"#define TQ_(\w+) \{([^}]*)\}",
                            residual.HEADER.read_text())}


def _ids(c):
    return c[0]


def _eq(want, got, what):
    a, b = np.asarray(want), np.asarray(got)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=what)


def _same(want: dict, got: dict, what: str, kinds: bool = True):
    assert list(want) == list(got), (what, list(want), list(got))
    for k in want:
        if kinds:
            assert want[k].dtype == got[k].dtype, (what, k, want[k].dtype,
                                                   got[k].dtype)
        _eq(want[k].numpy(), got[k].numpy(), f"{what}: {k}")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def k7_case(c):
    """`inter_residual`'s arguments of a K7 case, torch tensors."""
    (_, seed, n, mbw, mbh, qp, lanes, rows, plan, parts, qpel,
     reach) = c
    d = inter_residual_inputs(seed, n, mbw, mbh, qp, lanes=lanes,
                              frame_rows=rows, plan=plan, parts=parts,
                              qpel=qpel, reach=reach,
                              noisy_guard=c == K7_CLAMP)
    t = {k: torch.from_numpy(v) for k, v in d.items() if k != "parts"}
    p = d["parts"]
    return (t["src_y_mb"], t["src_u_mb"], t["src_v_mb"], t["u_pad"],
            t["v_pad"], t["lane"], t["row0"], t["qp"], t["qpc"], t["mv_y"],
            t["mv_x"], t["full_my"], t["full_mx"], t["cost16"], t["pred16"],
            None if p is None else {k: torch.from_numpy(v)
                                    for k, v in p.items()}, mbw, mbh, True)


@functools.lru_cache(maxsize=None)
def k8_case(c):
    """`select_parallel`'s arguments of a K8 case, torch tensors (the
    availability numpy, as the encoders pass it)."""
    _, seed, n, mbw, mbh, qp, plan, band = c
    d = select_parallel_inputs(seed, n, mbw, mbh, qp, plan=plan, band=band)
    return (*(torch.from_numpy(d[k]) for k in (
        "src_y_mb", "src_u_mb", "src_v_mb", "qp", "qpc")),
        d["avail_top"], d["avail_left"],
        {k: torch.from_numpy(v) for k, v in d["inter"].items()}, mbw)


@functools.lru_cache(maxsize=None)
def k7_plain(c):
    return tmb.inter_residual_plain(*k7_case(c))


@functools.lru_cache(maxsize=None)
def k8_plain(c):
    return tmb.select_parallel_plain(*k8_case(c))


# ---------------------------------------------------------------------------
# the plain versions against JAX
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("mbw", "mbh", "zero_thr"))
def _jax_residual(sy, su, sv, u_pad, v_pad, row0, qp, qpc, mv_y, mv_x,
                  full_my, full_mx, cost16, pred16, ps, mbw, mbh, zero_thr):
    """`h264lab_tpu/models/mbscan.py:221-293` of one frame on the search's
    outputs (its code, with `ps` K5's outputs or None)."""
    nmb = mbw * mbh
    rr = jnp.arange(nmb, dtype=jnp.int32) // mbw
    cc = jnp.arange(nmb, dtype=jnp.int32) % mbw
    qp0, tq_qp, _, tq_qpc2, _ = jmb._qp_views(qp, qpc, mbw)
    lam = jme.lambda_me(qp0)
    mv4_y = jnp.broadcast_to(mv_y[:, None, None], (nmb, 4, 4))
    mv4_x = jnp.broadcast_to(mv_x[:, None, None], (nmb, 4, 4))
    shape = jnp.zeros((nmb,), jnp.int32)
    inter_cost = cost16
    pred_y = pred16
    if ps is not None:
        costs = jnp.stack([cost16,
                           ps["cost16x8"] + lam * PART_16X8_PENALTY_BITS,
                           ps["cost8x16"] + lam * PART_16X8_PENALTY_BITS,
                           ps["cost8x8"] + lam * PART_8X8_PENALTY_BITS],
                          axis=1)
        shape = jnp.argmin(costs, axis=1).astype(jnp.int32)
        inter_cost = jnp.min(costs, axis=1)
        half = jnp.asarray([0, 0, 1, 1])
        quad = jnp.asarray([[0, 0, 1, 1], [0, 0, 1, 1], [2, 2, 3, 3],
                            [2, 2, 3, 3]])
        sh = shape[:, None, None]

        def grid(cmp, m4):
            m168 = jnp.broadcast_to(ps["mv16x8"][:, half, cmp][:, :, None],
                                    (nmb, 4, 4))
            m816 = jnp.broadcast_to(ps["mv8x16"][:, half, cmp][:, None, :],
                                    (nmb, 4, 4))
            m88 = ps["mv8x8"][:, quad, cmp]
            return jnp.where(sh == 1, m168, jnp.where(
                sh == 2, m816, jnp.where(sh == 3, m88, m4)))
        mv4_y, mv4_x = grid(0, mv4_y), grid(1, mv4_x)
        pred_y = jnp.where(sh == 1, ps["pred16x8"], jnp.where(
            sh == 2, ps["pred8x16"], jnp.where(
                sh == 3, ps["pred8x8"], pred16))).astype(jnp.uint8)
    cb_y = jqp.GUARD // 2 + 8 * (rr + row0)
    cb_x = jqp.GUARD // 2 + 8 * cc
    if ps is not None:
        pred_u = jqp.mc_chroma_grid(u_pad, mv4_y, mv4_x, cb_y, cb_x)
        pred_v = jqp.mc_chroma_grid(v_pad, mv4_y, mv4_x, cb_y, cb_x)
    else:
        pred_u, pred_v = jqp.mc_chroma_uniform(u_pad, v_pad, cb_y, cb_x,
                                               full_my, full_mx, mv_y, mv_x)
    lev, recon_y = jmb._encode_inter_luma(sy, pred_y, tq_qp, zero_thr)
    cdc, cac, rec_uv = jmb._encode_chroma(
        jnp.concatenate([su, sv]), jnp.concatenate([pred_u, pred_v]),
        tq_qpc2, INTER_DEADZONE_Q8)
    return dict(mv4_y=mv4_y, mv4_x=mv4_x, shape=shape,
                inter_cost=inter_cost, lev_inter=lev, recon_y_inter=recon_y,
                recon_u_inter=rec_uv[:nmb], recon_v_inter=rec_uv[nmb:],
                cdc_inter=jnp.stack([cdc[:nmb], cdc[nmb:]], axis=1),
                cac_inter=jnp.stack([cac[:nmb], cac[nmb:]], axis=1))


@pytest.mark.parametrize("c", K7_CASES, ids=_ids)
def test_inter_residual_plain_equals_jax(c):
    a = k7_case(c)
    got = k7_plain(c)
    (sy, su, sv, u_pad, v_pad, lane, row0, qp, qpc, mvy, mvx, fmy, fmx,
     cost16, pred16, parts, mbw, mbh, zero_thr) = a
    nmb = mbw * mbh
    assert list(got) == list(K7_OUT)
    for f in range(sy.shape[0]):
        one = slice(f * nmb, (f + 1) * nmb)
        ps = None if parts is None else {
            k: jnp.asarray(v[one].numpy().astype(np.int32))
            for k, v in parts.items()}
        want = _jax_residual(
            *(jnp.asarray(x[f].numpy()) for x in (sy, su, sv)),
            jnp.asarray(u_pad[lane[f]].numpy()),
            jnp.asarray(v_pad[lane[f]].numpy()), int(row0[f]),
            jnp.asarray(qp[f].numpy()), jnp.asarray(qpc[f].numpy()),
            *(jnp.asarray(x[f].numpy()) for x in (mvy, mvx, fmy, fmx, cost16,
                                                  pred16)),
            ps, mbw=mbw, mbh=mbh, zero_thr=zero_thr)
        for k, v in want.items():
            _eq(v, got[k][f].numpy(), f"{c[0]} frame {f}: {k}")


def test_inter_inputs_cover_the_branches():
    """The K7 cases take every shape (with ties), put blocks exactly at both
    kill thresholds, spread the QPs over 0-51, and clamp the uniform
    window."""
    shapes, hits, qps = set(), {1: 0, 2: 0}, set()
    for c in K7_CASES:
        a = k7_case(c)
        got = k7_plain(c)
        shapes |= set(got["shape"].unique().tolist())
        qps |= set(a[7].reshape(-1).tolist())
        # luma blocks whose largest coefficient is exactly at a threshold
        res = a[0].int() - _pred_y(a, got).int()
        coef = ttr.fdct4x4(tmb.mb_to_blocks(res.reshape(-1, 16, 16), 4))
        q = torch.from_numpy(_qp_mb(a)).reshape(-1)
        for t, thr in ((1, INTER_ZERO_THR_Q8), (2, INTER_ZERO_THR2_Q8)):
            lim = ttr.zero_thr4x4(q, thr)[:, None, None]
            over = (coef.abs() - lim).amax((-2, -1))
            hits[t] += int((over == 0).sum())
    assert shapes == {0, 1, 2, 3}
    assert hits[1] > 20 and hits[2] > 20, hits
    assert qps == set(range(52)), sorted(set(range(52)) - qps)
    a = k7_case(K7_CLAMP)
    rows = a[3].shape[1]
    oy = 32 + 8 * (torch.arange(a[16] * a[17]) // a[16] + a[6][:, None]) \
        + (a[11] >> 1) - 1
    assert ((oy < 0) | (oy > rows - 10)).any()


def _qp_mb(a):
    qp, mbw, mbh = a[7], a[16], a[17]
    n = a[0].shape[0]
    if qp.ndim == 2:
        return qp.repeat_interleave(mbw, 1).numpy()
    return qp[:, None].expand(n, mbw * mbh).numpy()


def _pred_y(a, got):
    """The luma prediction of the chosen shape (the plain version's)."""
    parts, pred16 = a[15], a[14]
    if parts is None:
        return pred16
    sh = got["shape"].reshape(-1, 1, 1)
    p = torch.where(sh == 1, parts["pred16x8"], torch.where(
        sh == 2, parts["pred8x16"], torch.where(
            sh == 3, parts["pred8x8"], pred16.reshape(-1, 16, 16).int())))
    return p.to(torch.uint8).reshape(pred16.shape)


@pytest.mark.parametrize("c", K8_CASES, ids=_ids)
def test_select_parallel_plain_equals_jax(c):
    sy, su, sv, qp, qpc, at, al, inter, mbw = k8_case(c)
    got = k8_plain(c)
    n, nmb = sy.shape[:2]
    mbh = nmb // mbw
    steps = jnp.asarray(jwf.make_plan(mbw, mbh, 2).steps)
    for f in range(n):
        want = jmb.select_stage(
            *(jnp.asarray(x[f].numpy()) for x in (sy, su, sv, qp, qpc)),
            steps, jnp.asarray(at), jnp.asarray(al),
            {k: jnp.asarray(v[f].numpy()) for k, v in inter.items()},
            mb_width=mbw, mb_height=mbh, has_inter=True, enable_i4x4=False)
        assert set(want) == set(got)
        for k, v in want.items():
            _eq(v, got[k][f].numpy(), f"{c[0]} frame {f}: {k}")


def test_select_inputs_cover_the_branches():
    """Clustered "wants intra" MBs, refused neighbours and every mode."""
    i16, refused, modes, cmodes = 0, 0, set(), set()
    for c in K8_CASES:
        got = k8_plain(c)
        want = emulate_k8_want(c)
        i16 += int((got["sel"] == tmb.SEL_I16).sum())
        refused += int((want & (got["sel"] == tmb.SEL_INTER).numpy()).sum())
        modes |= set(got["mode16"].unique().tolist())
        cmodes |= set(got["cmode"].unique().tolist())
    assert i16 > 5 and refused > 5, (i16, refused)
    assert modes == {0, 1, 2} and cmodes == {0, 1, 2}


# the inter stage end to end against JAX's, with a per-row QP plan
W, H = 64, 48
MBW, MBH = 4, 3


@pytest.fixture(scope="module")
def stage_inputs():
    frames = list(noise_pan_sequence(W, H, 2))
    ref = jrs.prepare_reference(
        *(jnp.asarray(jwf.mb_tiles(p, t)) for p, t in zip(frames[0],
                                                          (16, 8, 8))),
        MBW, MBH)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    src = tuple(jwf.mb_tiles(p, t) for p, t in zip(frames[1], (16, 8, 8)))
    qp = np.array([24, 31, 40], np.int32)
    return ref, src, qp, jtb.QPC_FROM_QPY[qp].astype(np.int32)


@pytest.mark.parametrize("speed", [2, 0, 9])
def test_inter_stage_core_equals_jax_with_a_row_plan(stage_inputs, speed):
    ref, src, qp, qpc = stage_inputs
    parts, qpel = speed == 0, speed < 9
    want = jmb.inter_stage(*src, ref["y_pad"], ref["u_pad"], ref["v_pad"],
                           ref["y4_pad"], jnp.asarray(qp), jnp.asarray(qpc),
                           0, None, None, mb_width=MBW, mb_height=MBH,
                           enable_partitions=parts, enable_qpel=qpel)
    tref = {k: torch.from_numpy(np.array(v))[None] for k, v in ref.items()}
    got = tmb.inter_stage_core(
        *(torch.from_numpy(s)[None] for s in src), tref, torch.tensor([0]),
        torch.from_numpy(qp)[None], torch.from_numpy(qpc)[None],
        torch.tensor([0]), None, None, MBW, MBH, enable_partitions=parts,
        enable_qpel=qpel)
    assert set(want) == set(got)
    for k, v in want.items():
        _eq(v, got[k][0].numpy(), f"speed {speed}: {k}")
    assert got["inter_cost"].dtype == torch.int32


# ---------------------------------------------------------------------------
# K7's lane schedule
# ---------------------------------------------------------------------------

def _bf(x0, x1, x2, x3, k):                   # tq.h tq_bf
    t0, t1, t2, t3 = x0 + x3, x0 - x3, x1 + x2, x1 - x2
    return (t0 + t2, 2 * t1 + t3, t0 - t2, t1 - 2 * t3)[k]


def _ibf(d0, d1, d2, d3, k):                  # tq.h tq_ibf
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    return (e0 + e3, e1 + e2, e1 - e2, e0 - e3)[k]


def _fdct(x):                                 # tq.h tq_fdct, in place
    for j in range(4):
        a, b, c, d = x[j], x[4 + j], x[8 + j], x[12 + j]
        for k in range(4):
            x[4 * k + j] = _bf(a, b, c, d, k)
    for i in range(4):
        a, b, c, d = x[4 * i:4 * i + 4]
        for k in range(4):
            x[4 * i + k] = _bf(a, b, c, d, k)


def _idct(x):                                 # tq.h tq_idct, in place
    for i in range(4):
        a, b, c, d = x[4 * i:4 * i + 4]
        for k in range(4):
            x[4 * i + k] = _ibf(a, b, c, d, k)
    for j in range(4):
        a, b, c, d = x[j], x[4 + j], x[8 + j], x[12 + j]
        for k in range(4):
            x[4 * k + j] = (_ibf(a, b, c, d, k) + 32) >> 6


def _pos(i):                                  # TQ_POS_CLASS(i)
    word = int(re.search(r"TQ_POS_CLASS\(i\) \(\(int\)\(\((0x[0-9a-f]+)u",
                         residual.HEADER.read_text()).group(1), 16)
    return (word >> (2 * i)) & 3


class _Quant:                                 # tq.h TqQuant, tq_quant
    def __init__(self, qp):
        self.div6 = qp // 6
        self.mod6 = qp - 6 * self.div6
        mf, v = np.array(TAB["QUANT_MF"]), np.array(TAB["DEQUANT_V"])
        self.mf = [mf[3 * self.mod6 + c] for c in range(3)]
        self.v = [v[3 * self.mod6 + c] for c in range(3)]


def _sgn_mag(f, mag):
    return np.where(f > 0, mag, np.where(f < 0, -mag, 0))


def _quant_block(w, q, dz):                   # tq.h tq_quant_block
    qbits = 15 + q.div6
    f = dz << (qbits - 8)
    lev, deq = [], []
    for i in range(16):
        c = _pos(i)
        mag = (np.abs(w[i]) * q.mf[c] + f) >> qbits
        lev.append(_sgn_mag(w[i], mag))
        deq.append(lev[-1] * q.v[c] * (1 << q.div6))
    return lev, deq


def _under(w, q, thr_q8, strict=False):      # tq.h tq_under
    num = thr_q8 << (7 + q.div6)
    t = [num // q.mf[c] for c in range(3)]
    under = np.ones_like(w[0], dtype=bool)
    for i in range(16):
        under &= (np.abs(w[i]) < t[_pos(i)]) if strict \
            else (np.abs(w[i]) <= t[_pos(i)])
    return under


LANE = np.arange(32)


def _shfl_xor(v, s):
    return v[:, LANE ^ s]


def _hadamard2(h, bi, bj):                    # tq.h tq_hadamard2
    o = _shfl_xor(h, 1)
    h = np.where(bj == 0, h + o, o - h)
    o = _shfl_xor(h, 2)
    return np.where(bi == 0, h + o, o - h)


def _chroma_dc(w0, q, bi, bj):                # tq.h tq_chroma_dc
    f = _hadamard2(w0, bi, bj)
    qbits = 16 + q.div6
    lev = _sgn_mag(f, (np.abs(f) * q.mf[0] + (1 << (qbits - 1))) >> qbits)
    return lev, (_hadamard2(lev, bi, bj) * q.v[0] * (1 << q.div6)) >> 1


def _recon(rec, pred):
    return [np.clip(r + p, 0, 255) for r, p in zip(rec, pred)]


def _np(x):
    return None if x is None else x.numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# the lanes of K7 and K8: a block of 4 warps takes a tile of 16 consecutive
# MBs, a warp 4 of them, a group of 8 lanes (g = lane & 7) one MB; lanes
# are the columns of (warps, 32) arrays, tq.h's group helpers shuffles
# across them
# ---------------------------------------------------------------------------

def _warps(kk):
    """Each lane's MB, (warps, 32), the batch's last for the lanes past
    its end, and whether it is in the batch."""
    w = -(-kk // 4)
    k = 4 * np.arange(w)[:, None] + (LANE[None] >> 3)
    return np.minimum(k, kk - 1), k < kk


def _shfl(v, src):                            # __shfl_sync
    return np.take_along_axis(v, np.broadcast_to(src, v.shape), 1)


def _sum8(v):                                 # tq.h tq_sum8
    v = v + _shfl_xor(v, 1)
    v = v + _shfl_xor(v, 2)
    return v + _shfl_xor(v, 4)


def _hadamard4_lanes(lo, hi, mutation=None):  # tq.h tq_hadamard4
    g = LANE & 7
    bj = g & 3
    s, t = lo + hi, lo - hi
    ps, pt = _shfl_xor(s, 4), _shfl_xor(t, 4)
    lo = np.where(g < 4, s + ps, pt + t)
    hi = np.where(g < 4, t - pt, ps - s)
    src = LANE if mutation == "hadamard_no_fixup" else \
        (LANE & ~3) | ((0x1320 >> (4 * bj)) & 3)

    def row(x):
        o = _shfl_xor(x, 2)
        x = np.where(bj < 2, x + o, o - x)
        o = _shfl_xor(x, 1)
        x = np.where((bj & 1) == 0, x + o, o - x)
        return _shfl(x, src[None])
    return row(lo), row(hi)


def _frames(n, nmb):
    def frames(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x).reshape(
            (n, nmb) + x.shape[1:]).astype(dtype))
    return frames


def emulate_k7(args, mutation=None):
    """K7 on `inter_residual_args`' packing, lanes as columns (`_warps`).
    `mutation`: "quarter_lane2" (an 8x8 quarter's blocks paired across
    lane ^ 2), "kill_strict" (the thresholds compared with `<`),
    "no_clamp" (the uniform window left unclamped), "window_shift" (the
    window's bytes read from its aligned word, without the shift),
    "chroma_transposed" (a chroma lane's block at (bj, bi))."""
    (sy, su, sv, u_pad, v_pad, lane, row0, qp, qpc, mvy, mvx, fmy, fmx,
     cost16, pred16, parts, mbw, mbh, zero_thr) = args
    sy, su, sv, u_pad, v_pad, lane, row0, qp, qpc, mvy, mvx, fmy, fmx, \
        cost16, pred16 = (_np(x) for x in args[:15])
    n, nmb = sy.shape[:2]
    kk = n * nmb
    hc, wc = u_pad.shape[1:]
    plan = qp.ndim == 2
    qpf, qpcf = qp.reshape(-1), qpc.reshape(-1)
    k, valid = _warps(kk)
    nw = k.shape[0]
    g = np.broadcast_to(LANE[None] & 7, k.shape)
    t = np.broadcast_to(LANE[None] >> 3, k.shape)    # the MB in the warp
    wi = np.broadcast_to(np.arange(nw)[:, None], k.shape)
    nn = k // nmb
    m = k - nn * nmb
    r = m // mbw
    c = m - r * mbw
    qrow = nn * mbh + r if plan else nn
    qpv, qpcv = qpf[qrow], qpcf[qrow]
    # the shape
    cost = cost16.reshape(-1)[k].astype(np.int64)
    shape = np.zeros_like(cost)
    if parts is not None:
        pt = {name: _np(parts[j]) for j, (name, _, _) in
              enumerate(residual.K7_PARTS)}
        lam = np.array(TAB["LAMBDA_ME"])[qpf[nn * mbh if plan else nn]]
        for s, (name, pen) in enumerate((
                ("cost16x8", PART_16X8_PENALTY_BITS),
                ("cost8x16", PART_16X8_PENALTY_BITS),
                ("cost8x8", PART_8X8_PENALTY_BITS)), 1):
            cs = pt[name][k] + lam * pen
            shape = np.where(cs < cost, s, shape)
            cost = np.minimum(cs, cost)
    mvy16, mvx16 = mvy.reshape(-1)[k], mvx.reshape(-1)[k]

    def block_mv(bi, bj):
        if parts is None:
            return (np.broadcast_to(mvy16, np.broadcast(k, bi).shape),
                    np.broadcast_to(mvx16, np.broadcast(k, bi).shape))
        out = []
        for cmp, m16 in ((0, mvy16), (1, mvx16)):
            out.append(np.select(
                [shape == 1, shape == 2, shape == 3],
                [pt["mv16x8"][k, bi >> 1, cmp], pt["mv8x16"][k, bj >> 1, cmp],
                 pt["mv8x8"][k, 2 * (bi >> 1) + (bj >> 1), cmp]], m16))
        return out

    # the chroma windows: the group's lanes load 18 rows of three words
    ln = lane[nn]
    guard = residual.GUARD // 2
    cb_y, cb_x = guard + 8 * (r + row0[nn]), guard + 8 * c
    wy = (fmy.reshape(-1)[k] >> 1) - 1
    wx = (fmx.reshape(-1)[k] >> 1) - 1
    if mutation == "no_clamp":
        oy, ox = cb_y, cb_x
    else:
        oy = np.clip(cb_y + wy, 0, hc - 10) - wy
        ox = np.clip(cb_x + wx, 0, wc - 10) - wx
    y0, x0 = oy + (mvy16 >> 3), ox + (mvx16 >> 3)
    windowed = (parts is None) & (y0 >= 0) & (y0 + 8 <= hc - 1) \
        & (x0 >= 0) & (x0 + 8 <= wc - 1)
    xa = x0 & ~3
    planes = np.stack([u_pad, v_pad])               # (2, L, hc, wc)
    win = np.zeros((nw, 4, 2, 9, 12), np.int64)
    for step in (0, 8, 16):
        i = g + step
        p = (i >= 9).astype(np.int64)
        row = i - 9 * p
        ok = windowed & (i < 18)
        yy = np.clip(y0 + row, 0, hc - 1)[..., None]
        cols = np.clip(xa[..., None] + np.arange(12), 0, wc - 1)
        vals = planes[p[..., None], ln[..., None], yy, cols]
        win[wi[ok], t[ok], p[ok], row[ok]] = vals[ok]
    kv = k[valid]
    # luma: lane g blocks (g >> 2, g & 3) and the one two rows below
    kill = bool(zero_thr) and INTER_ZERO_THR_Q8 > 0
    strict = mutation == "kill_strict"
    q = _Quant(qpv)
    sy_f, p16 = sy.reshape(kk, 16, 16), pred16.reshape(kk, 16, 16)
    lev_y = np.zeros((kk, 16, 16), np.int64)
    rec_y = np.zeros((kk, 16, 16), np.int64)
    mv4 = np.zeros((2, kk, 16), np.int64)
    bj = g & 3
    for h in range(2):
        bi = (g >> 2) + 2 * h
        x, prow = [], []
        for y in range(4):
            for j in range(4):
                yy, xx = 4 * bi + y, 4 * bj + j
                pv = p16[k, yy, xx]
                if parts is not None:
                    pv = np.select([shape == 1, shape == 2, shape == 3],
                                   [pt[f"pred{s}"][k, yy, xx]
                                    for s in ("16x8", "8x16", "8x8")],
                                   pv) & 0xff
                x.append(sy_f[k, yy, xx] - pv)
                prow.append(pv)
        _fdct(x)
        z2 = kill & _under(x, q, INTER_ZERO_THR2_Q8, strict)
        z2 = _shfl_xor(z2, 1) & z2
        z2 = _shfl_xor(z2, 2 if mutation == "quarter_lane2" else 4) & z2
        dead = kill & (z2 | _under(x, q, INTER_ZERO_THR_Q8, strict))
        lev, rec = _quant_block(x, q, INTER_DEADZONE_Q8)
        lev = [np.where(dead, 0, v) for v in lev]
        rec = [np.where(dead, 0, v) for v in rec]
        _idct(rec)
        rec = _recon(rec, prow)
        blk = (4 * bi + bj)[valid]
        lev_y[kv, blk] = np.stack(lev, -1)[valid]
        for y in range(4):
            for j in range(4):
                rec_y[kv, (4 * bi + y)[valid], (4 * bj + j)[valid]] = \
                    rec[4 * y + j][valid]
        for cmp, v in enumerate(block_mv(bi, bj)):
            mv4[cmp, kv, blk] = v[valid]
    # chroma: lane g block (bi, bj) of plane p, g = 4 p + 2 bi + bj
    p = g >> 2
    cbi, cbj = (g >> 1) & 1, g & 1
    if mutation == "chroma_transposed":
        cbi, cbj = cbj, cbi
    fy, fx = mvy16 & 7, mvx16 & 7
    o = 4 * cbj + (0 if mutation == "window_shift" else x0 & 3)
    src_c = np.stack([su.reshape(kk, 8, 8), sv.reshape(kk, 8, 8)])
    x, prow = [], []
    for y in range(4):
        for j in range(4):
            cy, cx = 4 * cbi + y, 4 * cbj + j

            def w(dy, dx):
                return win[wi, t, p, cy + dy, o + j + dx]
            vw = ((8 - fx) * (8 - fy) * w(0, 0) + fx * (8 - fy) * w(0, 1)
                  + (8 - fx) * fy * w(1, 0) + fx * fy * w(1, 1) + 32) >> 6
            my, mx = block_mv(cy >> 1, cx >> 1)
            iy = (cb_y if parts is not None else oy) + (my >> 3) + cy
            ix = (cb_x if parts is not None else ox) + (mx >> 3) + cx
            iy, ix = np.clip(iy, 0, hc - 2), np.clip(ix, 0, wc - 2)

            def at(dy, dx):
                return planes[p, ln, iy + dy, ix + dx]
            fyp, fxp = my & 7, mx & 7
            vd = ((8 - fxp) * (8 - fyp) * at(0, 0) + fxp * (8 - fyp)
                  * at(0, 1) + (8 - fxp) * fyp * at(1, 0) + fxp * fyp
                  * at(1, 1) + 32) >> 6
            pv = np.where(windowed, vw, vd)
            x.append(src_c[p, k, cy, cx] - pv)
            prow.append(pv)
    q = _Quant(qpcv)
    _fdct(x)
    dc_lev, dc_deq = _chroma_dc(x[0], q, cbi, cbj)
    lev, rec = _quant_block(x, q, INTER_DEADZONE_Q8)
    lev[0] = np.zeros_like(lev[0])
    rec[0] = dc_deq
    _idct(rec)
    rec = _recon(rec, prow)
    cb = (4 * p + 2 * cbi + cbj)[valid]
    cdc = np.zeros((kk, 8), np.int64)
    cac = np.zeros((kk, 8, 16), np.int64)
    rec_c = np.zeros((kk, 2, 8, 8), np.int64)
    cdc[kv, cb] = dc_lev[valid]
    cac[kv, cb] = np.stack(lev, -1)[valid]
    for y in range(4):
        for j in range(4):
            rec_c[kv, p[valid], (4 * cbi + y)[valid],
                  (4 * cbj + j)[valid]] = rec[4 * y + j][valid]
    first = valid & (g == 0)
    shape_o = np.zeros(kk, np.int64)
    cost_o = np.zeros(kk, np.int64)
    shape_o[k[first]] = shape[first]
    cost_o[k[first]] = cost[first]
    frames = _frames(n, nmb)
    i32, u8 = np.int32, np.uint8
    return dict(
        mv4_y=frames(mv4[0].reshape(kk, 4, 4), i32),
        mv4_x=frames(mv4[1].reshape(kk, 4, 4), i32),
        shape=frames(shape_o, i32), inter_cost=frames(cost_o, i32),
        lev_inter=frames(lev_y.reshape(kk, 4, 4, 4, 4), i32),
        recon_y_inter=frames(rec_y, u8),
        recon_u_inter=frames(rec_c[:, 0], u8),
        recon_v_inter=frames(rec_c[:, 1], u8),
        cdc_inter=frames(cdc.reshape(kk, 2, 2, 2), i32),
        cac_inter=frames(cac.reshape(kk, 2, 2, 2, 4, 4), i32))


@pytest.mark.parametrize("c", K7_CASES + [K7_CLAMP], ids=_ids)
def test_k7_schedule_equals_plain(c):
    got = emulate_k7(tmb.inter_residual_args(*k7_case(c)))
    _same(k7_plain(c), got, c[0])


@pytest.mark.parametrize("mutation", ["quarter_lane2", "kill_strict",
                                      "no_clamp", "window_shift",
                                      "chroma_transposed"])
def test_k7_schedule_mutations_fail(mutation):
    differs = []
    for c in K7_CASES + [K7_CLAMP]:
        want = k7_plain(c)
        got = emulate_k7(tmb.inter_residual_args(*k7_case(c)), mutation)
        differs.append(any(not torch.equal(want[k].long(), got[k].long())
                           for k in want))
    assert any(differs), mutation


def test_k7_windows_serve_the_uniform_mbs():
    """One MV an MB (speeds 1 and up): the chroma comes through the
    group's window, so reading it without its byte shift changes the
    chroma; with K5's partitions every MB reads the plane per pixel, and
    the same fault changes nothing."""
    for c, windowed in ((K7_CASES[0], True), (K7_CASES[1], False)):
        a = tmb.inter_residual_args(*k7_case(c))
        got = emulate_k7(a, "window_shift")
        want = k7_plain(c)
        assert torch.equal(got["recon_y_inter"], want["recon_y_inter"])
        assert torch.equal(got["recon_u_inter"],
                           want["recon_u_inter"]) != windowed, c[0]


# ---------------------------------------------------------------------------
# K8's one launch
# ---------------------------------------------------------------------------

INVALID = 1 << 30


def _k8_np(args):
    (sy, su, sv, qp, qpc, avail, icost, ry, ru, rv, cdc_i, cac_i, mvy, mvx,
     mv4y, mv4x, shape_i, mbw) = args
    return [_np(x) for x in args[:17]] + [mbw]


def _k8_where(args):
    """Each lane's MB (`_warps`) and its place: frame, index, row, the
    availability."""
    sy, avail, mbw = _np(args[0]), _np(args[5]), args[-1]
    n, nmb = sy.shape[:2]
    k, valid = _warps(n * nmb)
    nn = k // nmb
    m = k - nn * nmb
    return n, nmb, k, valid, nn, m, m // mbw, avail[0][m] != 0, \
        avail[1][m] != 0


def _luma_dc(st, sl, top, left):              # select.cu luma_dc
    return np.where(top & left, (st + sl + 16) >> 5, np.where(
        top, (st + 8) >> 4, np.where(left, (sl + 8) >> 4, 128)))


def k8_wants(args):
    """K8's `wants_intra` of every MB: mode16 and whether it wants intra,
    (K,) each, as a group computes them, a lane rows 2 g and 2 g + 1 of
    the MB. The kernel computes them for a tile's MBs and again for its
    halo, from the same inputs, so one array serves both."""
    a = _k8_np(args)
    sy, qp, icost, ry, mbw = a[0], a[3], a[6], a[7], a[17]
    n, nmb, k, valid, nn, m, r, top, left = _k8_where(args)
    kk, mbh = n * nmb, nmb // mbw
    g = LANE[None] & 7
    ry, sy = ry.reshape(-1, 16, 16), sy.reshape(-1, 16, 16)
    above = np.where((m >= mbw)[..., None],
                     ry[np.maximum(k - mbw, 0), 15], 0)     # (W, 32, 16)
    kl = np.maximum(k - 1, 0)
    l0 = np.where(m >= 1, ry[kl, 2 * g, 15], 0)
    l1 = np.where(m >= 1, ry[kl, 2 * g + 1, 15], 0)
    dc = _luma_dc(above.sum(-1), _sum8(l0 + l1), top, left)
    s0, s1 = sy[k, 2 * g], sy[k, 2 * g + 1]
    sad_v = _sum8((np.abs(s0 - above) + np.abs(s1 - above)).sum(-1))
    sad_h = _sum8((np.abs(s0 - l0[..., None])
                   + np.abs(s1 - l1[..., None])).sum(-1))
    sad_dc = _sum8((np.abs(s0 - dc[..., None])
                    + np.abs(s1 - dc[..., None])).sum(-1))
    cost = np.where(top, sad_v, INVALID)
    mode = np.zeros_like(cost)
    hc = np.where(left, sad_h, INVALID)
    mode = np.where(hc < cost, 1, mode)
    cost = np.where(hc < cost, sad_h, cost)
    mode = np.where(sad_dc < cost, 2, mode)
    cost = np.where(sad_dc < cost, sad_dc, cost)
    qp0 = qp.reshape(-1)[nn * mbh if qp.ndim == 2 else nn]
    want = cost + np.array(TAB["LAMBDA_ME"])[qp0] * INTRA_IN_P_PENALTY_BITS \
        < icost.reshape(-1)[k]
    first = valid & (g == 0)
    mode16 = np.zeros(kk, np.int64)
    wants = np.zeros(kk, bool)
    mode16[k[first]] = mode[first]
    wants[k[first]] = want[first]
    return mode16, wants


def emulate_k8_want(c):
    return k8_wants(tmb.select_parallel_args(*k8_case(c)))[1].reshape(
        k8_case(c)[0].shape[:2])


def emulate_k8(args, mutation=None):
    """K8's launch on `select_parallel_args`' packing, lanes as columns
    (`_warps`). `mutation`: "want_across_frames" (the neighbours'
    bytes read without the frame's first MB and row guards),
    "ignore_avail" (read without their availability), "quadrant_swap"
    (the top-right chroma quadrant prefers the left edge),
    "hadamard_no_fixup" (the luma DC Hadamard's outputs left on the
    butterfly's lanes)."""
    (sy, su, sv, qp, qpc, avail, icost, ry, ru, rv, cdc_i, cac_i, mvy, mvx,
     mv4y, mv4x, shape_i, mbw) = _k8_np(args)
    n, nmb, k, valid, nn, m, r, top, left = _k8_where(args)
    kk, mbh = n * nmb, nmb // mbw
    nw = k.shape[0]
    g = np.broadcast_to(LANE[None] & 7, k.shape)
    t = np.broadcast_to(LANE[None] >> 3, k.shape)
    wi = np.broadcast_to(np.arange(nw)[:, None], k.shape)
    mode16, want = k8_wants(args)
    # the decision, from the tile's wants and its halo's: the MB before
    # (the tile's previous one, or the MB before the tile) and the MB above,
    # their indices clamped at 0 as the kernel clamps them
    guard = mutation != "want_across_frames"
    use_avail = mutation != "ignore_avail"
    wl = want[np.maximum(k - 1, 0)] & ((m >= 1) | (not guard)) \
        & (left | (not use_avail))
    wt = want[np.maximum(k - mbw, 0)] & ((m >= mbw) | (not guard)) \
        & (top | (not use_avail))
    i16 = want[k] & ~wl & ~wt
    mode = mode16[k]
    qrow = nn * mbh + r if qp.ndim == 2 else nn
    qpv, qpcv = qp.reshape(-1)[qrow], qpc.reshape(-1)[qrow]
    # the edges as the lanes gather them into shared memory
    ry, sy = ry.reshape(-1, 16, 16), sy.reshape(-1, 16, 16)
    rc = np.stack([ru.reshape(-1, 8, 8), rv.reshape(-1, 8, 8)])
    sc = np.stack([su.reshape(-1, 8, 8), sv.reshape(-1, 8, 8)])
    up, before = m >= mbw, m >= 1
    ku, kl = np.maximum(k - mbw, 0), np.maximum(k - 1, 0)
    edge = np.zeros((nw, 4, 32), np.int64)
    cedge = np.zeros((nw, 4, 2, 16), np.int64)
    four = g < 4
    for j in range(4):
        edge[wi[four], t[four], (4 * g + j)[four]] = np.where(
            up, ry[ku, 15, np.minimum(4 * g + j, 15)], 0)[four]
    edge[wi, t, 16 + 2 * g] = np.where(before, ry[kl, 2 * g, 15], 0)
    edge[wi, t, 17 + 2 * g] = np.where(before, ry[kl, 2 * g + 1, 15], 0)
    p, i = g >> 2, g & 3
    cedge[wi, t, p, 2 * i] = np.where(up, rc[p, ku, 7, 2 * i], 0)
    cedge[wi, t, p, 2 * i + 1] = np.where(up, rc[p, ku, 7, 2 * i + 1], 0)
    cedge[wi, t, p, 8 + 2 * i] = np.where(before, rc[p, kl, 2 * i, 7], 0)
    cedge[wi, t, p, 9 + 2 * i] = np.where(before, rc[p, kl, 2 * i + 1, 7], 0)
    e = edge[wi, t]                                   # (W, 32, 32)
    dc = _luma_dc(e[..., :16].sum(-1), e[..., 16:].sum(-1), top, left)

    def chroma_dc(ce, qy, qx):                    # select.cu chroma_dc
        def at(base):
            return sum(np.take_along_axis(
                ce, np.broadcast_to(base + d, ce.shape[:2])[..., None],
                2)[..., 0] for d in range(4))
        st, sl = at(4 * qx), at(8 + 4 * qy)
        tt, lf = (st + 2) >> 2, (sl + 2) >> 2
        both = np.where(top & left, (st + sl + 4) >> 3,
                        np.where(top, tt, np.where(left, lf, 128)))
        top_first = np.where(top, tt, np.where(left, lf, 128))
        left_first = np.where(left, lf, np.where(top, tt, 128))
        if mutation == "quadrant_swap":
            top_first, left_first = left_first, top_first
        return np.where(qy == qx, both,
                        np.where(qy == 0, top_first, left_first))

    # chroma prediction: lane g plane p, rows 2 i and 2 i + 1
    ce = cedge[wi, t, p]                              # (W, 32, 16)
    rows = [sc[p, k, 2 * i + d] for d in range(2)]    # (W, 32, 8) each
    d0, d1 = chroma_dc(ce, i >> 1, 0), chroma_dc(ce, i >> 1, 1)
    sad_dc = sad_h = sad_v = 0
    for d in range(2):
        sad_dc = sad_dc + np.abs(rows[d][..., :4] - d0[..., None]).sum(-1) \
            + np.abs(rows[d][..., 4:] - d1[..., None]).sum(-1)
        left_d = np.take_along_axis(ce, (8 + 2 * i + d)[..., None], 2)
        sad_h = sad_h + np.abs(rows[d] - left_d).sum(-1)
        sad_v = sad_v + np.abs(rows[d] - ce[..., :8]).sum(-1)
    sad_dc, sad_h, sad_v = _sum8(sad_dc), _sum8(sad_h), _sum8(sad_v)
    cmode = np.zeros_like(sad_dc)
    best = sad_dc
    hh = np.where(left, sad_h, INVALID)
    cmode = np.where(hh < best, 1, cmode)
    best = np.where(hh < best, sad_h, best)
    cmode = np.where(np.where(top, sad_v, INVALID) < best, 2, cmode)
    # the Intra_16x16 TQ: lane g blocks (bi, bj) and (bi + 2, bj); their
    # DCs first, through the group's Hadamard
    bi0, bj = g >> 2, g & 3
    q = _Quant(qpv)
    src, pred, dcs = [], [], []
    for h in range(2):
        s_h, p_h = [], []
        for y in range(4):
            yy = 4 * (bi0 + 2 * h) + y
            for j in range(4):
                s_h.append(sy[k, yy, 4 * bj + j])
                p_h.append(np.select([mode == 0, mode == 1], [
                    np.take_along_axis(e, (4 * bj + j)[..., None], 2)[..., 0],
                    np.take_along_axis(e, (16 + yy)[..., None], 2)[..., 0]],
                    dc))
        src.append(s_h)
        pred.append(p_h)
        dcs.append(sum(s_h) - sum(p_h))
    lo, hi = _hadamard4_lanes(dcs[0], dcs[1], mutation)
    qbits = 17 + q.div6
    ldc = [_sgn_mag(v, (np.abs(v) * q.mf[0] + (1 << (qbits - 1))) >> qbits)
           for v in (lo, hi)]
    gl, gh = _hadamard4_lanes(ldc[0], ldc[1], mutation)
    deq = []
    for v in (gl, gh):
        v = v * q.v[0]
        deq.append(np.where(q.div6 >= 2,
                            v * (1 << np.maximum(q.div6 - 2, 0)),
                            (v + (1 << np.maximum(1 - q.div6, 0)))
                            >> (2 - np.minimum(q.div6, 2))))
    kv = k[valid]
    dc_lev = np.zeros((kk, 16), np.int64)
    ac_lev = np.zeros((kk, 16, 16), np.int64)
    rec_y = ry.reshape(kk, 16, 16).copy()
    i16v = i16 & valid
    for h in range(2):
        bi = bi0 + 2 * h
        blk = 4 * bi + bj
        dc_lev[kv, blk[valid]] = ldc[h][valid]
        x = [a - b for a, b in zip(src[h], pred[h])]
        _fdct(x)
        lev, rec = _quant_block(x, q, INTRA_DEADZONE_Q8)
        lev[0] = np.zeros_like(lev[0])
        ac_lev[kv, blk[valid]] = np.stack(lev, -1)[valid]
        rec[0] = deq[h]
        _idct(rec)
        rec = _recon(rec, pred[h])
        for y in range(4):
            for j in range(4):
                rec_y[k[i16v], (4 * bi + y)[i16v], (4 * bj + j)[i16v]] = \
                    rec[4 * y + j][i16v]
    # the chroma TQ of the Intra_16x16 MBs: lane g = 4 p + 2 bi + bj
    cbi, cbj = (g >> 1) & 1, g & 1
    cdc_q = chroma_dc(ce, cbi, cbj)
    x, prow = [], []
    for y in range(4):
        for j in range(4):
            pv = np.select([cmode == 0, cmode == 1], [
                cdc_q, np.take_along_axis(ce, (8 + 4 * cbi + y)[..., None],
                                          2)[..., 0]],
                np.take_along_axis(ce, (4 * cbj + j)[..., None], 2)[..., 0])
            x.append(sc[p, k, 4 * cbi + y, 4 * cbj + j] - pv)
            prow.append(pv)
    qc = _Quant(qpcv)
    _fdct(x)
    cdc_lev, dc_deq = _chroma_dc(x[0], qc, cbi, cbj)
    lev, rec = _quant_block(x, qc, INTRA_DEADZONE_Q8)
    lev[0] = np.zeros_like(lev[0])
    rec[0] = dc_deq
    _idct(rec)
    rec = _recon(rec, prow)
    cdc = cdc_i.reshape(kk, 8).copy()
    cac = cac_i.reshape(kk, 8, 16).copy()
    rec_c = rc.reshape(2, kk, 8, 8).transpose(1, 0, 2, 3).copy()
    ki = k[i16v]
    cdc[ki, g[i16v]] = cdc_lev[i16v]
    cac[ki, g[i16v]] = np.stack(lev, -1)[i16v]
    for y in range(4):
        for j in range(4):
            rec_c[ki, p[i16v], (4 * cbi + y)[i16v], (4 * cbj + j)[i16v]] = \
                rec[4 * y + j][i16v]
    # the fields
    first = valid & (g == 0)
    zero = np.zeros(kk, bool)
    zero[k[first]] = i16[first]
    cm = np.zeros(kk, np.int64)
    cm[k[first]] = cmode[first]
    frames = _frames(n, nmb)
    i32, u8 = np.int32, np.uint8
    return dict(
        sel=frames(np.where(zero, tmb.SEL_I16, tmb.SEL_INTER), i32),
        mode16=frames(mode16, i32), cmode=frames(cm, i32),
        dc_lev=frames(dc_lev.reshape(kk, 4, 4), i32),
        ac_lev=frames(ac_lev.reshape(kk, 4, 4, 4, 4), i32),
        cdc_lev=frames(cdc.reshape(kk, 2, 2, 2), i32),
        cac_lev=frames(cac.reshape(kk, 2, 2, 2, 4, 4), i32),
        recon_y=frames(rec_y, u8),
        recon_u=frames(rec_c[:, 0], u8), recon_v=frames(rec_c[:, 1], u8),
        i4modes=frames(np.full((kk, 16), 2), i32),
        i4sym_v=frames(np.zeros((kk, 16)), i32),
        i4sym_l=frames(np.zeros((kk, 16)), i32),
        mv_y=frames(np.where(zero, 0, mvy.reshape(-1)), i32),
        mv_x=frames(np.where(zero, 0, mvx.reshape(-1)), i32),
        shape=frames(np.where(zero, 0, shape_i.reshape(-1)), i32),
        mv4_y=frames(np.where(zero[:, None, None], 0, mv4y.reshape(kk, 4, 4)),
                     i32),
        mv4_x=frames(np.where(zero[:, None, None], 0, mv4x.reshape(kk, 4, 4)),
                     i32))


def test_the_group_hadamard_is_the_transforms():
    """tq_hadamard4's shuffles over a group of 8 lanes give
    transform.hadamard4x4 of each MB's 16 values, each output on the lane
    of its block; without the last shuffle they do not."""
    rng = np.random.default_rng(5)
    x = rng.integers(-4000, 4000, (3, 4, 4, 4))      # (warps, MBs, 4, 4)
    g = LANE & 7
    lo = x[:, LANE >> 3, g >> 2, g & 3]
    hi = x[:, LANE >> 3, (g >> 2) + 2, g & 3]
    want = np.stack([ttr.hadamard4x4(torch.from_numpy(b)).numpy()
                     for b in x.reshape(-1, 4, 4)]).reshape(x.shape)
    got = _hadamard4_lanes(lo, hi)
    _eq(want[:, LANE >> 3, g >> 2, g & 3], got[0], "rows 0-1")
    _eq(want[:, LANE >> 3, (g >> 2) + 2, g & 3], got[1], "rows 2-3")
    bad = _hadamard4_lanes(lo, hi, "hadamard_no_fixup")
    assert not np.array_equal(bad[0], got[0])


@pytest.mark.parametrize("c", K8_CASES, ids=_ids)
def test_k8_schedule_equals_plain(c):
    got = emulate_k8(tmb.select_parallel_args(*k8_case(c)))
    got["lev_inter"] = k8_case(c)[7]["lev_inter"]
    _same(k8_plain(c), got, c[0])


@pytest.mark.parametrize("mutation", ["want_across_frames", "ignore_avail",
                                      "quadrant_swap", "hadamard_no_fixup"])
def test_k8_schedule_mutations_fail(mutation):
    differs = []
    for c in K8_CASES:
        want = k8_plain(c)
        got = emulate_k8(tmb.select_parallel_args(*k8_case(c)), mutation)
        differs.append(any(not torch.equal(want[k].long(), got[k].long())
                           for k in got))
    assert any(differs), mutation


# ---------------------------------------------------------------------------
# tables, packing, buffers, dispatch
# ---------------------------------------------------------------------------

def test_k7_k8_tables_come_from_the_port():
    header = residual.HEADER.read_text()
    assert header == residual.tables_header()
    assert TAB["QUANT_MF"] == tables.QUANT_MF.reshape(-1).tolist()
    assert TAB["DEQUANT_V"] == tables.DEQUANT_V.reshape(-1).tolist()
    assert TAB["LAMBDA_ME"] == LAMBDA_ME.tolist()
    assert [_pos(i) for i in range(16)] == tables.POS_CLASS.tolist()
    for name, want in (("SEL_INTER", tmb.SEL_INTER), ("SEL_I16", tmb.SEL_I16)):
        assert f"#define TQ_{name} {want}\n" in header
    tq = (residual.cuda_build.CSRC / "tq.h").read_text()
    assert '#include "tq_tables.h"' in tq
    for src in (residual.K7_SRC, residual.K8_SRC):
        assert '#include "tq.h"' in src.read_text()


@pytest.mark.parametrize("c", [K7_CASES[1], K7_CASES[3]], ids=_ids)
def test_inter_residual_args_pack_the_plain_arguments(c):
    a = k7_case(c)
    packed = tmb.inter_residual_args(*a)
    n, nmb, mbh = a[0].shape[0], a[16] * a[17], a[17]
    specs = residual.k7_inputs(n, nmb, mbh, a[7].ndim == 2,
                               a[15] is not None, tuple(a[3].shape))
    tensors = list(packed[:15]) + list(packed[15] or ())
    assert len(tensors) == len(specs)
    for x, (name, dtype, shape, mask) in zip(tensors, specs):
        assert x.dtype == dtype and x.shape == shape, name
        assert x.is_contiguous() and x.data_ptr() & mask == 0, name
    assert packed[16:] == (a[16], a[17], True)
    # the parts in K7's order, equal to the plain dict's
    if a[15] is not None:
        for x, (name, _, _) in zip(packed[15], residual.K7_PARTS):
            assert torch.equal(x, a[15][name].reshape(x.shape)), name
    # and the plain version on the packed arguments gives the same
    _same(k7_plain(c), tmb.inter_residual_plain(
        *packed[:15], {name: x for x, (name, _, _) in zip(
            packed[15], residual.K7_PARTS)} if packed[15] else None,
        *packed[16:]), c[0])


def test_select_parallel_args_pack_the_plain_arguments():
    c = K8_CASES[1]
    a = k8_case(c)
    packed = tmb.select_parallel_args(*a)
    n, nmb = a[0].shape[:2]
    specs = residual.k8_inputs(n, nmb, nmb // a[-1], True)
    for x, (name, dtype, shape, mask) in zip(packed[:17], specs):
        assert x.dtype == dtype and x.shape == shape, name
        assert x.is_contiguous() and x.data_ptr() & mask == 0, name
    assert packed[17] == a[-1]
    assert torch.equal(packed[5], torch.from_numpy(np.stack(
        [a[5], a[6]]).astype(np.uint8)))
    # the masks are copied once per distinct pair and device
    assert tmb.select_parallel_args(*a)[5] is packed[5]


@pytest.mark.parametrize("which", ["k7", "k8"])
def test_k7_k8_buffers_hold_the_plain_outputs(which):
    """The wrappers' one buffer: every output of the plain version with
    its dtype and shape, each on a 16-byte boundary, none overlapping;
    worked out once per size."""
    if which == "k7":
        c = K7_CASES[0]
        want, outs = k7_plain(c), residual.K7_OUTPUTS
        n, nmb = k7_case(c)[0].shape[:2]
    else:
        c = K8_CASES[0]
        want, outs = k8_plain(c), residual.K8_OUTPUTS
        n, nmb = k8_case(c)[0].shape[:2]
    layout = residual._layout(outs, n, nmb)
    nbytes, views, _ = residual.cuda_build.buffer_plan(layout)
    assert residual.cuda_build.buffer_plan(layout)[1] is views
    buf = torch.zeros(nbytes, dtype=torch.uint8)
    out = residual.cuda_build.buffer_views(buf, views)
    assert list(out) == [name for name, _, _ in outs]
    spans = []
    for name, x in out.items():
        if name in want:
            assert x.dtype == want[name].dtype, name
            assert x.shape == want[name].shape, name
        start = x.data_ptr() - buf.data_ptr()
        assert start % 16 == 0 and x.is_contiguous(), name
        spans.append((start, start + x.numel() * x.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= nbytes
    assert set(want) - set(out) <= {"lev_inter"}


def test_cpu_tensors_never_reach_k7_or_k8():
    before = dict(LAUNCH_COUNTS)
    cfg = EncoderConfig(width=64, height=48, gop=3, qp=33)
    frames = list(chessboard_sequence(64, 48, 3))
    enc = GopBandEncoder(cfg, n_gop=2, device="cpu")
    for t in range(2):
        res = enc.encode_step(frames[t:t + 2], RunConfig(
            qp_min=33, qp_max=33, encode_speed=2))
    assert res[0].frame_type == "P"
    seq = H264Encoder(cfg, device="cpu")
    for f in frames[:2]:
        seq.encode(*f, RunConfig(qp_min=33, qp_max=33))
    assert LAUNCH_COUNTS == before
    assert LAUNCH_COUNTS["inter_residual"] == LAUNCH_COUNTS[
        "select_parallel"] == 0
    # the wrappers refuse CPU tensors
    a = tmb.inter_residual_args(*k7_case(K7_CASES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        residual.inter_tiles(*a)
    b = tmb.select_parallel_args(*k8_case(K8_CASES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        residual.select_tiles(*b)
    assert LAUNCH_COUNTS == before


def test_the_residual_entries_dispatch_by_device(monkeypatch):
    """`inter_residual` and `select_parallel` run the plain versions on
    CPU tensors and never the wrappers."""
    def refuse(*a, **k):
        raise AssertionError("a wrapper was called on CPU tensors")
    monkeypatch.setattr(residual, "inter_tiles", refuse)
    monkeypatch.setattr(residual, "select_tiles", refuse)
    c7, c8 = K7_CASES[0], K8_CASES[0]
    _same(k7_plain(c7), tmb.inter_residual(*k7_case(c7)), c7[0])
    _same(k8_plain(c8), tmb.select_parallel(*k8_case(c8)), c8[0])


def test_the_reference_planes_are_the_encoders():
    """The seeded planes are guard-padded as the encoders pad theirs."""
    d = inter_residual_inputs(9, 2, 4, 3, 30)
    inner = torch.from_numpy(d["u_pad"][0, 32:-32, 32:-32])
    tiles = inner.reshape(3, 8, 4, 8).permute(0, 2, 1, 3).reshape(1, 12, 8, 8)
    ref = trs.prepare_reference(tiles.new_zeros((1, 12, 16, 16)), tiles,
                                tiles, 4, 3)
    assert torch.equal(ref["u_pad"][0], torch.from_numpy(d["u_pad"][0]))
