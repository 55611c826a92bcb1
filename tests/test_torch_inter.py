"""Parity of the port's P-frame ops and stages with the JAX package.

The same seeded numpy inputs go to the JAX function (on the CPU) and to
its `h264lab_tpu_torch` counterpart on `device="cpu"`; the encoder is
integer arithmetic, so the tolerance is exact equality. Cases run at
64x48 (4x3 MBs): noise-pan content at QP 20 and chessboard content at
QP 33, each predicted from the sequence's previous frame, with a patch
that no reference MB matches (so intra MBs occur in P) and a previous-MV
field that reaches beyond the coarse +-32 px range and past the
+-MAX_CAND_FP clip on border MBs. The port runs both cases in one batched
call (two lanes), which JAX ran one at a time.
"""

import functools

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
from h264lab_tpu.ops import transform as jtr
from h264lab_tpu.utils.synthetic import chessboard_sequence, noise_pan_sequence
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.models import refstate as trs
from h264lab_tpu_torch.ops import me as tme
from h264lab_tpu_torch.ops import qpel as tqp
from h264lab_tpu_torch.ops import transform as ttr

W, H = 64, 48
MBW, MBH = 4, 3
NMB = MBW * MBH
CASES = {20: noise_pan_sequence, 33: chessboard_sequence}


def _eq(jax_val, torch_val, what=""):
    a = np.asarray(jax_val)
    b = torch_val.numpy() if isinstance(torch_val, torch.Tensor) \
        else np.asarray(torch_val)
    if a.dtype == np.uint32:
        b = b.astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=what)


def _t(x):
    return torch.from_numpy(np.array(x))


def _prev_field(seed):
    """Full-pel previous MVs: inside and beyond the coarse +-32 range, and
    +-MAX_CAND_FP and past it (clipped) on the frame's border MBs."""
    rng = np.random.default_rng(seed)
    f = rng.integers(-70, 71, (2, NMB)).astype(np.int32)
    m = jme.MAX_CAND_FP
    f[:, 0] = (-m, -m)                    # top-left MB, up and left
    f[:, MBW - 1] = (-m - 9, m + 9)       # top-right, clipped
    f[:, NMB - 1] = (m, m)                # bottom-right, down and right
    f[:, NMB - MBW] = (m + 20, -m - 20)   # bottom-left, clipped
    f[:, 5] = (40, -36)                   # beyond the coarse range
    return f


def _inputs(qp):
    frames = list(CASES[qp](W, H, 2))
    ry, ru, rv = frames[0]
    y, u, v = (p.copy() for p in frames[1])
    y[16:32, 16:32] = y[16:32, 15:16]     # Intra_16x16 H predicts it
    return (ry, ru, rv), (y, u, v)


@functools.partial(jax.jit, static_argnames=("mbh", "mbw"))
def _jax_me(cur_plane, tiles, ref_pad, ref4_pad, base_y, base_x, qp,
            row_offset, prev_my, prev_mx, mbh, mbw):
    return jme.motion_search_dense(cur_plane, tiles, ref_pad, ref4_pad,
                                   base_y, base_x, qp, mbh, mbw, row_offset,
                                   prev_my=prev_my, prev_mx=prev_mx)


@pytest.fixture(scope="module")
def jax_p():
    """Per QP: the inputs and the JAX reference, inter, select, symbolize
    and deblock outputs of one P frame (each JAX stage runs once)."""
    rr = np.arange(NMB) // MBW
    cc = np.arange(NMB) % MBW
    a_top, a_left = rr > 0, cc > 0
    steps = jwf.make_plan(MBW, MBH, 1).steps
    out = {}
    for qp in CASES:
        ref_f, cur = _inputs(qp)
        ref = jrs.prepare_reference(
            *(jnp.asarray(jwf.mb_tiles(p, t))
              for p, t in zip(ref_f, (16, 8, 8))), MBW, MBH)
        ref = {k: np.asarray(v) for k, v in ref.items()}
        src = tuple(jwf.mb_tiles(p, t) for p, t in zip(cur, (16, 8, 8)))
        prev = _prev_field(qp)
        qpc = int(jtb.QPC_FROM_QPY[qp])
        inter = jmb.inter_stage(*src, ref["y_pad"], ref["u_pad"],
                                ref["v_pad"], ref["y4_pad"], jnp.int32(qp),
                                jnp.int32(qpc), 0, prev[0], prev[1],
                                mb_width=MBW, mb_height=MBH)
        st = jmb.select_stage(*src, jnp.int32(qp), jnp.int32(qpc),
                              jnp.asarray(steps), jnp.asarray(a_top),
                              jnp.asarray(a_left), inter, mb_width=MBW,
                              mb_height=MBH, has_inter=True,
                              enable_i4x4=False)
        st = {k: np.asarray(v) for k, v in st.items()}
        sym = jmb.symbolize_stage(
            st["sel"], st["mode16"], st["cmode"], st["i4modes"],
            st["i4sym_v"], st["i4sym_l"], st["mv4_y"], st["mv4_x"],
            st["shape"], st["dc_lev"], st["ac_lev"], st["lev_inter"],
            st["cdc_lev"], st["cac_lev"], MBW, MBH, True)
        df = jmb.deblock_stage(
            st["recon_y"], st["recon_u"], st["recon_v"], st["sel"],
            st["lev_inter"], st["mv4_y"], st["mv4_x"], jnp.int32(qp),
            jnp.int32(qpc), jnp.asarray(a_top), jnp.asarray(a_left),
            mb_width=MBW, mb_height=MBH)
        out[qp] = dict(ref_f=ref_f, ref=ref, src=src, prev=prev, qpc=qpc,
                       inter={k: np.asarray(v) for k, v in inter.items()},
                       st=st, sym={k: np.asarray(v) for k, v in sym.items()},
                       df=[np.asarray(d) for d in df], steps=steps,
                       a_top=a_top, a_left=a_left)
    return out


def _stack(jax_p, fn):
    """The two cases stacked on the port's leading frame axis."""
    return torch.stack([_t(fn(jax_p[qp])) for qp in CASES])


def _port_refs(jax_p):
    tiles = [_stack(jax_p, lambda c, i=i, t=t: jwf.mb_tiles(c["ref_f"][i], t))
             for i, t in enumerate((16, 8, 8))]
    return trs.prepare_reference(*tiles, MBW, MBH)


def test_prepare_reference(jax_p):
    got = _port_refs(jax_p)
    for i, qp in enumerate(CASES):
        for key, val in jax_p[qp]["ref"].items():
            _eq(val, got[key][i], key)
    # the ref stage: bands joined per lane, next-step MV candidates mv >> 2
    df = [_stack(jax_p, lambda c, i=i: c["df"][i]) for i in range(3)]
    halves = [d.reshape((4, NMB // 2) + d.shape[2:]) for d in df]
    mv = _t(np.arange(-60, 60, 5, dtype=np.int32).reshape(4, NMB // 2))
    refs, flat, pmy, pmx = trs.ref_stage(*halves, mv, -mv, 2, MBW, MBH)
    for a, b in zip(df, flat):
        assert torch.equal(a, b)
    _eq(np.asarray(mv) >> 2, pmy)
    _eq(-np.asarray(mv) >> 2, pmx)
    for i, qp in enumerate(CASES):
        want = jrs.prepare_reference(*(c[i].numpy() for c in df), MBW, MBH)
        for key, val in want.items():
            _eq(val, refs[key][i], key)


def test_zero_thr_and_mv_bits():
    qp = np.arange(52, dtype=np.int32)
    for thr in (186, 282):
        _eq(jtr.zero_thr4x4(qp, thr), ttr.zero_thr4x4(_t(qp), thr), "thr")
        _eq(jtr.zero_thr4x4(30, thr), ttr.zero_thr4x4(30, thr), "thr")
    v = np.arange(-5000, 5000, 7, dtype=np.int32)
    _eq(jme.mv_bits(v), tme.mv_bits(_t(v)), "mv_bits")
    plane = np.random.default_rng(3).integers(0, 256, (2, 35, 66),
                                              dtype=np.uint8)
    for i in range(2):
        _eq(jme.downsample4(plane[i]), tme.downsample4(_t(plane))[i])


def test_mc_chroma_uniform(jax_p):
    """Random quarter-pel MVs around full-pel winners, windows partly past
    the padded plane (clamped starts) on both sides."""
    rng = np.random.default_rng(5)
    k = 200
    c = jax_p[20]["ref"]
    hc, wc = c["u_pad"].shape
    cb_y = rng.integers(0, hc - 8, k).astype(np.int32)
    cb_x = rng.integers(0, wc - 8, k).astype(np.int32)
    full_my = rng.integers(-80, 81, k).astype(np.int32)
    full_mx = rng.integers(-80, 81, k).astype(np.int32)
    mv_y = (full_my * 4 + rng.integers(-3, 4, k)).astype(np.int32)
    mv_x = (full_mx * 4 + rng.integers(-3, 4, k)).astype(np.int32)
    want = jqp.mc_chroma_uniform(c["u_pad"], c["v_pad"], cb_y, cb_x,
                                 full_my, full_mx, mv_y, mv_x)
    lanes = torch.zeros(k, dtype=torch.long)
    got = tqp.mc_chroma_uniform(_t(c["u_pad"])[None], _t(c["v_pad"])[None],
                                lanes, _t(cb_y), _t(cb_x), _t(full_my),
                                _t(full_mx), _t(mv_y), _t(mv_x))
    for a, b in zip(want, got):
        _eq(a, b, "mc_chroma_uniform")
    oy = cb_y + (full_my >> 1) - 1
    assert (oy < 0).any() and (oy > hc - 10).any()     # clamped windows


@pytest.mark.parametrize("band", ["frame", "band_at_row1"])
def test_motion_search_dense(jax_p, band):
    """Both cases in one port call; with and without the previous-MV
    field on the whole frame, and on a 2-row band at MB row 1 whose
    reference is the whole frame."""
    mbh, row0 = (MBH, 0) if band == "frame" else (2, 1)
    nmb = mbh * MBW
    rr = np.arange(nmb) // MBW + row0
    cc = np.arange(nmb) % MBW
    base_y = (jqp.GUARD + 16 * rr).astype(np.int32)
    base_x = (jqp.GUARD + 16 * cc).astype(np.int32)
    refs = _port_refs(jax_p)
    tiles = _stack(jax_p, lambda c: c["src"][0])[:, row0 * MBW:][:, :nmb]
    planes = tiles.reshape(2, mbh, MBW, 16, 16).permute(0, 1, 3, 2, 4) \
        .reshape(2, mbh * 16, MBW * 16)
    qps = torch.tensor(list(CASES), dtype=torch.int32)
    lanes = torch.tensor([0, 1])
    rows = torch.tensor([row0, row0], dtype=torch.int32)
    for with_prev in (False, True):
        prev = ([_stack(jax_p, lambda c, a=a: c["prev"][a][:nmb])
                 for a in range(2)] if with_prev else [None, None])
        got = tme.motion_search_dense(
            planes, tiles, refs["y_pad"], refs["y4_pad"], lanes,
            _t(base_y).expand(2, nmb), _t(base_x).expand(2, nmb), qps,
            mbh, MBW, rows, *prev)
        for i, qp in enumerate(CASES):
            c = jax_p[qp]
            p = [None, None] if not with_prev else \
                [jnp.asarray(c["prev"][a][:nmb]) for a in range(2)]
            want = _jax_me(planes[i].numpy(), tiles[i].numpy(),
                           c["ref"]["y_pad"], c["ref"]["y4_pad"], base_y,
                           base_x, jnp.int32(qp), row0, *p, mbh=mbh,
                           mbw=MBW)
            for j, what in enumerate(("mv_y", "mv_x", "cost", "pred")):
                _eq(want[j], got[j][i], f"{what} prev={with_prev}")
            for key in ("cy4", "cx4", "full_my", "full_mx", "mvp_y",
                        "mvp_x"):
                _eq(want[4][key], got[4][key][i], key)


def test_prev_mv_reaches_beyond_coarse_range():
    """A 40-px pan: the coarse +-32 window cannot reach it, the previous-MV
    centre can (mirrors tests/test_me_range.py). Port and JAX agree with
    and without the centre, and the centre changes the result."""
    rng = np.random.default_rng(11)
    ref_y = rng.integers(0, 256, (H // 4, W // 4)).astype(np.uint8)
    ref_y = np.kron(ref_y, np.ones((4, 4), np.uint8))
    cur_y = np.roll(ref_y, -40, axis=1)           # cur[x] = ref[x + 40]
    u = np.full((H // 2, W // 2), 128, np.uint8)
    refs = trs.prepare_reference(
        _t(jwf.mb_tiles(ref_y, 16))[None], _t(jwf.mb_tiles(u, 8))[None],
        _t(jwf.mb_tiles(u, 8))[None], MBW, MBH)
    tiles = _t(jwf.mb_tiles(cur_y, 16))
    rr = np.arange(NMB) // MBW
    cc = np.arange(NMB) % MBW
    base_y = (jqp.GUARD + 16 * rr).astype(np.int32)
    base_x = (jqp.GUARD + 16 * cc).astype(np.int32)
    zero = np.zeros((NMB,), np.int32)
    mvx = []
    for prev_x in (0, 40):
        prev = [zero, np.full((NMB,), prev_x, np.int32)]
        got = tme.motion_search_dense(
            _t(cur_y)[None], tiles[None], refs["y_pad"], refs["y4_pad"],
            torch.tensor([0]), _t(base_y)[None], _t(base_x)[None],
            torch.tensor([30]), MBH, MBW, torch.tensor([0]),
            *(_t(a)[None] for a in prev))
        want = _jax_me(cur_y, tiles.numpy(), refs["y_pad"][0].numpy(),
                       refs["y4_pad"][0].numpy(), base_y, base_x,
                       jnp.int32(30), 0, *prev, mbh=MBH, mbw=MBW)
        for j in range(4):
            _eq(want[j], got[j][0], f"output {j} prev_x={prev_x}")
        mvx.append(got[1][0].numpy())
    # column 0 can track +40 px only from the previous-MV centre
    col0 = np.arange(NMB) % MBW == 0
    assert np.all(np.abs(mvx[0][col0]) <= 35 * 4)
    assert np.any(mvx[1][col0] == 40 * 4)


def _port_inter(jax_p):
    src = [_stack(jax_p, lambda c, i=i: c["src"][i]) for i in range(3)]
    qps = torch.tensor(list(CASES), dtype=torch.int32)
    qpcs = torch.tensor([jax_p[q]["qpc"] for q in CASES], dtype=torch.int32)
    prev = [_stack(jax_p, lambda c, a=a: c["prev"][a]) for a in range(2)]
    inter = tmb.inter_stage_core(*src, _port_refs(jax_p), torch.tensor([0, 1]),
                                 qps, qpcs, torch.zeros(2, dtype=torch.int32),
                                 *prev, MBW, MBH)
    return src, qps, qpcs, inter


def test_inter_stage(jax_p):
    _, _, _, got = _port_inter(jax_p)
    for i, qp in enumerate(CASES):
        want = jax_p[qp]["inter"]
        assert set(got) == set(want)
        for key, val in got.items():
            _eq(want[key], val[i], key)


def _port_select(jax_p):
    src, qps, qpcs, inter = _port_inter(jax_p)
    c = jax_p[20]
    return qps, qpcs, tmb.select_stage_core(
        *src, qps, qpcs, c["steps"], c["a_top"], c["a_left"], inter, MBW,
        MBH)


def test_select_stage_p(jax_p):
    _, _, got = _port_select(jax_p)
    for i, qp in enumerate(CASES):
        st = jax_p[qp]["st"]
        assert set(got) <= set(st)
        for key, val in got.items():
            _eq(st[key], val[i], key)
    # both candidates win somewhere: the patch goes intra
    sels = set().union(*(np.unique(jax_p[q]["st"]["sel"]).tolist()
                         for q in CASES))
    assert sels == {0, 1}


def test_symbolize_and_deblock_p(jax_p):
    qps, qpcs, st = _port_select(jax_p)
    sym = tmb.symbolize(*(st[k] for k in (
        "sel", "mode16", "cmode", "i4sym_v", "i4sym_l", "mv4_y", "mv4_x",
        "shape", "dc_lev", "ac_lev", "lev_inter", "cdc_lev", "cac_lev")),
        MBW, MBH, True)
    c = jax_p[20]
    df = tmb.deblock_stage_core(
        *(st[k] for k in ("recon_y", "recon_u", "recon_v", "sel",
                          "lev_inter", "mv4_y", "mv4_x")),
        qps, qpcs, c["a_top"], c["a_left"], MBW, MBH)
    for i, qp in enumerate(CASES):
        want = jax_p[qp]
        for key in ("sym_vals", "sym_lens", "tail_val", "tail_len",
                    "total_bits"):
            _eq(want["sym"][key], sym[key][i], key)
        for a, b in zip(want["df"], df):
            _eq(a, b[i], "deblock")
    # P_Skip MBs (zero-length headers past the skip run) and coded MVDs
    # both occur
    assert any(int((~np.asarray(jax_p[q]["sym"]["skip"])).sum()) < NMB
               for q in CASES)
    assert any(int(jax_p[q]["sym"]["tail_len"]) > 0
               or (np.asarray(jax_p[q]["sym"]["mvd_px"]) != 0).any()
               for q in CASES)
