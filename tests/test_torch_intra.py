"""Parity of the port's intra-slice ops and stages with the JAX package.

Each case feeds the same seeded numpy inputs to the JAX function (on the
CPU) and to its `h264lab_tpu_torch` counterpart on `device="cpu"`. The
encoder is integer arithmetic end to end, so the tolerance is exact
equality. Stage cases run at 64x48 (4x3 MBs) at QP 20 and QP 33; flat
chessboard content makes mode-cost ties common, which must resolve to the
first index on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264lab_tpu.models import mbscan as jmb
from h264lab_tpu.models import wavefront as jwf
from h264lab_tpu.ops import cavlc as jcv
from h264lab_tpu.ops import intra as jin
from h264lab_tpu.ops import intra4 as ji4
from h264lab_tpu.ops import me as jme
from h264lab_tpu.ops import tables as jtb
from h264lab_tpu.ops import transform as jtr
from h264lab_tpu.utils.synthetic import chessboard_sequence, noise_pan_sequence
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.ops import cavlc as tcv
from h264lab_tpu_torch.ops import intra as tin
from h264lab_tpu_torch.ops import intra4 as ti4
from h264lab_tpu_torch.ops import transform as ttr

W, H = 64, 48
MBW, MBH = 4, 3
NMB = MBW * MBH


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


@pytest.mark.parametrize("qp", [20, 33])
def test_transform_quant(qp):
    rng = np.random.default_rng(qp)
    res = rng.integers(-255, 256, (60, 4, 4)).astype(np.int32)
    res[:10] = rng.integers(-3, 4, (10, 4, 4))       # near-zero blocks
    qpb = rng.integers(10, 52, (60,)).astype(np.int32)
    for name in ("fdct4x4", "hadamard4x4"):
        _eq(getattr(jtr, name)(res), getattr(ttr, name)(_t(res)), name)
    _eq(jtr.hadamard2x2(res[:, :2, :2]), ttr.hadamard2x2(_t(res[:, :2, :2])))
    coef = np.asarray(jtr.fdct4x4(res))
    for q_j, q_t in ((qp, torch.tensor(qp)), (qpb, _t(qpb))):
        lev = jtr.quant4x4(coef, q_j, 94)
        _eq(lev, ttr.quant4x4(_t(coef), q_t, 94), "quant4x4")
        deq = jtr.dequant4x4(lev, q_j)
        _eq(deq, ttr.dequant4x4(_t(np.asarray(lev)), q_t), "dequant4x4")
        _eq(jtr.idct4x4(deq), ttr.idct4x4(_t(np.asarray(deq))), "idct4x4")
    dc = coef[:48, 0, 0].reshape(3, 4, 4)
    dl = jtr.quant_luma_dc(dc, qp)
    _eq(dl, ttr.quant_luma_dc(_t(dc), torch.tensor(qp)), "quant_luma_dc")
    _eq(jtr.dequant_luma_dc(dl, qp),
        ttr.dequant_luma_dc(_t(np.asarray(dl)), torch.tensor(qp)))
    cdc = coef[:48, 0, 0].reshape(12, 2, 2)
    qpc = int(jtb.QPC_FROM_QPY[qp])
    cl = jtr.quant_chroma_dc(cdc, qpc)
    _eq(cl, ttr.quant_chroma_dc(_t(cdc), torch.tensor(qpc)))
    _eq(jtr.dequant_chroma_dc(cl, qpc),
        ttr.dequant_chroma_dc(_t(np.asarray(cl)), torch.tensor(qpc)))


def _edges(rng, k, n):
    top = rng.integers(0, 256, (k, n)).astype(np.uint8)
    left = rng.integers(0, 256, (k, n)).astype(np.uint8)
    top[: k // 4] = 128                               # flat: ties
    left[: k // 4] = 128
    at = rng.random(k) < 0.6
    al = rng.random(k) < 0.6
    return top, left, at, al


@pytest.mark.parametrize("qp", [20, 33])
def test_predict_and_select(qp):
    rng = np.random.default_rng(100 + qp)
    k = 64
    src = rng.integers(0, 256, (k, 16, 16)).astype(np.uint8)
    src[: k // 4] = 128
    top, left, at, al = _edges(rng, k, 16)
    pj, vj = jin.predict_16x16(top, left, at, al)
    pt, vt = tin.predict_16x16(_t(top), _t(left), _t(at), _t(al))
    _eq(pj, pt)
    _eq(vj, vt)
    for a, b in zip(jin.select_mode(src, pj, vj), tin.select_mode(_t(src),
                                                                  pt, vt)):
        _eq(a, b, "select_mode")
    top, left, at, al = _edges(rng, k, 8)
    pj, vj = jin.predict_chroma(top, left, at, al)
    pt, vt = tin.predict_chroma(_t(top), _t(left), _t(at), _t(al))
    _eq(pj, pt)
    _eq(vj, vt)


@pytest.mark.parametrize("qp", [20, 33])
def test_encode_i4x4_mb(qp):
    rng = np.random.default_rng(200 + qp)
    k = 40
    src = rng.integers(0, 256, (k, 16, 16)).astype(np.uint8)
    src[:8] = 100
    top, left, at, al = _edges(rng, k, 16)
    tl = rng.integers(0, 256, (k,)).astype(np.uint8)
    tr = rng.integers(0, 256, (k, 4)).astype(np.uint8)
    atl = at & al & (rng.random(k) < 0.8)
    atr = at & (rng.random(k) < 0.5)
    lm = rng.integers(0, 9, (k, 4)).astype(np.int32)
    tm = rng.integers(0, 9, (k, 4)).astype(np.int32)
    lam = int(jme.lambda_me(jnp.int32(qp)))
    rj = ji4.encode_i4x4_mb(src, top, left, tl, tr, at, al, atl, atr, lm, tm,
                            qp, 94, lam)
    rt = ti4.encode_i4x4_mb(_t(src), _t(top), _t(left), _t(tl), _t(tr),
                            _t(at), _t(al), _t(atl), _t(atr), _t(lm), _t(tm),
                            torch.tensor(qp), 94, torch.tensor(lam))
    for key in rj:
        _eq(rj[key], rt[key], key)


@pytest.mark.parametrize("qp", [20, 33])
def test_cavlc_encode_blocks(qp):
    rng = np.random.default_rng(300 + qp)
    n = 500
    lv = rng.integers(-4, 5, (n, 16)) * (rng.random((n, 16)) < 0.4)
    lv[rng.random((n, 16)) < 0.02] = rng.integers(-3000, 3000)  # escapes
    lv[:50] = 0
    lv[50:80] = rng.choice([-1, 1], (30, 16))                    # t1 runs
    lv = lv.astype(np.int32)
    nc = rng.integers(0, 17, (n,)).astype(np.int32)
    mc = np.where(rng.random(n) < 0.5, 15, 16).astype(np.int32)
    lv15 = np.where(np.arange(16) < mc[:, None], lv, 0).astype(np.int32)
    cases = [(lv, nc, 16, 16), (lv15, nc, mc, _t(mc)),
             (np.pad(lv[:, :4], ((0, 0), (0, 12))),
              np.full((n,), -1, np.int32), 4, 4)]
    for levels, ncs, mc_j, mc_t in cases:
        for a, b in zip(jcv.encode_blocks(levels, ncs, mc_j),
                        tcv.encode_blocks(_t(levels), _t(ncs), mc_t)):
            _eq(a, b, "encode_blocks")


# ---------------------------------------------------------------------------
# the three stages of an intra step, one frame
# ---------------------------------------------------------------------------

def _chess_stripes():
    """Chessboard with a first MB row of horizontal stripes, which the
    Intra_16x16 H mode predicts exactly (so both intra modes occur)."""
    y, u, v = next(chessboard_sequence(W, H, 1))
    y = y.copy()
    y[:16] = (np.arange(16, dtype=np.uint8) * 8)[:, None]
    return y, u, v


CASES = {20: lambda: next(noise_pan_sequence(W, H, 1)), 33: _chess_stripes}


@pytest.fixture(scope="module")
def jax_stages():
    """Per QP: the tiled inputs and the JAX select/symbolize/deblock
    outputs (each JAX stage runs once per module)."""
    plan = jwf.make_plan(MBW, MBH, 2)
    rr = np.arange(NMB) // MBW
    cc = np.arange(NMB) % MBW
    a_top, a_left = rr > 0, cc > 0
    out = {}
    for qp, frame in CASES.items():
        y, u, v = frame()
        src = (jwf.mb_tiles(y, 16), jwf.mb_tiles(u, 8), jwf.mb_tiles(v, 8))
        qpc = int(jtb.QPC_FROM_QPY[qp])
        st = jmb.select_stage(*src, jnp.int32(qp), jnp.int32(qpc),
                              jnp.asarray(plan.steps), jnp.asarray(a_top),
                              jnp.asarray(a_left), None, mb_width=MBW,
                              mb_height=MBH, has_inter=False,
                              enable_i4x4=True)
        st = {k: np.asarray(v) for k, v in st.items()}
        sym = jmb.symbolize_stage(
            st["sel"], st["mode16"], st["cmode"], st["i4modes"],
            st["i4sym_v"], st["i4sym_l"], st["mv4_y"], st["mv4_x"],
            st["shape"], st["dc_lev"], st["ac_lev"], st["lev_inter"],
            st["cdc_lev"], st["cac_lev"], MBW, MBH, False)
        df = jmb.deblock_stage(
            st["recon_y"], st["recon_u"], st["recon_v"], st["sel"],
            st["lev_inter"], st["mv4_y"], st["mv4_x"], jnp.int32(qp),
            jnp.int32(qpc), jnp.asarray(a_top), jnp.asarray(a_left),
            mb_width=MBW, mb_height=MBH)
        out[qp] = dict(src=src, qpc=qpc, steps=plan.steps, a_top=a_top,
                       a_left=a_left, st=st, sym=sym, df=df)
    return out


def _b(x):
    """One frame -> the port's leading frame axis of 1."""
    return _t(np.asarray(x))[None]


@pytest.mark.parametrize("qp", [20, 33])
def test_select_stage(jax_stages, qp):
    c = jax_stages[qp]
    got = tmb.select_stage_core(*(_b(s) for s in c["src"]), torch.tensor([qp]),
                                torch.tensor([c["qpc"]]), c["steps"],
                                c["a_top"], c["a_left"], None, MBW, MBH)
    assert set(got) <= set(c["st"])
    for key, val in got.items():
        _eq(c["st"][key], val[0], key)
    # the cases mix both intra modes, so both candidates are exercised
    sels = set().union(*(np.unique(x["st"]["sel"]).tolist()
                         for x in jax_stages.values()))
    assert sels == {1, 2}


@pytest.mark.parametrize("qp", [20, 33])
def test_symbolize_stage(jax_stages, qp):
    c = jax_stages[qp]
    st = c["st"]
    got = tmb.symbolize(*(_b(st[k]) for k in (
        "sel", "mode16", "cmode", "i4sym_v", "i4sym_l", "mv4_y", "mv4_x",
        "shape", "dc_lev", "ac_lev", "lev_inter", "cdc_lev", "cac_lev")),
        MBW, MBH, False)
    assert got["sym_vals"].shape == (1, NMB, 952)
    for key in ("sym_vals", "sym_lens", "tail_val", "tail_len",
                "total_bits"):
        _eq(c["sym"][key], got[key][0], key)


@pytest.mark.parametrize("qp", [20, 33])
def test_deblock_stage(jax_stages, qp):
    c = jax_stages[qp]
    st = c["st"]
    got = tmb.deblock_stage_core(
        *(_b(st[k]) for k in ("recon_y", "recon_u", "recon_v", "sel",
                              "lev_inter", "mv4_y", "mv4_x")),
        torch.tensor([qp]), torch.tensor([c["qpc"]]),
        c["a_top"], c["a_left"], MBW, MBH)
    for a, b in zip(c["df"], got):
        _eq(a, b[0], "deblock")
    # the filter changed the picture, so the comparison is not vacuous
    assert not np.array_equal(np.asarray(c["df"][0]), st["recon_y"])
