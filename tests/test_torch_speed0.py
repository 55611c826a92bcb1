"""Parity of the port's speed-0, speed-1 and full-pel P tools with the JAX
package, stage by stage, and of the GOP lanes at those speeds.

The same seeded numpy inputs go to the JAX function (on the CPU) and to
its `h264lab_tpu_torch` counterpart on `device="cpu"`; the encoder is
integer arithmetic, so the tolerance is exact equality. Covered:
- `mc_chroma_grid` with MVs at the +-57.75 px reach of the search on MBs
  at every edge of the frame;
- the partition search on a 64x64 frame whose 8x8 blocks move apart in
  four patterns, so every shape (16x16, 16x8, 8x16, 8x8) wins somewhere;
- `inter_stage_core` with partitions and with full-pel ME;
- the P wavefront with the inter candidate, inter, Intra_16x16 and
  Intra_4x4 all chosen somewhere;
- `symbolize` with a per-row QP plan (`mb_qp_delta`, `qp_dec`,
  `row_bits`) and deblocking at the decoded per-MB QPs.
The GOP lanes at these speeds are in `test_torch_gop_speeds.py`.
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
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.ops import me as tme
from h264lab_tpu_torch.ops import qpel as tqp

W = H = 64
MBW = MBH = 4
NMB = MBW * MBH
QP = 24


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


def _moving_blocks():
    """(ref, cur) luma planes and flat chroma: cur's 8x8 blocks are the
    reference moved by one of two full-pel displacements, in the pattern
    of MB i % 4: uniform, top/bottom, left/right, diagonal quadrants. The
    last MB row holds new content: a strong diagonal edge, a noise patch
    and a patch that repeats the row above it (Intra_16x16's vertical
    mode)."""
    rng = np.random.default_rng(21)
    tex = rng.integers(0, 256, (H + 8, W + 8)).astype(np.float64)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3
    ref_pad = tex.astype(np.uint8)                   # 4 px ring each side
    ref = ref_pad[4:-4, 4:-4]
    d = [(1, -1), (-1, 1)]
    pattern = [(0, 0, 0, 0), (0, 0, 1, 1), (0, 1, 0, 1), (0, 1, 1, 0)]
    cur = np.empty_like(ref)
    for i in range(NMB):
        r, c = divmod(i, MBW)
        for q, k in enumerate(pattern[i % 4]):
            y0, x0 = 16 * r + 8 * (q // 2), 16 * c + 8 * (q % 2)
            dy, dx = d[k]
            cur[y0:y0 + 8, x0:x0 + 8] = ref_pad[4 + y0 + dy:12 + y0 + dy,
                                                4 + x0 + dx:12 + x0 + dx]
    yy, xx = np.mgrid[0:16, 0:16]
    cur[48:64, 0:16] = np.where(yy > xx, 230, 20)
    cur[48:64, 16:32] = rng.integers(0, 256, (16, 16))
    cur[48:64, 32:48] = cur[47:48, 32:48]
    u = np.full((H // 2, W // 2), 128, np.uint8)
    v = (np.arange(W // 2)[None, :] * 4 + np.zeros((H // 2, 1))).astype(
        np.uint8)
    return (ref, u, v), (cur, u, v)


@functools.partial(jax.jit, static_argnames=("enable_partitions",
                                             "enable_qpel"))
def _jax_inter(sy, su, sv, ry, ru, rv, r4, qp, qpc, enable_partitions,
               enable_qpel):
    return jmb.inter_stage_core(sy, su, sv, ry, ru, rv, r4, qp, qpc, 0,
                                None, None, MBW, MBH,
                                enable_partitions=enable_partitions,
                                enable_qpel=enable_qpel)


@pytest.fixture(scope="module")
def frame():
    """The inputs and JAX's inter (partitions on; full-pel), select (the
    wavefront with the inter candidate; the parallel path), symbolize
    (with a per-row QP plan) and deblock outputs of one P frame."""
    ref_f, cur = _moving_blocks()
    ref = jrs.prepare_reference(
        *(jnp.asarray(jwf.mb_tiles(p, t)) for p, t in zip(ref_f, (16, 8, 8))),
        MBW, MBH)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    src = tuple(jwf.mb_tiles(p, t) for p, t in zip(cur, (16, 8, 8)))
    qpc = int(jtb.QPC_FROM_QPY[QP])
    refs = (ref["y_pad"], ref["u_pad"], ref["v_pad"], ref["y4_pad"])
    out = dict(ref_f=ref_f, ref=ref, src=src, qpc=qpc)
    for name, part, qpel in (("part", True, True), ("fullpel", False, False)):
        out[name] = {k: np.asarray(v) for k, v in _jax_inter(
            *src, *refs, jnp.int32(QP), jnp.int32(qpc), part, qpel).items()}
    steps = jwf.make_plan(MBW, MBH, 2).steps
    rr, cc = np.arange(NMB) // MBW, np.arange(NMB) % MBW
    a_top, a_left = rr > 0, cc > 0
    out.update(steps=steps, a_top=a_top, a_left=a_left)
    st = jmb.select_stage(*src, jnp.int32(QP), jnp.int32(qpc),
                          jnp.asarray(steps), jnp.asarray(a_top),
                          jnp.asarray(a_left), out["part"], mb_width=MBW,
                          mb_height=MBH, has_inter=True, enable_i4x4=True)
    out["wave"] = {k: np.asarray(v) for k, v in st.items()}
    # the parallel path at per-row QPs, then symbolize and deblock
    qp_rows = np.asarray([QP, QP + 6, QP - 5, QP + 2], np.int32)
    qpc_rows = jtb.QPC_FROM_QPY[qp_rows].astype(np.int32)
    st = jmb.select_stage(*src, qp_rows, qpc_rows, jnp.asarray(steps),
                          jnp.asarray(a_top), jnp.asarray(a_left),
                          out["part"], mb_width=MBW, mb_height=MBH,
                          has_inter=True, enable_i4x4=False)
    st = {k: np.asarray(v) for k, v in st.items()}
    sym = jmb.symbolize(st["sel"], st["mode16"], st["cmode"], st["i4modes"],
                        st["i4sym_v"], st["i4sym_l"], st["mv4_y"],
                        st["mv4_x"], st["shape"], st["dc_lev"], st["ac_lev"],
                        st["lev_inter"], st["cdc_lev"], st["cac_lev"], MBW,
                        MBH, True, qp_rows=jnp.asarray(qp_rows))
    qp_dec = np.asarray(sym["qp_dec"])
    df = jmb.deblock_stage(
        st["recon_y"], st["recon_u"], st["recon_v"], st["sel"],
        st["lev_inter"], st["mv4_y"], st["mv4_x"], jnp.asarray(qp_dec),
        jnp.asarray(jtb.QPC_FROM_QPY[qp_dec]), jnp.asarray(a_top),
        jnp.asarray(a_left), mb_width=MBW, mb_height=MBH)
    out.update(qp_rows=qp_rows, qpc_rows=qpc_rows, rows_st=st,
               rows_sym={k: np.asarray(v) for k, v in sym.items()},
               rows_df=[np.asarray(x) for x in df])
    return out


def _port_inter(frame, **kw):
    src = [_t(s)[None] for s in frame["src"]]
    ref = {k: _t(v)[None] for k, v in frame["ref"].items()}
    one = torch.zeros(1, dtype=torch.int32)
    return src, tmb.inter_stage_core(
        *src, ref, torch.tensor([0]), torch.tensor([QP], dtype=torch.int32),
        torch.tensor([frame["qpc"]], dtype=torch.int32), one, None, None,
        MBW, MBH, **kw)


def test_mc_chroma_grid_at_the_frame_edges():
    """MVs at the full reach (+-52 candidate clip, +-3 refine, +-2
    partition sweep, +-0.75 qpel = +-231 quarter-pel) on MBs at all four
    edges and corners of a 64x48 frame, and random ones elsewhere."""
    rng = np.random.default_rng(9)
    mbw, mbh = 4, 3
    plane = rng.integers(0, 256, (mbh * 8 + 64, mbw * 8 + 64), np.uint8)
    k = mbw * mbh
    cb_y = (32 + 8 * (np.arange(k) // mbw)).astype(np.int32)
    cb_x = (32 + 8 * (np.arange(k) % mbw)).astype(np.int32)
    mv_y = rng.integers(-231, 232, (k, 4, 4)).astype(np.int32)
    mv_x = rng.integers(-231, 232, (k, 4, 4)).astype(np.int32)
    reach = 231
    for i in range(k):                     # edge MBs point out of the frame
        r, c = divmod(i, mbw)
        if r == 0:
            mv_y[i, 0] = -reach
        if r == mbh - 1:
            mv_y[i, 3] = reach
        if c == 0:
            mv_x[i, :, 0] = -reach
        if c == mbw - 1:
            mv_x[i, :, 3] = reach
    want = jqp.mc_chroma_grid(plane, mv_y, mv_x, cb_y, cb_x)
    got = tqp.mc_chroma_grid(_t(plane)[None], torch.zeros(k, dtype=torch.long),
                             _t(mv_y), _t(mv_x), _t(cb_y), _t(cb_x))
    _eq(want, got, "mc_chroma_grid")
    # the reads reach to 3 pixels of the plane's edges and stay inside
    iy = cb_y[:, None, None] + np.arange(4)[None, :, None] * 2 + (mv_y >> 3)
    ix = cb_x[:, None, None] + np.arange(4)[None, None, :] * 2 + (mv_x >> 3)
    assert iy.min() == 3 and ix.min() == 3
    assert iy.max() + 2 <= plane.shape[0] - 1
    assert ix.max() + 2 <= plane.shape[1] - 1


def test_partition_search(frame):
    """Every shape wins somewhere, and the port's per-shape MVs, costs and
    predictions equal JAX's."""
    ref = {k: _t(v)[None] for k, v in frame["ref"].items()}
    tiles = _t(frame["src"][0])
    plane = tiles.reshape(MBH, MBW, 16, 16).permute(0, 2, 1, 3).reshape(
        1, H, W)
    rr, cc = np.arange(NMB) // MBW, np.arange(NMB) % MBW
    base_y = (jqp.GUARD + 16 * rr).astype(np.int32)
    base_x = (jqp.GUARD + 16 * cc).astype(np.int32)
    want_me = jme.motion_search_dense(
        plane[0].numpy(), tiles.numpy(), frame["ref"]["y_pad"],
        frame["ref"]["y4_pad"], base_y, base_x, jnp.int32(QP), MBH, MBW, 0)
    want = jme.partition_search(tiles.numpy(), want_me[4], jnp.int32(QP))
    got_me = tme.motion_search_dense(
        plane, tiles[None], ref["y_pad"], ref["y4_pad"], torch.tensor([0]),
        _t(base_y)[None], _t(base_x)[None],
        torch.tensor([QP], dtype=torch.int32), MBH, MBW,
        torch.zeros(1, dtype=torch.int32))
    for name, (a, b) in zip(("F", "B", "H", "J"), zip(want_me[4]["wins"],
                                                      got_me[4]["wins"])):
        _eq(a, b, f"half-pel plane {name}")
    aux = dict(wins=got_me[4]["wins"], **{
        k: got_me[4][k].reshape(-1)
        for k in ("full_my", "full_mx", "mvp_y", "mvp_x")})
    got = tme.partition_search(tiles, aux,
                               tme.lambda_me(torch.full((NMB,), QP)))
    assert set(got) == set(want)
    for key in want:
        _eq(want[key], got[key], key)
    assert set(np.unique(frame["part"]["shape"]).tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("tools", ["part", "fullpel"])
def test_inter_stage(frame, tools):
    kw = (dict(enable_partitions=True) if tools == "part"
          else dict(enable_qpel=False))
    _, got = _port_inter(frame, **kw)
    want = frame[tools]
    assert set(got) == set(want)
    for key, val in got.items():
        _eq(want[key], val[0], key)
    if tools == "fullpel":
        assert (np.asarray(want["mv_y"]) % 4 == 0).all()


def test_p_wavefront_with_inter_candidate(frame):
    """Speeds 0 and 1: the slope-2 wavefront with Intra_4x4 on a P frame,
    the inter candidate's cost and recon per MB, inter winning ties."""
    src, inter = _port_inter(frame, enable_partitions=True)
    got = tmb.select_stage_core(
        *src, torch.tensor([QP], dtype=torch.int32),
        torch.tensor([frame["qpc"]], dtype=torch.int32), frame["steps"],
        frame["a_top"], frame["a_left"], inter, MBW, MBH, enable_i4x4=True)
    want = frame["wave"]
    assert set(got) <= set(want)
    for key, val in got.items():
        _eq(want[key], val[0], key)
    assert set(np.unique(want["sel"]).tolist()) == {0, 1, 2}


def test_symbolize_and_deblock_with_row_qps(frame):
    """A per-row QP plan on the parallel P path: real mb_qp_delta along
    the scan, the decoded running QP, the per-row bits, and deblocking at
    the decoded per-MB QPs."""
    src, inter = _port_inter(frame, enable_partitions=True)
    qp_rows = _t(frame["qp_rows"])[None]
    qpc_rows = _t(frame["qpc_rows"])[None]
    st = tmb.select_stage_core(*src, qp_rows, qpc_rows, frame["steps"],
                               frame["a_top"], frame["a_left"], inter, MBW,
                               MBH)
    for key, val in st.items():
        _eq(frame["rows_st"][key], val[0], key)
    sym = tmb.symbolize(*(st[k] for k in (
        "sel", "mode16", "cmode", "i4sym_v", "i4sym_l", "mv4_y", "mv4_x",
        "shape", "dc_lev", "ac_lev", "lev_inter", "cdc_lev", "cac_lev")),
        MBW, MBH, True, qp_rows=qp_rows)
    want = frame["rows_sym"]
    for key in ("sym_vals", "sym_lens", "tail_val", "tail_len",
                "total_bits", "row_bits", "qp_dec"):
        _eq(want[key], sym[key][0], key)
    assert len(np.unique(want["qp_dec"])) > 2
    qpc_dec = torch.as_tensor(jtb.QPC_FROM_QPY)[sym["qp_dec"].long()]
    df = tmb.deblock_stage_core(
        *(st[k] for k in ("recon_y", "recon_u", "recon_v", "sel",
                          "lev_inter", "mv4_y", "mv4_x")),
        sym["qp_dec"], qpc_dec, frame["a_top"], frame["a_left"], MBW, MBH)
    for a, b in zip(frame["rows_df"], df):
        _eq(a, b[0], "deblock")
    # per-row QPs are refused off the parallel P path, as in JAX
    with pytest.raises(NotImplementedError):
        tmb.select_stage_core(*src, qp_rows, qpc_rows, frame["steps"],
                              frame["a_top"], frame["a_left"], inter, MBW,
                              MBH, enable_i4x4=True)
