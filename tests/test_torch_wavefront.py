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
- K3's Intra_4x4 in dependency waves: block (bi, bj) at wave 2 bi + bj,
  the blocks of a wave in a seeded random order, built from the port's
  `intra4.predict4` and transforms, on a canvas and mode slots that hold
  a poison value until a wave (or the MB's edges) writes them, and the
  top-right pixels poisoned until wave 3: no block reads a poisoned
  neighbour or mode, and every output equals the port's and JAX's
  `encode_i4x4_mb` on flat, chessboard and noise MBs, at QPs 0, 12 and
  51, for each availability K3 gives the chain (top and left on or off,
  top-left where both are, top-right on or off where top is);
- K3's Intra_4x4 predictions: every mode but DC at every pixel is the
  (U[a] + U[b] + U[c] + U[d] + 2) >> 2 of four neighbours that
  `wavefront.i4_tap_tables` selects by a byte permute of an 8-byte
  window, equal to `intra4.predict4` on random neighbours;
- K3's schedule, emulated in torch with the port's intra operations: one
  worker per MB row of each frame that takes its MBs in order, keeps the
  left MB in its own state as K3 keeps it in shared memory, and reads
  the records of the MBs above (top-left, top, top-right) as K3's 9
  tagged units of 4 bytes from a buffer whose unwritten units are
  poisoned (tag clear), zeros for an unavailable neighbour. An MB step
  has two parts: the first (Intra_16x16, chroma, Intra_4x4 waves 0-2)
  reads the records above and above left, the second (waves 3-9, the
  selection) the top-right one. The workers take the parts in a seeded
  random order that K3's rule allows (row r starts MB c once row r - 1
  has finished MB c, and goes on at wave 3 once it has finished MB
  c + 1), half of the steps the lowest row's, which runs as close behind
  the row above as the rule lets it: a rule that waited less would read
  a unit whose tag is clear. Rows run in thread-block clusters as K3
  launches them: one ticket per cluster of 8 rows (and, in a second test,
  of 2 or 4 rows with one or two clusters resident at once), drawn in
  ticket order as a place frees, rows past the frame idle, a cluster's
  rows reading the units of the row above from its shared copy and its
  first row from the global buffer, which only a cluster's last row
  writes, and a cluster leaving once all its rows are done: a schedule
  that could deadlock finds no row to run. It takes the arguments that
  `mbscan.select_wavefront_args` packs and equals the plain version;
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
from h264lab_tpu.ops import intra4 as jintra4
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.models import wavefront as plan
from h264lab_tpu_torch.models.encoder import H264Encoder
from h264lab_tpu_torch.ops import intra, intra4, tables, transform, \
    wavefront
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


I32 = torch.int32
POISON = -1000                  # a canvas pixel no wave has written yet
MODE_POISON = -7                # a mode slot no wave has written yet


def i4_in_waves(src_mb, top_row, left_col, tl_px, get_tr, avail_top,
                avail_left, avail_tl, avail_tr, left_modes, top_modes, qp,
                deadzone_q8, lam, rng):
    """`intra4.encode_i4x4_mb` of k MBs as K3 runs it, a generator: block
    (bi, bj) at wave 2 bi + bj, the blocks of a wave in a random order of
    `rng`, each block's arithmetic that of the port (`predict4`, the
    first-minimum argmin, `transform`). The canvas and the mode slots hold
    POISON and MODE_POISON until written, the top-right pixels until wave
    3, where the generator yields once and then takes them from
    `get_tr()` where `avail_tr` (as K3 waits there for the top-right
    record). A block that reads a poisoned neighbour (all 13, as K3 stages
    them) or mode fails. Returns `encode_i4x4_mb`'s dict."""
    k = src_mb.shape[0]
    src = src_mb.to(I32)
    qp = torch.as_tensor(qp)
    lam = torch.as_tensor(lam, dtype=I32).reshape(-1, 1)
    canvas = torch.full((k, 17, 21), POISON, dtype=I32)
    canvas[:, 0, 1:17] = top_row.to(I32)
    canvas[:, 1:17, 0] = left_col.to(I32)
    canvas[:, 0, 0] = tl_px.to(I32)
    ones = torch.ones(k, dtype=torch.bool)
    modes = torch.full((k, 16), MODE_POISON, dtype=I32)
    cost = torch.zeros(k, dtype=I32)
    levels = torch.empty((k, 4, 4, 4, 4), dtype=I32)
    s_vals = torch.empty((k, 16), dtype=I32)
    s_lens = torch.empty((k, 16), dtype=I32)
    mode_ids = torch.arange(intra4.N_MODES, dtype=I32)
    for t in range(10):
        if t == 3:
            yield
            if avail_tr.any():
                canvas[:, 0, 17:21] = torch.where(avail_tr[:, None],
                                                  get_tr().to(I32), POISON)
        wave = [(bi, t - 2 * bi) for bi in range(4) if 0 <= t - 2 * bi < 4]
        assert len(wave) == (2 if 2 <= t <= 7 else 1)
        for bi, bj in rng.permutation(wave):
            b, y0, x0 = 4 * bi + bj, 4 * bi, 4 * bj
            t4 = canvas[:, y0, x0 + 1:x0 + 5]
            l4 = canvas[:, y0 + 1:y0 + 5, x0]
            tlp = canvas[:, y0, x0]
            a_top = ones if bi > 0 else avail_top
            a_left = ones if bj > 0 else avail_left
            a_tl = (ones if bi > 0 and bj > 0 else avail_tl if bi == bj == 0
                    else avail_top if bi == 0 else avail_left)
            tr_ok = (ones if bi > 0 else avail_tr if bj == 3 else avail_top) \
                & (b not in intra4.NO_TOPRIGHT)
            tr4 = torch.where(tr_ok[:, None], canvas[:, y0, x0 + 5:x0 + 9],
                              t4[:, 3:4])
            for what, v in (("top", t4), ("left", l4), ("top-left", tlp),
                            ("top-right", tr4)):
                assert (v != POISON).all(), (t, b, what)
            preds, valid = intra4.predict4(t4, l4, tlp, tr4, a_top, a_left,
                                           a_tl)
            mode_a = left_modes[:, bi] if bj == 0 else modes[:, b - 1]
            mode_b = top_modes[:, bj] if bi == 0 else modes[:, b - 4]
            assert (mode_a != MODE_POISON).all(), (t, b, "left mode")
            assert (mode_b != MODE_POISON).all(), (t, b, "top mode")
            pred_mode = torch.where(a_left & a_top,
                                    torch.minimum(mode_a, mode_b), 2)
            src_blk = src[:, y0:y0 + 4, x0:x0 + 4]
            sad = (src_blk[:, None] - preds).abs().sum((2, 3), dtype=I32)
            bits = 4 - 3 * (mode_ids[None] == pred_mode[:, None]).to(I32)
            c = torch.where(valid, sad + lam * bits, intra.INVALID_COST)
            cmin, m = c.min(dim=1)
            m = m.to(I32)
            best = intra.pick(preds, m)
            cost = cost + cmin
            modes[:, b] = m
            eq = m == pred_mode
            s_vals[:, b] = torch.where(eq, 1, torch.where(m < pred_mode, m,
                                                          m - 1))
            s_lens[:, b] = torch.where(eq, 1, 4)
            lev = transform.quant4x4(transform.fdct4x4(src_blk - best), qp,
                                     deadzone_q8)
            res = transform.idct4x4(transform.dequant4x4(lev, qp))
            canvas[:, y0 + 1:y0 + 5, x0 + 1:x0 + 5] = torch.clamp(
                res + best, 0, 255)
            levels[:, bi, bj] = lev
    scan = torch.as_tensor(tables.BLOCK_SCAN_4x4, dtype=torch.long)
    return dict(levels=levels, recon=canvas[:, 1:17, 1:17].to(torch.uint8),
                modes=modes, mode_sym_val=s_vals[:, scan],
                mode_sym_len=s_lens[:, scan], cost=cost)


def run_waves(gen):
    """Drive an `i4_in_waves` generator to its end; its result."""
    try:
        while True:
            next(gen)
    except StopIteration as done:
        return done.value


# availability that K3 passes the Intra_4x4 chain: (top, left, top-right);
# the top-left is available where both top and left are
I4_AVAIL = [(False, False, False), (False, True, False), (True, False, False),
            (True, False, True), (True, True, False), (True, True, True)]
_jax_i4 = jax.jit(jintra4.encode_i4x4_mb, static_argnames=("deadzone_q8",))


def _i4_inputs(seed, qp, avail, k=6):
    """k MBs (flat, chessboard, noise, two of each), random edges and
    neighbour modes, and the availability of `avail` for all of them."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:16, 0:16]
    src = np.empty((k, 16, 16), np.uint8)
    for i in range(k):
        kind = i % 3
        if kind == 0:
            src[i] = rng.integers(0, 256)
        elif kind == 1:
            cell = 2 if i < 3 else 4
            lo, hi = rng.integers(0, 256, 2)
            src[i] = np.where((yy // cell + xx // cell) % 2, hi, lo)
        else:
            src[i] = rng.integers(0, 256, (16, 16))
    top, left = (rng.integers(0, 256, (k, 16)).astype(np.uint8)
                 for _ in range(2))
    tl = rng.integers(0, 256, k).astype(np.uint8)
    tr = rng.integers(0, 256, (k, 4)).astype(np.uint8)
    lm, tm = (rng.integers(0, 9, (k, 4)).astype(np.int32) for _ in range(2))
    a_top, a_left, a_tr = (np.full(k, v) for v in avail)
    return dict(src_mb=src, top_row=top, left_col=left, tl_px=tl, tr4_px=tr,
                avail_top=a_top, avail_left=a_left,
                avail_tl=a_top & a_left, avail_tr=a_tr, left_modes=lm,
                top_modes=tm, qp=np.full(k, qp, np.int32),
                lam=np.full(k, lambda_me(torch.tensor(qp)).item(), np.int32))


@pytest.mark.parametrize("qp", [0, 12, 51])
@pytest.mark.parametrize("avail", I4_AVAIL, ids=lambda a: "top%d-left%d-tr%d"
                         % tuple(a))
def test_i4_waves_match_encode_i4x4(avail, qp):
    d = _i4_inputs(50 + qp, qp, avail)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    got = run_waves(i4_in_waves(
        t["src_mb"], t["top_row"], t["left_col"], t["tl_px"],
        lambda: t["tr4_px"], t["avail_top"], t["avail_left"], t["avail_tl"],
        t["avail_tr"], t["left_modes"], t["top_modes"], t["qp"],
        INTRA_DEADZONE_Q8, t["lam"], np.random.default_rng(qp)))
    port = intra4.encode_i4x4_mb(
        t["src_mb"], t["top_row"], t["left_col"], t["tl_px"], t["tr4_px"],
        t["avail_top"], t["avail_left"], t["avail_tl"], t["avail_tr"],
        t["left_modes"], t["top_modes"], t["qp"], INTRA_DEADZONE_Q8, t["lam"])
    ref = _jax_i4(**dict(d, qp=d["qp"][0], lam=d["lam"][0]),
                  deadzone_q8=INTRA_DEADZONE_Q8)        # one QP and lambda
    for k, v in got.items():
        assert torch.equal(v, port[k]), k
        np.testing.assert_array_equal(v.numpy().astype(np.int64),
                                      np.asarray(ref[k]).astype(np.int64),
                                      err_msg=k)


@pytest.mark.parametrize("mode", wavefront.TAP_MODES)
def test_i4_tap_tables_match_predict4(mode):
    rng = np.random.default_rng(mode)
    k = 512
    top, left, tr = (rng.integers(0, 256, (k, 4)) for _ in range(3))
    tl = rng.integers(0, 256, k)
    ones = torch.ones(k, dtype=torch.bool)
    preds, _ = intra4.predict4(*(torch.from_numpy(x) for x in (
        top, left, tl, tr)), ones, ones, ones)
    # K3's U = [l3, l2, l1, l0, tl, t0..t3, t4..t7], and its two windows
    # of 8 bytes: U[0..7] and U[5..12]
    u = np.concatenate([left[:, ::-1], tl[:, None], top, tr], axis=1)
    tab = wavefront.i4_tap_tables().view(np.uint32)
    sel, win = tab[:-16].reshape(16, -1), tab[-16:]
    kk = wavefront.TAP_MODES.index(mode)
    for pix in range(16):
        w = (int(win[pix]) >> kk) & 1
        window = u[:, 5 * w:5 * w + 8]
        taps = [window[:, (int(sel[pix, kk]) >> (4 * j)) & 7]
                for j in range(4)]
        got = (sum(taps) + 2) >> 2
        np.testing.assert_array_equal(
            got, preds[:, mode, pix >> 2, pix & 3].numpy(),
            err_msg=f"pixel {pix}")


def _unit(above, m, k):
    """The 4 bytes of record unit k of MB m of the row above; K3 reads a
    unit only once its tag is set."""
    u = int(above[m, k])
    assert u >> 32 == 1, (m, k, "read before written")
    return torch.tensor([(u >> (8 * j)) & 0xff for j in range(4)],
                        dtype=torch.uint8)


def _mb_step(args, f, r, c, above, left, mbw, rng):
    """One MB step of K3 on its packed arguments `args`, a generator: MB
    (r, c) of frame f, the row above's record units from `above` (mbw, 9)
    int64, the left MB from `left` (a dict, None on column 0). It yields
    once, where K3 waits for the top-right record (before Intra_4x4 wave
    3), then returns the MB's outputs (the plain version's names, no
    leading axes), its 9 record units and the left state for the next
    MB."""
    (src_y, src_u, src_v, qp, qpc, lam, pen, at, al, inter_cost, ry_i, ru_i,
     rv_i, _, dz, i4_pen) = args
    i = r * mbw + c
    a_top = bool(at[i]) and r > 0
    a_left = bool(al[i]) and c > 0
    a_tl, a_tr = a_top and a_left, a_top and c < mbw - 1
    zero = torch.zeros(4, dtype=torch.uint8)
    top = torch.cat([_unit(above, c, k) if a_top else zero
                     for k in range(9)])
    tl = _unit(above, c - 1, 3)[3] if a_tl else zero[0]
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
    # Intra_4x4 in waves; the top-right record is read at wave 3
    waves = i4_in_waves(
        sy, top[None, 0:16], left["y"][None, :, 15], tl[None],
        lambda: _unit(above, c + 1, 0)[None], *b,
        left["em_r"][None], top[None, 32:36].to(torch.int32), q, dz, lm, rng)
    next(waves)
    yield
    i4 = run_waves(waves)
    cost4 = i4["cost"] + lm * i4_pen
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
    data = torch.cat([rec["y"][15], rec["u"][7], rec["v"][7],
                      em_b.to(torch.uint8)]).to(torch.int64).reshape(9, 4)
    units = (data << (8 * torch.arange(4))).sum(1) | (1 << 32)
    outs = dict(sel=torch.tensor(sel), mode16=m16[0], cmode=cm[0],
                dc_lev=dc_lev[0], ac_lev=(i4["levels"][0], ac16[0])[sel != 2],
                cdc_lev=cdc, cac_lev=cac, recon_y=rec["y"], recon_u=rec["u"],
                recon_v=rec["v"], i4modes=modes,
                i4sym_v=i4["mode_sym_val"][0], i4sym_l=i4["mode_sym_len"][0])
    return outs, units, dict(rec, em_r=em_r.to(torch.int32))


def emulate_k3(args, seed, cluster=wavefront.CLUSTERS[0], resident=None):
    """K3's schedule in torch on the arguments that `select_wavefront_args`
    packs (module docstring), with MB rows in clusters of `cluster` and at
    most `resident` clusters at once (all by default). Returns the plain
    version's output dict."""
    src_y, mbw = args[0], args[13]
    n, nmb = src_y.shape[:2]
    mbh = nmb // mbw
    rng = np.random.default_rng(seed)
    out = {name: torch.zeros((n, nmb) + shape, dtype=dtype)
           for name, dtype, shape in wavefront.OUTPUTS}

    def poisoned(*shape):           # unwritten units: tag clear, data
        return torch.full(shape + (wavefront.REC_UNITS,), 0xABABABAB,
                          dtype=torch.int64)         # 0xABABABAB

    records = poisoned(n, nmb)      # global memory
    progress = np.zeros((n, mbh), np.int64)
    tickets = iter(range(n * -(-mbh // cluster)))
    clusters, workers = [], []

    def draw():
        """The next cluster's ticket t: rows cluster * (t // n) + k of
        frame t % n, each with its record units in shared memory; rows
        past mbh idle."""
        t = next(tickets, None)
        if t is None:
            return
        f, r0 = t % n, cluster * (t // n)
        shared = [poisoned(mbw) for _ in range(cluster)]
        rows = [dict(f=f, r=r0 + k, k=k, c=0, left=None, step=None,
                     shared=shared) for k in range(cluster) if r0 + k < mbh]
        clusters.append(rows)
        workers.extend(rows)

    def above(w):                   # the units of the row above
        if w["k"] > 0:
            return w["shared"][w["k"] - 1]
        r = w["r"]
        return records[w["f"], (r - 1) * mbw:r * mbw]

    def ready(w):
        i = w["r"] * mbw + w["c"]
        if w["r"] == 0 or not bool(args[7][i]):
            return True
        if w["step"] is None:       # the records above and above left
            return progress[w["f"], w["r"] - 1] >= w["c"] + 1
        return (w["c"] == mbw - 1    # the top-right record, at wave 3
                or progress[w["f"], w["r"] - 1] >= w["c"] + 2)

    for _ in range(resident or n * mbh):
        draw()
    while workers:
        live = [w for w in workers if ready(w)]
        assert live, "no row can go on: the schedule deadlocks"
        if rng.random() < 0.5:      # the lowest row, as close behind the
            w = max(live, key=lambda w: (w["r"], w["f"]))   # row above as
        else:                       # the rule lets it run
            w = live[rng.integers(len(live))]
        f, r, c = w["f"], w["r"], w["c"]
        if w["step"] is None:
            w["step"] = _mb_step(args, f, r, c, above(w), w["left"], mbw,
                                 rng)
            next(w["step"])
            continue
        try:
            next(w["step"])
        except StopIteration as done:
            outs, units, w["left"] = done.value
        w["step"] = None
        for k, v in outs.items():
            out[k][f, r * mbw + c] = v
        if r + 1 < mbh:             # for the row below: the cluster's
            if w["k"] + 1 < cluster:    # next row reads shared memory,
                w["shared"][w["k"]][c] = units  # the next cluster global
            else:
                records[f, r * mbw + c] = units
        w["c"] += 1
        progress[f, r] = w["c"]
        if w["c"] == mbw:
            workers.remove(w)
        # a cluster leaves once all its rows are done (its blocks meet at
        # a cluster barrier before they exit), and frees a place for the
        # next ticket
        for rows in [rows for rows in clusters
                     if all(x["c"] == mbw for x in rows)]:
            clusters.remove(rows)
            draw()
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


@pytest.mark.parametrize("cluster,resident", [(2, 1), (2, 2), (4, 1)])
@pytest.mark.parametrize("case", [CASES[1], CASES[6], CASES[8]],
                         ids=lambda c: f"seed{c[0]}-{c[2]}x{c[3]}-{c[6]}")
def test_k3_cluster_schedule_matches_plain(case, cluster, resident):
    # clusters that cross the frame's rows and leave idle rows: rows hand
    # records over in the cluster's shared memory and, between clusters,
    # through global memory; one cluster at a time still finishes
    d, mbw, mbh, inter = _inputs(case)
    args = _port_args(d, mbw, mbh, inter)
    want = tmb._select_wavefront_plain(*args)
    got = emulate_k3(tmb.select_wavefront_args(*args), seed=case[0],
                     cluster=cluster, resident=resident)
    for k, v in want.items():
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
