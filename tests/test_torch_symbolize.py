"""CAVLC symbolization: the plain version and the schedule of its CUDA
kernel K6 (`csrc/symbolize.cu`), emulated on the CPU.

`symbolize_plain` (the port's `mbscan.symbolize` on CPU tensors, the
version K6 is held against on the card) equals JAX's `symbolize`
(`h264lab_tpu/models/mbscan.py`), every output and every slot, values
where the lengths are 0 included, on `utils.synthetic.sym_inputs` cases:
I and P slices; Intra_16x16 MBs with and without AC, Intra_4x4, intra MBs
in P slices, inter shapes 0-3 with partition-constant MVs; P_Skip runs in
the middle, across a row end and at a slice's end, and skips with a
nonzero predicted MV; cbpc 0, 1 and 2; blocks with 16 nonzeros, levels
that take both escapes of the level code (28 and 30 bits) and nC >= 8;
row QP plans with MBs that carry no mb_qp_delta; base_mode_flag slots;
4 x 3, 6 x 1, 1 x 6 and 11 x 3 MBs. JAX runs each slice alone (its
`symbolize` takes one), one trace per case shape.

A CUDA kernel cannot run here, so `emulate_k6` does in Python what K6
does: pass A, a warp per MB, counts each block's nonzeros, derives cbp,
cbpc, the coded counts that nC reads (a 32-byte record per MB), the MV
predictors of the MB's partitions (lanes 0-3) and P_Skip's (lane 4);
pass B scans each slice's MBs in chunks with a carry (here chunks of 5,
so that the carry is used; the kernel's chunks are 1024) for the skip
runs, the tail and the running QP; pass C, a warp per MB, codes unit u
on lane u (the luma DC, the 16 luma blocks in BLOCK_SCAN_4x4 order, the
chroma DC and AC) from the MB's and its left and upper neighbours'
records, walking each block's positions in reverse scan as the kernel
does, and builds the header on lanes 0 and 28-31, with the tables the
kernel includes (`csrc/symbolize_tables.h`). It equals the
plain version on every case. Three faults of the schedule each make it
fail: nC read across a band's top (from the slice before), the slice
scans' carry kept across a slice boundary, and the luma units in raster
order. Tolerance: exact equality (integer arithmetic).
"""

import re

import numpy as np
import pytest
import torch

from h264lab_tpu.models import mbscan as jmb
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.models.encoder import H264Encoder
from h264lab_tpu_torch.ops import cuda_build, tables, tables_cavlc
from h264lab_tpu_torch.ops import symbolize as k6
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
from h264lab_tpu_torch.parallel.gop import GopBandEncoder
from h264lab_tpu_torch.utils.synthetic import chessboard_sequence, sym_inputs

KEYS = ("sel", "mode16", "cmode", "i4sym_v", "i4sym_l", "mv4_y", "mv4_x",
        "shape", "dc_lev", "ac_lev", "lev_inter", "cdc_lev", "cac_lev")
# (seed, slices, mb_width, mb_height, P slices, row QP plan, base_mode bit)
CASES = [
    (101, 3, 4, 3, True, True, False),
    (102, 2, 4, 3, False, False, False),
    (103, 3, 11, 3, True, False, True),
    (104, 2, 11, 3, False, True, False),
    (105, 2, 6, 1, True, True, False),
    (106, 2, 6, 1, False, False, True),
    (107, 2, 1, 6, True, False, False),
    (108, 2, 1, 6, False, True, False),
]
SCAN_CHUNK = 5                  # pass B's chunk in the emulation


def _ids(c):
    return (f"{c[1]}x{c[2]}x{c[3]}-{'P' if c[4] else 'I'}"
            + ("-plan" if c[5] else "") + ("-bm" if c[6] else ""))


def case(c):
    seed, n, mbw, mbh, has_inter, plan, flag = c
    return sym_inputs(seed, n, mbw, mbh, has_inter, plan=plan)


def plain(d, c):
    _, _, mbw, mbh, has_inter, _, flag = c
    qp = d["qp_rows"]
    return tmb.symbolize_plain(
        *(torch.from_numpy(d[k]) for k in KEYS), mbw, mbh, has_inter,
        qp_rows=None if qp is None else torch.from_numpy(qp),
        svc_base_mode_bit=flag)


def _eq(want, got, what):
    """Equal arrays of equal kinds; symbol values compared as bit
    patterns (JAX keeps them as uint32)."""
    a, b = np.asarray(want), np.asarray(got)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype == np.uint32 or b.dtype == np.uint32:
        a, b = (x.astype(np.int64) & 0xFFFFFFFF for x in (a, b))
    else:
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same(want: dict, got: dict, what: str):
    assert set(want) == set(got), (what, sorted(want), sorted(got))
    for k in want:
        _eq(want[k].numpy(), got[k].numpy(), f"{what}: {k}")


@pytest.mark.parametrize("c", CASES, ids=_ids)
def test_symbolize_plain_equals_jax(c):
    d = case(c)
    got = plain(d, c)
    _, n, mbw, mbh, has_inter, plan, flag = c
    for i in range(n):
        jax_in = [d[k][i] for k in KEYS]
        want = jmb.symbolize_stage(
            *jax_in[:3], np.zeros((mbw * mbh, 16), np.int32), *jax_in[3:],
            mb_width=mbw, mb_height=mbh, has_inter=has_inter,
            svc_base_mode_bit=flag,
            qp_rows=None if d["qp_rows"] is None else d["qp_rows"][i])
        assert set(want) == set(got)
        for k, v in want.items():
            _eq(v, got[k][i].numpy(), f"{_ids(c)} slice {i}: {k}")


def test_sym_inputs_cover_the_branches():
    """Over the cases: every MB kind and shape, skips in every place, the
    cbpc values, dense blocks, both level escapes, nC >= 8 and MBs without
    mb_qp_delta under a plan."""
    seen = dict.fromkeys((
        "i16_ac", "i16_no_ac", "i4", "intra_in_p", "shape0", "shape1",
        "shape2", "shape3", "skip_middle", "skip_row_end", "skip_tail",
        "skip_mv", "cbpc0", "cbpc1", "cbpc2", "dense16", "escape12",
        "escape13", "nc8", "plan_no_dqp"), False)
    for c in CASES:
        d, out = case(c), plain(case(c), c)
        _, n, mbw, mbh, has_inter, plan, _ = c
        sel, shape = d["sel"], d["shape"]
        nz_ac = (d["ac_lev"] != 0).any((2, 3, 4, 5))
        i16, i4 = sel == tmb.SEL_I16, sel == tmb.SEL_I4
        seen["i16_ac"] |= bool((i16 & nz_ac).any())
        seen["i16_no_ac"] |= bool((i16 & ~nz_ac).any())
        seen["i4"] |= bool(i4.any())
        seen["intra_in_p"] |= has_inter and bool((i16 | i4).any())
        inter = sel == tmb.SEL_INTER
        for s in range(4):
            seen[f"shape{s}"] |= bool((inter & (shape == s)
                                       & ~out["skip"].numpy()).any())
        # each partition's MV is constant over its blocks
        mv = d["mv4_y"]
        assert (mv[shape == 0] == mv[shape == 0][:, :1, :1]).all()
        assert (mv[shape == 1] == mv[shape == 1][:, :, :1]).all()
        assert (mv[shape == 2] == mv[shape == 2][:, :1, :]).all()
        skip = out["skip"].numpy()
        nmb = mbw * mbh
        col = np.arange(nmb) % mbw
        seen["skip_tail"] |= bool(skip[:, -1].all() and has_inter)
        seen["skip_row_end"] |= bool((skip[:, :-1] & skip[:, 1:]
                                      & (col[:-1] == mbw - 1)).any())
        seen["skip_middle"] |= bool((skip[:, 1:-1] & ~skip[:, 2:]).any())
        seen["skip_mv"] |= bool((skip & ((d["mv4_y"][..., 0, 0] != 0)
                                         | (d["mv4_x"][..., 0, 0] != 0))
                                 ).any())
        for v in range(3):
            seen[f"cbpc{v}"] |= bool((out["cbpc"].numpy() == v).any())
        blocks = np.concatenate([d["ac_lev"], d["lev_inter"]]).reshape(
            -1, 16)
        seen["dense16"] |= bool(((blocks != 0).sum(1) == 16).any())
        lens = out["sym_lens"].numpy()
        seen["escape12"] |= bool((lens == 28).any())
        seen["escape13"] |= bool((lens == 30).any())
        # nC >= 8 (the FLC coeff_token) on a luma block
        nnz = np.where(inter[..., None, None], (d["lev_inter"] != 0).sum(
            (-2, -1)), (d["ac_lev"] != 0).sum((-2, -1)))
        nc = tmb._nc_grid(torch.from_numpy(nnz), mbh, mbw, 4)
        seen["nc8"] |= bool((nc >= 8).any())
        if plan:
            needed = ~skip & (i16 | (out["cbp"].numpy() != 0))
            seen["plan_no_dqp"] |= bool((~needed).any())
    assert all(seen.values()), [k for k, v in seen.items() if not v]


# ---------------------------------------------------------------------------
# K6's schedule, emulated
# ---------------------------------------------------------------------------

def _macro(header: str, name: str) -> list:
    m = re.search(rf"#define {name} \{{([^}}]*)\}}", header)
    return [int(v) for v in m.group(1).split(",")]


HEADER = k6.HEADER.read_text()
TAB = {name: _macro(HEADER, f"K6_{name}") for name in (
    "ZIGZAG", "BLOCK_SCAN", "CBP_TO_CODENUM", "COEFF_TOKEN", "TOTAL_ZEROS",
    "TOTAL_ZEROS_CDC", "RUN_BEFORE")}
# the partitions' top-left blocks, and their neighbours A, B, C, D (dy,
# dx, static availability) with the directional rule, as the kernel lists
# them (`_mv_predictors`)
PARTS = tmb._PART_BLOCKS
NO = (0, 0, False)
SPECS = {
    (0, 0): (((0, -1, True), (-1, 0, True), (-1, 4, True), (-1, -1, True)),
             None),
    (1, 0): (((0, -1, True), (-1, 0, True), (-1, 4, True), (-1, -1, True)),
             "B"),
    (1, 1): (((2, -1, True), (1, 0, True), NO, (1, -1, True)), "A"),
    (2, 0): (((0, -1, True), (-1, 0, True), (-1, 2, True), (-1, -1, True)),
             "A"),
    (2, 1): (((0, 1, True), (-1, 2, True), (-1, 4, True), (-1, 1, True)),
             "C"),
    (3, 0): (((0, -1, True), (-1, 0, True), (-1, 2, True), (-1, -1, True)),
             None),
    (3, 1): (((0, 1, True), (-1, 2, True), (-1, 4, True), (-1, 1, True)),
             None),
    (3, 2): (((2, -1, True), (1, 0, True), (1, 2, True), (1, -1, True)),
             None),
    (3, 3): (((2, 1, True), (1, 2, True), NO, (1, 1, True)), None),
}


def ue(v):
    code = v + 1
    return code, 2 * (code.bit_length() if code > 0 else 0) - 1


def se(v):
    return ue(2 * v - 1 if v > 0 else -2 * v)


def level_code(lc, sl):
    prefix = lc >> sl
    if sl == 0 and lc < 14:
        return 1, lc + 1
    if sl == 0 and lc < 30:
        return 16 | (lc - 14), 19
    if sl > 0 and prefix < 15:
        return (1 << sl) | (lc & ((1 << sl) - 1)), prefix + 1 + sl
    rem = lc - ((15 << sl) + (15 if sl == 0 else 0))
    if rem < 4096:
        return (1 << 12) | rem, 28
    return (1 << 13) | (rem - 4096), 30


def code_block(lv, nc, max_coeff, keep, sv, sl):
    """The kernel's `code_block`: lv 16 levels in scan order; writes the
    unit's 34 slots; returns the bits kept."""
    total = sum(1 for v in lv if v)
    t1 = signs = k = 0
    ones = True
    for p in range(15, -1, -1):
        if lv[p]:
            if k < 3 and ones and abs(lv[p]) == 1:
                t1 += 1
                signs = (signs << 1) | (lv[p] < 0)
            else:
                ones = False
            k += 1
    bits = [0]

    def put(slot, v, n):
        sv[slot] = v
        if keep:
            sl[slot] = n
            bits[0] += n

    ctx = 4 if nc < 0 else 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 \
        else 3
    ct = TAB["COEFF_TOKEN"][(ctx * 17 + total) * 4 + t1]
    put(0, ct & 0xFFFF, ct >> 16)
    put(1, signs, t1)
    suffix = 1 if total > 10 and t1 < 3 else 0
    prev = first = k = 0
    for p in range(15, -1, -1):
        lev = lv[p]
        if not lev:
            continue
        if k == 0:
            first = p
        else:
            zeros_left = prev - (total - k)
            if zeros_left > 0:
                rb = TAB["RUN_BEFORE"][min(zeros_left, 7) * 15
                                       + min(prev - p - 1, 14)]
                put(19 + k - 1, rb & 0xFFFF, rb >> 16)
        if k >= t1:
            lc = 2 * (abs(lev) - 1) + (lev < 0)
            if k == t1 and t1 < 3:
                lc -= 2
            put(2 + k, *level_code(max(lc, 0), suffix))
            nxt = 1 if suffix == 0 else suffix
            if abs(lev) > 3 << (nxt - 1):
                nxt += 1
            suffix = min(nxt, 6)
        prev = p
        k += 1
    if 0 < total < max_coeff:
        tz = first + 1 - total
        t = (TAB["TOTAL_ZEROS_CDC"][min(total, 3) * 4 + min(tz, 3)] if nc < 0
             else TAB["TOTAL_ZEROS"][min(total, 15) * 16 + tz])
        put(18, t & 0xFFFF, t >> 16)
    return bits[0]


def median3(a, b, c):
    return max(min(max(a, b), c), min(a, b))


def emulate_k6(d, mbw, mbh, has_inter, flag, mutation=None):
    """K6's three passes in Python on `sym_inputs` arrays. `mutation`:
    "nc_across_band_top" (pass C reads the upper records of a band's first
    row from the slice before it), "carry_across_slices" (pass B carries
    its scans from one slice into the next) or "raster_luma" (luma units in
    raster order). Returns the plain version's dict as torch tensors."""
    sel, shape = d["sel"], d["shape"]
    n, nmb = sel.shape
    zz, scan = TAB["ZIGZAG"], TAB["BLOCK_SCAN"]
    qp_rows = d["qp_rows"]
    I32 = np.int32
    rec = np.zeros((n, nmb, 24), np.int64)
    skip = np.zeros((n, nmb), bool)
    cbp_o, cbpc_o = (np.zeros((n, nmb), I32) for _ in range(2))
    mvd_y, mvd_x = (np.zeros((n, nmb, 4), I32) for _ in range(2))

    def nb_block(i, r, c, dy, dx, stat):
        gy, gx = 4 * r + dy, 4 * c + dx
        avail = stat and 0 <= gy < 4 * mbh and 0 <= gx < 4 * mbw
        if avail:
            mb = (gy >> 2) * mbw + (gx >> 2)
            if sel[i, mb] == tmb.SEL_INTER:
                b = (gy & 3, gx & 3)
                return (int(d["mv4_y"][i, mb][b]), int(d["mv4_x"][i, mb][b]),
                        True, True)
        return 0, 0, False, avail

    def predict(i, r, c, s, p):
        spec, direc = SPECS[(s, p)]
        a, b, cc, dd = (list(nb_block(i, r, c, *x)) for x in spec)
        cav2 = cc[3] or dd[3]
        if not cc[3]:
            cc[:3] = dd[:3]
        if not b[3] and not cav2 and a[3]:
            b[:3] = a[:3]
            cc[:3] = a[:3]
        refs = [x for x in (a, b, cc) if x[2]]
        if len(refs) == 1:
            py, px = refs[0][:2]
        else:
            py = median3(a[0], b[0], cc[0])
            px = median3(a[1], b[1], cc[1])
        for name, x in (("A", a), ("B", b), ("C", cc)):
            if direc == name and x[2]:
                py, px = x[:2]
        return py, px

    # pass A: a warp per MB
    for i in range(n):
        for m in range(nmb):
            r, c = divmod(m, mbw)
            s = int(shape[i, m])
            is_inter = sel[i, m] == tmb.SEL_INTER
            is_i4 = sel[i, m] == tmb.SEL_I4
            # the MB's luma levels: lev_inter's if it is inter, else ac_lev's
            lev = d["lev_inter" if is_inter else "ac_lev"][i, m]
            n_l = (lev != 0).sum((-2, -1)).reshape(16)
            n_ca = (d["cac_lev"][i, m] != 0).sum((-2, -1)).reshape(8)
            cdc_any = bool((d["cdc_lev"][i, m] != 0).any())

            def cbp_bits(cnt):
                g = (cnt.reshape(2, 2, 2, 2) > 0).any((1, 3))
                return int(g[0, 0]) + 2 * g[0, 1] + 4 * g[1, 0] + 8 * g[1, 1]
            cbpl_i16 = not is_inter and bool(n_l.any())
            cbpc = 2 if n_ca.any() else 1 if cdc_any else 0
            cbp_luma = (cbp_bits(n_l) if is_i4 or is_inter
                        else 15 * cbpl_i16)
            cbp = cbp_luma + (cbpc << 4)
            sk = False
            if has_inter:
                if 0 <= s <= 3:
                    for p, (by, bx) in enumerate(PARTS[s]):   # lanes 0-3
                        py, px = predict(i, r, c, s, p)
                        mvd_y[i, m, p] = d["mv4_y"][i, m, by, bx] - py
                        mvd_x[i, m, p] = d["mv4_x"][i, m, by, bx] - px
                py, px = predict(i, r, c, 0, 0)                # lane 4
                a = nb_block(i, r, c, 0, -1, True)
                b = nb_block(i, r, c, -1, 0, True)
                force0 = (not a[3] or not b[3] or (a[2] and a[:2] == (0, 0))
                          or (b[2] and b[:2] == (0, 0)))
                sy, sx = (0, 0) if force0 else (py, px)
                sk = bool(is_inter and s == 0 and cbp == 0
                          and d["mv4_y"][i, m, 0, 0] == sy
                          and d["mv4_x"][i, m, 0, 0] == sx)
            skip[i, m], cbp_o[i, m], cbpc_o[i, m] = sk, cbp, cbpc
            luma = n_l if is_inter or is_i4 or cbpl_i16 else 0 * n_l
            rec[i, m, :16] = 0 if sk else luma
            rec[i, m, 16:] = n_ca if cbpc == 2 and not sk else 0

    # pass B: the slice scans, chunk by chunk with a carry
    scan_out = np.zeros((n, nmb, 2), np.int64)
    qp_dec = np.zeros((n, nmb), I32)
    tail_val, tail_len, total = (np.zeros(n, I32) for _ in range(3))
    seqs = ([[(i, m) for i in range(n) for m in range(nmb)]]
            if mutation == "carry_across_slices"
            else [[(i, m) for m in range(nmb)] for i in range(n)])
    for seq in seqs:
        carry_c = carry_d = -1
        for s0 in range(0, len(seq), SCAN_CHUNK):
            chunk = seq[s0:s0 + SCAN_CHUNK]
            run_c, run_d = carry_c, carry_d
            for j, (i, m) in enumerate(chunk):
                at = s0 + j                       # the index in the scan
                coded = not skip[i, m]
                dqp = coded and (sel[i, m] == tmb.SEL_I16 or cbp_o[i, m])
                exc_c, exc_d = run_c, run_d
                if coded:
                    run_c = at
                if dqp:
                    run_d = at
                delta = 0
                if qp_rows is not None:
                    def qp_at(k):
                        ii, mm = seq[k]
                        return int(qp_rows[ii, mm // mbw])
                    first = int(qp_rows[i, 0])
                    delta = qp_at(at) - (qp_at(exc_d) if exc_d >= 0
                                         else first)
                    qp_dec[i, m] = qp_at(run_d) if run_d >= 0 else first
                scan_out[i, m] = (at - 1 - exc_c if coded else 0, delta)
            carry_c, carry_d = run_c, run_d
        if mutation != "carry_across_slices":
            i = seq[0][0]
            trailing = nmb - 1 - carry_c
            if has_inter:
                tail_val[i] = ue(trailing)[0]
                tail_len[i] = ue(trailing)[1] if trailing > 0 else 0
    if mutation == "carry_across_slices":
        for i in range(n):
            coded = np.flatnonzero(~skip[i])
            trailing = nmb - 1 - (coded[-1] if len(coded) else -1)
            if has_inter:
                tail_val[i] = ue(int(trailing))[0]
                tail_len[i] = ue(int(trailing))[1] if trailing > 0 else 0
    total[:] = tail_len

    # pass C: a warp per MB, lane u codes unit u, lanes 0 and 28-31 the
    # header
    vals = np.zeros((n, nmb, 28, 34), np.int64)
    lens = np.zeros((n, nmb, 28, 34), np.int64)
    row_bits = np.zeros((n, mbh), I32)
    flat_rec = rec.reshape(n * nmb, 24)
    for i in range(n):
        for m in range(nmb):
            r, c = divmod(m, mbw)
            g = i * nmb + m
            has_left = c > 0
            has_top = r > 0 or (mutation == "nc_across_band_top" and g >= mbw)
            own = rec[i, m]
            left = flat_rec[g - 1] if has_left else np.zeros(24, np.int64)
            top = flat_rec[g - mbw] if has_top else np.zeros(24, np.int64)

            def block_nc(o, lf, tp, k, by, bx):
                la, ta = bx > 0 or has_left, by > 0 or has_top
                na = (o[by * k + bx - 1] if bx > 0 else lf[by * k + k - 1]
                      if la else 0)
                nb = (o[(by - 1) * k + bx] if by > 0 else tp[(k - 1) * k + bx]
                      if ta else 0)
                return ((na + nb + 1) >> 1 if la and ta else na if la else nb
                        if ta else 0)

            s_ = int(sel[i, m])
            is_inter, is_i16, is_i4 = (s_ == tmb.SEL_INTER,
                                       s_ == tmb.SEL_I16, s_ == tmb.SEL_I4)
            cbp, cbpc = int(cbp_o[i, m]), int(cbpc_o[i, m])
            coded = not skip[i, m]
            cbpl_i16 = (cbp & 15) != 0
            bits = 0
            for lane in range(32):
                if 1 <= lane < 28:
                    sv, sl = vals[i, m, lane], lens[i, m, lane]
                    max_coeff, nc = 16, -1
                    if lane == 1:
                        raw = d["dc_lev"][i, m].reshape(16)
                        lv = [int(raw[zz[j]]) for j in range(16)]
                        nc = block_nc(own, left, top, 4, 0, 0)
                        keep = is_i16
                    elif lane < 18:
                        b = (lane - 2 if mutation == "raster_luma"
                             else scan[lane - 2])
                        src = d["lev_inter"] if is_inter else d["ac_lev"]
                        raw = src[i, m].reshape(16, 16)[b]
                        if is_i16:
                            lv = [int(raw[zz[j + 1]]) for j in range(15)] + [0]
                            max_coeff = 15
                        else:
                            lv = [int(raw[zz[j]]) for j in range(16)]
                        nc = block_nc(own, left, top, 4, b >> 2, b & 3)
                        grp = (b >> 3) * 2 + ((b & 3) >> 1)
                        keep = (cbpl_i16 if is_i16 else coded and (
                            is_inter or is_i4) and (cbp >> grp) & 1)
                    elif lane < 20:
                        lv = [int(v) for v in d["cdc_lev"][i, m].reshape(
                            2, 4)[lane - 18]] + [0] * 12
                        max_coeff = 4
                        keep = cbpc >= 1 and coded
                    else:
                        k = lane - 20
                        raw = d["cac_lev"][i, m].reshape(8, 16)[k]
                        lv = [int(raw[zz[j + 1]]) for j in range(15)] + [0]
                        max_coeff = 15
                        off = 16 + (k & 4)
                        nc = block_nc(own[off:], left[off:], top[off:], 2,
                                      (k >> 1) & 1, k & 1)
                        keep = cbpc == 2 and coded
                    bits += code_block(lv, nc, max_coeff, bool(keep), sv, sl)
                    continue
                sv, sl = vals[i, m, 0], lens[i, m, 0]

                def put(slot, v, nb, keep):
                    sv[slot] = v
                    if keep:
                        sl[slot] = nb
                    return nb if keep else 0
                s = int(shape[i, m])
                if lane == 0:
                    run, delta = (int(x) for x in scan_out[i, m])
                    if has_inter:
                        bits += put(0, *ue(run), coded)
                    bits += put(1, 0, 1, flag and coded)
                    i16code = (1 + int(d["mode16"][i, m]) + 4 * cbpc
                               + 12 * cbpl_i16)
                    mb_type = ((s if is_inter else 5 if is_i4
                                else 5 + i16code) if has_inter
                               else 0 if is_i4 else i16code)
                    bits += put(2, *ue(mb_type), coded)
                    for j in range(4):
                        bits += put(3 + j, 1, 1,
                                    coded and is_inter and s == 3)
                    bits += put(31, *ue(int(d["cmode"][i, m])),
                                coded and not is_inter)
                    code = TAB["CBP_TO_CODENUM"][min(max(cbp, 0), 47) * 2
                                                 + (0 if is_i4 else 1)]
                    bits += put(32, *ue(code), coded and (is_inter or is_i4))
                    dqp = coded and (is_i16 or cbp != 0)
                    if qp_rows is not None:
                        bits += put(33, *se(delta), dqp)
                    else:
                        bits += put(33, 1, 1, dqp)
                else:
                    p = lane - 28
                    n_parts = len(PARTS[min(max(s, 0), 3)])
                    active = p < n_parts and coded and is_inter
                    bits += put(7 + 2 * p, *se(int(mvd_x[i, m, p])), active)
                    bits += put(8 + 2 * p, *se(int(mvd_y[i, m, p])), active)
                    for j in range(4):
                        q = 4 * p + j
                        bits += put(15 + q, int(d["i4sym_v"][i, m, q]),
                                    int(d["i4sym_l"][i, m, q]), is_i4)
            row_bits[i, r] += bits
            total[i] += bits
    t = torch.from_numpy
    out = dict(sym_vals=t(vals.reshape(n, nmb, 952).astype(I32)),
               sym_lens=t(lens.reshape(n, nmb, 952).astype(I32)),
               tail_val=t(tail_val), tail_len=t(tail_len),
               total_bits=t(total), row_bits=t(row_bits), skip=t(skip),
               cbp=t(cbp_o), cbpc=t(cbpc_o), mvd_py=t(mvd_y), mvd_px=t(mvd_x))
    if qp_rows is not None:
        out["qp_dec"] = t(qp_dec)
    return out


@pytest.mark.parametrize("c", CASES, ids=_ids)
def test_k6_schedule_equals_plain(c):
    d = case(c)
    _, _, mbw, mbh, has_inter, _, flag = c
    _same(plain(d, c), emulate_k6(d, mbw, mbh, has_inter, flag), _ids(c))


@pytest.mark.parametrize("mutation,c", [
    ("nc_across_band_top", CASES[3]),
    ("carry_across_slices", CASES[0]),
    ("raster_luma", CASES[2])])
def test_k6_schedule_mutations_fail(mutation, c):
    d = case(c)
    _, _, mbw, mbh, has_inter, _, flag = c
    want = plain(d, c)
    got = emulate_k6(d, mbw, mbh, has_inter, flag, mutation)
    assert any(not torch.equal(want[k], got[k]) for k in want), mutation


def test_k6_tables_come_from_the_port():
    """The tables that K6 includes are the port's, value | length << 16 for
    the VLC tables: the committed header is what `tables_header` writes,
    and `csrc/symbolize.cu` includes it."""
    def vlc(v, n):
        return (np.asarray(v).reshape(-1)
                | np.asarray(n).reshape(-1) << 16).tolist()
    tc = tables_cavlc
    assert TAB["ZIGZAG"] == tables.ZIGZAG_4x4.tolist()
    assert TAB["BLOCK_SCAN"] == tables.BLOCK_SCAN_4x4.tolist()
    assert TAB["CBP_TO_CODENUM"] == tables.CBP_TO_CODENUM.reshape(-1).tolist()
    assert TAB["COEFF_TOKEN"] == vlc(tc.COEFF_TOKEN_VAL, tc.COEFF_TOKEN_LEN)
    assert TAB["TOTAL_ZEROS"] == vlc(tc.TOTAL_ZEROS_VAL, tc.TOTAL_ZEROS_LEN)
    assert TAB["TOTAL_ZEROS_CDC"] == vlc(tc.TOTAL_ZEROS_CDC_VAL,
                                         tc.TOTAL_ZEROS_CDC_LEN)
    assert TAB["RUN_BEFORE"] == vlc(tc.RUN_BEFORE_VAL, tc.RUN_BEFORE_LEN)
    for name, want in (("SEL_INTER", tmb.SEL_INTER),
                       ("SEL_I16", tmb.SEL_I16), ("SEL_I4", tmb.SEL_I4)):
        assert f"#define K6_{name} {want}\n" in HEADER
    # the partitions' macros decode to mbscan's tables
    word = {k: int(re.search(
        rf"#define K6_{k}\([^)]*\) \(\(int\)\(\((0x[0-9a-f]+)u",
        HEADER).group(1), 16) for k in ("PART_BY", "PART_BX", "N_PARTS")}
    for s, blocks in tmb._PART_BLOCKS.items():
        assert (word["N_PARTS"] >> 3 * s) & 7 == tmb._N_PARTS[s]
        for p, (by, bx) in enumerate(blocks):
            assert (word["PART_BY"] >> 2 * (4 * s + p)) & 3 == by
            assert (word["PART_BX"] >> 2 * (4 * s + p)) & 3 == bx
    assert HEADER == k6.tables_header()
    assert '#include "symbolize_tables.h"' in k6.SRC.read_text()


def test_a_header_beside_a_source_is_in_its_digest(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text('#include "t.h"\n')
    (tmp_path / "t.h").write_text("#define T 1\n")
    first = cuda_build._target(src)
    (tmp_path / "t.h").write_text("#define T 2\n")
    assert cuda_build._target(src) != first
    assert first.parent == cuda_build.BUILD_DIR


def test_symbolize_args_pack_the_plain_arguments():
    c = CASES[0]
    d = case(c)
    _, n, mbw, mbh, has_inter, _, _ = c
    t = {k: torch.from_numpy(d[k]) for k in KEYS}
    args = tmb.symbolize_args(*(t[k] for k in KEYS), mbw, mbh, has_inter,
                              qp_rows=torch.from_numpy(d["qp_rows"]),
                              svc_base_mode_bit=True)
    for x, k in zip(args, KEYS):           # packed already: no copy
        assert x.data_ptr() == t[k].data_ptr() and x.dtype == torch.int32
    assert torch.equal(args[13], torch.from_numpy(d["qp_rows"]))
    assert args[14:] == (mbw, mbh, True, True)
    # other dtypes, shapes and layouts come back int32, contiguous,
    # 16-byte aligned, of the kernel's shapes
    odd = dict(t, sel=t["sel"].long(), ac_lev=t["ac_lev"].reshape(
        n, mbw * mbh, 16, 16).transpose(-1, -2).contiguous().transpose(
            -1, -2), shape=t["shape"].to(torch.int16),
        mv4_y=t["mv4_y"].reshape(n, -1, 16))
    args = tmb.symbolize_args(*(odd[k] for k in KEYS), mbw, mbh, 1,
                              qp_rows=d["qp_rows"].tolist())
    for x, k, (_, trail) in zip(args, KEYS, k6.INPUTS):
        assert x.dtype == torch.int32 and x.is_contiguous(), k
        assert x.data_ptr() % 16 == 0 and tuple(x.shape) == (
            n, mbw * mbh) + trail, k
        assert torch.equal(x, t[k]), k
    assert args[13].dtype == torch.int32
    assert args[14:] == (mbw, mbh, True, False)
    assert tmb.symbolize_args(*(t[k] for k in KEYS), mbw, mbh, False)[13] \
        is None


def test_cpu_tensors_never_reach_k6():
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
    assert LAUNCH_COUNTS == before and LAUNCH_COUNTS["symbolize"] == 0
    # the wrapper refuses CPU tensors
    c = CASES[0]
    d = case(c)
    args = tmb.symbolize_args(*(torch.from_numpy(d[k]) for k in KEYS),
                              c[2], c[3], c[4])
    with pytest.raises(ValueError, match="CUDA"):
        k6.symbolize_tiles(*args)
    assert LAUNCH_COUNTS == before
