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
`symbolize` takes one), one trace per case shape. SVC base-mode slices
(`base_mode=True`, on the levels of `sym_inputs`' P slices: MBs of cbp
0 among them) code every MB with their own header and an empty luma-DC
unit, and refuse the inputs they do not read; their residual units are
held against JAX's base-mode frame in `test_torch_svc.py`.

A CUDA kernel cannot run here, so `emulate_k6` does in Python what K6
does: pass A, a warp per MB, counts each block's nonzeros, derives cbp,
cbpc, the coded counts that nC reads (a 32-byte record per MB), the MV
predictors of the MB's partitions (lanes 0-3) and P_Skip's (lane 4);
pass B, a block per slice, gives each thread a run of consecutive MBs
and scans the runs' last coded and last dQP MBs over the threads (here 4
threads, so that runs hold several MBs and the scan carries across
them; the kernel's block has 1024) for the skip runs, the tail and the
running QP; pass C, a warp per MB, stages the
MB's levels as the kernel lays them out in shared memory, derives unit
u's descriptor on lane u (where its levels lie, its view of them, nC,
max_coeff, whether its lengths stand) from the MB's and its left and
upper neighbours' records, builds the header a slot a lane, and codes
the residual units two a step, a half-warp a unit and a lane a scan
position (`code_unit`): the ballot masks of the nonzero, +-1 and negative
levels, each coefficient's rank in reverse scan order, TrailingOnes and
their signs from the masks, run_before from the next nonzero below, and
suffixLength from an exclusive scan of the levels' transfer maps (8
nibbles, composed with the kernel's byte permutes) over the half-warp in
4 shuffle steps; every slot of the grid must be written exactly once.
The tables are the ones the kernel includes (`csrc/symbolize_tables.h`).
It equals the plain version on every case, base-mode slices included
(K6's two passes of that kind: no MV, no slice scans, the base-mode
header), and `code_unit` equals the port's `cavlc.encode_blocks` on
random blocks (hypothesis). Seven faults of the schedule each make it
fail: nC read across a band's top (from the slice before), the slice
scans' carry kept across a slice boundary, the luma units in raster
order, the suffixLength scan taken inclusive, TrailingOnes not capped at
3, a run_before written for the last coefficient, and a base-mode pass A
that keeps the P slices' P_Skip rule. Tolerance: exact equality (integer
arithmetic).
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from h264lab_tpu.models import mbscan as jmb
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.models.encoder import H264Encoder
from h264lab_tpu_torch.ops import cavlc, cuda_build, tables, tables_cavlc
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
# and every block coding all its positions (`sym_inputs(dense=True)`)
DENSE_CASES = [(109, 2, 11, 3, True, True, False, True),
               (110, 2, 4, 3, False, False, True, True)]
# base-mode slices (`symbolize(..., base_mode=True)`): (seed, slices,
# mb_width, mb_height, dense), their levels `sym_inputs`' of P slices, whose
# intra and quiet MBs have none (coded base-mode MBs of cbp 0)
BASE_MODE_CASES = [(111, 2, 4, 3, False), (112, 2, 6, 1, False),
                   (113, 2, 1, 6, False), (114, 3, 11, 3, False),
                   (115, 2, 4, 3, True)]
BASE_MODE_KEYS = ("lev_inter", "cdc_lev", "cac_lev")
SCAN_THREADS = 4                # pass B's threads in the emulation


def _ids(c):
    return (f"{c[1]}x{c[2]}x{c[3]}-{'P' if c[4] else 'I'}"
            + ("-plan" if c[5] else "") + ("-bm" if c[6] else "")
            + ("-dense" if c[7:] and c[7] else ""))


def case(c):
    seed, n, mbw, mbh, has_inter, plan, flag = c[:7]
    return sym_inputs(seed, n, mbw, mbh, has_inter, plan=plan,
                      dense=bool(c[7:] and c[7]))


def plain(d, c):
    _, _, mbw, mbh, has_inter, _, flag = c[:7]
    qp = d["qp_rows"]
    return tmb.symbolize_plain(
        *(torch.from_numpy(d[k]) for k in KEYS), mbw, mbh, has_inter,
        qp_rows=None if qp is None else torch.from_numpy(qp),
        svc_base_mode_bit=flag)


def _bm_ids(c):
    return f"{c[1]}x{c[2]}x{c[3]}" + ("-dense" if c[4] else "")


def bm_case(c):
    seed, n, mbw, mbh, dense = c
    return sym_inputs(seed, n, mbw, mbh, True, dense=dense)


def bm_plain(d, c):
    """`symbolize_plain` of base-mode slices on a case's levels."""
    return tmb.symbolize_plain(
        *(None,) * 10, *(torch.from_numpy(d[k]) for k in BASE_MODE_KEYS),
        c[2], c[3], False, base_mode=True)


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


@pytest.mark.parametrize("c", CASES + DENSE_CASES, ids=_ids)
def test_symbolize_plain_equals_jax(c):
    d = case(c)
    got = plain(d, c)
    _, n, mbw, mbh, has_inter, plan, flag = c[:7]
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


def test_dense_sym_inputs_code_every_position():
    """The dense cases: every block codes all its positions, no MB is
    skipped, levels take both escapes, and suffixLength reaches 6."""
    for c in DENSE_CASES:
        d, out = case(c), plain(case(c), c)
        _, n, mbw, mbh, has_inter, _, _ = c[:7]
        sel = d["sel"]
        inter, i16 = sel == tmb.SEL_INTER, sel == tmb.SEL_I16
        luma = np.where(inter[..., None, None, None, None], d["lev_inter"],
                        d["ac_lev"]).reshape(n, -1, 16, 16)
        nz = (luma != 0).sum(-1)
        assert (nz[i16] == 15).all() and (nz[~i16] == 16).all()
        assert (d["dc_lev"][i16] != 0).all() and (d["cdc_lev"] != 0).all()
        assert ((d["cac_lev"] != 0).sum((-2, -1)) == 15).all()
        assert not out["skip"].any()
        lens = out["sym_lens"].numpy().reshape(n, -1, 28, 34)
        vals = out["sym_vals"].numpy().reshape(n, -1, 28, 34)
        assert (lens == 28).any() and (lens == 30).any()
        # a level coded at suffixLength 6: 1 << 6 | suffix, 7 to 21 bits
        lv, vv = lens[..., 2:18], vals[..., 2:18]
        assert ((lv >= 7) & (lv <= 21) & (vv >> 6 == 1)).any()


@pytest.mark.parametrize("c", BASE_MODE_CASES, ids=_bm_ids)
def test_base_mode_slices(c):
    """A base-mode slice codes every MB, those of cbp 0 too: unit 0 is
    base_mode_flag `1`, the coded_block_pattern (the inter column) and
    se(0) where the cbp is not 0, every other slot 0; unit 1 is empty,
    values too; no tail; `total_bits` the sum of the lengths. (Its
    residual units are held against the JAX package's base-mode frame in
    `test_torch_svc.py`.)"""
    d = bm_case(c)
    _, n, mbw, mbh, _ = c
    got = bm_plain(d, c)
    cbp = got["cbp"]
    assert (cbp != 0).any() and (cbp == 0).any() != c[4]   # dense: none
    assert not got["skip"].any() and not got["tail_len"].any()
    assert not got["tail_val"].any()
    vals = got["sym_vals"].reshape(n, -1, 28, 34)
    lens = got["sym_lens"].reshape(n, -1, 28, 34)
    code = torch.as_tensor(tables.CBP_TO_CODENUM)[cbp.long(), 1]
    bits = torch.floor(torch.log2(code.double() + 1)).long()
    assert torch.equal(vals[..., 0, 0], torch.ones_like(cbp))
    assert torch.equal(lens[..., 0, 0], torch.ones_like(cbp))
    assert torch.equal(vals[..., 0, 1], (code + 1).int())
    assert torch.equal(lens[..., 0, 1], (2 * bits + 1).int())
    assert torch.equal(vals[..., 0, 2], torch.ones_like(cbp))
    assert torch.equal(lens[..., 0, 2], (cbp != 0).int())
    assert not vals[..., 0, 3:].any() and not lens[..., 0, 3:].any()
    assert not vals[..., 1, :].any() and not lens[..., 1, :].any()
    assert torch.equal(got["total_bits"], got["sym_lens"].sum(
        (1, 2), dtype=torch.int32))


def test_base_mode_slices_take_their_own_inputs():
    c = BASE_MODE_CASES[0]
    d = bm_case(c)
    levels = [torch.from_numpy(d[k]) for k in BASE_MODE_KEYS]
    for i, k in enumerate(KEYS[:10]):
        given = [None] * 10
        given[i] = torch.from_numpy(d[k])
        with pytest.raises(ValueError, match=k):
            tmb.symbolize(*given, *levels, c[2], c[3], False,
                          base_mode=True)
    for kw in (dict(qp_rows=torch.zeros((c[1], c[3]), dtype=torch.int32)),
               dict(svc_base_mode_bit=True)):
        with pytest.raises(ValueError):
            tmb.symbolize(*(None,) * 10, *levels, c[2], c[3], False,
                          base_mode=True, **kw)
    with pytest.raises(ValueError):
        tmb.symbolize(*(None,) * 10, *levels, c[2], c[3], True,
                      base_mode=True)


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
    """The kernel's `level_code`: level_prefix lc >> sl and sl suffix
    bits, but at suffixLength 0 level_prefix 14 from levelCode 14, and the
    two escapes from the escape's start."""
    rem = lc - ((15 << sl) + (15 if sl == 0 else 0))
    if rem >= 4096:
        return (1 << 13) | (rem - 4096), 30
    if rem >= 0:
        return (1 << 12) | rem, 28
    if sl == 0 and lc >= 14:
        return 16 | (lc - 14), 19
    return (1 << sl) | (lc & ((1 << sl) - 1)), (lc >> sl) + 1 + sl


MAP_IDENTITY = 0x76543210       # suffixLength's transfer maps, 8 nibbles
MAP_FLOOR = 0x76543211          # s -> max(s, 1)
FULL16 = 0xFFFF


def popc(x):
    return bin(x).count("1")


def clz(x):
    return 32 - x.bit_length()


def ctx_of(nc):
    """coeff_token's table of nC (4: chroma DC, nC -1)."""
    return 4 if nc < 0 else 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 \
        else 3


def level_map(al):
    """The kernel's `level_map`: the transfer map of a level of magnitude
    al, nibble s the suffixLength after it at suffixLength s; k, the
    thresholds al passes, is the bit length of (al - 1) / 3, the quotient
    taken as the kernel's high half of (al - 1) * 0x55555556."""
    k = min((((al - 1) * 0x55555556) >> 32).bit_length(), 5)
    return MAP_FLOOR + ((0x111111 >> (4 * (5 - k))) if k else 0)


def byte_perm(x, y, sel):
    """`__byte_perm` (PRMT): byte n of the result is byte (sel's nibble n)
    of the 8 bytes of y:x; the selectors used never set a nibble's top
    bit."""
    pool = x | y << 32
    out = 0
    for n in range(4):
        k = (sel >> (4 * n)) & 15
        assert k < 8, hex(sel)
        out |= ((pool >> (8 * k)) & 0xFF) << (8 * n)
    return out


def map_bytes(w):
    """The kernel's `map_bytes`: a map's nibbles spread to 8 bytes."""
    even, odd = w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F
    return byte_perm(even, odd, 0x5140), byte_perm(even, odd, 0x7362)


def compose(lo, hi, f):
    """The kernel's `compose`: g after f, g as the bytes (lo, hi), f as
    nibbles; returns the result as nibbles and as bytes."""
    r0, r1 = byte_perm(lo, hi, f & 0xFFFF), byte_perm(lo, hi, f >> 16)
    return byte_perm(r0, r1, 0x6420) | (byte_perm(r0, r1, 0x7531) << 4), \
        r0, r1


def code_unit(lv, nc, max_coeff, keep, mutation=None):
    """One half-warp of pass C coding one 4x4 block as the kernel does:
    lv the 16 lanes' levels, lane i at scan position i (0 past
    max_coeff), nc its nC (-1 for chroma DC, which also takes the chroma
    DC total_zeros table). Returns [(slot, value, length)], the writes of
    the 16 lanes in lane order, lengths 0 unless `keep`. `mutation`:
    "inclusive_suffix" (each level's suffixLength from the scan including
    its own map), "t1_uncapped" (TrailingOnes not capped at 3) or
    "run_for_last" (a run_before for the last coefficient too)."""
    nz = sum(1 << i for i in range(16) if lv[i])
    big = sum(1 << i for i in range(16) if abs(lv[i]) > 1)
    total = popc(nz)
    rank = [popc(nz >> (i + 1)) for i in range(16)]
    t1 = popc(nz >> (32 - clz(big)))
    if mutation != "t1_uncapped":
        t1 = min(t1, 3)
    # the trailing ones' signs, the first highest: an OR over the lanes
    signs = 0
    for i in range(16):
        if lv[i] and rank[i] < t1:
            signs |= (lv[i] < 0) << (t1 - 1 - rank[i])
    lvl = [bool(lv[i]) and rank[i] >= t1 for i in range(16)]
    # suffixLength: the exclusive scan of the transfer maps from lane 15
    # down, in 4 steps of __shfl_down_sync(.., d, 16); the kernel skips it
    # when no half-warp has two levels past its trailing ones, where it
    # leaves every level at s0, as the scan does
    s0 = int(total > 10 and t1 < 3)
    x = [level_map(abs(lv[i])) if lvl[i] else MAP_IDENTITY
         for i in range(16)]
    b = [map_bytes(w) for w in x]
    for d in (1, 2, 4, 8):
        step = [compose(*b[i], x[i + d] if i + d < 16 else MAP_IDENTITY)
                for i in range(16)]
        x, b = [c[0] for c in step], [c[1:] for c in step]
    e = (x if mutation == "inclusive_suffix"
         else x[1:] + [MAP_IDENTITY])
    ctx = ctx_of(nc)
    tz = 32 - clz(nz) - total
    writes = []

    def put(slot, v, n):
        writes.append((slot, v, n if keep else 0))

    for i in range(16):
        l, r = lv[i], rank[i]
        lc = max(2 * (abs(l) - 1) + (l < 0) - (2 if r == t1 and t1 < 3
                                                 else 0), 0)
        sl = (e[i] >> (4 * s0)) & 15
        v, n = level_code(lc, sl)
        zl = i - (total - 1 - r)
        nxt = 31 - clz(nz & ((1 << i) - 1))
        has_run = bool(l) and (r < total if mutation == "run_for_last"
                               else r < total - 1)
        rb = 0
        if has_run and zl > 0:
            rb = TAB["RUN_BEFORE"][min(zl, 7) * 15 + min(i - nxt - 1, 14)]
        tab = 0
        if i == 0:
            tab = TAB["COEFF_TOKEN"][(ctx * 17 + total) * 4 + t1]
        elif i == 2 and 0 < total < max_coeff:
            tab = (TAB["TOTAL_ZEROS_CDC"][total * 4 + tz] if nc < 0
                   else TAB["TOTAL_ZEROS"][total * 16 + tz])
        # one level slot and one run_before slot a lane: a coefficient
        # its rank's, the zero lanes the level slots past TotalCoeff and
        # the lanes without a run the run_before slots past the runs, in
        # turn from position 15 down (the last of them none)
        t0 = max(total - 1, 0)
        lslot = 2 + (r if l else total + 15 - i - r)
        rslot = 19 + r if has_run else 19 + t0 + 15 - i - min(r, t0)
        put(lslot, v if lvl[i] else 0, n if lvl[i] else 0)
        if rslot < 34:
            put(rslot, rb & 0xFFFF, rb >> 16)
        if i == 1:
            put(1, signs, t1)
        elif i < 3:
            put(0 if i == 0 else 18, tab & 0xFFFF, tab >> 16)
    return writes


def code_block_once(lv, nc, max_coeff, mutation=None):
    """`code_unit`'s 34 slots of one block, lengths kept, and whether each
    was written exactly once."""
    vals, lens, count = [0] * 34, [0] * 34, [0] * 35
    for slot, v, n in code_unit(lv, nc, max_coeff, True, mutation):
        count[min(slot, 34)] += 1
        if slot < 34:
            vals[slot], lens[slot] = v, n
    return vals, lens, count[:34] == [1] * 34 and count[34] == 0


def median3(a, b, c):
    return max(min(max(a, b), c), min(a, b))


def emulate_k6(d, mbw, mbh, has_inter, flag, mutation=None,
               base_mode=False):
    """K6's three passes in Python on `sym_inputs` arrays; with
    `base_mode`, its two of a base-mode slice (passes A and C as the
    kernel instantiates them for that kind, on lev_inter, cdc_lev and
    cac_lev only: every MB inter and coded, no MV, no slice scans, the
    base-mode header and an empty luma-DC unit). `mutation`:
    "nc_across_band_top" (pass C reads the upper records of a band's first
    row from the slice before it), "carry_across_slices" (pass B carries
    its scans from one slice into the next), "raster_luma" (luma units in
    raster order), "p_skip_on" (a base-mode slice's pass A keeps the P
    slices' P_Skip rule), or one of `code_unit`'s. Returns the plain
    version's dict as torch tensors, and whether pass C wrote every slot
    of the grid exactly once."""
    if base_mode:
        z = np.zeros_like
        d = dict(d, sel=z(d["sel"]), mode16=z(d["mode16"]),
                 cmode=z(d["cmode"]), shape=z(d["shape"]),
                 i4sym_v=z(d["i4sym_v"]), i4sym_l=z(d["i4sym_l"]),
                 mv4_y=z(d["mv4_y"]), mv4_x=z(d["mv4_x"]),
                 dc_lev=z(d["dc_lev"]), ac_lev=z(d["ac_lev"]), qp_rows=None)
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
            if has_inter or mutation == "p_skip_on":
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

    # pass B: the slice scans, a block per slice, each thread a run of
    # consecutive MBs; one exclusive max-scan over the threads of each
    # run's last coded and last dQP MB starts each run's walk
    scan_out = np.zeros((n, nmb, 2), np.int64)
    qp_dec = np.zeros((n, nmb), I32)
    tail_val, tail_len, total = (np.zeros(n, I32) for _ in range(3))
    seqs = ([] if base_mode     # no pass B: the counts and tails 0
            else [[(i, m) for i in range(n) for m in range(nmb)]]
            if mutation == "carry_across_slices"
            else [[(i, m) for m in range(nmb)] for i in range(n)])
    for seq in seqs:
        per = -(-len(seq) // SCAN_THREADS)
        runs = [range(min(k * per, len(seq)), min(k * per + per, len(seq)))
                for k in range(SCAN_THREADS)]

        def coded_dqp(at):
            i, m = seq[at]
            coded = not skip[i, m]
            return coded, coded and bool(sel[i, m] == tmb.SEL_I16
                                         or cbp_o[i, m])
        last = [(max([at for at in run if coded_dqp(at)[0]], default=-1),
                 max([at for at in run if coded_dqp(at)[1]], default=-1))
                for run in runs]
        for k, run in enumerate(runs):
            run_c = max([c for c, _ in last[:k]], default=-1)
            run_d = max([d for _, d in last[:k]], default=-1)
            for at in run:
                i, m = seq[at]
                coded, dqp = coded_dqp(at)
                delta = 0
                if qp_rows is not None:
                    def qp_at(k):
                        ii, mm = seq[k]
                        return int(qp_rows[ii, mm // mbw])
                    first = int(qp_rows[i, 0])
                    prev = qp_at(run_d) if run_d >= 0 else first
                    delta = qp_at(at) - prev
                    qp_dec[i, m] = qp_at(at) if dqp else prev
                scan_out[i, m] = (at - 1 - run_c if coded else 0, delta)
                run_c = at if coded else run_c
                run_d = at if dqp else run_d
        if mutation != "carry_across_slices":
            i = seq[0][0]
            trailing = nmb - 1 - max(c for c, _ in last)
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

    # pass C: a warp per MB; the levels as the kernel lays them out in
    # shared memory, the units' descriptors, the header a slot a lane, then
    # the residual units two a step, a half-warp a unit
    vals = np.zeros((n, nmb, 28, 34), np.int64)
    lens = np.zeros((n, nmb, 28, 34), np.int64)
    count = np.zeros((n, nmb, 28, 34), np.int64)
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
            levs = np.concatenate([
                d["lev_inter" if is_inter else "ac_lev"][i, m].reshape(256),
                d["cac_lev"][i, m].reshape(128), d["dc_lev"][i, m].reshape(16),
                d["cdc_lev"][i, m].reshape(8)]).astype(np.int64)
            # lane u's descriptor of unit u: (levels at, view, nC, keep,
            # max_coeff)
            desc = [None]
            desc.append((384, 0, block_nc(own, left, top, 4, 0, 0), is_i16,
                         16))
            for j in range(16):
                b = j if mutation == "raster_luma" else scan[j]
                grp = (b >> 3) * 2 + ((b & 3) >> 1)
                keep = (cbpl_i16 if is_i16 else coded and (
                    is_inter or is_i4) and bool((cbp >> grp) & 1))
                desc.append((16 * b, int(is_i16), block_nc(
                    own, left, top, 4, b >> 2, b & 3), keep,
                    15 if is_i16 else 16))
            for k in range(2):
                desc.append((400 + 4 * k, 2, -1, cbpc >= 1 and coded, 4))
            for k in range(8):
                off = 16 + (k & 4)
                desc.append((256 + 16 * k, 1, block_nc(
                    own[off:], left[off:], top[off:], 2, (k >> 1) & 1, k & 1),
                    cbpc == 2 and coded, 15))
            bits = 0
            # the header, a slot a lane
            sh = int(shape[i, m])
            run, delta = (int(x) for x in scan_out[i, m])
            i16code = 1 + int(d["mode16"][i, m]) + 4 * cbpc + 12 * cbpl_i16
            mb_type = ((sh if is_inter else 5 if is_i4 else 5 + i16code)
                       if has_inter else 0 if is_i4 else i16code)
            n_parts = len(PARTS[min(max(sh, 0), 3)])
            code = TAB["CBP_TO_CODENUM"][min(max(cbp, 0), 47) * 2
                                         + (0 if is_i4 else 1)]
            dqp = coded and (is_i16 or cbp != 0)
            for slot in range(34):
                p = (slot - 7) >> 1
                if base_mode:
                    # base_mode_flag, coded_block_pattern, mb_qp_delta
                    v, nb = ((1, 1) if slot == 0 else ue(code) if slot == 1
                             else (1, 1) if slot == 2 else (0, 0))
                    keep = slot != 2 or cbp != 0
                elif slot == 0:
                    v, nb = ue(run) if has_inter else (0, 0)
                    keep = has_inter and coded
                elif slot == 1:
                    v, nb, keep = 0, 1, flag and coded
                elif slot == 2:
                    (v, nb), keep = ue(mb_type), coded
                elif slot < 7:
                    v, nb, keep = 1, 1, coded and is_inter and sh == 3
                elif slot < 15:
                    mv = (mvd_x if slot & 1 else mvd_y)[i, m, p]
                    (v, nb), keep = se(int(mv)), (p < n_parts and coded
                                                  and is_inter)
                elif slot < 31:
                    v = int(d["i4sym_v"][i, m, slot - 15])
                    nb = int(d["i4sym_l"][i, m, slot - 15])
                    keep = is_i4
                elif slot == 31:
                    (v, nb) = ue(int(d["cmode"][i, m]))
                    keep = coded and not is_inter
                elif slot == 32:
                    (v, nb), keep = ue(code), coded and (is_inter or is_i4)
                else:
                    v, nb = se(delta) if qp_rows is not None else (1, 1)
                    keep = dqp
                vals[i, m, 0, slot], lens[i, m, 0, slot] = v, nb if keep else 0
                count[i, m, 0, slot] += 1
                bits += nb if keep else 0
            # the residual units: half-warp h codes unit 2t + h
            zz1 = [zz[min(j + 1, 15)] for j in range(16)]
            for t in range(14):
                lanes = []
                for h in range(2):        # each half's levels by its view
                    at, view = desc[max(2 * t + h, 1)][:2]
                    lanes.append([int(levs[at + (
                        zz[j] if view == 0 else zz1[j] if view == 1 else j)])
                        if view == 0 or (j < 15 if view == 1 else j < 4)
                        else 0 for j in range(16)])
                for h in range(2):
                    u = 2 * t + h
                    if u == 0:
                        continue
                    at, view, nc, keep, max_coeff = desc[u]
                    lv = lanes[h]
                    if not any(lanes[0] + lanes[1]):
                        # both blocks empty: the coeff_token of
                        # TotalCoeff 0 on lane 0, every other slot 0
                        ct = TAB["COEFF_TOKEN"][ctx_of(nc) * 68]
                        if base_mode and u == 1:   # luma DC, values too
                            ct = 0
                        writes = [(0, ct & 0xFFFF, ct >> 16 if keep else 0)]
                        writes += [(j, 0, 0) for j in range(1, 34)]
                    else:
                        writes = code_unit(lv, nc, max_coeff, bool(keep),
                                           mutation)
                    for slot, v, nb in writes:
                        if slot < 34:
                            vals[i, m, u, slot], lens[i, m, u, slot] = v, nb
                            count[i, m, u, slot] += 1
                        else:                 # past the unit
                            count[i, m, u, 33] += 1
                        bits += nb
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
    return out, bool((count == 1).all())


@pytest.mark.parametrize("c", CASES + DENSE_CASES, ids=_ids)
def test_k6_schedule_equals_plain(c):
    d = case(c)
    _, _, mbw, mbh, has_inter, _, flag = c[:7]
    got, once = emulate_k6(d, mbw, mbh, has_inter, flag)
    assert once, "a slot of the grid not written exactly once"
    _same(plain(d, c), got, _ids(c))


@pytest.mark.parametrize("mutation,c", [
    ("nc_across_band_top", CASES[3]),
    ("carry_across_slices", CASES[0]),
    ("raster_luma", CASES[2]),
    ("inclusive_suffix", CASES[0]),
    ("t1_uncapped", CASES[1]),
    ("run_for_last", CASES[4])])
def test_k6_schedule_mutations_fail(mutation, c):
    d = case(c)
    _, _, mbw, mbh, has_inter, _, flag = c
    want = plain(d, c)
    got, once = emulate_k6(d, mbw, mbh, has_inter, flag, mutation)
    assert not once or any(not torch.equal(want[k], got[k])
                           for k in want), mutation


@pytest.mark.parametrize("c", BASE_MODE_CASES, ids=_bm_ids)
def test_k6_base_mode_schedule_equals_plain(c):
    d = bm_case(c)
    got, once = emulate_k6(d, c[2], c[3], False, False, base_mode=True)
    assert once, "a slot of the grid not written exactly once"
    _same(bm_plain(d, c), got, _bm_ids(c))


def test_k6_base_mode_schedule_without_its_skip_rule_fails():
    """A base-mode pass A that keeps the P slices' P_Skip rule skips the
    MBs of cbp 0 (their MV, 0, is the predicted one)."""
    c = BASE_MODE_CASES[0]
    d = bm_case(c)
    want = bm_plain(d, c)
    got, once = emulate_k6(d, c[2], c[3], False, False, "p_skip_on",
                           base_mode=True)
    assert got["skip"].any()
    assert not once or any(not torch.equal(want[k], got[k]) for k in want)


def test_k6_suffix_maps_follow_the_recurrence():
    """`level_map` is `encode_blocks`' suffixLength step at every state
    and magnitude, and `compose` with its byte permutes is the composition
    of maps on random maps of states 0-7."""
    for al in list(range(1, 200)) + [383, 384, 385, 767, 768, 769, 3000,
                                     2 ** 20, 2 ** 31 - 1]:
        w = level_map(al)
        for s in range(7):
            nxt = 1 if s == 0 else s
            want = min(nxt + (al > 3 << (nxt - 1)), 6)
            assert (w >> 4 * s) & 15 == want, (al, s)
    rng = np.random.default_rng(19)
    for _ in range(500):
        f, g = (rng.integers(0, 8, 8) for _ in range(2))
        word = [sum(int(x[s]) << 4 * s for s in range(8)) for x in (f, g)]
        got = compose(*map_bytes(word[1]), word[0])[0]
        assert [(got >> 4 * s) & 15 for s in range(8)] == [
            int(g[f[s]]) for s in range(8)]
    assert compose(*map_bytes(MAP_IDENTITY), 0x12345670)[0] == 0x12345670
    assert compose(*map_bytes(0x12345670), MAP_IDENTITY)[0] == 0x12345670


LEVELS = st.one_of(st.sampled_from([-1, 1]), st.integers(-3, 3),
                   st.integers(-60, 60), st.integers(-3000, 3000),
                   st.sampled_from([-3000, -2063, -2048, 2047, 2064, 3000]))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.data())
def test_k6_block_coder_equals_encode_blocks(data):
    """The kernel's half-warp block coder (`code_unit`) against the port's
    `cavlc.encode_blocks` on random blocks: nC -1 (chroma DC, max_coeff
    4) or 0 to 16 with max_coeff 15 or 16, any number of nonzeros, levels
    into both escapes of the level code; every slot written once."""
    max_coeff = data.draw(st.sampled_from([4, 15, 16]))
    nc = -1 if max_coeff == 4 else data.draw(st.integers(0, 16))
    on = data.draw(st.lists(st.booleans(), min_size=max_coeff,
                            max_size=max_coeff))
    lv = [data.draw(LEVELS) if x else 0 for x in on] + [0] * (16 - max_coeff)
    vals, lens, once = code_block_once(lv, nc, max_coeff)
    want_v, want_l, _ = cavlc.encode_blocks(
        torch.tensor([lv]), torch.tensor([nc]), max_coeff)
    assert once
    assert vals == (want_v[0].long() & 0xFFFFFFFF).tolist()
    assert lens == want_l[0].tolist()


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


def test_a_cached_build_keeps_its_compiler_log(tmp_path, monkeypatch):
    """`cuda_build.build_all` keeps each build's compiler log (ptxas's
    registers, shared memory and stack) beside its library and returns it
    again when the library is cached."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\necho "ptxas info    : Used 40 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    (path, log), = cuda_build.build_all([src])
    assert path.exists() and "Used 40 registers" in log
    assert cuda_build.build_all([src]) == [(path, log)]


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
    assert args[14:] == (mbw, mbh, True, True, False)
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
    assert args[14:] == (mbw, mbh, True, False, False)
    assert tmb.symbolize_args(*(t[k] for k in KEYS), mbw, mbh, False)[13] \
        is None


@pytest.mark.parametrize("plan", [False, True])
def test_k6_buffer_holds_the_plain_outputs(plan):
    """The wrapper's one buffer (`symbolize._plan`,
    `cuda_build.buffer_views`): every output
    of the plain version with its dtype and shape, and the scratch, each
    on a 16-byte boundary, none overlapping, the entry point's pointers at
    their offsets; worked out once per size."""
    c = CASES[0] if plan else CASES[1]
    want = plain(case(c), c)
    n, nmb, mbh = c[1], c[2] * c[3], c[3]
    shapes, nbytes, views, offsets = k6._plan(n, nmb, mbh, plan)
    assert k6._plan(n, nmb, mbh, plan)[2] is views
    assert [tuple(x) for x in shapes] == [(n, nmb) + t for _, t in k6.INPUTS] \
        + ([(n, mbh)] if plan else [])
    buf = torch.zeros(nbytes, dtype=torch.uint8)
    out = k6.cuda_build.buffer_views(buf, views)
    assert set(out) == set(want) | {"scratch"}
    spans = []
    for name, x in out.items():
        if name != "scratch":
            assert x.dtype == want[name].dtype and x.shape == want[name].shape
        assert x.is_contiguous()
        start = x.data_ptr() - buf.data_ptr()
        assert start % 16 == 0, name
        spans.append((start, start + x.numel() * x.element_size()))
        if name in k6._OUTPUT_ARGS:
            assert offsets[k6._OUTPUT_ARGS.index(name)] == start, name
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= nbytes
    assert (offsets[k6._OUTPUT_ARGS.index("qp_dec")] is None) == (not plan)
    # every output is written through its view
    for x in out.values():
        x.fill_(1)
    assert int(buf.sum()) == sum(x.numel() * x.element_size()
                                 for x in out.values()) - 3 * sum(
        x.numel() for x in out.values() if x.dtype == torch.int32)


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
