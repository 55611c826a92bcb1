"""The motion search's kernels K4 and K5 (`csrc/me.cu`), their schedule
emulated on the CPU.

A CUDA kernel cannot run here, so `emulate_k4` and `emulate_k5` do in
torch what each kernel does per MB: every candidate position's cost
computed on its own, the winner taken as the least of signed (cost,
raster index) keys (`key_min`), windows read at starts clamped into the
plane as `qpel.windows` clamps them (the coarse band window per dy), the
half-pel planes from the re-centred window by the kernel's formulas, and
each quarter-pel sample as the rounded mean of the two plane samples of
the kernel's phase table (`PHASES`). The emulations are held against the
port's plain `motion_search_dense` / `partition_search` (through
`motion_search_plain` / `partition_plain`, which take the kernels'
arguments) and against JAX's (`h264lab_tpu/ops/me.py`) on
`utils.synthetic.me_inputs` cases: flat and
chessboard MBs (ties everywhere), shifted noise, half-pel matches,
unmatched patches, previous MVs past the +-52 clip, bands at a row
offset, QPs 0, 12, 33 and 51, the sub-pel stage on and off; one case
reaches a negative quarter-pel cost (the skip bias), one reads planes
whose guard is cut so that the window starts are clamped, one ties two
candidate centres. JAX runs each
search once per case (one trace per shape). Tolerance: exact equality
(integer arithmetic).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264lab_tpu.ops import me as jme
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.models.encoder import H264Encoder
from h264lab_tpu_torch.ops import me as tme
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
from h264lab_tpu_torch.parallel.gop import GopBandEncoder
from h264lab_tpu_torch.utils.synthetic import chessboard_sequence, me_inputs

G, G4 = 64, 16
TAPS = (1, -5, 20, 20, -5, 1)
F, B, H, J = range(4)
# K4's and K5's phase table: (fy, fx) -> the two planes and their (row,
# column) shifts whose rounded mean is the quarter-pel sample
PHASES = {
    (0, 0): (F, 0, 0, F, 0, 0), (0, 1): (F, 0, 0, B, 0, 0),
    (0, 2): (B, 0, 0, B, 0, 0), (0, 3): (B, 0, 0, F, 0, 1),
    (1, 0): (F, 0, 0, H, 0, 0), (1, 1): (B, 0, 0, H, 0, 0),
    (1, 2): (B, 0, 0, J, 0, 0), (1, 3): (B, 0, 0, H, 0, 1),
    (2, 0): (H, 0, 0, H, 0, 0), (2, 1): (H, 0, 0, J, 0, 0),
    (2, 2): (J, 0, 0, J, 0, 0), (2, 3): (J, 0, 0, H, 0, 1),
    (3, 0): (H, 0, 0, F, 1, 0), (3, 1): (H, 0, 0, B, 1, 0),
    (3, 2): (J, 0, 0, B, 1, 0), (3, 3): (H, 0, 1, B, 1, 0),
}
GEOMETRIES = (("16x8", ((0, 0), (8, 0)), 8, 16),
              ("8x16", ((0, 0), (0, 8)), 16, 8),
              ("8x8", ((0, 0), (0, 8), (8, 0), (8, 8)), 8, 8))
# (seed, frames, mb_width, mb_height, qp, lanes, frame rows, sub-pel); JAX
# checks the 4 x 3 band cases (one shape, so one trace per search)
CASES = [
    (61, 3, 4, 3, 33, 2, 5, True),
    (62, 3, 4, 3, 0, 2, 5, True),
    (63, 3, 4, 3, 12, 2, 5, False),
    (64, 3, 4, 3, 51, 2, 5, True),
    (65, 2, 6, 1, 33, 1, 2, True),          # one MB high
    (66, 2, 1, 6, 20, 2, 8, False),         # one MB wide, banded
]
JAX_CASES = [c for c in CASES if c[2:4] == (4, 3)]
ME_ARGS = ("y_pad", "y4_pad", "cur_tiles", "lane", "row_offset", "qp",
           "prev_my", "prev_mx")


def _ids(c):
    return (f"{c[1]}x{c[2]}x{c[3]}-qp{c[4]}-rows{c[6]}"
            + ("" if c[7] else "-fullpel"))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def bits(v):
    """Exp-Golomb bits of se(v), 2 bitlen(code) - 1, the bit length from
    the float exponent (exact for these integers) as the kernel takes it
    from clz."""
    code = torch.where(v > 0, 2 * v - 1, -2 * v) + 1
    return 2 * torch.frexp(code.double()).exponent.long() - 1


def key_min(costs):
    """The least of signed (cost, raster index) keys over positions:
    costs (K, P) -> (index, cost), each (K,)."""
    keys = costs.long() * 2**32 + torch.arange(costs.shape[1])
    best = keys.min(dim=1).values
    idx = best & 0xFFFFFFFF
    return idx, (best - idx) // 2**32


def at(img, y, x, h, w):
    """(K, h, w) blocks of per-MB images img (K, H, W) at (y, x) (K,)."""
    k = torch.arange(img.shape[0])[:, None, None]
    return img[k, (y[:, None] + torch.arange(h))[:, :, None],
               (x[:, None] + torch.arange(w))[:, None, :]]


def clamp(v, lo, hi):
    return torch.clamp(v, lo, hi)


def predictor(q4, n, mbw, mbh):
    """The kernel's per-MB predictor from the coarse field q4 (K,)."""
    q = (16 * q4).reshape(n, mbh, mbw)
    out = torch.zeros_like(q)
    for r in range(mbh):
        for c in range(mbw):
            left = q[:, r, c - 1] if c > 0 else torch.zeros(n, dtype=q.dtype)
            if r == 0:
                out[:, r, c] = left
                continue
            top = q[:, r - 1, c]
            if c == mbw - 1:
                tr = q[:, r - 1, c - 1] if c > 0 else torch.zeros_like(top)
            else:
                tr = q[:, r - 1, c + 1]
            out[:, r, c] = torch.maximum(
                torch.minimum(torch.maximum(left, top), tr),
                torch.minimum(left, top))
    return out.reshape(-1)


def phase_block(planes, dyq, dxq, y, x, h, w):
    """(K, h, w) quarter-pel samples of phase (dyq & 3, dxq & 3) from the
    (K, 4, 22, 22) planes at plane coordinates (y, x) (K,)."""
    pa, ya, xa, pb, yb, xb = PHASES[(dyq & 3, dxq & 3)]
    a = at(planes[:, pa], y + ya, x + xa, h, w)
    b = at(planes[:, pb], y + yb, x + xb, h, w)
    return (a + b + 1) >> 1


def emulate_k4(d, mbw, mbh, subpel):
    """K4 per MB, as the kernel computes it. Returns a dict of (K,) fields,
    pred (K, 16, 16) and planes (K, 4, 22, 22) (None without sub-pel)."""
    t = {k: _t(v).long() for k, v in d.items()}
    n, nmb = t["cur_tiles"].shape[:2]
    kk = n * nmb
    cur = t["cur_tiles"].reshape(kk, 16, 16)
    f = torch.arange(kk) // nmb
    m = torch.arange(kk) % nmb
    r, c = m // mbw, m % mbw
    lane, row0 = t["lane"][f], t["row_offset"][f]
    lam = _t(tme.LAMBDA_ME).long()[t["qp"][f]]
    # launch A: the coarse search, each dy's band window start clamped
    ref4 = t["y4_pad"][lane]
    h4p, w4p = ref4.shape[1:]
    cur4 = (cur.reshape(kk, 4, 4, 4, 4).sum((2, 4)) + 8) >> 4
    x0 = min(max(G4 - 8, 0), w4p - (4 * mbw + 16)) + 4 * c
    costs = []
    for p in range(17 * 17):
        dy, dx = p // 17 - 8, p % 17 - 8
        y = clamp(G4 + 4 * row0 + dy, 0, h4p - 4 * mbh) + 4 * r
        sad = (cur4 - at(ref4, y, x0 + dx + 8, 4, 4)).abs().sum((1, 2))
        costs.append(16 * sad + lam * (bits(torch.tensor(16 * dy))
                                       + bits(torch.tensor(16 * dx))))
    p, _ = key_min(torch.stack(costs, 1))
    cy4, cx4 = p // 17 - 8, p % 17 - 8
    # launch B
    pvy, pvx = predictor(cy4, n, mbw, mbh), predictor(cx4, n, mbw, mbh)
    ref = t["y_pad"][lane]
    hp, wp = ref.shape[1:]
    by, bx = G + 16 * (r + row0), G + 16 * c
    cands = [(torch.zeros(kk, dtype=torch.long),) * 2, (4 * cy4, 4 * cx4),
             (clamp(t["prev_my"].reshape(kk), -52, 52),
              clamp(t["prev_mx"].reshape(kk), -52, 52))]
    best = None
    for cy, cx in cands:
        oy = clamp(by + cy - 9, 0, hp - 34)
        ox = clamp(bx + cx - 9, 0, wp - 34)
        sad = (cur - at(ref, oy + 9, ox + 9, 16, 16)).abs().sum((1, 2))
        cost = sad + lam * (bits(cy * 4 - pvy) + bits(cx * 4 - pvx))
        if best is None:
            best, cm_y, cm_x, oyw, oxw = cost, cy, cx, oy, ox
            continue
        upd = cost < best
        best = torch.where(upd, cost, best)
        cm_y, cm_x = torch.where(upd, cy, cm_y), torch.where(upd, cx, cm_x)
        oyw, oxw = torch.where(upd, oy, oyw), torch.where(upd, ox, oxw)
    win = at(ref, oyw, oxw, 34, 34)
    zero = torch.zeros(kk, dtype=torch.long)
    costs = []
    for p in range(49):
        dy, dx = p // 7 - 3, p % 7 - 3
        sad = (cur - win[:, 9 + dy:25 + dy, 9 + dx:25 + dx]).abs().sum((1, 2))
        costs.append(sad + lam * (bits((cm_y + dy) * 4 - pvy)
                                  + bits((cm_x + dx) * 4 - pvx)))
    p, full_cost = key_min(torch.stack(costs, 1))
    bdy, bdx = p // 7 - 3, p % 7 - 3
    out = dict(cy4=cy4, cx4=cx4, mvp_y=pvy, mvp_x=pvx, full_my=cm_y + bdy,
               full_mx=cm_x + bdx, planes=None)
    if not subpel:
        out.update(mv_y=4 * out["full_my"], mv_x=4 * out["full_mx"],
                   cost=full_cost, pred=at(win, 9 + bdy, 9 + bdx, 16, 16))
        return out
    # the planes from the re-centred window A(p, q) = win[4 + bdy + p][4 +
    # bdx + q], with the vertical sums kept unclamped for J
    a = at(win, 4 + bdy, 4 + bdx, 27, 27)
    hr = sum(tp * a[:, i:i + 22, :] for i, tp in enumerate(TAPS))
    hb = sum(tp * a[:, 2:24, i:i + 22] for i, tp in enumerate(TAPS))
    hj = sum(tp * hr[:, :, i:i + 22] for i, tp in enumerate(TAPS))
    planes = torch.stack([a[:, 2:24, 2:24], clamp((hb + 16) >> 5, 0, 255),
                          clamp((hr[:, :, 2:24] + 16) >> 5, 0, 255),
                          clamp((hj + 512) >> 10, 0, 255)], 1)
    thr = tme.SKIP_THR_BASE + t["qp"][f] * tme.SKIP_THR_QP
    fmy, fmx = out["full_my"], out["full_mx"]
    costs = []
    for p in range(49):
        dyq, dxq = p // 7 - 3, p % 7 - 3
        blk = phase_block(planes, dyq, dxq, zero + 3 + (dyq >> 2),
                          zero + 3 + (dxq >> 2), 16, 16)
        sad = (cur - blk).abs().sum((1, 2))
        mvy, mvx = 4 * fmy + dyq, 4 * fmx + dxq
        cost = sad + lam * (bits(mvy - pvy) + bits(mvx - pvx))
        skip = (mvy == pvy) & (mvx == pvx) & (sad < thr)
        costs.append(cost - skip * lam * tme.SKIP_BIAS_BITS)
    p, cost = key_min(torch.stack(costs, 1))
    dyq, dxq = p // 7 - 3, p % 7 - 3
    pred = torch.stack([phase_block(planes[i:i + 1], int(dyq[i]),
                                    int(dxq[i]), zero[:1] + 3 + (dyq[i] >> 2),
                                    zero[:1] + 3 + (dxq[i] >> 2), 16, 16)[0]
                        for i in range(kk)])
    out.update(mv_y=4 * fmy + dyq, mv_x=4 * fmx + dxq, cost=cost, pred=pred,
               planes=planes)
    return out


def emulate_k5(cur, k4, lam):
    """K5 per MB from K4's planes and fields, as the kernel computes it:
    cur (K, 16, 16), lam (K,). Returns `partition_search`'s dict."""
    cur, planes = cur.long(), k4["planes"]
    kk = cur.shape[0]
    fmy, fmx, pvy, pvx = (k4[k] for k in ("full_my", "full_mx", "mvp_y",
                                          "mvp_x"))
    zero = torch.zeros(kk, dtype=torch.long)
    out = {}
    for name, offsets, bh, bw in GEOMETRIES:
        mvs, total = [], 0
        pred = torch.zeros((kk, 16, 16), dtype=torch.long)
        for oy0, ox0 in offsets:
            blk_cur = cur[:, oy0:oy0 + bh, ox0:ox0 + bw]
            costs = []
            for p in range(25):
                dy, dx = p // 5 - 2, p % 5 - 2
                ref = at(planes[:, F], zero + 3 + oy0 + dy, zero + 3 + ox0 + dx,
                         bh, bw)
                costs.append((blk_cur - ref).abs().sum((1, 2))
                             + lam * (bits((fmy + dy) * 4 - pvy)
                                      + bits((fmx + dx) * 4 - pvx)))
            p, _ = key_min(torch.stack(costs, 1))
            bmy, bmx = fmy + p // 5 - 2, fmx + p % 5 - 2
            y0, x0 = 2 + oy0 + bmy - fmy, 2 + ox0 + bmx - fmx
            costs = []
            for p in range(49):
                dyq, dxq = p // 7 - 3, p % 7 - 3
                blk = phase_block(planes, dyq, dxq, y0 + 1 + (dyq >> 2),
                                  x0 + 1 + (dxq >> 2), bh, bw)
                costs.append((blk_cur - blk).abs().sum((1, 2))
                             + lam * (bits(bmy * 4 + dyq - pvy)
                                      + bits(bmx * 4 + dxq - pvx)))
            p, cost = key_min(torch.stack(costs, 1))
            dyq, dxq = p // 7 - 3, p % 7 - 3
            for i in range(kk):
                q = slice(i, i + 1)
                pred[i, oy0:oy0 + bh, ox0:ox0 + bw] = phase_block(
                    planes[q], int(dyq[i]), int(dxq[i]),
                    y0[q] + 1 + (dyq[i] >> 2), x0[q] + 1 + (dxq[i] >> 2), bh,
                    bw)[0]
            mvs.append(torch.stack([bmy * 4 + dyq, bmx * 4 + dxq], -1))
            total = total + cost
        out[f"mv{name}"] = torch.stack(mvs, 1)
        out[f"cost{name}"] = total
        out[f"pred{name}"] = pred
    return out


def plain_me(d, mbw, mbh, subpel):
    """The port's plain search with K4's arguments on a case."""
    t = {k: _t(d[k]) for k in ME_ARGS}
    return tme.motion_search_plain(*t.values(), mbw, mbh,
                                   enable_subpel=subpel, planes=subpel)


def plain_partitions(d, me_out):
    """The port's plain partition search with K5's arguments."""
    aux = me_out[4]
    nmb = aux["full_my"].shape[1]
    return tme.partition_plain(
        _t(d["cur_tiles"]).reshape(-1, 16, 16), aux["wins"],
        *(aux[k].reshape(-1) for k in ("full_my", "full_mx", "mvp_y",
                                       "mvp_x")),
        tme.lambda_me(_t(d["qp"])).repeat_interleave(nmb))


@functools.partial(jax.jit, static_argnames=("mbh", "mbw", "subpel"))
def _jax_me(plane, tiles, ref_pad, ref4_pad, base_y, base_x, qp, row_offset,
            prev_my, prev_mx, mbh, mbw, subpel):
    return jme.motion_search_dense(plane, tiles, ref_pad, ref4_pad, base_y,
                                   base_x, qp, mbh, mbw, row_offset,
                                   enable_subpel=subpel, prev_my=prev_my,
                                   prev_mx=prev_mx)


_jax_partitions = jax.jit(jme.partition_search)


@functools.lru_cache(maxsize=None)
def case(c):
    """A case's inputs, its emulations and the port's plain outputs."""
    seed, n, mbw, mbh, qp, lanes, rows, subpel = c
    d = me_inputs(seed, n, mbw, mbh, qp, lanes=lanes, frame_rows=rows)
    k4 = emulate_k4(d, mbw, mbh, subpel)
    plain = plain_me(d, mbw, mbh, subpel)
    out = dict(d=d, k4=k4, plain=plain)
    if subpel:
        nmb = mbw * mbh
        lam = _t(tme.LAMBDA_ME).long()[_t(d["qp"]).long()].repeat_interleave(
            nmb)
        out["k5"] = emulate_k5(_t(d["cur_tiles"]).reshape(-1, 16, 16), k4,
                               lam)
        out["plain_part"] = plain_partitions(d, plain)
    return out


@functools.lru_cache(maxsize=None)
def jax_case(c):
    """JAX's search (and partition search) of each frame of a case."""
    seed, n, mbw, mbh, qp, lanes, rows, subpel = c
    d = case(c)["d"]
    nmb = mbw * mbh
    frames = []
    for i in range(n):
        tiles = d["cur_tiles"][i]
        plane = tiles.reshape(mbh, mbw, 16, 16).transpose(0, 2, 1, 3).reshape(
            16 * mbh, 16 * mbw)
        r = np.arange(nmb) // mbw + d["row_offset"][i]
        c = np.arange(nmb) % mbw
        got = _jax_me(plane, tiles, d["y_pad"][d["lane"][i]],
                      d["y4_pad"][d["lane"][i]], (G + 16 * r).astype(np.int32),
                      (G + 16 * c).astype(np.int32), jnp.int32(d["qp"][i]),
                      jnp.int32(d["row_offset"][i]), d["prev_my"][i],
                      d["prev_mx"][i], mbh=mbh, mbw=mbw, subpel=subpel)
        part = (_jax_partitions(tiles, got[4], jnp.int32(d["qp"][i]))
                if subpel else None)
        frames.append((got, part))
    return frames


def _eq(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_array_equal(a.astype(np.int64).ravel(),
                                  b.astype(np.int64).ravel(), err_msg=what)


def _plain_fields(plain):
    mv_y, mv_x, cost, pred, aux = plain
    out = dict(mv_y=mv_y, mv_x=mv_x, cost=cost, pred=pred,
               **{k: aux[k] for k in ("cy4", "cx4", "full_my", "full_mx",
                                      "mvp_y", "mvp_x")})
    if aux["wins"] is not None:
        out["planes"] = aux["wins"]
    return out


@pytest.mark.parametrize("c", CASES, ids=_ids)
def test_k4_schedule_equals_plain_search(c):
    got = case(c)
    want = _plain_fields(got["plain"])
    assert (want.get("planes") is None) == (got["k4"]["planes"] is None)
    for k, v in want.items():
        _eq(got["k4"][k], v, k)
    # the inputs hold what the cases are for
    d = got["d"]
    assert (np.abs(d["prev_my"]) > 52).any() and (d["prev_my"] == 0).any()
    assert (d["cur_tiles"].reshape(-1, 256) == 128).all(1).any()


@pytest.mark.parametrize("c", [c for c in CASES if c[7]], ids=_ids)
def test_k5_schedule_equals_plain_partition_search(c):
    got = case(c)
    assert set(got["k5"]) == set(got["plain_part"])
    for k, v in got["plain_part"].items():
        _eq(got["k5"][k], v, k)


@pytest.mark.parametrize("c", JAX_CASES, ids=_ids)
def test_k4_and_k5_schedules_equal_jax(c):
    got = case(c)
    nmb = c[2] * c[3]
    for i, (want, part) in enumerate(jax_case(c)):
        sl = slice(i * nmb, (i + 1) * nmb)
        for j, k in enumerate(("mv_y", "mv_x", "cost", "pred")):
            _eq(got["k4"][k][sl], want[j], f"frame {i} {k}")
        for k in ("cy4", "cx4", "full_my", "full_mx", "mvp_y", "mvp_x"):
            _eq(got["k4"][k][sl], want[4][k], f"frame {i} {k}")
        if part is None:
            continue
        for p, w in enumerate(want[4]["wins"]):
            _eq(got["k4"]["planes"][sl, p], w, f"frame {i} plane {p}")
        for k, v in part.items():
            _eq(got["k5"][k][sl], v, f"frame {i} {k}")


def test_k4_schedule_reaches_a_negative_cost():
    """The skip bias takes QP 51's cost below zero at the predictor: the
    signed keys must order it first."""
    got = case(CASES[3])
    assert (got["k4"]["cost"] < 0).any()
    assert ((got["k4"]["mv_y"] == got["k4"]["mvp_y"])
            & (got["k4"]["cost"] < 0)).any()
    _eq(got["k4"]["cost"], got["plain"][2], "cost")


@pytest.mark.parametrize("subpel", [True, False])
def test_k4_schedule_clamps_windows_as_the_plain_search(subpel):
    """Planes whose guard is cut at the bottom and right: the coarse band
    windows and the candidate windows start clamped into them, in the
    emulation as in `qpel.windows`."""
    d = me_inputs(67, 2, 4, 3, 33, lanes=2, frame_rows=3)
    d["y_pad"] = np.ascontiguousarray(d["y_pad"][:, :-40, :-40])
    d["y4_pad"] = np.ascontiguousarray(d["y4_pad"][:, :-10, :-6])
    d["prev_my"][:] = 52
    d["prev_mx"][:] = 52
    k4 = emulate_k4(d, 4, 3, subpel)
    want = _plain_fields(plain_me(d, 4, 3, subpel))
    for k, v in want.items():
        _eq(k4[k], v, k)
    # the clamps were reached: the previous-MV windows of the bottom row,
    # the coarse windows of dy > 5
    hp = d["y_pad"].shape[1]
    assert G + 16 * 2 + 52 - 9 > hp - 34
    assert G4 + 8 > d["y4_pad"].shape[1] - 12


@pytest.mark.parametrize("subpel", [True, False])
def test_k4_schedule_keeps_the_first_of_tied_centres(subpel):
    """Stripes of period 8 moved by 4 pixels: the coarse centre (0, -4)
    and the previous MV (0, 4) cost the same on each frame's first MB
    (zero predictor); the coarse one, tried first, stays the winner."""
    d = me_inputs(71, 2, 4, 3, 33, lanes=1, frame_rows=3, stripes=True)
    k4 = emulate_k4(d, 4, 3, subpel)
    want = _plain_fields(plain_me(d, 4, 3, subpel))
    for k, v in want.items():
        _eq(k4[k], v, k)
    first = torch.arange(2) * 12
    assert (k4["mvp_x"][first] == 0).all() and (k4["cx4"][first] == -1).all()
    assert (k4["full_mx"][first] == -4).all()


def test_me_inputs_cover_the_kinds():
    d = me_inputs(68, 4, 6, 4, 30, lanes=3, frame_rows=9)
    t = d["cur_tiles"].reshape(-1, 256).astype(np.int64)
    flat = (t == 128).all(1)
    assert flat.any() and (~flat).any()
    assert set(d["lane"].tolist()) == {0, 1, 2}
    assert d["row_offset"].max() <= 5 and d["row_offset"].min() >= 0
    assert d["y_pad"].shape == (3, 16 * 9 + 128, 16 * 6 + 128)
    assert d["y4_pad"].shape == (3, 4 * 9 + 32, 4 * 6 + 32)
    assert set(np.unique(np.abs(d["prev_mx"]))) >= {0, 52, 53}
    # the kernels take contiguous tensors, so the arrays are C-contiguous
    for stripes in (False, True):
        d = me_inputs(68, 2, 4, 3, 30, stripes=stripes)
        assert all(v.flags["C_CONTIGUOUS"] for v in d.values()), stripes


def test_motion_search_args_pack_the_plain_arguments():
    d = me_inputs(69, 2, 4, 3, 33, lanes=2, frame_rows=4)
    t = {k: _t(v) for k, v in d.items()}
    ref = dict(y_pad=t["y_pad"], y4_pad=t["y4_pad"])
    src = t["cur_tiles"].permute(0, 1, 3, 2).transpose(-1, -2)
    args = tmb.motion_search_args(src, ref, t["lane"].long(),
                                  t["row_offset"], t["qp"].long(),
                                  t["prev_my"].long(), t["prev_mx"])
    assert args[0] is t["y_pad"] and args[1] is t["y4_pad"]
    assert args[2].is_contiguous() and torch.equal(args[2], t["cur_tiles"])
    for x, want in zip(args[3:], ("lane", "row_offset", "qp", "prev_my",
                                  "prev_mx")):
        assert x.dtype == torch.int32 and x.is_contiguous()
        assert torch.equal(x, t[want].int())
    none = tmb.motion_search_args(src, ref, t["lane"], t["row_offset"],
                                  t["qp"], None, None)
    assert none[-2:] == (None, None)


def test_cpu_tensors_never_reach_k4():
    before = dict(LAUNCH_COUNTS)
    cfg = EncoderConfig(width=64, height=48, gop=3, qp=33)
    frames = list(chessboard_sequence(64, 48, 3))
    enc = GopBandEncoder(cfg, n_gop=2, device="cpu")
    for t in range(2):
        res = enc.encode_step(frames[t:t + 2], RunConfig(
            qp_min=33, qp_max=33, encode_speed=2))
    assert res[0].frame_type == "P"
    seq = H264Encoder(cfg, device="cpu")        # speed 0: partitions
    for f in frames[:2]:
        seq.encode(*f, RunConfig(qp_min=33, qp_max=33))
    assert LAUNCH_COUNTS == before
    assert LAUNCH_COUNTS["me"] == 0 and LAUNCH_COUNTS["partition"] == 0
    # the wrappers refuse CPU tensors
    d = me_inputs(70, 1, 4, 3, 33)
    t = {k: _t(v) for k, v in d.items()}
    with pytest.raises(ValueError, match="CUDA"):
        tme.motion_search_tiles(t["y_pad"], t["y4_pad"], t["cur_tiles"],
                                t["lane"], t["row_offset"], t["qp"],
                                t["prev_my"], t["prev_mx"], 4, 3)
    z = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tme.partition_tiles(t["cur_tiles"][0],
                            torch.zeros((12, 4, 22, 22), dtype=torch.uint8),
                            z, z, z, z, z)
    assert LAUNCH_COUNTS == before
