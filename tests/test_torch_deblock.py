"""The port's deblocking filter against the JAX package's, on the CPU.

`h264lab_tpu_torch.models.mbscan.deblock_frame` on CPU tensors runs its
plain version (`deblock_frame_plain`); on CUDA tensors it launches K2
(`csrc/deblock.cu`), which `tests/test_torch_cuda.py` and `chip_smoke.py`
hold against that plain version on the card. Here, on seeded inputs
(`utils.synthetic.deblock_inputs`: bS 0 to 4, flat areas for the strong
filter, QPs below 16 where alpha is 0, per-frame and per-MB QPs, a band's
first row and column unavailable; 4 x 3, 3 x 5, 1 x 6 and 6 x 1 MBs, one
to three frames):
- the port's `deblock_frame` equals JAX's `deblock_frame`, frame by frame;
- K2's schedule, emulated in torch with the port's edge filters: one
  worker per MB row and plane group (luma; U and V) that filters its MBs
  in order (V, then H), keeps the MB and its left neighbour as K2 keeps
  them in shared memory, puts an MB out once its right neighbour's V pass
  is done (its bottom lines go to K2's mailbox) and takes and writes back
  the bottom lines of the MB above; bS and the edge QPs derived per MB
  from the MB and its neighbours, as K2 derives them. The workers take
  their steps in a seeded random order that K2's rule allows (row r takes
  MB c once row r - 1 of its plane group has put MB c out). It equals
  `deblock_frame_plain` and JAX's `deblock_frame`, also with per-MB
  availability;
- `mbscan.deblock_tiles_args`, which packs K2's arguments, gives
  arguments that `deblock_frame_plain` turns into JAX's output, with
  availability as bools, numpy arrays and tensors, per frame and per MB,
  and per-frame and per-MB QPs;
- `deblock.edge_qps`, which builds the plain filter's QP arguments, gives
  per-frame QPs the same per-edge arrays as per-MB QPs that repeat them,
  and the plain filter the same output either way;
- CPU tensors never reach K2: a CPU GopBandEncoder step launches nothing,
  and `deblock_tiles` refuses CPU tensors.
Tolerance: exact equality (integer arithmetic).
"""
import jax
import numpy as np
import pytest
import torch

from h264lab_tpu.models import mbscan as jmb
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import mbscan as tmb
from h264lab_tpu_torch.ops import deblock
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
from h264lab_tpu_torch.parallel.gop import GopBandEncoder
from h264lab_tpu_torch.utils.synthetic import chessboard_sequence, \
    deblock_inputs

_jax_deblock = jax.jit(jmb.deblock_frame, static_argnums=(11, 12))

# (seed, frames, mb_width, mb_height, qp, per-MB QPs, band edges)
CASES = [
    (1, 1, 4, 3, 30, False, False),
    (2, 3, 4, 3, 14, True, True),       # QPs 4..24: alpha 0 below 16
    (3, 3, 3, 5, 40, False, True),
    (4, 1, 3, 5, 22, True, False),
    (5, 3, 1, 6, 36, True, True),       # one MB wide
    (6, 1, 1, 6, 48, False, False),
]
# one MB high and one MB wide, per-MB QPs, for K2's schedule
SHAPE_CASES = [
    (7, 2, 6, 1, 28, True, False),
    (8, 2, 1, 6, 33, True, False),
]


def _inputs(case):
    seed, n, mbw, mbh, qp, per_mb, band = case
    return deblock_inputs(seed, n, mbw, mbh, qp, per_mb_qp=per_mb,
                          band=band), mbw, mbh


def _torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_deblock_frame_matches_jax(case):
    d, mbw, mbh = _inputs(case)
    t = _torch(d)
    bs = torch.cat(tmb._frame_bs(t["sel"], t["nnz_blk"], t["mv4_y"],
                                 t["mv4_x"], t["avail_top"], t["avail_left"],
                                 mbw, mbh))
    assert set(bs.unique().tolist()) == {0, 1, 2, 3, 4}
    got = tmb.deblock_frame(**t, mb_width=mbw, mb_height=mbh)
    assert all(b.dtype == torch.uint8 for b in got)
    _assert_equal_jax(got, _jax_frames(d, mbw, mbh))
    assert any(not torch.equal(a, t[k]) for a, k in zip(
        got, ("recon_y", "recon_u", "recon_v")))      # the filter ran


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[5]],
                         ids=lambda c: f"seed{c[0]}")
def test_edge_qps_per_frame_equal_per_mb(case):
    d, mbw, mbh = _inputs(case)
    t = _torch(d)
    n, nmb = t["sel"].shape
    per_frame = deblock.edge_qps(t["qp"], t["qpc"], n, mbw, mbh)
    per_mb = deblock.edge_qps(t["qp"][:, None].expand(n, nmb),
                              t["qpc"][:, None].expand(n, nmb), n, mbw, mbh)
    for a, b, q, edges in zip(per_frame, per_mb, ("qp", "qp", "qpc", "qpc"),
                              (4, 4, 2, 2)):
        assert a.dtype == torch.int32 and a.shape == (n, nmb, edges)
        assert torch.equal(a, b)
        assert torch.equal(a, t[q][:, None, None].expand(n, nmb, edges))
    want = tmb.deblock_frame(**t, mb_width=mbw, mb_height=mbh)
    t["qp"] = t["qp"][:, None].expand(n, nmb)
    t["qpc"] = t["qpc"][:, None].expand(n, nmb)
    got = tmb.deblock_frame(**t, mb_width=mbw, mb_height=mbh)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_edge_qps_per_mb_average():
    d, mbw, mbh = _inputs(CASES[1])
    q = d["qp"].reshape(3, mbh, mbw).astype(np.int64)
    qv, qh, _, _ = deblock.edge_qps(torch.from_numpy(d["qp"]),
                                    torch.from_numpy(d["qpc"]), 3, mbw, mbh)
    left = np.concatenate([q[:, :, :1], q[:, :, :-1]], axis=2)
    top = np.concatenate([q[:, :1], q[:, :-1]], axis=1)
    for got, nb in ((qv, left), (qh, top)):
        got = got.numpy().reshape(3, mbh, mbw, 4)
        np.testing.assert_array_equal(got[..., 0], (q + nb + 1) // 2)
        np.testing.assert_array_equal(got[..., 1:], np.repeat(
            q[..., None], 3, axis=3))


def _jax_frames(d, mbw, mbh, avail_top=None, avail_left=None):
    """JAX's deblock_frame on each frame of the numpy inputs `d`."""
    at = d["avail_top"] if avail_top is None else avail_top
    al = d["avail_left"] if avail_left is None else avail_left
    return [_jax_deblock(
        d["recon_y"][i], d["recon_u"][i], d["recon_v"][i], d["sel"][i],
        d["nnz_blk"][i], d["mv4_y"][i], d["mv4_x"][i], d["qp"][i],
        d["qpc"][i], at, al, mbw, mbh) for i in range(d["sel"].shape[0])]


def _assert_equal_jax(got, want):
    for i, frame in enumerate(want):
        for plane, a, b in zip("yuv", frame, got):
            np.testing.assert_array_equal(np.asarray(a), b[i].numpy(),
                                          err_msg=f"frame {i} {plane}")


def _mb_bs(intra_p, intra_q, p, q, mb_edge):
    """bS of one edge's 4 groups: p and q are (nnz, mvy, mvx) rows of the
    blocks on either side."""
    return deblock.mb_edge_bs(intra_p, intra_q, p[0], q[0], p[1], p[2],
                              q[1], q[2], mb_edge).to(torch.int32)


def emulate_k2(t, mbw, mbh, seed):
    """K2's schedule in torch on the packed arguments `t` (a dict keyed by
    `deblock_frame`'s names, as `deblock_tiles_args` packs them): see the
    module docstring. Returns the (df_y, df_u, df_v) uint8 tiles."""
    n, nmb = t["sel"].shape
    per_mb = t["qp"].ndim == 2
    rng = np.random.default_rng(seed)
    out = dict(y=torch.zeros(t["recon_y"].shape, dtype=torch.int32),
               c=torch.zeros((n, nmb, 2, 8, 8), dtype=torch.int32))

    def mb(f, r, c, plane):
        """What K2 loads of MB (r, c) of frame f for a plane group: its
        tile (luma, or U and V on a plane axis), block data rows, intra
        flag, QPs and availability."""
        i = r * mbw + c
        q = (t["qp"][f, i], t["qpc"][f, i]) if per_mb else (
            t["qp"][f], t["qpc"][f])
        tile = (t["recon_y"][f, i] if plane == "y" else torch.stack(
            [t["recon_u"][f, i], t["recon_v"][f, i]]))
        return dict(
            px=tile.to(torch.int32),
            blk=torch.stack([t[k][f, i] for k in ("nnz_blk", "mv4_y",
                                                  "mv4_x")]),
            intra=t["sel"][f, i] != tmb.SEL_INTER, qp=q[0], qpc=q[1],
            top=bool(t["avail_top"][i]) and r > 0,
            left=bool(t["avail_left"][i]) and c > 0)

    def bs_edges(m, nb, has_nb, vertical):
        """(1, 4 edges, 4 groups) bS of the MB's vertical or horizontal
        edges; nb is the left or upper MB."""
        blk = m["blk"] if vertical else m["blk"].transpose(1, 2)
        out = [torch.zeros(4, dtype=torch.int32)]
        if has_nb:
            nb_blk = nb["blk"] if vertical else nb["blk"].transpose(1, 2)
            out[0] = _mb_bs(nb["intra"], m["intra"], nb_blk[:, :, 3],
                            blk[:, :, 0], True)
        out += [_mb_bs(m["intra"], m["intra"], blk[:, :, e - 1],
                       blk[:, :, e], False) for e in range(1, 4)]
        return torch.stack(out)[None]

    def qps(m, nb, has_nb, plane):
        key = "qp" if plane == "y" else "qpc"
        q0 = (m[key] + nb[key] + 1) >> 1 if has_nb else m[key]
        return torch.stack([q0] + [m[key]] * (3 if plane == "y" else 1))[
            None]

    # luma lines have 4 pixels of the neighbour in the strip, chroma 2
    filters = dict(y=(deblock.filter_luma_v, deblock.filter_luma_h, 4),
                   c=(deblock.filter_chroma_v, deblock.filter_chroma_h, 2))

    def v_pass(m, left, plane):
        filt, _, k = filters[plane]
        left = left or m
        strip = torch.cat([left["px"][..., -k:], m["px"]], dim=-1)[None]
        filt(strip, bs_edges(m, left, m["left"], True),
             qps(m, left, m["left"], plane), edge_x0=k)
        left["px"][..., 1 - k:] = strip[0, ..., 1:k]
        m["px"] = strip[0, ..., k:]

    def h_pass(m, top, above, plane):
        """`above`: the bottom lines of the MB above, updated in place."""
        _, filt, k = filters[plane]
        if not m["top"]:
            above = torch.zeros_like(m["px"][..., :k, :])
        strip = torch.cat([above, m["px"]], dim=-2)[None]
        filt(strip, bs_edges(m, top, m["top"], False),
             qps(m, top, m["top"], plane), edge_y0=k)
        above[...] = strip[0, ..., :k, :]
        m["px"] = strip[0, ..., k:, :]

    def step(w):
        """MB c of a row: its V pass and the left MB put out, or (phase H)
        its H pass with the bottom lines of the MB above."""
        f, plane, r, c = w["f"], w["plane"], w["r"], w["c"]
        if w["phase"] == "V":
            w["cur"] = mb(f, r, c, plane)
            v_pass(w["cur"], w["left"], plane)
            if c > 0:                   # the left MB is final: put it out
                out[plane][f, r * mbw + c - 1] = w["left"]["px"]
                progress[w["key"]] = c
            w["phase"] = "H"
            return
        m, kk = w["cur"], filters[plane][2]
        h_pass(m, mb(f, r - 1, c, plane) if r > 0 else m,
               out[plane][f, (r - 1) * mbw + c][..., -kk:, :]
               if m["top"] else None, plane)
        w["left"], w["c"], w["phase"] = m, c + 1, "V"
        if w["c"] == mbw:
            out[plane][f, r * mbw + c] = m["px"]
            progress[w["key"]] = mbw

    def ready(w):
        if w["phase"] == "V" or not w["cur"]["top"]:
            return True
        return progress[w["key"][:2] + (w["r"] - 1,)] > w["c"]

    progress = {}
    workers = []
    for f in range(n):
        for plane in "yc":
            for r in range(mbh):
                workers.append(dict(f=f, plane=plane, r=r, c=0, left=None,
                                    phase="V", key=(f, plane, r)))
                progress[f, plane, r] = 0
    while workers:
        w = [w for w in workers if ready(w)]
        w = w[rng.integers(len(w))]
        step(w)
        if w["c"] == mbw:
            workers.remove(w)
    return (out["y"].to(torch.uint8), out["c"][:, :, 0].to(torch.uint8),
            out["c"][:, :, 1].to(torch.uint8))


def _per_mb_avail(seed, mbw, mbh):
    """Random per-MB availability, as `svc.base_mode_deblock` may pass."""
    rng = np.random.default_rng(seed)
    return (rng.random(mbw * mbh) < 0.7, rng.random(mbw * mbh) < 0.7)


@pytest.mark.parametrize("case", CASES + SHAPE_CASES,
                         ids=lambda c: f"seed{c[0]}-{c[2]}x{c[3]}")
def test_k2_schedule_matches_plain_and_jax(case):
    d, mbw, mbh = _inputs(case)
    if case[0] % 2:                 # odd seeds: per-MB availability
        d["avail_top"], d["avail_left"] = _per_mb_avail(case[0], mbw, mbh)
    t = _torch(d)
    packed = tmb.deblock_tiles_args(**t, mb_width=mbw, mb_height=mbh)
    names = list(t)
    got = emulate_k2(dict(zip(names, packed)), mbw, mbh, seed=case[0])
    want = tmb.deblock_frame_plain(**t, mb_width=mbw, mb_height=mbh)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _assert_equal_jax(got, _jax_frames(d, mbw, mbh))


AVAIL_FORMS = ("bool", "numpy", "tensor")


@pytest.mark.parametrize("per_mb_qp", [False, True], ids=["frame_qp",
                                                          "mb_qp"])
@pytest.mark.parametrize("avail", AVAIL_FORMS)
def test_packed_k2_args_match_jax(avail, per_mb_qp):
    mbw, mbh = 4, 3
    d = deblock_inputs(30 + per_mb_qp, 2, mbw, mbh, 24, per_mb_qp=per_mb_qp,
                       band=avail != "bool")
    t = _torch(d)
    if avail == "bool":
        d["avail_top"] = d["avail_left"] = t["avail_top"] = \
            t["avail_left"] = True
    elif avail == "tensor":     # as svc.base_mode_deblock builds them
        d["avail_top"], d["avail_left"] = _per_mb_avail(31, mbw, mbh)
        t["avail_top"], t["avail_left"] = (torch.from_numpy(a) for a in (
            d["avail_top"], d["avail_left"]))
    packed = tmb.deblock_tiles_args(**t, mb_width=mbw, mb_height=mbh)
    n, nmb = 2, mbw * mbh
    q = (n, nmb) if per_mb_qp else (n,)
    for x, (name, dtype, shape) in zip(packed, deblock._k2_args(
            n, nmb, per_mb_qp)):
        assert x.dtype == dtype and tuple(x.shape) == shape, name
        assert x.is_contiguous(), name
    assert packed[7].shape == q and packed[-2:] == (mbw, mbh)
    got = tmb.deblock_frame_plain(*packed)
    _assert_equal_jax(got, _jax_frames(d, mbw, mbh))


def test_cpu_tensors_never_reach_k2():
    cfg = EncoderConfig(width=64, height=48, gop=3, qp=33)
    run = RunConfig(qp_min=33, qp_max=33, encode_speed=2)
    enc = GopBandEncoder(cfg, n_gop=2, device="cpu")
    frames = list(chessboard_sequence(64, 48, 3))
    before = dict(LAUNCH_COUNTS)
    enc.stage_times = {}
    for t in range(2):                  # an IDR step, then a P step
        res = enc.encode_step([frames[t], frames[t + 1]], run)
        assert all(len(r.payload) > 0 for r in res)
    assert "deblock" in enc.stage_times           # the stage ran
    assert LAUNCH_COUNTS == before and LAUNCH_COUNTS["deblock"] == 0
    d, mbw, mbh = _inputs(CASES[0])
    packed = tmb.deblock_tiles_args(**_torch(d), mb_width=mbw,
                                    mb_height=mbh)
    with pytest.raises(ValueError, match="CUDA"):
        deblock.deblock_tiles(*packed)
    assert LAUNCH_COUNTS == before
