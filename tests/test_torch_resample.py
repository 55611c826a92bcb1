"""The SVC resampling and the reference planes: the plain versions and
the index math of their CUDA kernels K9, K10 (`csrc/resample.cu`) and K11
(`csrc/refplanes.cu`), emulated on the CPU, against the JAX package.

The stage entries on CPU tensors run the plain versions, which the
kernels are held against on the card:
- `resample.downsample_planes` (the `down` stage) equals JAX's
  `downsample2x` of each plane, on even and odd planes;
- `resample.upsample_tiles` (the `up` stage) equals the JAX package's
  chain (`h264lab_tpu/models/svc.py:316-330`): the cropped base recon,
  `upsample2x_luma` / `upsample2x_chroma`, `wavefront.pad_plane` to the
  enhancement's padded size, `mb_tiles`, and `qpel.pad_guard` by GUARD //
  2 of the padded chroma planes; on a base that fills its MBs, cropped
  bases (120x90 in 8 x 6 MBs, one a few pixels wide and high), one MB
  wide and one MB high;
- `refstate.prepare_reference_plain` equals JAX's `prepare_reference` at
  L = 1 and 3 pictures, and `refstate.reference_chroma` its chroma planes.
Inputs are seeded numpy planes with 0 and 255 borders and flat patches.

A CUDA kernel cannot run here, so `emulate_k9`, `emulate_k10` and
`emulate_k11` compute in numpy what the kernels compute, thread by
thread in their layout: a thread per 4 output bytes; K9 walking its
plane's output in flat order and reading each 2x2 box by the kernel's
address; K10 clamping each of a thread's 4 pixels as the kernel does
(into the padded enhancement plane for u_pad and v_pad, then to the
upsampled plane of the cropped base), summing the filter's rows over
its window of 6 base columns and each pixel's columns from there (the
one 2-D tap sum), reading the base tiles by MB and offset; K11 per band
of the padded planes ((mb_height + 8) bands of 16 luma, 8 chroma and 4
pyramid rows; every row written by exactly one band), a tile row's word
inside the plane and a clamped byte on the ring, the pyramid from 4-byte
box rows. Each equals the JAX functions array for array; K10 clamped at
the base's MB grid in place of its picture fails on a cropped base.
Tolerance: exact equality (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264lab_tpu.models import refstate as jref
from h264lab_tpu.models import wavefront as jwf
from h264lab_tpu.ops import qpel as jqp
from h264lab_tpu.ops import resample as jrs
from h264lab_tpu_torch.config import EncoderConfig, RunConfig
from h264lab_tpu_torch.models import refstate, svc
from h264lab_tpu_torch.ops import refplanes, resample
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
from h264lab_tpu_torch.utils.synthetic import chessboard_sequence

GUARD = 64                       # qpel.GUARD
LUMA_TAPS = ((-3, 28, 8, -1), (-1, 8, 28, -3))
CHROMA_TAPS = ((1, 3, 0, 0), (0, 3, 1, 0))


def _plane(rng, h, w):
    """Seeded noise with full-scale borders (0 above and right, 255 below
    and left) and a flat patch."""
    p = rng.integers(0, 256, (h, w), dtype=np.uint8)
    p[0], p[-1] = 0, 255
    p[:, 0], p[:, -1] = 255, 0
    p[h // 3:h // 3 + 5, w // 4:w // 4 + 7] = 128
    return p


def _mb_tiles(plane, t):
    h, w = plane.shape
    return (plane.reshape(h // t, t, w // t, t).transpose(0, 2, 1, 3)
            .reshape(-1, t, t))


def _eq(want, got, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(np.asarray(want), got, err_msg=what)


# ---------------------------------------------------------------------------
# emulations of the kernels' threads
# ---------------------------------------------------------------------------

def emulate_k9(plane):
    """K9 on one (h, w) plane: a thread per 4 output bytes in flat order,
    its row and column carried across the row end; one byte store past the
    plane's last whole word."""
    h, w = plane.shape
    oh, ow = h // 2, w // 2
    n = oh * ow
    src = plane.reshape(-1).astype(np.int64)
    out = np.full(n, 77, np.int64)
    o4 = 4 * np.arange((n + 3) // 4)
    r, c = o4 // ow, o4 % ow
    for k in range(4):
        ok = o4 + k < n
        s = (2 * r * w + 2 * c)[ok]
        out[(o4 + k)[ok]] = (src[s] + src[s + 1] + src[s + w]
                             + src[s + w + 1] + 2) >> 2
        c = c + 1
        r = np.where(c == ow, r + 1, r)
        c = np.where(c == ow, 0, c)
    return out.astype(np.uint8).reshape(oh, ow)


def _up4(base, bmbw, h, w, y, x, luma):
    """K10's `up4` for a batch of threads: y (n,), x (n, 4) enhancement
    coordinates, base the plane's flat tiles."""
    t, ls = (16, 4) if luma else (8, 3)
    taps, n_taps = (LUMA_TAPS, 4) if luma else (CHROMA_TAPS, 3)
    rnd, shift = (512, 10) if luma else (8, 4)
    yu = np.minimum(y, 2 * h - 1)
    i, a = yu >> 1, yu & 1
    xu = np.minimum(x, 2 * w - 1)
    j0 = xu[:, 0] >> 1
    rows = [(r >> ls) * bmbw * t * t + (r & (t - 1)) * t
            for r in (np.clip(i - 1 + k, 0, h - 1) for k in range(n_taps))]
    tap = np.asarray(taps)
    v = []
    for m in range(6):
        c = np.clip(j0 - 1 + m, 0, w - 1)
        col = (c >> ls) * t * t + (c & (t - 1))
        v.append(sum(tap[a, k] * base[rows[k] + col] for k in range(n_taps)))
    out = np.zeros(x.shape, np.int64)
    for k in range(4):
        d, b = (xu[:, k] >> 1) - j0, xu[:, k] & 1
        assert d.min() >= 0 and d.max() <= 2
        te = [sum(tap[b, l] * v[e + l] for l in range(n_taps))
              for e in range(3)]
        s = np.where(d == 0, te[0], np.where(d == 1, te[1], te[2]))
        out[:, k] = np.clip((s + rnd) >> shift, 0, 255)
    return out


def emulate_k10(base_tiles, bmbw, crops, mbw, mbh, mutation=None):
    """K10's five outputs from the (bnmb, t, t) base tiles: a thread per 4
    output bytes of each (the tiles' rows, the padded planes' words).
    `mutation="grid_clamp"` clamps at the base's MB grid in place of the
    cropped picture."""
    g = GUARD // 2
    outs = []
    for o in range(5):
        p = o if o < 3 else o - 2
        t = 16 if p == 0 else 8
        ph, pw = mbh * t, mbw * t
        if o < 3:
            per_mb = t * t // 4
            item = np.arange(mbw * mbh * per_mb)
            mb, rem = item // per_mb, item % per_mb
            row, cq = rem // (t // 4), rem % (t // 4)
            y = (mb // mbw) * t + row
            x = ((mb % mbw) * t + 4 * cq)[:, None] + np.arange(4)
            addr = mb * t * t + row * t + 4 * cq
            shape = (1, mbw * mbh, t, t)
        else:
            words = (pw + 2 * g) // 4
            item = np.arange((ph + 2 * g) * words)
            r, q = item // words, item % words
            y = np.clip(r - g, 0, ph - 1)
            x = np.clip((4 * q)[:, None] + np.arange(4) - g, 0, pw - 1)
            addr = r * (pw + 2 * g) + 4 * q
            shape = (1, ph + 2 * g, pw + 2 * g)
        h, w = crops[p]
        if mutation == "grid_clamp":
            h = base_tiles[p].shape[0] // bmbw * t
            w = bmbw * t
        word = _up4(base_tiles[p].reshape(-1).astype(np.int64), bmbw, h, w,
                    y, x, p == 0)
        out = np.full(int(np.prod(shape)), -1, np.int64)
        out[addr[:, None] + np.arange(4)] = word
        assert out.min() >= 0                     # every byte written
        outs.append(out.astype(np.uint8).reshape(shape))
    return tuple(outs)


def emulate_k11(tiles, mbw, mbh):
    """K11's planes of L pictures from (L, nmb, t, t) tiles ((u, v) alone,
    or (y, u, v)), band by band: band b writes rows [t b, t b + t) of each
    padded plane of tile size t (4 b .. 4 b + 3 of the pyramid)."""
    luma = len(tiles) == 3
    n = tiles[0].shape[0]
    bands = mbh + 8
    outs = {}
    planes = (("y_pad", 0, 16), ("u_pad", 1, 8), ("v_pad", 2, 8))
    for name, p, t in planes if luma else planes[1:]:
        src = tiles[p - (0 if luma else 1)].reshape(n, -1).astype(np.int64)
        g = 4 * t
        ph, pw = mbh * t, mbw * t
        words = (pw + 2 * g) // 4
        out = np.full((n, bands * t, pw + 2 * g), -1, np.int64)
        written = np.zeros(bands * t, np.int64)
        for b in range(bands):
            pr = t * b + np.arange(t)
            written[pr] += 1
            y = np.clip(pr - g, 0, ph - 1)
            row = (y // t) * mbw * t * t + (y % t) * t
            x = 4 * np.arange(words) - g
            inside = (x >= 0) & (x < pw)
            c = np.clip(x, 0, pw - 1)
            at = np.where(inside[None, :, None],
                          (row[:, None] + (x // t) * t * t + x % t)[..., None]
                          + np.arange(4),
                          (row[:, None] + (c // t) * t * t + c % t)[..., None]
                          + 0 * np.arange(4))
            out[:, pr] = src[:, at].reshape(n, t, -1)
        assert (written == 1).all() and out.min() >= 0
        outs[name] = out.astype(np.uint8)
    if luma:
        src = tiles[0].reshape(n, -1).astype(np.int64)
        h4, w4, g4 = 4 * mbh, 4 * mbw, GUARD // 4
        words = (w4 + 2 * g4) // 4
        out = np.full((n, 4 * bands, w4 + 2 * g4), -1, np.int64)
        for b in range(bands):
            pr = 4 * b + np.arange(4)
            r4 = np.clip(pr - g4, 0, h4 - 1)
            rows = (r4 >> 2) * mbw * 256 + 4 * (r4 & 3) * 16
            c4 = np.clip((4 * np.arange(words))[:, None] + np.arange(4) - g4,
                         0, w4 - 1)
            box = rows[:, None, None] + (c4 >> 2) * 256 + 4 * (c4 & 3)
            s = sum(src[:, box + 16 * i + k] for i in range(4)
                    for k in range(4))
            out[:, pr] = ((s + 8) >> 4).reshape(n, 4, -1)
        assert out.min() >= 0
        outs["y4_pad"] = out.astype(np.uint8)
    return outs


# ---------------------------------------------------------------------------
# the `down` stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(48, 64), (90, 120), (37, 51), (3, 9),
                                 (2, 2)])
def test_downsample_planes_match_jax(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    planes = [_plane(rng, h, w), _plane(rng, max(h // 2, 2), max(w // 2, 2)),
              _plane(rng, max(h // 2, 2), max(w // 2, 2))]
    got = resample.downsample_planes(*(torch.from_numpy(p) for p in planes))
    for p, g in zip(planes, got):
        want = np.asarray(jrs.downsample2x(jnp.asarray(p)))
        assert g.shape == (p.shape[0] // 2, p.shape[1] // 2)
        _eq(want, g, f"downsample_planes {p.shape}")
        _eq(want, emulate_k9(p), f"emulate_k9 {p.shape}")


# ---------------------------------------------------------------------------
# the `up` stage
# ---------------------------------------------------------------------------

# (what, base width, base height): the base picture; its MB grid and the
# enhancement's padded size follow as SvcEncoder sizes them
UP_CASES = (("a base that fills its MBs", 64, 48),
            ("120x90 in 8 x 6 MBs", 120, 90),
            ("one MB wide", 16, 40),
            ("one MB high", 40, 16),
            ("a few pixels, cropped", 12, 10))


def _up_case(case, seed=3):
    """Seeded base tiles and the sizes of one case: (tiles (3 numpy
    (bnmb, t, t)), bmbw, crops, mbw, mbh, the cropped base planes)."""
    _, bw, bh = case
    rng = np.random.default_rng(seed + bw * 7 + bh)
    bmbw, bmbh = -(-bw // 16), -(-bh // 16)
    grids = [_plane(rng, bmbh * 16, bmbw * 16)] + [
        _plane(rng, bmbh * 8, bmbw * 8) for _ in range(2)]
    crops = ((bh, bw), (bh // 2, bw // 2), (bh // 2, bw // 2))
    tiles = [_mb_tiles(g, t) for g, t in zip(grids, (16, 8, 8))]
    mbw, mbh = -(-2 * bw // 16), -(-2 * bh // 16)
    cropped = [g[:h, :w] for g, (h, w) in zip(grids, crops)]
    return tiles, bmbw, crops, mbw, mbh, cropped


def _up_jax(cropped, mbw, mbh):
    """The JAX package's chain: upsample2x_*, pad_plane, mb_tiles; the
    chroma planes guard-padded by GUARD // 2."""
    out, pads = [], []
    for plane, t, up in zip(cropped, (16, 8, 8), (
            jrs.upsample2x_luma, jrs.upsample2x_chroma,
            jrs.upsample2x_chroma)):
        padded = jwf.pad_plane(np.asarray(up(jnp.asarray(plane))),
                               mbh * t, mbw * t)
        out.append(jwf.mb_tiles(padded, t)[None])
        pads.append(np.asarray(jqp.pad_guard(jnp.asarray(padded),
                                             GUARD // 2))[None])
    return (*out, pads[1], pads[2])


@pytest.mark.parametrize("case", UP_CASES, ids=lambda c: c[0])
def test_upsample_tiles_match_jax(case):
    tiles, bmbw, crops, mbw, mbh, cropped = _up_case(case)
    want = _up_jax(cropped, mbw, mbh)
    got = resample.upsample_tiles(
        tuple(torch.from_numpy(t)[None] for t in tiles), bmbw, crops, mbw,
        mbh)
    emulated = emulate_k10(tiles, bmbw, crops, mbw, mbh)
    names = resample.UP_OUTPUTS
    for name, w, g, e in zip(names, want, got, emulated):
        _eq(w, g, f"upsample_tiles {name}")
        _eq(w, e, f"emulate_k10 {name}")


def test_k10_clamps_at_the_cropped_picture():
    """Clamped at the base's MB grid, K10 would read the padding of a
    cropped base: the emulation with that fault differs from JAX."""
    tiles, bmbw, crops, mbw, mbh, cropped = _up_case(UP_CASES[1])
    want = _up_jax(cropped, mbw, mbh)
    bad = emulate_k10(tiles, bmbw, crops, mbw, mbh, mutation="grid_clamp")
    assert not all(np.array_equal(w, b) for w, b in zip(want, bad))


def test_base_mode_symbols_take_the_planes():
    """`base_mode_symbols` with `upsample_tiles`' chroma planes equals the
    call that builds them from the tiles (`refstate.reference_chroma`)."""
    tiles, bmbw, crops, mbw, mbh, _ = _up_case(UP_CASES[1])
    *pred, u_pad, v_pad = resample.upsample_tiles(
        tuple(torch.from_numpy(t) for t in tiles), bmbw, crops, mbw, mbh)
    _eq(u_pad, refstate.reference_chroma(pred[1], pred[2], mbw, mbh)[0])
    rng = np.random.default_rng(11)
    src = [torch.from_numpy(rng.integers(0, 256, p.shape, dtype=np.uint8))
           for p in pred]
    a = svc.base_mode_symbols(*src, *pred, [30], [29], mbw, mbh)
    b = svc.base_mode_symbols(*src, *pred, [30], [29], mbw, mbh, u_pad,
                              v_pad)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# the `ref` stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L,mbw,mbh", [(1, 4, 3), (3, 4, 3), (1, 1, 6),
                                       (3, 6, 1), (1, 7, 2)])
def test_reference_planes_match_jax(L, mbw, mbh):
    rng = np.random.default_rng(L * 100 + mbw * 10 + mbh)
    tiles = [np.stack([_mb_tiles(_plane(rng, mbh * t, mbw * t), t)
                       for _ in range(L)]) for t in (16, 8, 8)]
    got = refstate.prepare_reference_plain(
        *(torch.from_numpy(t) for t in tiles), mbw, mbh)
    entry = refstate.prepare_reference(
        *(torch.from_numpy(t) for t in tiles), mbw, mbh)
    emulated = emulate_k11(tiles, mbw, mbh)
    chroma = emulate_k11(tiles[1:], mbw, mbh)
    u_pad, v_pad = refstate.reference_chroma(
        *(torch.from_numpy(t) for t in tiles[1:]), mbw, mbh)
    for i in range(L):
        want = jref.prepare_reference(*(t[i] for t in tiles), mbw, mbh)
        assert set(want) == set(got) == set(emulated) == set(entry)
        for k, v in want.items():
            _eq(v, got[k][i], f"prepare_reference_plain {k} picture {i}")
            _eq(v, entry[k][i], f"prepare_reference {k} picture {i}")
            _eq(v, emulated[k][i], f"emulate_k11 {k} picture {i}")
        for k, v in (("u_pad", u_pad), ("v_pad", v_pad)):
            _eq(want[k], v[i], f"reference_chroma {k}")
            _eq(want[k], chroma[k][i], f"emulate_k11 chroma only {k}")


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------

def test_cpu_tensors_never_reach_k9_k10_k11():
    """On the CPU the encode paths run the plain versions (no launch), and
    the wrappers refuse CPU tensors."""
    before = dict(LAUNCH_COUNTS)
    cfg = EncoderConfig(width=64, height=48, gop=10, qp=30, num_layers=2,
                        inter_layer_pred_flag=True)
    enc = svc.SvcEncoder(cfg, device="cpu")
    for f in chessboard_sequence(64, 48, 2):
        enc.encode(*f, RunConfig(qp_min=30, qp_max=30, encode_speed=2))
    assert LAUNCH_COUNTS == before
    planes = [torch.zeros((8, 8), dtype=torch.uint8)] * 3
    with pytest.raises(ValueError, match="CUDA"):
        resample.downsample_k9(*planes)
    tiles, bmbw, crops, mbw, mbh, _ = _up_case(UP_CASES[0])
    with pytest.raises(ValueError, match="CUDA"):
        resample.upsample_k10(*(torch.from_numpy(t) for t in tiles), bmbw,
                              crops, mbw, mbh)
    y = torch.zeros((1, 12, 16, 16), dtype=torch.uint8)
    c = torch.zeros((1, 12, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        refplanes.planes_k11(y, c, c, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        refplanes.planes_k11(None, c, c, 4, 3)
    assert LAUNCH_COUNTS == before


def test_the_kernels_launch_counts_exist():
    for name in ("resample_down", "resample_up", "refplanes"):
        assert name in LAUNCH_COUNTS
