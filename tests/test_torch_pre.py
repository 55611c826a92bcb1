"""The `pre` stage (the upload, padding and tiling of the source planes)
and the temporal denoise: the plain versions and the index math of their
CUDA kernels K12 (`csrc/pretile.cu`) and K13 (`csrc/denoise.cu`),
emulated on the CPU, against the JAX package.

- `FrameStages.tiles` (the `pre` stage: `stages.Staging`, then
  `stages.source_tiles`, on CPU tensors `source_tiles_plain`) equals the
  JAX package's `wavefront.pad_plane` of each plane followed by the
  tiling of `pre_fn` (`h264lab_tpu/parallel/gop.py:94-106`): on 1080-row
  crops, a width that is no multiple of 16, two bands, a mesh block of
  bands (the block's rows, as `GopBandEncoder._shard_frames` cuts them),
  from numpy planes and from tensors;
- one `Staging` reused over three steps whose inputs differ (and grow)
  gives each step's own planes, leaves the planes it returned before
  untouched, alternates its two staging buffers and grows them together,
  with its host copies on one thread and on three;
- `denoise.denoise_planes` equals JAX's `denoise_plane` of each plane on
  1 x 1, 2 x 3, 1 x 17 and odd planes up to 33 x 1000 whose
  |cur - prev| covers 0 to 40, and the gains K13 is handed are GAIN_Q8.

A CUDA kernel cannot run here, so `emulate_k12` and `emulate_k13`
compute in numpy what the kernels compute, thread by thread in their
layout: K12's entry point (a launch per 64 lanes) and its blocks of 256
threads, a thread a tile row (16 luma rows x 16 MBs, or U and V each 8
rows x 16 MBs), each row loaded as 16-, 8- or 4-byte words where its
source address allows and it lies inside the plane, else byte by byte
with clamped columns, and stored in one 16- or 8-byte aligned store,
each tile byte written once; K13's one grid over the three planes' live
tiles (a warp a tile of 4 rows x 512 columns, four warps a block, no
block without a tile), a lane a strip of 16 columns marching down the
tile's rows with a one-row halo, 16-byte loads and stores where the
addresses and the width allow, else bytes, the horizontal neighbours by
shuffles and the edge lanes' loads of the columns beside the tile; every
pixel written once, and each byte of cur and prev loaded once by each
tile that covers it (halo included) and by no other. Both equal the
plain versions. Tolerance: exact equality (integer arithmetic).
"""

import numpy as np
import pytest
import torch

from h264lab_tpu.models import wavefront as jwf
from h264lab_tpu.ops import denoise as jdn
from h264lab_tpu.parallel import gop as jgop
from h264lab_tpu_torch.models import stages
from h264lab_tpu_torch.ops import denoise, pretile

CPU = torch.device("cpu")
TILE = (16, 8, 8)


def _frames(seed, n, w, h):
    """n seeded (y, u, v) numpy frames of w x h, 0 and 255 on the borders."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = []
        for ph, pw in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
            p = rng.integers(0, 256, (ph, pw), dtype=np.uint8)
            p[0], p[-1] = 0, 255
            p[:, -1] = 7
            f.append(p)
        out.append(tuple(f))
    return out


def _jax_tiles(frames, mbw, mbh, n_bands):
    """JAX's `pre`: `pad_plane` to the padded size, then `pre_fn`'s tiling
    into (G * B, nmb_band, t, t)."""
    rows = mbh // n_bands
    fns = jgop._gop_stage_fns(mbw, rows, n_bands, False, True, False, True)
    padded = [np.stack([jwf.pad_plane(f[p], mbh * t, mbw * t)
                        for f in frames]) for p, t in enumerate(TILE)]
    return [np.asarray(x).reshape((-1, rows * mbw, t, t))
            for x, t in zip(fns.pre(*padded), TILE)]


# (what, w, h, lanes, bands, mesh band axis)
PRE_CASES = (
    ("1080-row crop", 64, 1080, 2, 1, 1),
    ("width 70, no multiple of 16", 70, 40, 3, 1, 1),
    ("two bands", 48, 64, 2, 2, 1),
    ("a mesh block of bands", 64, 90, 2, 6, 2),
)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("case", PRE_CASES, ids=[c[0] for c in PRE_CASES])
def test_pre_tiles_equal_jax(case, kind):
    what, w, h, lanes, bands, n_band = case
    mbw, mbh = -(-w // 16), -(-h // 16)
    frames = _frames(len(what), lanes, w, h)
    want = _jax_tiles(frames, mbw, mbh, bands)
    bl, rows = bands // n_band, mbh // bands
    for j in range(n_band):
        # the block's rows, as `GopBandEncoder._shard_frames` cuts them
        y0, n = j * bl * rows, bl * rows
        block = [tuple(p[y0 * t:(y0 + n) * t] for p, t in zip(f, TILE))
                 for f in frames]
        if kind == "tensor":
            block = [tuple(torch.from_numpy(np.ascontiguousarray(p))
                           for p in f) for f in block]
        st = stages.FrameStages(CPU, mbw, n)
        got = st.tiles(block)
        for g, wt, t in zip(got, want, TILE):
            g = g.reshape(lanes * bl, rows * mbw, t, t).numpy()
            w_blk = wt.reshape(lanes, bands, -1, t, t)[:, j * bl:(j + 1) * bl]
            np.testing.assert_array_equal(g, w_blk.reshape(g.shape))


@pytest.mark.parametrize("threads", [1, 3])
def test_staging_reused_over_three_steps(threads):
    """A Staging's two buffers alternate over steps whose inputs differ
    (the third larger, so both buffers grow): every step's planes are its
    own, and the planes an earlier step returned stay as they were; with
    its host copies on one thread or on three."""
    st = stages.FrameStages(CPU, 5, 3)
    staging = st.staging
    staging.threads = threads
    staging.PARALLEL_BYTES = 0
    kept, slots = [], []
    for step, (w, h) in enumerate(((70, 40), (70, 40), (80, 48))):
        frames = _frames(100 + step, 2, w, h)
        slots.append(staging._next)
        planes = staging.upload(frames)
        kept.append((frames, planes))
        tiles = stages.source_tiles(tuple(zip(*planes)), 5, 3)
        want = _jax_tiles(frames, 5, 3, 1)
        for g, wt in zip(tiles, want):
            np.testing.assert_array_equal(g.numpy(), wt)
    assert slots == [0, 1, 0]
    assert len({h.numel() for h in staging._host}) == 1
    for frames, planes in kept:
        for f, p in zip(frames, planes):
            for a, b in zip(f, p):
                np.testing.assert_array_equal(b.numpy(), a)
                assert b.is_contiguous() and b.data_ptr() % 16 == 0


def test_staging_takes_tensors_as_they_are():
    """Tensors on the staging's device are not copied; numpy planes of
    another dtype are cast as `np.asarray(x, np.uint8)` casts."""
    staging = stages.Staging(CPU)
    y = torch.arange(12, dtype=torch.uint8).reshape(3, 4)
    u = np.arange(2, dtype=np.int64).reshape(1, 2) + 250
    v = np.full((1, 2), 3, np.uint8)
    (gy, gu, gv), = staging.upload([(y, u, v)])
    assert gy is y
    np.testing.assert_array_equal(gu.numpy(), u.astype(np.uint8))
    np.testing.assert_array_equal(gv.numpy(), v)
    with pytest.raises(ValueError):
        staging.upload([(y, u[0], v)])


# ---------------------------------------------------------------------------
# K12's index math
# ---------------------------------------------------------------------------

K12_THREADS, K12_MBS, K12_MAX_LANES = 256, 16, 64


def _k12_row(flat, addr, start, x0, w0, t, paths):
    """One tile row as `tile_row<t>` loads it: (row bytes, path taken)."""
    a = addr + start + x0
    if x0 + t <= w0:
        for width in ((16, 8, 4) if t == 16 else (8, 4)):
            if a % width == 0:
                paths.add(width)
                return flat[start + x0:start + x0 + t]
    paths.add(1)
    return flat[start + np.minimum(x0 + np.arange(t), w0 - 1)]


def emulate_k12(planes, mbw, mbh, addrs=None, pitches=None):
    """K12 on planes (Y, U, V, each G 2-D uint8 numpy planes of one
    shape): the entry point's launches of at most 64 lanes, each block of
    256 threads thread by thread, each source plane at the emulated
    address `addrs[p][g]` with row pitch `pitches[p][g]` (its rows read
    from a buffer of that pitch). Returns (the three (G, nmb, t, t)
    outputs, the load widths taken)."""
    n = len(planes[0])
    addrs = addrs or [[0] * n] * 3
    pitches = pitches or [[x.shape[1] for x in lanes] for lanes in planes]
    bufs = []
    for lanes, pl in zip(planes, pitches):
        row = []
        for x, pitch in zip(lanes, pl):
            b = np.zeros((x.shape[0], pitch), np.uint8)
            b[:, :x.shape[1]] = x
            row.append(b.reshape(-1))
        bufs.append(row)
    outs = [np.full(n * mbh * mbw * t * t, -1, np.int64) for t in TILE]
    writes = [np.zeros_like(o) for o in outs]
    paths = set()
    for g0 in range(0, n, K12_MAX_LANES):
        lanes = min(K12_MAX_LANES, n - g0)
        for bz in range(2):
            for by in range(lanes * mbh):
                lane, r = divmod(by, mbh)
                for bx in range(-(-mbw // K12_MBS)):
                    for tid in range(K12_THREADS):
                        if bz == 0:
                            p, c, y = 0, bx * K12_MBS + (tid & 15), tid >> 4
                        else:
                            p, q = 1 + (tid >> 7), tid & 127
                            c = bx * K12_MBS + ((q & 7) | ((q >> 2) & 8))
                            y = ((q >> 3) & 3) | ((q >> 4) & 4)
                        if c >= mbw:
                            continue
                        t = TILE[p]
                        g = g0 + lane
                        h0, w0 = planes[p][g].shape
                        sy = min(t * r + y, h0 - 1)
                        data = _k12_row(bufs[p][g], addrs[p][g],
                                        sy * pitches[p][g], t * c, w0, t,
                                        paths)
                        at = ((g0 * mbh + by) * mbw + c) * t * t + t * y
                        assert at % t == 0     # the 16- or 8-byte store
                        outs[p][at:at + t] = data
                        writes[p][at:at + t] += 1
    assert all((w == 1).all() for w in writes)
    return [o.reshape(n, -1, t, t).astype(np.uint8)
            for o, t in zip(outs, TILE)], paths


def _plain(planes, mbw, mbh):
    return [x.numpy() for x in stages.source_tiles_plain(
        tuple(tuple(torch.from_numpy(p) for p in lanes) for lanes in planes),
        mbw, mbh)]


def _planes(seed, n, shapes):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 256, s, dtype=np.uint8) for _ in range(n)]
            for s in shapes]


# (what, lanes, (h, w) of Y, U, V, mbw, mbh, address offsets, pitch pad)
K12_CASES = (
    ("aligned 3 x 2 MBs", 2, ((32, 48), (16, 24), (16, 24)), 3, 2, 0, 0),
    ("cropped 70 x 40, odd address", 1, ((40, 70), (20, 35), (20, 35)), 5,
     3, 1, 0),
    ("8-byte rows", 2, ((16, 40), (8, 20), (8, 20)), 3, 1, 8, 0),
    ("odd pitch", 1, ((20, 33), (10, 17), (10, 17)), 3, 2, 0, 3),
    ("4-byte pitch", 1, ((16, 36), (8, 18), (8, 18)), 3, 1, 4, 0),
    ("a pixel", 3, ((1, 1), (1, 1), (1, 1)), 1, 1, 0, 0),
    ("larger than padded", 1, ((40, 40), (20, 20), (20, 20)), 2, 2, 0, 0),
    ("17 MBs wide", 1, ((16, 272), (8, 136), (8, 136)), 17, 1, 0, 0),
    ("past 64 lanes", 66, ((16, 16), (8, 8), (8, 8)), 1, 1, 0, 0),
)


@pytest.mark.parametrize("case", K12_CASES, ids=[c[0] for c in K12_CASES])
def test_emulate_k12_equals_plain(case):
    what, n, shapes, mbw, mbh, offset, pad = case
    planes = _planes(len(what), n, shapes)
    addrs = [[16 * g + offset for g in range(n)]] * 3
    pitches = [[s[1] + pad] * n for s in shapes]
    got, paths = emulate_k12(planes, mbw, mbh, addrs, pitches)
    for g, w in zip(got, _plain(planes, mbw, mbh)):
        np.testing.assert_array_equal(g, w)
    if what.startswith("aligned"):
        assert paths == {16, 8}          # luma 16 bytes, chroma 8
    if "odd" in what:
        assert 1 in paths


def test_k12_and_k13_refuse_cpu_tensors():
    y = torch.zeros((16, 16), dtype=torch.uint8)
    u = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError):
        pretile.tiles_k12(((y,), (u,), (u,)), 1, 1)
    with pytest.raises(ValueError):
        denoise.denoise_k13(y, u, u, y, u, u)


# ---------------------------------------------------------------------------
# the temporal denoise and K13's index math
# ---------------------------------------------------------------------------

# K13's schedule, as `csrc/denoise.cu` sets it (checked against the source)
K13_ROWS, K13_WARPS, K13_STRIP = 4, 4, 16
K13_TILE_W = 32 * K13_STRIP


def _denoise_pair(seed, h, w, spread=40):
    """A seeded (cur, prev) pair whose |cur - prev| covers 0 to `spread`
    (and 0 to 40), with saturated pixels."""
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, (h, w), dtype=np.int64)
    d = rng.integers(-spread, spread + 1, (h, w))
    d.flat[:min(41, d.size)] = np.arange(min(41, d.size))
    cur = np.clip(prev + d, 0, 255)
    cur.flat[-1:] = 255
    return cur.astype(np.uint8), prev.astype(np.uint8)


def _frame_pairs(seed, h, w, spread=40):
    """(cur, prev) pairs of a frame's three planes: (h, w) and two chroma
    planes of half its size."""
    ch, cw = max(h // 2, 1), max(w // 2, 1)
    return [_denoise_pair(seed + k, *s, spread)
            for k, s in enumerate(((h, w), (ch, cw), (ch, cw)))]


def k13_grid(shapes):
    """K13's one grid over the three planes' live tiles (a warp a tile of
    K13_ROWS x 512 pixels, K13_WARPS a block), as its entry point sets it:
    each plane's tile columns, the prefix sum of the tiles, the blocks."""
    cols, first = [], [0]
    for h, w in shapes:
        c = -(-w // K13_TILE_W)
        cols.append(max(c, 1))
        first.append(first[-1] + (c * -(-h // K13_ROWS) if h and w else 0))
    return cols, first, -(-first[3] // K13_WARPS)


def _strip_load(plane, addr, o, n, counts, kinds):
    """`load_strip`: a strip's 16 bytes at element o of a flat plane whose
    first byte lies at `addr`, n of them inside the row: one 16-byte load
    where aligned and n is 16, else the n bytes one by one, the rest
    repeating the last."""
    if n == K13_STRIP and (addr + o) % 16 == 0:
        kinds.add("load16")
        counts[o:o + 16] += 1
        return plane[o:o + 16].copy()
    kinds.add("load bytes")
    counts[o:o + n] += 1
    v = plane[o:o + n]
    return np.concatenate([v, np.full(K13_STRIP - n, v[-1])])


def _u32(x):
    return (np.asarray(x, np.int64) & 0xffffffff).astype(np.uint32)


def _byte_perm(x, y, s):
    """CUDA's `__byte_perm`: byte j of the result is byte (s >> 4 j) & 7
    of the eight bytes of (y, x), x's first."""
    b = (_u32(y).astype(np.uint64) << np.uint64(32)) | _u32(x)
    out = np.zeros(np.shape(b), np.uint64)
    for j in range(4):
        sel = np.uint64(8 * ((s >> (4 * j)) & 7))
        out |= ((b >> sel) & np.uint64(0xff)) << np.uint64(8 * j)
    return out.astype(np.uint32)


def _lanes(x, width, n):
    """x's n unsigned lanes of `width` bits, low first (last axis)."""
    x = np.asarray(x, np.int64)
    return np.stack([(x >> (width * j)) & ((1 << width) - 1)
                     for j in range(n)], axis=-1)


def _join(v, width):
    return _u32(sum(v[..., j] << (width * j) for j in range(v.shape[-1])))


def _vabsdiffu4(a, b):
    return _join(np.abs(_lanes(a, 8, 4) - _lanes(b, 8, 4)), 8)


def _vmaxu2(a, b):
    return _join(np.maximum(_lanes(a, 16, 2), _lanes(b, 16, 2)), 16)


def _vminu2(a, b):
    return _join(np.minimum(_lanes(a, 16, 2), _lanes(b, 16, 2)), 16)


def _dp2a(a, b, hi):
    """PTX `dp2a.lo` / `.hi` with `.s32.u32` and an addend of 255: a's two
    signed 16-bit halves times b's bytes 0, 1 (lo) or 2, 3 (hi)."""
    h = _lanes(a, 16, 2)
    h = np.where(h >= 1 << 15, h - (1 << 16), h)
    bb = _lanes(b, 8, 4)
    return _u32(h[..., 0] * bb[..., 2 * hi] + h[..., 1] * bb[..., 2 * hi + 1]
                + 255)


def _words(b):
    """(..., 16) bytes as (..., 4) little-endian words."""
    return _join(np.asarray(b, np.int64).reshape(b.shape[:-1] + (4, 4)), 8)


def _bytes(w):
    return _lanes(w, 8, 4).reshape(w.shape[:-1] + (16,))


def _shfl(v, src):
    """A warp's `__shfl_up_sync` / `__shfl_down_sync` by one: each lane
    reads lane `src`, or its own value where that lies past the warp."""
    src = np.where((src < 0) | (src > 31), np.arange(32), src)
    return v[src].copy()


def emulate_k13(curs, prevs, addrs=(0,) * 9):
    """K13 on a frame's three planes, warp by warp in its schedule: the 1-D
    grid over the planes' live tiles (`k13_grid`; no block without one),
    a lane a strip of 16 columns of a tile's K13_ROWS rows and the
    one-row halo above and below (rows inside the plane), all by 16-byte
    loads where the strip's every row is aligned (`addrs`: the byte
    address mod 16 of cur Y, U, V, prev Y, U, V, out Y, U, V), else row by
    row (`_strip_load`); lane 0 the byte left of the tile and lane 31 the
    one right of it; a missing row's |d| the nearest row's; the march with
    the strip's horizontal neighbours from the next lanes (a shuffle up
    and down: a lane past the warp's end reads its own) and the gain from
    the lane that holds it; the 16 pixels in one 16-byte store or byte by
    byte. Every pixel is written once; each byte of cur and prev is
    loaded once by each tile whose rows and columns, halo and edge
    columns included, cover it, and by no other. Returns (the three
    planes, the load and store kinds)."""
    shapes = [c.shape for c in curs]
    cols, first, blocks = k13_grid(shapes)
    gain = np.asarray(denoise.gain_words(), np.int64)
    assert ((gain >= 0) & (gain <= 256)).all()  # the entry point's range
    pairs = _u32((256 - gain) | gain << 16)     # lane i's gain pair
    flat = [[x.reshape(-1).astype(np.int64) for x in xs]
            for xs in (curs, prevs)]
    outs = [np.full(c.size, -1, np.int64) for c in curs]
    writes = [np.zeros(c.size, np.int64) for c in curs]
    loads = [[np.zeros(c.size, np.int64) for c in curs] for _ in range(2)]
    expect = [np.zeros(c.shape, np.int64) for c in curs]
    kinds = set()
    lanes = np.arange(32)
    for b in range(blocks):
        live = [t for t in range(b * K13_WARPS, (b + 1) * K13_WARPS)
                if t < first[3]]
        assert live, f"block {b} holds no tile"
        for t in live:
            p = 0 if t < first[1] else 1 if t < first[2] else 2
            h, w = shapes[p]
            ty, tx = divmod(t - first[p], cols[p])
            y0 = ty * K13_ROWS
            x0 = tx * K13_TILE_W + K13_STRIP * lanes
            n = np.minimum(K13_STRIP, w - x0)
            expect[p][max(y0 - 1, 0):y0 + K13_ROWS + 1,
                      max(tx * K13_TILE_W - 1, 0):
                      (tx + 1) * K13_TILE_W + 1] += 1
            ex = np.where(lanes == 0, x0 - 1, x0 + K13_STRIP)
            edge = ((lanes == 0) | (lanes == 31)) & (ex >= 0) & (ex < w)
            rows = K13_ROWS + 2
            c = np.zeros((rows, 32, K13_STRIP), np.int64)
            q = np.zeros_like(c)
            ec = np.zeros((rows, 32), np.int64)
            eq = np.zeros_like(ec)
            for lane in range(32):
                wide = (n[lane] == K13_STRIP and w % 16 == 0
                        and (addrs[p] + x0[lane]) % 16 == 0
                        and (addrs[3 + p] + x0[lane]) % 16 == 0)
                for i in range(rows):
                    y = y0 - 1 + i
                    if not 0 <= y < h:
                        continue
                    o = y * w + x0[lane]
                    if wide:
                        kinds.add("load16")
                        for src, cnt, dst in ((flat[0][p], loads[0][p], c),
                                              (flat[1][p], loads[1][p], q)):
                            dst[i, lane] = src[o:o + 16]
                            cnt[o:o + 16] += 1
                    elif n[lane] > 0:
                        c[i, lane] = _strip_load(flat[0][p], addrs[p], o,
                                                 n[lane], loads[0][p], kinds)
                        q[i, lane] = _strip_load(flat[1][p], addrs[3 + p], o,
                                                 n[lane], loads[1][p], kinds)
                    if edge[lane]:
                        e = y * w + ex[lane]
                        ec[i, lane], eq[i, lane] = flat[0][p][e], flat[1][p][e]
                        loads[0][p][e] += 1
                        loads[1][p][e] += 1
            # the march in 16-bit pairs, as the kernel writes it; a row
            # above or below the plane takes the nearest row's |d|
            cw, qw = _words(c), _words(q)
            ad = _vabsdiffu4(cw, qw)
            lo, hi = _byte_perm(ad, 0, 0x4240), _byte_perm(ad, 0, 0x4341)
            for i in range(1, K13_ROWS + 1):
                y = y0 - 1 + i
                if y >= h:
                    break
                up = i if y == 0 else i - 1
                dn = i if y + 1 >= h else i + 1
                ulo, uhi, mlo, mhi = lo[up], hi[up], lo[i], hi[i]
                dlo, dhi = lo[dn], hi[dn]
                left = _shfl(mhi[:, 3], lanes - 1)
                right = _shfl(mlo[:, 0], lanes + 1)
                e = np.abs(ec[i] - eq[i]).astype(np.uint32)
                left[0] = (e[0] if edge[0] else mlo[0, 0] & 0xffff) << 16
                right[31] = e[31]
                right = np.where(x0 + K13_STRIP >= w, mhi[:, 3] >> 16, right)
                wd = np.zeros((32, 4), np.uint32)
                for k in range(4):
                    lft = _byte_perm(mhi[:, k - 1] if k else left, mhi[:, k],
                                     0x5432)
                    rgt = _byte_perm(mlo[:, k], mlo[:, k + 1] if k < 3
                                     else right, 0x5432)
                    act_lo = _u32((ulo[:, k] + dlo[:, k] + lft + mhi[:, k]
                                   + 0x00020002) >> 2) & 0x3fff3fff
                    act_hi = _u32((uhi[:, k] + dhi[:, k] + mlo[:, k] + rgt
                                   + 0x00020002) >> 2) & 0x3fff3fff
                    i_lo = _vminu2(_vmaxu2(mlo[:, k], act_lo), 0x001f001f)
                    i_hi = _vminu2(_vmaxu2(mhi[:, k], act_hi), 0x001f001f)
                    g = [pairs[x & 31] for x in (i_lo, i_hi, i_lo >> 16,
                                                 i_hi >> 16)]   # shuffles
                    b01 = _byte_perm(cw[i, :, k], qw[i, :, k], 0x5140)
                    b23 = _byte_perm(cw[i, :, k], qw[i, :, k], 0x7362)
                    t01 = _byte_perm(_dp2a(g[0], b01, 0), _dp2a(g[1], b01, 1),
                                     0x0051)
                    t23 = _byte_perm(_dp2a(g[2], b23, 0), _dp2a(g[3], b23, 1),
                                     0x5100)
                    wd[:, k] = _byte_perm(t01, t23, 0x7610)
                v = _bytes(wd)
                for lane in np.flatnonzero(n > 0):
                    o, m = y * w + x0[lane], n[lane]
                    kinds.add("store16" if m == K13_STRIP
                              and (addrs[6 + p] + o) % 16 == 0
                              else "store bytes")
                    outs[p][o:o + m] = v[lane, :m]
                    writes[p][o:o + m] += 1
    for p, (h, w) in enumerate(shapes):
        assert (writes[p] == 1).all()
        for cnt in loads:
            np.testing.assert_array_equal(cnt[p].reshape(h, w), expect[p])
        assert expect[p].max() <= 4          # one halo row and column a side
    return [o.reshape(s).astype(np.uint8) for o, s in zip(outs, shapes)], kinds


DENOISE_SIZES = ((1, 1), (2, 3), (3, 2), (9, 130), (17, 33), (37, 51),
                 (20, 256), (1, 17), (33, 1000))


@pytest.mark.parametrize("h,w", DENOISE_SIZES)
def test_denoise_planes_equal_jax(h, w):
    pairs = _frame_pairs(h * 100 + w, h, w)
    got = denoise.denoise_planes(
        tuple(torch.from_numpy(c) for c, _ in pairs),
        tuple(torch.from_numpy(p) for _, p in pairs))
    for g, (c, p) in zip(got, pairs):
        want = np.asarray(jdn.denoise_plane(c, p))
        np.testing.assert_array_equal(g.numpy(), want)
        assert g.dtype == torch.uint8
    # the gains are exercised: some pixels blend, some do not
    c, p = pairs[0]
    moved = got[0].numpy() != c
    if c.size > 40:
        assert moved.any() and (~moved & (c != p)).any()


def _plain_frame(pairs):
    return [denoise.denoise_plane(torch.from_numpy(c),
                                  torch.from_numpy(p)).numpy()
            for c, p in pairs]


@pytest.mark.parametrize("h,w", DENOISE_SIZES)
def test_emulate_k13_equals_plain(h, w):
    pairs = _frame_pairs(h * 7 + w, h, w)
    got, kinds = emulate_k13([c for c, _ in pairs], [p for _, p in pairs])
    for g, want in zip(got, _plain_frame(pairs)):
        np.testing.assert_array_equal(g, want)
    if w % 32 == 0:                      # every plane's width divides by 16
        assert kinds == {"load16", "store16"}
    if w % 16:
        assert {"load bytes", "store bytes"} <= kinds


@pytest.mark.parametrize("h,w", [(17, 1536), (24, 1100)])
def test_emulate_k13_across_tile_edges(h, w):
    """Planes of two and three tile columns whose |cur - prev| is mostly
    below 6, so that the activity across a tile's left and right edges
    (the edge lanes' loads) sets many gains."""
    pairs = _frame_pairs(h + w, h, w, spread=5)
    got, _ = emulate_k13([c for c, _ in pairs], [p for _, p in pairs])
    for g, want in zip(got, _plain_frame(pairs)):
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("addrs", [(1, 0, 0, 0, 0, 0, 0, 0, 0),
                                   (0, 8, 0, 3, 0, 0, 0, 0, 0),
                                   (0, 0, 0, 0, 0, 0, 0, 5, 0)])
def test_emulate_k13_takes_bytes_at_unaligned_addresses(addrs):
    """A plane at an address that is no multiple of 16 takes the byte path
    for its loads (cur or prev) or its stores (out) and is still right;
    the other planes keep their 16-byte loads and stores."""
    pairs = _frame_pairs(5, 18, 64)
    got, kinds = emulate_k13([c for c, _ in pairs], [p for _, p in pairs],
                             addrs)
    for g, want in zip(got, _plain_frame(pairs)):
        np.testing.assert_array_equal(g, want)
    assert {"load16", "store16"} <= kinds
    assert ("load bytes" in kinds) == any(addrs[:6])
    assert ("store bytes" in kinds) == any(addrs[6:])


@pytest.mark.parametrize("h,w,tiles", [(1088, 1920, (1088, 272, 272)),
                                       (1080, 1920, (1080, 270, 270)),
                                       (288, 352, (72, 36, 36)),
                                       (64, 96, (16, 8, 8))])
def test_k13_grid_holds_only_live_tiles(h, w, tiles):
    """K13's grid at 1080p, CIF and the card tests' 96 x 64: the planes'
    tiles back to back, every block a live tile, at most the last block's
    spare warps idle (a grid sized by the luma plane for all three would
    leave about half its blocks empty)."""
    cols, first, blocks = k13_grid(((h, w), (h // 2, w // 2),
                                    (h // 2, w // 2)))
    assert tuple(np.diff(first)) == tiles
    assert 0 <= blocks * K13_WARPS - first[3] < K13_WARPS


def test_k13_emulation_follows_the_source():
    """The emulation's tile sizes are the kernel's."""
    import re
    src = denoise.SRC.read_text()
    assert re.search(rf"constexpr int kRows = {K13_ROWS}, "
                     rf"kWarps = {K13_WARPS};", src)
    assert f"constexpr int kStrip = {K13_STRIP};" in src
    assert "constexpr int kTileW = 32 * kStrip;" in src


def test_k13_gains_are_gain_q8():
    """K13 reads the port's GAIN_Q8, which equals the JAX package's."""
    assert denoise.gain_words() == [int(g) for g in denoise.GAIN_Q8]
    assert denoise.gain_words() == [int(g) for g in jdn.GAIN_Q8]
    assert len(denoise.gain_words()) == 32
    sizes = denoise._plan(((4, 4), (2, 2), (2, 2)))[4]
    assert sizes[6:] == denoise.gain_words()
