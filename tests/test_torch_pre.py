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
  1 x 1, 2 x 3 and odd planes whose |cur - prev| covers 0 to 40, and the
  gains K13 is handed are GAIN_Q8.

A CUDA kernel cannot run here, so `emulate_k12` and `emulate_k13`
compute in numpy what the kernels compute, thread by thread in their
layout: K12's entry point (a launch per 64 lanes) and its blocks of 256
threads, a thread a tile row (16 luma rows x 16 MBs, or U and V each 8
rows x 16 MBs), each row loaded as 16-, 8- or 4-byte words where its
source address allows and it lies inside the plane, else byte by byte
with clamped columns, and stored in one 16- or 8-byte aligned store,
each tile byte written once; K13's blocks of 8 x 128 pixels of one
plane, d of the tile and its clamped ring in shared memory, a thread 4
pixels of a row, stored as one aligned word or bytes, each pixel written
once. Both equal the plain versions. Tolerance: exact equality (integer
arithmetic).
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

K13_THREADS, K13_TH, K13_TW = 256, 8, 128


def _denoise_pair(seed, h, w):
    """A seeded (cur, prev) pair whose |cur - prev| covers 0 to 40, with
    saturated pixels."""
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, (h, w), dtype=np.int64)
    d = rng.integers(-40, 41, (h, w))
    d.flat[:min(41, d.size)] = np.arange(min(41, d.size))
    cur = np.clip(prev + d, 0, 255)
    cur.flat[-1:] = 255
    return cur.astype(np.uint8), prev.astype(np.uint8)


def emulate_k13(cur, prev):
    """K13 on one plane: its blocks of 8 x 128 pixels, d of the tile and
    its ring (clamped into the plane) as the shared 16-bit tile, each
    thread's 4 pixels of a row from it, one aligned 4-byte store or bytes;
    every pixel written once. Returns (the plane, the store kinds)."""
    h, w = cur.shape
    c16, p16 = cur.astype(np.int64), prev.astype(np.int64)
    out = np.full(h * w, -1, np.int64)
    writes = np.zeros(h * w, np.int64)
    gain = np.asarray(denoise.gain_words())
    kinds = set()
    for by in range(-(-h // K13_TH)):
        for bx in range(-(-w // K13_TW)):
            y0, x0 = by * K13_TH, bx * K13_TW
            i = np.arange((K13_TH + 2) * (K13_TW + 2))
            r, c = i // (K13_TW + 2), i % (K13_TW + 2)
            gy = np.clip(y0 - 1 + r, 0, h - 1)
            gx = np.clip(x0 - 1 + c, 0, w - 1)
            sd = (c16[gy, gx] - p16[gy, gx]).reshape(K13_TH + 2, K13_TW + 2)
            assert np.abs(sd).max() < 1 << 15          # int16 holds it
            for tid in range(K13_THREADS):
                ty, tx = tid >> 5, 4 * (tid & 31)
                y, x = y0 + ty, x0 + tx
                if y >= h or x >= w:
                    continue
                n = min(4, w - x)
                for k in range(n):
                    rr, cc = ty + 1, tx + k + 1
                    d = sd[rr, cc]
                    act = (abs(sd[rr - 1, cc]) + abs(sd[rr + 1, cc])
                           + abs(sd[rr, cc - 1]) + abs(sd[rr, cc + 1])
                           + 2) >> 2
                    g = gain[min(max(abs(d), act), 31)]
                    o = y * w + x + k
                    out[o] = min(max(c16[y, x + k] - ((d * g) >> 8), 0), 255)
                    writes[o] += 1
                kinds.add("word" if n == 4 and (y * w + x) % 4 == 0
                          else "bytes")
    assert (writes == 1).all()
    return out.reshape(h, w).astype(np.uint8), kinds


DENOISE_SIZES = ((1, 1), (2, 3), (3, 2), (9, 130), (17, 33), (37, 51),
                 (20, 256))


@pytest.mark.parametrize("h,w", DENOISE_SIZES)
def test_denoise_planes_equal_jax(h, w):
    ch, cw = max(h // 2, 1), max(w // 2, 1)
    pairs = [_denoise_pair(h * 100 + w + k, *s)
             for k, s in enumerate(((h, w), (ch, cw), (ch, cw)))]
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


@pytest.mark.parametrize("h,w", DENOISE_SIZES)
def test_emulate_k13_equals_plain(h, w):
    cur, prev = _denoise_pair(h * 7 + w, h, w)
    got, kinds = emulate_k13(cur, prev)
    want = denoise.denoise_plane(torch.from_numpy(cur),
                                 torch.from_numpy(prev)).numpy()
    np.testing.assert_array_equal(got, want)
    if w % 4 == 0:
        assert kinds == {"word"}


def test_k13_gains_are_gain_q8():
    """K13 reads the port's GAIN_Q8, which equals the JAX package's."""
    assert denoise.gain_words() == [int(g) for g in denoise.GAIN_Q8]
    assert denoise.gain_words() == [int(g) for g in jdn.GAIN_Q8]
    assert len(denoise.gain_words()) == 32
    sizes = denoise._plan(((4, 4), (2, 2), (2, 2)))[4]
    assert sizes[6:] == denoise.gain_words()
