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
  bases (120x90 in 8 x 6 MBs, one a few pixels wide and high, crops that
  end inside a tile across and down), one MB, one MB wide and one MB high,
  18 MBs wide (K10's chunks of 8 cut short) and an enhancement past twice
  its base;
- `refstate.prepare_reference_plain` equals JAX's `prepare_reference` at
  L = 1 and 3 pictures, and `refstate.reference_chroma` its chroma planes.
Inputs are seeded numpy planes with 0 and 255 borders and flat patches.

A CUDA kernel cannot run here, so `emulate_k9`, `emulate_k10` and
`emulate_k11` compute in numpy what the kernels compute, thread by
thread in their layout: K9 block by block, a thread per 16 output bytes
of a row, on its 16-byte path (where the plane's width divides by 32 and
its addresses by 16: four 16-byte loads as words, the boxes two to a
word, a byte permute, one 16-byte store) or byte by byte, each output
byte written once; K10 block by block, a chunk of 8 enhancement MBs of
one MB row, its bulk copies (16-byte aligned: at most two base MB rows
of 6 tiles a plane, the halo included), its vertical pass into shared
16-bit rows (a word of 4 columns of a pair of rows an item, the columns
clamped into the cropped picture, the luma biased), each luma tile row
one 16-byte store and each chroma tile row one 8-byte store, the pixels
past the crop repeating the row's last, the padded chroma rows by K11's
writers; K11 block by block, a chunk of 16 MBs of one MB row, its tiles
bulk-copied (16-byte aligned, each tile byte once), its bands of every
plane (the 4 guard bands on the first and last row's blocks, the ring on
the first and last chunk) written item by item in the kernel's thread
map, in stores of the width each pitch allows, none across a row, each
output byte once, the pyramid through a shared row-major copy. Every
warp's shared reads (and K10's writes) are asserted free of bank
conflicts. Each equals the JAX functions array for array; K10 clamped at
the base's MB grid in place of its picture, or reading its halo past the
crop, fails on a cropped base; K10's and K11's tiles at a 4-byte aligned
address fail their bulk copies. Tolerance: exact equality (integer
arithmetic).
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

K9_BLOCK = (32, 8)               # K9's block: 16-byte columns x rows


def _words(b):
    """(..., 4 k) uint8 -> (..., k) little-endian uint32 words."""
    b = b.astype(np.uint32).reshape(b.shape[:-1] + (b.shape[-1] // 4, 4))
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _down_pair(a, b):
    """K9's `down_pair`: the 2x2 boxes of input words a (above) and b, two
    16-bit lanes."""
    lo = np.uint32(0x00ff00ff)
    s = (a & lo) + ((a >> 8) & lo) + (b & lo) + ((b >> 8) & lo) + np.uint32(
        0x00020002)
    return (s >> 2) & lo


def _byte_perm_6420(x, y):
    """`__byte_perm(x, y, 0x6420)`: bytes 0 and 2 of x, then of y."""
    return ((x & 0xff) | ((x >> 16) & 0xff) << 8 | (y & 0xff) << 16
            | ((y >> 16) & 0xff) << 24)


def emulate_k9(planes, addrs=((0, 0),) * 3):
    """K9's launch on three (h, w) uint8 planes, block by block, thread by
    thread: the grid the entry point sizes from the largest plane, a
    thread per 16 output bytes of one row (plane on the grid's third
    axis). A plane whose input width is a multiple of 32 and whose input
    and output addresses (`addrs`, (in, out) per plane) are 16-byte
    aligned takes the 16-byte path: four 16-byte loads of two 32-byte
    runs of two rows as words, the boxes two to a word (`_down_pair`),
    `__byte_perm` and one 16-byte store, each address asserted aligned;
    any other plane the byte-wise path. Every output byte is asserted
    written once. Returns (the three outputs, the paths taken)."""
    sizes = [(h // 2, w // 2) for h, w in (p.shape for p in planes)]
    live = [(oh, ow) for oh, ow in sizes if oh and ow]
    rows = max(oh for oh, _ in live)
    groups = max(-(-ow // 16) for _, ow in live)
    bx_n, by_n = -(-groups // K9_BLOCK[0]), -(-rows // K9_BLOCK[1])
    ty, tx = np.meshgrid(np.arange(K9_BLOCK[1]), np.arange(K9_BLOCK[0]),
                         indexing="ij")
    outs, paths = [], []
    for plane, (oh, ow), (a_in, a_out) in zip(planes, sizes, addrs):
        iw = plane.shape[1]
        flat = plane.reshape(-1)
        vec = iw % 32 == 0 and (a_in | a_out) % 16 == 0
        paths.append("16-byte" if vec else "byte-wise")
        out = np.full(oh * ow, -1, np.int64)
        writes = np.zeros(oh * ow, np.int64)
        for by in range(by_n):
            for bx in range(bx_n):
                r = (by * K9_BLOCK[1] + ty).ravel()
                c = 16 * (bx * K9_BLOCK[0] + tx).ravel()
                ok = (r < oh) & (c < ow)
                r, c = r[ok], c[ok]
                if not len(r):
                    continue
                s = 2 * r * iw + 2 * c
                o = r * ow + c
                if vec:
                    assert ((a_in + s) % 16 == 0).all()
                    assert ((a_out + o) % 16 == 0).all() and (c + 16 <= ow).all()
                    x0, x1, y0, y1 = (_words(flat[(s + d)[:, None]
                                                  + np.arange(16)])
                                      for d in (0, 16, iw, iw + 16))
                    word = np.stack([_byte_perm_6420(
                        _down_pair(x[:, 2 * k], y[:, 2 * k]),
                        _down_pair(x[:, 2 * k + 1], y[:, 2 * k + 1]))
                        for x, y in ((x0, y0), (x1, y1)) for k in range(2)],
                        axis=1)
                    data = (word[..., None] >> (8 * np.arange(4))) & 0xff
                    at = o[:, None] + np.arange(16)
                    out[at] = data.reshape(len(o), 16)
                    writes[at] += 1
                else:
                    src = flat.astype(np.int64)
                    for k in range(16):
                        m = c + k < ow
                        b = (s + 2 * k)[m]
                        out[(o + k)[m]] = (src[b] + src[b + 1] + src[b + iw]
                                           + src[b + iw + 1] + 2) >> 2
                        writes[(o + k)[m]] += 1
        assert (writes == 1).all() and out.min(initial=0) >= 0
        outs.append(out.astype(np.uint8).reshape(oh, ow))
    return outs, paths


K11_CHUNK, K11_THREADS = 16, 256    # MBs and threads a block


def _store_bytes(pitch):
    """K11's store width for a plane row pitch: 16, 8 or 4 bytes."""
    return 16 if pitch % 16 == 0 else 8 if pitch % 8 == 0 else 4


def _conflict_free(addrs, width):
    """The shared reads of one warp instruction (lane-ordered addresses of
    `width`-byte reads, -1 for a lane that does not read) in phases of 128
    // u lanes, u = max(width, 4): within a phase, distinct u-byte words
    hit distinct bank groups (lanes that read one word share it)."""
    unit = max(width, 4)
    lanes = 128 // unit
    for ph in range(0, len(addrs), lanes):
        a = addrs[ph:ph + lanes]
        words = np.unique(a[a >= 0] // unit)
        if len(np.unique(words % lanes)) != len(words):
            return False
    return True


def _warps(q, addrs, width):
    """Each warp instruction of an item loop (items q in order, every 256
    a round of the block, 32 a warp) conflict-free (`_conflict_free`);
    `addrs` -1 where a lane's item does not read."""
    full = np.full(-(-(q.max(initial=-1) + 1) // 32) * 32, -1, np.int64)
    full[q] = addrs
    return all(_conflict_free(full[w:w + 32], width)
               for w in range(0, len(full), 32))


def emulate_k11(tiles, mbw, mbh, tile_addr=0):
    """K11's launch on (L, nmb, t, t) tiles ((u, v) alone, or (y, u, v)),
    block by block: a block per chunk of K11_CHUNK MBs of one MB row of
    one picture, the grid (chunks, L, mbh) with blockIdx.z 0 the first MB
    row, 1 the last, then the rows between. Each block bulk-copies its
    chunk's tiles (asserted 16-byte aligned, 16-byte multiples, at
    `tile_addr` + the tiles' offsets) into its shared copy, then writes,
    item by item in the kernel's thread map: the chunk's columns of its
    bands of each plane (its MB row's, and the 4 guard bands above or
    below on the first and last row, copies of the edge row), the luma
    in 16-byte stores (a warp 8 rows x 4 MBs), the chroma in stores of
    the width their pitch allows (16: two MBs, the odd pairs' lanes
    reading their second MB first; 8: one), the pyramid summed from the
    shared luma into a row-major shared copy (poisoned until written),
    then written like the others; the ring columns by the first and last
    chunk, splats of the edge pixel. It asserts that every store is
    aligned to its width and stays inside one row, that every output
    byte is written exactly once, that every tile byte is copied once,
    and that the shared reads of each warp instruction are free of bank
    conflicts. The planes lie as the wrapper lays them out
    (`refplanes._plan`). Returns {plane: (L, rows, pitch)}."""
    luma = len(tiles) == 3
    n = tiles[0].shape[0]
    C = K11_CHUNK
    names = ("y", "u", "v")[3 - len(tiles):]
    src = {k: t.reshape(-1) for k, t in zip(names, tiles)}
    reads = {k: np.zeros(t.size, np.int64) for k, t in src.items()}
    _, nbytes, views, _, _ = refplanes._plan(n, mbw, mbh, luma)
    offsets = {name: off for name, _, _, _, off in views}
    buf = np.full(nbytes, -1, np.int64)
    writes = np.zeros(nbytes, np.int64)
    pitch = {t: t * (mbw + 8) for t in (16, 8, 4)}
    height = {t: t * (mbh + 8) for t in (16, 8, 4)}
    width = {16: 16, 8: _store_bytes(pitch[8]), 4: _store_bytes(pitch[4])}
    base = {"y_pad": 16, "u_pad": 8, "v_pad": 8, "y4_pad": 4}

    def store(plane, pic, row, col, data):
        """W-byte stores of `data` (k, W) at rows and columns of picture
        pic of a plane."""
        t = base[plane]
        w = data.shape[1]
        assert w == (16 if t == 16 else width[t])
        assert ((col % w) == 0).all() and (col >= 0).all()
        assert (col + w <= pitch[t]).all() and (row < height[t]).all()
        at = (offsets[plane] + pic * height[t] * pitch[t] + row * pitch[t]
              + col)
        assert (at % w == 0).all()
        at = at[:, None] + np.arange(w)
        buf[at] = data
        writes[at] += 1

    def ring(plane, pic, bd, t, left, right, first, last):
        store(plane, pic, *_ring_stores(
            bd, t, 16 if t == 16 else width[t], left, right, first, last,
            mbw))

    for z in range(mbh):
        r = 0 if z == 0 else mbh - 1 if z == 1 else z - 1
        for pic in range(n):
            for chunk in range(-(-mbw // C)):
                c0 = chunk * C
                cnt = min(C, mbw - c0)
                first, last = chunk == 0, c0 + cnt == mbw
                bd = _bands_of(r, mbh)
                mb0 = pic * mbw * mbh + r * mbw + c0
                smem = {}
                for k in names:                          # the bulk copies
                    size = 256 if k == "y" else 64
                    assert (tile_addr + size * mb0) % 16 == 0
                    assert size * cnt % 16 == 0
                    span = slice(size * mb0, size * (mb0 + cnt))
                    smem[k] = src[k][span].astype(np.int64)
                    reads[k][span] += 1
                for p, k in (("u_pad", "u"), ("v_pad", "v")):
                    for stores in _chroma_band_stores(
                            smem[k], bd, cnt, c0, width[8], C, first, last,
                            mbw):
                        store(p, pic, *stores)
                if not luma:
                    continue
                sy = smem["y"]
                q = np.arange(bd[1] * 16 * C)
                bi, qq = q // (16 * C), q % (16 * C)
                row = (qq & 7) | ((qq >> 2) & 8)
                j = ((qq >> 3) & 3) | ((qq >> 6) << 2)
                act = j < cnt
                addr = 256 * j + 16 * _src_row(bd, bi, row, 16)
                assert _warps(q, np.where(act, addr, -1), 16)
                store("y_pad", pic, 16 * (bd[0] + bi[act]) + row[act],
                      64 + 16 * c0 + 16 * j[act],
                      sy[addr[act][:, None] + np.arange(16)])
                ring("y_pad", pic, bd, 16, sy[16 * np.arange(16)],
                     sy[256 * (cnt - 1) + 16 * np.arange(16) + 15], first,
                     last)
                # the pyramid into the shared row-major copy
                s4 = np.full(16 * C, -1, np.int64)
                q = np.arange(4 * C)
                k4 = (q & 1) | ((q >> 2) & 2)
                m = ((q >> 1) & 3) | ((q >> 4) << 2)
                act = m < cnt
                sums = np.zeros((4 * C, 4), np.int64)
                for i in range(4):
                    addr = 256 * m + 64 * k4 + 16 * ((i + m) & 3)
                    assert _warps(q, np.where(act, addr, -1), 16)
                    sums += sy[np.where(act, addr, 0)[:, None]
                               + np.arange(16)].reshape(-1, 4, 4).sum(2)
                for c in range(4):
                    s4[(4 * C * k4 + 4 * m + c)[act]] = (sums[act, c] + 8) >> 4
                w = width[4]
                units = 4 * C // w
                q = np.arange(bd[1] * 4 * units)
                bi, qq = q // (4 * units), q % (4 * units)
                j, row = qq % units, qq // units
                act = w * j < 4 * cnt
                addr = 4 * C * _src_row(bd, bi, row, 4) + w * j
                data = s4[addr[act][:, None] + np.arange(w)]
                assert data.min(initial=0) >= 0          # written before read
                store("y4_pad", pic, 4 * (bd[0] + bi[act]) + row[act],
                      16 + 4 * c0 + w * j[act], data)
                ring("y4_pad", pic, bd, 4, s4[4 * C * np.arange(4)],
                     s4[4 * C * np.arange(4) + 4 * cnt - 1], first, last)
    for k, v in reads.items():
        assert (v == 1).all(), f"{k} tiles copied {v.min()} to {v.max()} times"
    out = {}
    for name, _, shape, _, off in views:
        size = int(np.prod(shape))
        assert (writes[off:off + size] == 1).all(), name
        out[name] = buf[off:off + size].astype(np.uint8).reshape(shape)
    return out


def _src_row(bd, bi, row, t):
    """The source row of band bi's row `row` of a block's bands (b0, nb,
    ib): the MB row's own in band ib, its first row before, its last
    after."""
    return np.where(bi < bd[2], 0, np.where(bi == bd[2], row, t - 1))


def _bands_of(r, mbh):
    """csrc/planes.h's `bands_of`: the bands (b0, nb, ib) of MB row r."""
    top, bottom = r == 0, r == mbh - 1
    return (0 if top else r + 4, 1 + 4 * top + 4 * bottom, 4 if top else 0)


def _ring_stores(bd, t, w, left, right, first, last, mbw):
    """csrc/planes.h's `ring` of a plane of t bytes an MB: its W-byte
    splats of the edge pixels, items (rows, 2 x units a side), as (rows,
    columns, data); left[s] and right[s] the edge pixels of source row
    s."""
    ru = 4 * t // w
    q = np.arange(bd[1] * t * 2 * ru)
    u, row = q & (2 * ru - 1), q // (2 * ru)
    is_left = u < ru
    keep = np.where(is_left, first, last)
    u, row, is_left = u[keep], row[keep], is_left[keep]
    srow = _src_row(bd, row // t, row % t, t)
    px = np.where(is_left, left[srow], right[srow])
    col = np.where(is_left, u * w, 4 * t + t * mbw + (u - ru) * w)
    return t * bd[0] + row, col, np.repeat(px[:, None], w, 1)


def _chroma_band_stores(sc, bd, cnt, c0, w, chunk, first, last, mbw):
    """csrc/planes.h's `chroma_plane` (K10's and K11's): the stores (rows,
    columns, data) of the bands `bd` of a chunk of `cnt` MBs from c0 of a
    chroma plane from its 8 x 8 tiles `sc` (shared memory), in the thread
    map of a chunk of `chunk` MBs and stores of w bytes (16: a row of two
    MBs, the odd pairs' lanes reading their second MB first; 8: one), and
    the ring by the first and the last chunk; asserts the shared reads of
    every warp instruction free of bank conflicts."""
    mbs = w // 8
    per_band = 8 * chunk // mbs
    q = np.arange(bd[1] * per_band)
    bi, qq = q // per_band, q % per_band
    row, j = qq & 7, qq >> 3
    act = mbs * j < cnt
    srow = _src_row(bd, bi, row, 8)
    if w == 16:
        e = j & 1
        a0 = 64 * (2 * j + e) + 8 * srow
        a1 = 64 * (2 * j + 1 - e) + 8 * srow
        for addr in (a0, a1):
            assert _warps(q, np.where(act, addr, -1), 8)
        x = sc[a0[act][:, None] + np.arange(8)]
        y = sc[a1[act][:, None] + np.arange(8)]
        odd = e[act][:, None] == 1
        data = np.concatenate([np.where(odd, y, x), np.where(odd, x, y)], 1)
    else:
        addr = 64 * j + 8 * srow
        assert _warps(q, np.where(act, addr, -1), 8)
        data = sc[addr[act][:, None] + np.arange(8)]
    return [(8 * (bd[0] + bi[act]) + row[act], 32 + 8 * c0 + w * j[act],
             data),
            _ring_stores(bd, 8, w, sc[8 * np.arange(8)],
                         sc[64 * (cnt - 1) + 8 * np.arange(8) + 7], first,
                         last, mbw)]


K10_CHUNK, K10_THREADS = 8, 128     # enhancement MBs and threads a block
K10_TILES = K10_CHUNK // 2 + 2      # base tiles a base MB row a block reads
K10_VY, K10_VC = 8 * K10_CHUNK + 16, 4 * K10_CHUNK + 16   # sums a row
K10_VYP, K10_VCP = K10_VY + 8, K10_VC + 8                 # their pitch
K10_CPLANE = 2 * K10_TILES * 64 + 32   # the shared chroma planes' stride
K10_BIAS = 1020                     # the luma sums' bias
POISON = -(1 << 20)                 # shared memory not yet written


def _k10_window(h, w, c0, r, t):
    """K10's `window`: a plane's base window of the chunk of MBs c0 .. of
    enhancement MB row r (t = 16 luma, 8 chroma)."""
    kmax = (2 * w - 1) >> (4 if t == 16 else 3)
    c0e = min(c0, kmax)
    if t == 16:
        vb = 8 * c0e - 8
        t1 = min(vb + K10_VY - 1, w - 1) >> 4
        s0 = max(min(8 * r, h - 1) - 1, 0) >> 4
        s1 = min(8 * r + 9, h - 1) >> 4
    else:
        vb = (4 * c0e - 4) & ~7
        t1 = min(vb + K10_VC - 1, w - 1) >> 3
        s0 = max(min(4 * r, h - 1) - 1, 0) >> 3
        s1 = min(4 * r + 4, h - 1) >> 3
    return dict(h=h, w=w, kmax=kmax, c0e=c0e, vb=vb, t0=max(vb, 0) // t,
                t1=t1, s0=s0, s1=s1)


def _field(wins, p, key):
    """Per lane, the window field `key` of its plane p (0 U, 1 V)."""
    return np.where(p == 1, wins[1][key], wins[0][key])


def _k10_vertical(smem, wins, p, pair, word, r, t, mutation):
    """K10's vertical pass items: the words of 4 elements `word` of the
    row pairs `pair` of planes p (indices into `wins`) from the shared
    base tiles `smem` (poisoned where not copied; chroma planes
    K10_CPLANE apart), each tap row one 4-byte read of the word that holds
    the 4 columns clamped into the crop (`quad`: the byte of each column
    picked from it). Returns (the items' 4-byte read addresses by tap,
    the 4 columns' sums of phase 0 and 1, (n, 4) each); asserts every read
    on copied bytes."""
    luma = t == 16
    taps = LUMA_TAPS if luma else CHROMA_TAPS
    n_taps = 4 if luma else 3
    h, w = _field(wins, p, "h"), _field(wins, p, "w")
    t0, t1 = _field(wins, p, "t0"), _field(wins, p, "t1")
    s0, s1 = _field(wins, p, "s0"), _field(wins, p, "s1")
    lo, hi = w * 0, w - 1
    if mutation == "halo_unclamped":        # clamped to the copied tiles
        lo, hi = t * t0, t * t1 + t - 1
    col0 = _field(wins, p, "vb") + 4 * word
    cb = np.clip(col0, lo, hi & ~3)
    b = np.clip(col0[:, None] + np.arange(4), lo[:, None],
                hi[:, None]) - cb[:, None]
    assert b.min() >= 0 and b.max() <= 3
    src = p * K10_CPLANE + (cb // t - t0) * t * t + cb % t
    per = 8 if luma else 4
    i = np.minimum(per * r + pair, h - 1)
    addrs, vals = [], []
    for k in range(n_taps):
        rlo, rhi = (0, h - 1)
        if mutation == "halo_unclamped":
            rlo, rhi = t * s0, t * s1 + t - 1
        row = np.clip(i - 1 + k, rlo, rhi)
        addr = src + (row // t - s0) * K10_TILES * t * t + (row % t) * t
        assert addr.min() >= 0 and addr.max() + 4 <= len(smem)
        addrs.append(addr)
        vals.append(smem[addr[:, None] + b])
    assert min(v.min() for v in vals) >= 0           # copied before read
    ph = [sum(taps[a][k] * vals[k] for k in range(n_taps)) for a in (0, 1)]
    return addrs, ph


def _k10_luma_vertical(smem, g, r, mutation):
    """K10's `luma_vertical`: the biased sums (16 rows, K10_VYP) of the
    chunk's luma rows, a word of 4 elements of a pair of rows an item
    (lanes: bits 0-1 the word, 2-4 the pair); asserts each warp's 4-byte
    reads and 8-byte writes free of bank conflicts and every biased sum in
    a 16-bit lane."""
    q = np.arange(2 * K10_VY)
    pair, word = (q >> 2) & 7, ((q >> 5) << 2) | (q & 3)
    addrs, ph = _k10_vertical(smem, [g, g], q * 0, pair, word, r, 16,
                              mutation)
    for addr in addrs:
        assert _warps(q, addr, 4)
    ph = [v + K10_BIAS for v in ph]
    assert min(v.min() for v in ph) >= 0 and max(v.max() for v in ph) < 1 << 15
    sums = np.full((16, K10_VYP), POISON, np.int64)
    cols = 4 * word[:, None] + np.arange(4)
    sums[2 * pair[:, None], cols] = np.where(
        (8 * r + pair < g["h"])[:, None], ph[0], ph[1])
    sums[2 * pair[:, None] + 1, cols] = ph[1]
    for a in (0, 1):
        assert _warps(q, 2 * (K10_VYP * (2 * pair + a) + 4 * word), 8)
    return sums


def _k10_chroma_vertical(smem, wins, r, mutation):
    """K10's `chroma_vertical`: the sums (2 planes, 8 rows, K10_VCP) of
    the chunk's U and V rows (lanes: bit 0 the word's low bit, 1-2 the
    pair, 3 the word's next bit, 4 the plane); asserts each warp's reads
    and writes free of bank conflicts."""
    q = np.arange(2 * K10_VC)
    p, pair = (q >> 4) & 1, (q >> 1) & 3
    word = ((q >> 5) << 2) | ((q >> 2) & 2) | (q & 1)
    addrs, ph = _k10_vertical(smem, wins, p, pair, word, r, 8, mutation)
    for addr in addrs:
        assert _warps(q, addr, 4)
    sums = np.full((2, 8, K10_VCP), POISON, np.int64)
    cols = 4 * word[:, None] + np.arange(4)
    h = _field(wins, p, "h")
    sums[p[:, None], 2 * pair[:, None], cols] = np.where(
        (4 * r + pair < h)[:, None], ph[0], ph[1])
    sums[p[:, None], 2 * pair[:, None] + 1, cols] = ph[1]
    for a in (0, 1):
        assert _warps(q, 2 * (K10_VCP * (8 * p + 2 * pair + a) + 4 * word),
                      8)
    return sums


def _repeat_last(u, e, cap):
    """Bytes x >= e of the rows u (k, n) replaced by byte `cap`."""
    x = np.arange(u.shape[1])
    last = u[np.arange(len(u)), cap]
    return np.where(x[None] < e[:, None], u, last[:, None])


def emulate_k10(base_tiles, bmbw, crops, mbw, mbh, mutation=None,
                tile_addr=0):
    """K10's launch on the (bnmb, t, t) base tiles, block by block: a
    block per chunk of K10_CHUNK enhancement MBs of one enhancement MB row,
    the grid (chunks, mbh) with blockIdx.y 0 the first MB row, 1 the last,
    then the rows between. Each block bulk-copies its window of each plane
    (asserted 16-byte aligned at `tile_addr` + the tiles' offsets, at most
    two base MB rows of at most K10_TILES tiles) into shared memory that is
    poisoned until written; sums the vertical taps of its rows at every
    element of its window (clamped into the crop) into shared 16-bit rows,
    the luma biased, a word of 4 columns of a pair of rows an item
    (`_k10_luma_vertical`, `_k10_chroma_vertical`); then writes, item by
    item in the kernel's thread map, each luma tile row as one 16-byte
    store (its sums from three 16-byte shared reads) and each chroma tile
    row as one 8-byte store and into the shared tiles (two 16-byte reads,
    the window at element 3 or 7), pixels past the crop repeating the
    row's last; then the padded chroma rows of its bands
    (`_chroma_band_stores`, csrc/planes.h). It asserts that every store is
    aligned to its width, that every output byte is written once, that
    every shared read hits written memory and that the shared reads and
    writes of each warp instruction are free of bank conflicts. Returns
    the five outputs. `mutation`: "grid_clamp" clamps at the base's MB
    grid in place of the cropped picture; "halo_unclamped" reads the
    window's halo at the copied tiles' edges in place of the crop's."""
    N = K10_CHUNK
    log_n = N.bit_length() - 1
    if mutation == "grid_clamp":
        bmbh = base_tiles[0].shape[0] // bmbw
        crops = [(bmbh * t, bmbw * t) for t in (16, 8, 8)]
    flat = [t.reshape(-1).astype(np.int64) for t in base_tiles]
    _, nbytes, views, offsets, _ = resample._up_plan(
        base_tiles[0].shape[0], bmbw, tuple(map(tuple, crops)), mbw, mbh)
    off = dict(zip(resample.UP_OUTPUTS, offsets))
    buf = np.full(nbytes, -1, np.int64)
    writes = np.zeros(nbytes, np.int64)
    pitch = 8 * (mbw + 8)
    width = _store_bytes(pitch)

    def store(name, at, data):
        w = data.shape[1]
        assert ((off[name] + at) % w == 0).all()
        at = off[name] + at[:, None] + np.arange(w)
        buf[at] = data
        writes[at] += 1

    def load(smem, at0, p, t, g):
        """The bulk copies of plane p's window into smem from at0."""
        assert g["t1"] - g["t0"] + 1 <= K10_TILES
        assert g["s1"] - g["s0"] + 1 <= 2
        size = (g["t1"] - g["t0"] + 1) * t * t
        for s in range(g["s0"], g["s1"] + 1):
            at = (s * bmbw + g["t0"]) * t * t
            assert (tile_addr + at) % 16 == 0 and size % 16 == 0
            assert at + size <= len(flat[p]) and at0 % 16 == 0
            dst = at0 + (s - g["s0"]) * K10_TILES * t * t
            smem[dst:dst + size] = flat[p][at:at + size]

    for z in range(mbh):
        r = 0 if z == 0 else mbh - 1 if z == 1 else z - 1
        for c0 in range(0, mbw, N):
            n = min(N, mbw - c0)
            gy, gu, gv = (_k10_window(*crops[p], c0, r, t)
                          for p, t in enumerate((16, 8, 8)))
            ysm = np.full(2 * K10_TILES * 256, POISON, np.int64)
            csm = np.full(2 * K10_CPLANE, POISON, np.int64)
            load(ysm, 0, 0, 16, gy)
            load(csm, 0, 1, 8, gu)
            load(csm, K10_CPLANE, 2, 8, gv)
            vy = _k10_luma_vertical(ysm, gy, r, mutation)
            vc = _k10_chroma_vertical(csm, (gu, gv), r, mutation)
            # luma tile rows
            q = np.arange(16 * N)
            m, row = q & (N - 1), q >> log_n
            act = m < n
            k = np.minimum(c0 + m, gy["kmax"])
            el = 8 * (k - gy["c0e"])
            for j in range(3):
                addr = 2 * (K10_VYP * row + el) + 16 * j
                assert _warps(q, np.where(act, addr, -1), 16)
            win = vy[row[:, None], el[:, None] + 7 + np.arange(11)]
            assert win[act].min() > POISON
            u = np.zeros((len(q), 16), np.int64)
            for x in range(16):
                tap = LUMA_TAPS[x & 1]
                u[:, x] = np.clip((512 - 32 * K10_BIAS + sum(
                    tap[j] * win[:, (x >> 1) + j] for j in range(4))) >> 10,
                    0, 255)
            cap = 2 * gy["w"] - 1 - 16 * k
            e = np.where(c0 + m > gy["kmax"], 0, cap + 1)
            u = _repeat_last(u, e, np.minimum(cap, 15))
            store("pred_y", ((r * mbw + c0 + m) * 256 + row * 16)[act],
                  u[act])
            # chroma tile rows, into the shared tiles too
            out = np.full((2, N * 64), POISON, np.int64)
            row = ((q & 3) << 1) | ((q >> 3) & 1)
            m = ((q >> 2) & 1) | (((q >> 4) & (N // 2 - 1)) << 1)
            p = q >> (3 + log_n)
            act = m < n
            kmax = _field((gu, gv), p, "kmax")
            k = np.minimum(c0 + m, kmax)
            st = 4 * k - 1 - _field((gu, gv), p, "vb")
            assert set(np.unique(st[act] & 7)) <= {3, 7}
            for j in range(2):
                addr = 2 * K10_VCP * (8 * p + row) + 16 * (st >> 3) + 16 * j
                assert _warps(q, np.where(act, addr, -1), 16)
            win = vc[p[:, None], row[:, None], st[:, None] + np.arange(6)]
            assert win[act].min() > POISON
            u = np.zeros((len(q), 8), np.int64)
            for x in range(8):
                tap = CHROMA_TAPS[x & 1]
                u[:, x] = (8 + sum(tap[j] * win[:, (x >> 1) + j]
                                   for j in range(3))) >> 4
            assert u.max() <= 255
            cap = 2 * _field((gu, gv), p, "w") - 1 - 8 * k
            e = np.where(c0 + m > kmax, 0, cap + 1)
            u = _repeat_last(u, e, np.minimum(cap, 7))
            assert _warps(q, np.where(act, 64 * (N * p + m) + 8 * row, -1),
                          8)                 # the 8-byte shared writes
            for pl, name in ((0, "pred_u"), (1, "pred_v")):
                sel = act & (p == pl)
                store(name, ((r * mbw + c0 + m) * 64 + row * 8)[sel], u[sel])
                out[pl, (m * 64 + row * 8)[sel, None] + np.arange(8)] = u[sel]
            # the padded chroma rows of the block's bands
            bd = _bands_of(r, mbh)
            for pl, name in ((0, "u_pad"), (1, "v_pad")):
                for rows, cols, data in _chroma_band_stores(
                        out[pl], bd, n, c0, width, N, c0 == 0,
                        c0 + n == mbw, mbw):
                    assert data.min(initial=0) >= 0  # written before read
                    assert (cols + data.shape[1] <= pitch).all()
                    store(name, rows * pitch + cols, data)
    outs = []
    for name, _, shape, _, at in views:
        size = int(np.prod(shape))
        assert (writes[at:at + size] == 1).all(), name
        outs.append(buf[at:at + size].astype(np.uint8).reshape(shape))
    return tuple(outs)


# ---------------------------------------------------------------------------
# the `down` stage
# ---------------------------------------------------------------------------

# (h, w) of the luma plane: 64 wide (every plane on the 16-byte path), 96
# wide (luma 16-byte, chroma byte-wise), an odd row count on the 16-byte
# path, odd and tiny planes (byte-wise)
@pytest.mark.parametrize("h,w", [(48, 64), (90, 120), (37, 51), (3, 9),
                                 (2, 2), (64, 96), (65, 64)])
def test_downsample_planes_match_jax(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    planes = [_plane(rng, h, w), _plane(rng, max(h // 2, 2), max(w // 2, 2)),
              _plane(rng, max(h // 2, 2), max(w // 2, 2))]
    got = resample.downsample_planes(*(torch.from_numpy(p) for p in planes))
    emulated, paths = emulate_k9(planes)
    assert paths == ["16-byte" if p.shape[1] % 32 == 0 else "byte-wise"
                     for p in planes]
    for p, g, e in zip(planes, got, emulated):
        want = np.asarray(jrs.downsample2x(jnp.asarray(p)))
        assert g.shape == (p.shape[0] // 2, p.shape[1] // 2)
        _eq(want, g, f"downsample_planes {p.shape}")
        _eq(want, e, f"emulate_k9 {p.shape}")


def test_k9_takes_planes_at_any_address():
    """Planes 64 wide at an odd input or output address take K9's
    byte-wise path and give the same outputs as the 16-byte path."""
    rng = np.random.default_rng(64)
    planes = [_plane(rng, 40, 64), _plane(rng, 20, 32), _plane(rng, 20, 32)]
    aligned, paths = emulate_k9(planes)
    assert paths == ["16-byte"] * 3
    odd, paths = emulate_k9(planes, addrs=((1, 0), (0, 8), (4, 4)))
    assert paths == ["byte-wise"] * 3
    for p, a, o in zip(planes, aligned, odd):
        want = np.asarray(jrs.downsample2x(jnp.asarray(p)))
        _eq(want, a, "16-byte path")
        _eq(want, o, "byte-wise path")


# ---------------------------------------------------------------------------
# the `up` stage
# ---------------------------------------------------------------------------

# (what, base width, base height[, (mb_width, mb_height)]): the base
# picture; its MB grid and, unless given, the enhancement's padded size
# follow as SvcEncoder sizes them. K10's chunks of 8 MBs end short at 15,
# 18 and 13 MBs; its padded chroma rows take 8-byte stores at odd widths
UP_CASES = (("a base that fills its MBs", 64, 48),
            ("120x90 in 8 x 6 MBs", 120, 90),
            ("one MB wide", 16, 40),
            ("one MB high", 40, 16),
            ("a few pixels, cropped", 12, 10),
            ("one MB", 16, 16),
            ("18 MBs wide, a short last chunk", 144, 32),
            ("a crop inside a tile across, an odd width", 100, 32),
            ("a crop inside a tile down", 32, 70),
            ("an enhancement past twice the base", 40, 24, (11, 6)))


def _up_case(case, seed=3):
    """Seeded base tiles and the sizes of one case: (tiles (3 numpy
    (bnmb, t, t)), bmbw, crops, mbw, mbh, the cropped base planes)."""
    bw, bh = case[1:3]
    rng = np.random.default_rng(seed + bw * 7 + bh)
    bmbw, bmbh = -(-bw // 16), -(-bh // 16)
    grids = [_plane(rng, bmbh * 16, bmbw * 16)] + [
        _plane(rng, bmbh * 8, bmbw * 8) for _ in range(2)]
    crops = ((bh, bw), (bh // 2, bw // 2), (bh // 2, bw // 2))
    tiles = [_mb_tiles(g, t) for g, t in zip(grids, (16, 8, 8))]
    mbw, mbh = case[3] if len(case) > 3 else (-(-2 * bw // 16),
                                              -(-2 * bh // 16))
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


@pytest.mark.parametrize("case", UP_CASES[7:9], ids=lambda c: c[0])
def test_k10_clamps_its_halo_into_the_crop(case):
    """A block's vertical pass reads its window's halo clamped into the
    cropped picture: read to the edge of its copied tiles instead, it
    takes the MB grid's padding past a crop that ends inside a tile, and
    the emulation with that fault differs from JAX."""
    tiles, bmbw, crops, mbw, mbh, cropped = _up_case(case)
    want = _up_jax(cropped, mbw, mbh)
    bad = emulate_k10(tiles, bmbw, crops, mbw, mbh,
                      mutation="halo_unclamped")
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

# (L, mb_width, mb_height): K11's store widths (chroma, pyramid) are 16 and
# 16 at 4 x 3, 16 and 8 at 6 x 1 and CIF's 22 x 18 (two chunks, the second
# short), 8 and 4 at odd widths (1 x 6, 7 x 2, 33 x 3: three chunks)
@pytest.mark.parametrize("L,mbw,mbh", [(1, 4, 3), (3, 4, 3), (1, 1, 6),
                                       (3, 6, 1), (1, 7, 2), (2, 7, 2),
                                       (1, 22, 18), (1, 33, 3)])
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

def test_k11_bulk_copies_need_16_byte_alignment():
    """K11 bulk-copies its tiles: tiles at a 4-byte but not 16-byte
    aligned address fail the emulation's check, which the wrapper's
    16-byte alignment check and `refstate._k11_tiles`' copy keep from the
    card."""
    rng = np.random.default_rng(5)
    tiles = [np.stack([_mb_tiles(_plane(rng, 3 * t, 4 * t), t)])
             for t in (16, 8, 8)]
    emulate_k11(tiles, 4, 3, tile_addr=16)
    with pytest.raises(AssertionError):
        emulate_k11(tiles, 4, 3, tile_addr=4)


def test_k10_bulk_copies_need_16_byte_alignment():
    """K10 bulk-copies its window of base tiles: tiles at a 4-byte but not
    16-byte aligned address fail the emulation's check, which the
    wrapper's 16-byte alignment check and `resample._k10_tiles`' copy keep
    from the card."""
    tiles, bmbw, crops, mbw, mbh, cropped = _up_case(UP_CASES[1])
    want = _up_jax(cropped, mbw, mbh)
    for w, e in zip(want, emulate_k10(tiles, bmbw, crops, mbw, mbh,
                                      tile_addr=16)):
        _eq(w, e)
    with pytest.raises(AssertionError):
        emulate_k10(tiles, bmbw, crops, mbw, mbh, tile_addr=4)


def test_k10_plan_is_cached_per_size():
    """`upsample_k10` takes its checks, buffer layout and size words from
    `_up_plan`, once per size: the same tuple object for the same sizes,
    crops given as lists taking the same plan; bad sizes and crops
    raise."""
    crops = ((90, 120), (45, 60), (45, 60))
    plan = resample._up_plan(48, 8, crops, 15, 12)
    assert resample._up_plan(48, 8, crops, 15, 12) is plan
    assert plan[4] == [8, 90, 120, 45, 60, 45, 60, 15, 12, GUARD // 2]
    for bad in ((48, 7, crops, 15, 12), (48, 8, crops, 0, 12),
                (48, 8, ((97, 120),) + crops[1:], 15, 12),
                (48, 8, ((90, 0),) + crops[1:], 15, 12),
                (48, 8, crops[:2], 15, 12)):
        with pytest.raises(ValueError):
            resample._up_plan(*bad)


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
