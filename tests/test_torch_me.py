"""The motion search's kernels K4 and K5 (`csrc/me.cu`), their schedule
emulated on the CPU.

A CUDA kernel cannot run here, so `emulate_k4` and `emulate_k5` do in
torch what each kernel does. K4 (`emulate_k4`): a block per tile of 2 x 8
MBs; the coarse +-8 search of the tile's MBs and of the halo their
predictors read (none above a band's first row), through the tile's 4x
strip, a half warp's lanes taking a column of positions each; the
reference strip of the tile, its origin clamped as `qpel.windows` clamps
a window start, every window read through it (a read outside it is 0);
the full-pel and quarter-pel sweeps row-split over 32 lanes, their
partial sums packed two to a word and reduced by the kernel's
reduce-scatter, the winner the least signed (cost, raster index) key; the
half-pel planes from the re-centred window with the kernel's biased
vertical sums, and each quarter-pel sample as the rounded mean of the two
plane samples of the kernel's phase table (`PHASES`). K5 (`emulate_k5`):
a warp per MB with the same lanes (i, h); one full-pel pass whose packed
sums a segmented reduce-scatter turns into the 8x8 quadrants' SADs, the
16x8 and 8x16 halves a quadrant plus its partner across h or across i >>
3; a quarter-pel pass per geometry in which every lane sweeps around its
own block's winner, the segmented reduce-scatter's rounds and the keyed
minimum over the block's lanes. Three faults of K4's schedule (a halo
above the band, an unclamped strip origin, keys ordered by lane) and
three of K5's (the 16x8 halves paired across the wrong lane bit, the
quarter-pel passes centred on the 16x16 winner, keys ordered by lane)
each make the emulation fail. The
emulations are held against the
port's plain `motion_search_dense` / `partition_search` (through
`motion_search_plain` / `partition_plain`, which take the kernels'
arguments) and against JAX's (`h264lab_tpu/ops/me.py`) on
`utils.synthetic.me_inputs` cases: flat and
chessboard MBs (ties everywhere), shifted noise, half-pel matches,
unmatched patches, previous MVs past the +-52 clip, bands at a row
offset, QPs 0, 12, 33 and 51, the sub-pel stage on and off, tiles cut at
the frame's right and bottom edges; one case reaches a negative
quarter-pel cost (the skip bias), one reads planes whose guard is cut so
that the window starts are clamped, one cuts them so far that the strip
origins clamp, one ties two candidate centres. JAX runs each
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
TILE = (2, 8)            # K4's tile: MB rows, MB columns
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
    (84, 2, 11, 3, 33, 2, 6, True),         # K4's tiles cut at both edges
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


def at(img, y, x, h, w):
    """(K, h, w) blocks of per-MB images img (K, H, W) at (y, x) (K,)."""
    k = torch.arange(img.shape[0])[:, None, None]
    return img[k, (y[:, None] + torch.arange(h))[:, :, None],
               (x[:, None] + torch.arange(w))[:, None, :]]


def clamp(v, lo, hi):
    return torch.clamp(v, lo, hi)


def phase_block(planes, dyq, dxq, y, x, h, w):
    """(K, h, w) quarter-pel samples of phase (dyq & 3, dxq & 3) from the
    (K, 4, 22, 22) planes at plane coordinates (y, x) (K,)."""
    pa, ya, xa, pb, yb, xb = PHASES[(dyq & 3, dxq & 3)]
    a = at(planes[:, pa], y + ya, x + xa, h, w)
    b = at(planes[:, pb], y + yb, x + xb, h, w)
    return (a + b + 1) >> 1


def strip_read(img, lane, origin, size, y, x, h, w):
    """(K, h, w) bytes of each MB's strip of the lanes' planes img (L, H,
    W): strip k is img[lane[k]] from origin (sy[k], sx[k]) of size (sh[k],
    sw[k]), read at strip coordinates (y, x) (K,). What lies outside the
    strip, or outside the plane, reads as 0 (bytes a copy never wrote)."""
    (sy, sx), (sh, sw) = origin, size
    yy = y[:, None] + torch.arange(h)
    xx = x[:, None] + torch.arange(w)
    gy, gx = sy[:, None] + yy, sx[:, None] + xx
    iny = (yy >= 0) & (yy < sh[:, None]) & (gy >= 0) & (gy < img.shape[1])
    inx = (xx >= 0) & (xx < sw[:, None]) & (gx >= 0) & (gx < img.shape[2])
    v = img[lane[:, None, None], gy.clamp(0, img.shape[1] - 1)[:, :, None],
            gx.clamp(0, img.shape[2] - 1)[:, None, :]]
    return torch.where(iny[:, :, None] & inx[:, None, :], v, 0)


LANES = torch.arange(32)
LANE_I, LANE_H = LANES >> 1, LANES & 1        # lane (i, h): row i, half h
PHASE_TAB = torch.tensor([PHASES[(fy, fx)] for fy in range(4)
                          for fx in range(4)])
# K5's blocks: per geometry the block of each lane, the lane bits that
# differ within a block (the segment) and the reduce-scatter rounds (each
# the lane bit of the partner and the slots kept) of each slot set
K5_BLOCK = {"16x8": LANE_I >> 3, "8x16": LANE_H,
            "8x8": 2 * (LANE_I >> 3) + LANE_H}
K5_SEGMENT = {"16x8": 0xF, "8x16": 0x1E, "8x8": 0xE}
K5_ROUNDS = {"16x8": (8, 4, 2, 1), "8x16": (16, 8, 4, 2), "8x8": (8, 4, 2)}
# the full-pel pass's rounds (the quadrants) and the partner lane bit that
# adds a quadrant's neighbour for the 16x8 and 8x16 halves
K5_FULL_ROUNDS = (8, 4, 2)
K5_PARTNER = {"16x8": 1, "8x16": 16}


def scatter_rounds(words, labels, rounds):
    """The kernels' (segmented) reduce-scatter of packed words (K, 32
    lanes, S slots): in the round of lane bit o the slots 0 .. 2 o are
    halved,
    lanes with bit o keeping the upper half and adding the partner's (lane
    ^ o) copy of it (the kernel's `scatter_round<o>`). `labels` (S,) is
    each slot's first position; returns the kept words (K, 32, S') and the
    labels of each lane's slots (32, S')."""
    lab = labels.expand(32, -1)
    for o in rounds:
        assert words.shape[2] == 2 * o, (words.shape, o)
        up = ((LANES & o) != 0)[None, :, None]
        lo, hi = words[:, :, :o], words[:, :, o:]
        send, keep = torch.where(up, lo, hi), torch.where(up, hi, lo)
        words = (keep + send[:, LANES ^ o]) & 0xFFFFFFFF
        lab = torch.where(up[0], lab[:, o:], lab[:, :o])
    return words, lab


def pack(partial, n_slots):
    """Partial sums (K, 32, P) packed two positions to a word (slot s:
    positions 2 s and 2 s + 1, low and high halves), 0 past P; with each
    slot's first position."""
    assert int(partial.max()) < 2**11            # 8 pixels of a lane
    pad = torch.zeros(partial.shape[:2] + (2 * n_slots - partial.shape[2],),
                      dtype=torch.long)
    v = torch.cat([partial, pad], 2)
    return v[:, :, 0::2] | v[:, :, 1::2] << 16, 2 * torch.arange(n_slots)


def unpack(words, labels):
    """Each lane's (position, SAD) pairs of its packed words: positions
    (32, 2 S'), SADs (K, 32, 2 S')."""
    sads = torch.stack([words & 0xFFFF, words >> 16], 3).flatten(2)
    return torch.stack([labels, labels + 1], 2).flatten(1), sads


def reduce_scatter(partial):
    """K4's reduce-scatter of row-split partial sums (K, 32 lanes, 49
    positions): two positions packed to a 32-bit word (`pack`), then five
    rounds over lane bits 16 .. 1 (`scatter_rounds`). Returns (K, 32
    lanes, 2): lane l's totals of positions 2 l and 2 l + 1 (0 past
    position 48)."""
    words, lab = scatter_rounds(*pack(partial, 32), (16, 8, 4, 2, 1))
    assert torch.equal(lab[:, 0], 2 * LANES)
    return torch.stack([words[:, :, 0] & 0xFFFF, words[:, :, 0] >> 16], 2)


def sweep_winner(partial, cost_of, lane_key=False):
    """The least (cost, raster index) key of a 49-position row-split sweep:
    the totals from `reduce_scatter`, lane l keys positions 2 l and 2 l +
    1 by `cost_of(sad (K,), position)` and the least key of the lanes wins.
    With `lane_key` (a mutation) the key's second part is the lane, not the
    position. Returns (position, cost), each (K,)."""
    tot = reduce_scatter(partial)
    keys = []
    for lane in range(25):
        for h in range(2):
            p = 2 * lane + h
            if p < 49:
                keys.append(cost_of(tot[:, lane, h], p) * 2**32
                            + (lane if lane_key else p))
    keys = torch.stack(keys, 1)
    best = keys.argmin(dim=1)                 # the first of the least keys
    return best, keys.min(dim=1).values // 2**32


def lane_partials(cur, blocks):
    """Row-split partial SADs: cur (K, 16, 16) and blocks (K, P, 16, 16)
    -> (K, 32, P), lane 2 i + h summing row i's pixels 8 h .. 8 h + 7."""
    diff = (cur[:, None] - blocks).abs().reshape(cur.shape[0], -1, 32, 8)
    return diff.sum(-1).permute(0, 2, 1)


def coarse_order():
    """K4's coarse positions p = 17 dy + dx (dy, dx in 0 .. 16) in a half
    warp's lane order: lane j takes column j (dy 0 .. 16), then position
    (j, 16), lane 0 also (16, 16). Returns the (289,) rank of each
    position in lane order."""
    order = []
    for j in range(16):
        order += [(d, j) for d in range(17)]
        order += [(d, 16) for d in (j, j + 16) if d < 17]
    rank = torch.empty(289, dtype=torch.long)
    for i, (d, e) in enumerate(order):
        rank[17 * d + e] = i
    return rank


def coarse_of(t, slots, mbw, mbh, lane_key):
    """The coarse-grid MBs' +-8 winners as K4's half warps take them.
    slots: [(frame, MB row, MB column, 4x strip)] where the 4x strip is the
    tile's ((row, column) origin, extent); an MB row < 0 reads a 4x4 block
    outside the band's tiles. Each dy's band window at its clamped row
    Y(d), read through the strip (a read outside it, or outside the plane,
    is 0); 32-bit (cost << 9 | raster index) keys, or with `lane_key` (a
    mutation) keys that order by lane, then by the lane's own order.
    Returns (dy4, dx4), each (S,)."""
    nmb = t["cur_tiles"].shape[1]
    f, r, c = (torch.tensor([x[i] for x in slots]) for i in range(3))
    oy4, ox4, n4, m4 = (torch.tensor([x[3][i // 2][i % 2] for x in slots])
                        for i in range(4))
    tiles = t["cur_tiles"].reshape(-1, 16, 16)
    idx = f * nmb + r * mbw + c
    tile = tiles[torch.where(idx < 0, idx + tiles.shape[0], idx)]
    cur4 = (tile.reshape(-1, 4, 4, 4, 4).sum((2, 4)) + 8) >> 4
    ref4 = t["y4_pad"][t["lane"][f]]                    # (S, h4p, w4p)
    h4p, w4p = ref4.shape[1:]
    p = torch.arange(289)
    d, e = p // 17, p % 17
    y0 = G4 + 4 * t["row_offset"][f] - 8
    x0 = min(max(G4 - 8, 0), w4p - (4 * mbw + 16))
    yy = (clamp(y0[:, None] + d, 0, h4p - 4 * mbh) + 4 * r[:, None])[
        ..., None] + torch.arange(4)                     # (S, 289, 4)
    xx = (x0 + 4 * c[:, None] + e)[..., None] + torch.arange(4)
    ok = (((yy >= oy4[:, None, None].clamp(min=0))
           & (yy < (oy4 + n4).clamp(max=h4p)[:, None, None]))[..., None]
          & ((xx >= ox4[:, None, None])
             & (xx < (ox4 + m4).clamp(max=w4p)[:, None, None]))[..., None, :])
    s = torch.arange(len(slots))[:, None, None, None]
    win = torch.where(ok, ref4[s, yy.clamp(0, h4p - 1)[..., None],
                               xx.clamp(0, w4p - 1)[..., None, :]], 0)
    lam = _t(tme.LAMBDA_ME).long()[t["qp"][f]]
    cost = (16 * (cur4[:, None] - win).abs().sum((2, 3))
            + lam[:, None] * (bits(16 * (d - 8)) + bits(16 * (e - 8))))
    assert int(cost.min()) >= 0 and int(cost.max()) < 2**23
    keys = cost << 9 | (coarse_order() if lane_key else p)
    best = keys.argmin(dim=1)
    return best // 17 - 8, best % 17 - 8


def emulate_k4(d, mbw, mbh, subpel, mutation=None):
    """K4 as the kernel schedules it (`csrc/me.cu` `search_kernel`). A
    block per tile of TILE MBs of a frame or band:
    - the coarse grid: the tile's MBs and the halo their predictors read
      (the column to the left, the row above from one column left to one
      right, the column to the right of the rows but the last), none above
      the band's first row, each searched by `coarse_of` through the
      tile's 4x strip; the predictor from the grid;
    - the reference strip: (16 R + 128) x (16 C + 128) bytes of the lane's
      plane (the plane where it is smaller) from an origin clamped as
      `qpel.windows` clamps a window start; every window read through it;
    - the centres, then the full-pel and quarter-pel sweeps row-split over
      32 lanes (`lane_partials`), reduced by `reduce_scatter`, the winner
      the least (cost, raster index) key (`sweep_winner`); the planes from
      the window re-centred on the full-pel winner, the vertical sums
      biased by 4096 as the kernel keeps them.
    `mutation`: "halo_above" (the grid reaches above the band's first
    row), "unclamped_strip" (the strip's origin unclamped) or "lane_key"
    (keys ordered by lane). Returns a dict of (K,) fields, pred (K, 16,
    16) and planes (K, 4, 22, 22) (None without sub-pel)."""
    t = {k: _t(v).long() for k, v in d.items()}
    n, nmb = t["cur_tiles"].shape[:2]
    kk = n * nmb
    hp, wp = t["y_pad"].shape[1:]
    h4p, w4p = t["y4_pad"].shape[1:]
    lane_key = mutation == "lane_key"
    tr, tc = TILE
    # per MB: its tile's strip and the predictor from its tile's grid
    sy, sx, sh, sw = (torch.zeros(kk, dtype=torch.long) for _ in range(4))
    cy4, cx4, pvy, pvx = (torch.zeros(kk, dtype=torch.long)
                          for _ in range(4))
    tiles, slots = [], []
    for f in range(n):
        ro = int(t["row_offset"][f])
        x0 = min(max(G4 - 8, 0), w4p - (4 * mbw + 16))
        ylo = min(max(G4 + 4 * ro - 8, 0), h4p - 4 * mbh)
        y16 = min(max(G4 + 4 * ro + 8, 0), h4p - 4 * mbh)
        for r0 in range(0, mbh, tr):
            for c0 in range(0, mbw, tc):
                R, C = min(tr, mbh - r0), min(tc, mbw - c0)
                above = -1 if mutation == "halo_above" else 0
                rmin, cmin = max(r0 - 1, above), max(c0 - 1, 0)
                cmax = min(c0 + C, mbw - 1)
                # the 4x strip: the grid's rows of every band window Y(d),
                # its columns and the windows' 16 more
                strip4 = ((ylo + 4 * rmin, x0 + 4 * cmin),
                          (y16 - ylo + 4 * (r0 + R - rmin),
                           4 * (cmax - cmin + 1) + 16))
                assert strip4[1][0] <= 28 and strip4[1][1] <= 56
                grid = []
                for gr in range(R + 1):
                    for gc in range(C + 2):
                        r, c = r0 - 1 + gr, c0 - 1 + gc
                        if not (r < above or c < 0 or c >= mbw
                                or (gr == R and gc == C + 1)):
                            grid.append((r, c, len(slots)))
                            slots.append((f, r, c, strip4))
                ssh, ssw = min(16 * R + 128, hp), min(16 * C + 128, wp)
                if mutation == "unclamped_strip":
                    ssy, ssx = 16 * (r0 + ro), 16 * c0
                else:
                    ssy = min(max(16 * (r0 + ro), 0), hp - ssh)
                    ssx = min(max(16 * c0, 0), wp - ssw)
                tiles.append((f, r0, c0, R, C, grid, (ssy, ssx, ssh, ssw)))
    dy4, dx4 = coarse_of(t, slots, mbw, mbh, lane_key)
    for f, r0, c0, R, C, grid, strip_k in tiles:
        grid = {(r, c): (int(dy4[i]), int(dx4[i])) for r, c, i in grid}
        for r in range(r0, r0 + R):
            for c in range(c0, c0 + C):
                k = f * nmb + r * mbw + c
                sy[k], sx[k], sh[k], sw[k] = strip_k
                cy4[k], cx4[k] = grid[r, c]
                pv = []
                for q in range(2):
                    left = 16 * grid[r, c - 1][q] if c > 0 else 0
                    if r == 0 and mutation != "halo_above":
                        pv.append(left)
                        continue
                    top = 16 * grid[r - 1, c][q]
                    if c == mbw - 1:
                        tr_ = 16 * grid[r - 1, c - 1][q] if c else 0
                    else:
                        tr_ = 16 * grid[r - 1, c + 1][q]
                    pv.append(max(min(max(left, top), tr_), min(left, top)))
                pvy[k], pvx[k] = pv
    f = torch.arange(kk) // nmb
    m = torch.arange(kk) % nmb
    r, c = m // mbw, m % mbw
    lane, row0 = t["lane"][f], t["row_offset"][f]
    lam = _t(tme.LAMBDA_ME).long()[t["qp"][f]]
    cur = t["cur_tiles"].reshape(kk, 16, 16)

    def strip(y, x, h, w):
        return strip_read(t["y_pad"], lane, (sy, sx), (sh, sw), y, x, h, w)

    # candidate centres, windows at starts clamped into the plane, read
    # through the strip
    by, bx = G + 16 * (r + row0), G + 16 * c
    cands = [(torch.zeros(kk, dtype=torch.long),) * 2, (4 * cy4, 4 * cx4),
             (clamp(t["prev_my"].reshape(kk), -52, 52),
              clamp(t["prev_mx"].reshape(kk), -52, 52))]
    best = None
    for cy, cx in cands:
        oy = clamp(by + cy - 9, 0, hp - 34) - sy
        ox = clamp(bx + cx - 9, 0, wp - 34) - sx
        sad = (cur - strip(oy + 9, ox + 9, 16, 16)).abs().sum((1, 2))
        cost = sad + lam * (bits(cy * 4 - pvy) + bits(cx * 4 - pvx))
        if best is None:
            best, cm_y, cm_x, wy, wx = cost, cy, cx, oy, ox
            continue
        upd = cost < best
        best = torch.where(upd, cost, best)
        cm_y, cm_x = torch.where(upd, cy, cm_y), torch.where(upd, cx, cm_x)
        wy, wx = torch.where(upd, oy, wy), torch.where(upd, ox, wx)
    win = strip(wy, wx, 34, 34)
    blocks = torch.stack([win[:, 9 + p // 7 - 3:25 + p // 7 - 3,
                              9 + p % 7 - 3:25 + p % 7 - 3]
                          for p in range(49)], 1)
    p, full_cost = sweep_winner(lane_partials(cur, blocks), lambda sad, p: (
        sad + lam * (bits((cm_y + p // 7 - 3) * 4 - pvy)
                     + bits((cm_x + p % 7 - 3) * 4 - pvx))), lane_key)
    bdy, bdx = p // 7 - 3, p % 7 - 3
    out = dict(cy4=cy4, cx4=cx4, mvp_y=pvy, mvp_x=pvx, full_my=cm_y + bdy,
               full_mx=cm_x + bdx, planes=None)
    if not subpel:
        out.update(mv_y=4 * out["full_my"], mv_x=4 * out["full_mx"],
                   cost=full_cost, pred=at(win, 9 + bdy, 9 + bdx, 16, 16))
        return out
    # the planes from the re-centred window A(p, q) = win[4 + bdy + p][4 +
    # bdx + q]: the vertical sums biased by 4096 (each 16-bit half of the
    # kernel's packed pairs stays in [0, 2^16)), H and J taking it off
    a = at(win, 4 + bdy, 4 + bdx, 27, 27)
    hr = sum(tp * a[:, i:i + 22, :] for i, tp in enumerate(TAPS)) + 4096
    assert int(hr.min()) >= 0 and int(hr.max()) < 2**16
    hb = sum(tp * a[:, 2:24, i:i + 22] for i, tp in enumerate(TAPS))
    hj = sum(tp * hr[:, :, i:i + 22] for i, tp in enumerate(TAPS))
    planes = torch.stack([a[:, 2:24, 2:24], clamp((hb + 16) >> 5, 0, 255),
                          clamp((hr[:, :, 2:24] + 16) >> 5, 128, 383) - 128,
                          clamp(((hj + 512) >> 10) - 128, 0, 255)], 1)
    thr = tme.SKIP_THR_BASE + t["qp"][f] * tme.SKIP_THR_QP
    fmy, fmx = out["full_my"], out["full_mx"]
    zero = torch.zeros(kk, dtype=torch.long)
    blocks = torch.stack([phase_block(planes, p // 7 - 3, p % 7 - 3,
                                      zero + 3 + ((p // 7 - 3) >> 2),
                                      zero + 3 + ((p % 7 - 3) >> 2), 16, 16)
                          for p in range(49)], 1)

    def qpel_cost(sad, p):
        mvy, mvx = 4 * fmy + p // 7 - 3, 4 * fmx + p % 7 - 3
        cost = sad + lam * (bits(mvy - pvy) + bits(mvx - pvx))
        skip = (mvy == pvy) & (mvx == pvx) & (sad < thr)
        return cost - skip * lam * tme.SKIP_BIAS_BITS

    p, cost = sweep_winner(lane_partials(cur, blocks), qpel_cost, lane_key)
    out.update(mv_y=4 * fmy + p // 7 - 3, mv_x=4 * fmx + p % 7 - 3,
               cost=cost, pred=blocks[torch.arange(kk), p], planes=planes)
    return out


def segment_min(cost, pos, n_pos, segment, lane_key=False):
    """The keyed minimum of K5: each lane the least signed (cost, position)
    key of its positions below n_pos, then the least over the lanes that
    differ in the bits of `segment` (xor shuffles). With `lane_key` (a
    mutation) the lanes' keys order by lane, not by position. Returns the
    winner's (position, cost) per lane, each (K, 32)."""
    keys = torch.where(pos < n_pos, cost * 2**32 + pos, 2**62)
    best = keys.min(2).values
    p, c = best & 0xFFFFFFFF, best >> 32
    keys = c * 2**32 + (LANES * 64 + p if lane_key else p)
    for o in (16, 8, 4, 2, 1):
        if segment & o:
            keys = torch.minimum(keys, keys[:, LANES ^ o])
    return keys & (63 if lane_key else 0xFFFFFFFF), keys >> 32


def lane_samples(planes, fy, fx, y, x):
    """The 8 quarter-pel samples of phase (fy, fx) (K, 32) of each lane
    from the (K, 4, 22, 22) planes, pixel 0 at plane coordinates (y, x)
    (K, 32): the rounded mean of the two plane samples of `PHASES`."""
    e = PHASE_TAB[4 * fy + fx]                               # (K, 32, 6)
    kk = torch.arange(planes.shape[0])[:, None, None]
    cols = x[..., None] + torch.arange(8)

    def read(pl, ey, ex):
        yy, xx = (y + ey)[..., None], cols + ex[..., None]
        assert int(yy.min()) >= 0 and int(yy.max()) < 22
        assert int(xx.min()) >= 0 and int(xx.max()) < 22
        return planes[kk, pl[..., None], yy, xx]

    a = read(e[..., 0], e[..., 1], e[..., 2])
    b = read(e[..., 3], e[..., 4], e[..., 5])
    return (a + b + 1) >> 1


def emulate_k5(cur, k4, lam, mutation=None):
    """K5 as the kernel schedules it (`csrc/me.cu` `partition_kernel`): a
    warp per MB, lane (i, h) owning row i and pixels 8 h .. 8 h + 7.
    - One full-pel pass: each lane's SADs on F at the 25 positions +-2
      around the 16x16 winner, packed two to a word, reduced over the
      lane bits of i & 7 (`K5_FULL_ROUNDS`) into the 8x8 quadrants' SADs;
      the partner across h adds the 16x8 half, the partner across i >> 3
      the 8x16 half (`K5_PARTNER`); each block's winner the least key of
      its lanes (`segment_min` over lane bits 1-3).
    - Per geometry one quarter-pel pass: every lane sweeps the 49
      positions +-3 around its own block's full-pel winner; the packed
      sums reduced by the geometry's rounds (`K5_ROUNDS`; 8x16 one 32-slot
      set, 16x8 and 8x8 two 16-slot sets), each lane's positions those the
      rounds leave it (held against the kernel's formulas); the keyed
      minimum over the block's lanes (`K5_SEGMENT`); each lane's 8
      prediction samples of the winning phase; a block's MV from its first
      lane, the cost sum from lane 0's partners.
    cur (K, 16, 16), lam (K,). `mutation`: "wrong_pair" (the 16x8 halves
    paired across lane bit 1, i & 1, instead of h), "shared_centre" (every
    quarter-pel pass centred on the 16x16 winner) or "lane_key" (keys
    ordered by lane). Returns (`partition_search`'s dict, each geometry's
    full-pel winners (K, blocks) as raster indices of the +-2 sweep)."""
    cur, planes = cur.long(), k4["planes"].long()
    kk = cur.shape[0]
    fmy, fmx, pvy, pvx = (k4[k][:, None] for k in ("full_my", "full_mx",
                                                   "mvp_y", "mvp_x"))
    lam = lam[:, None, None]
    lane_key = mutation == "lane_key"
    lane_cur = cur.reshape(kk, 32, 8)
    i, h, g = LANE_I, LANE_H, LANE_I & 7
    kidx = torch.arange(kk)[:, None, None]
    # the full-pel pass: F rows 1 + i + dy, columns 8 h + 1 + dx ..
    cols = 8 * h[:, None] + torch.arange(8)
    part = torch.stack([
        (lane_cur - planes[kidx, 0, (1 + i + p // 5)[:, None],
                           cols + 1 + p % 5]).abs().sum(2)
        for p in range(25)], 2)
    words, lab = pack(part, 16)
    words, lab = scatter_rounds(words, lab, K5_FULL_ROUNDS)
    assert torch.equal(lab, torch.stack([4 * g, 4 * g + 2], 1))
    pairs = dict(K5_PARTNER)
    if mutation == "wrong_pair":
        pairs["16x8"] = 2
    sums = {"8x8": words}
    for name, o in pairs.items():
        sums[name] = (words + words[:, LANES ^ o]) & 0xFFFFFFFF
    out, full = {}, {}
    for name, offsets, bh, bw in GEOMETRIES:
        pos, sad = unpack(sums[name], lab)
        cost = sad + lam * (bits(4 * (fmy[..., None] + pos // 5 - 2)
                                 - pvy[..., None])
                            + bits(4 * (fmx[..., None] + pos % 5 - 2)
                                   - pvx[..., None]))
        w, _ = segment_min(cost, pos, 25, 0xE, lane_key)   # (K, 32)
        blk = K5_BLOCK[name]
        first = [int((blk == b).nonzero()[0]) for b in range(len(offsets))]
        full[name] = w[:, first]
        if mutation == "shared_centre":
            w = torch.full_like(w, 12)
        bdy, bdx = w // 5 - 2, w % 5 - 2
        bmy, bmx = fmy + bdy, fmx + bdx
        # the quarter-pel pass around each lane's block winner
        part = torch.stack([
            (lane_cur - lane_samples(
                planes, torch.full_like(w, (p // 7 - 3) & 3),
                torch.full_like(w, (p % 7 - 3) & 3),
                3 + i + bdy + ((p // 7 - 3) >> 2),
                3 + 8 * h + bdx + ((p % 7 - 3) >> 2))).abs().sum(2)
            for p in range(49)], 2)
        words_q, lab_q = pack(part, 32)
        rounds = K5_ROUNDS[name]
        if name == "8x16":
            words_q, lab_q = scatter_rounds(words_q, lab_q, rounds)
            formula = [4 * i, 4 * i + 2]
        else:
            halves = [scatter_rounds(words_q[:, :, 16 * j:16 * j + 16],
                                     lab_q[16 * j:16 * j + 16], rounds)
                      for j in range(2)]
            words_q = torch.cat([x for x, _ in halves], 2)
            lab_q = torch.cat([x for _, x in halves], 1)
            formula = ([4 * g + 2 * h, 32 + 4 * g + 2 * h] if name == "16x8"
                       else [4 * g, 4 * g + 2, 32 + 4 * g, 34 + 4 * g])
        assert torch.equal(lab_q, torch.stack(formula, 1)), name
        pos, sad = unpack(words_q, lab_q)
        cost = sad + lam * (bits(4 * bmy[..., None] + pos // 7 - 3
                                 - pvy[..., None])
                            + bits(4 * bmx[..., None] + pos % 7 - 3
                                   - pvx[..., None]))
        p, c = segment_min(cost, pos, 49, K5_SEGMENT[name], lane_key)
        dyq, dxq = p // 7 - 3, p % 7 - 3
        out[f"pred{name}"] = lane_samples(
            planes, dyq & 3, dxq & 3, 3 + i + bdy + (dyq >> 2),
            3 + 8 * h + bdx + (dxq >> 2)).reshape(kk, 16, 16)
        out[f"mv{name}"] = torch.stack([4 * bmy + dyq, 4 * bmx + dxq],
                                       2)[:, first]
        # lane 0's sum: its block's cost and its partners' across the
        # lane bits that tell the blocks apart
        for o in {"16x8": (16,), "8x16": (1,), "8x8": (1, 16)}[name]:
            c = c + c[:, LANES ^ o]
        out[f"cost{name}"] = c[:, 0]
    return out, full


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


def k5_lam(d, nmb):
    """The ME lambda of each MB of a case's inputs, (K,)."""
    return _t(tme.LAMBDA_ME).long()[_t(d["qp"]).long()].repeat_interleave(
        nmb)


@functools.lru_cache(maxsize=None)
def case(c):
    """A case's inputs, its emulations and the port's plain outputs."""
    seed, n, mbw, mbh, qp, lanes, rows, subpel = c
    d = me_inputs(seed, n, mbw, mbh, qp, lanes=lanes, frame_rows=rows)
    k4 = emulate_k4(d, mbw, mbh, subpel)
    plain = plain_me(d, mbw, mbh, subpel)
    out = dict(d=d, k4=k4, plain=plain)
    if subpel:
        out["k5"], out["k5_full"] = emulate_k5(
            _t(d["cur_tiles"]).reshape(-1, 16, 16), k4, k5_lam(d, mbw * mbh))
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
    # the inputs hold what the cases are for: in every geometry some MBs
    # have blocks whose full-pel winners differ from one another and from
    # the 16x16 winner (raster index 12 of the +-2 sweep), which the
    # quadrant pairing and the blocks' own centres serve
    for name, w in got["k5_full"].items():
        assert ((w != w[:, :1]).any(1) & (w != 12).any(1)).any(), name


@pytest.mark.parametrize("mutation", ["wrong_pair", "shared_centre",
                                      "lane_key"])
def test_k5_schedule_mutations_fail(mutation):
    """Each named fault in K5's schedule makes the emulation differ from
    the plain partition search on every sub-pel case: the 16x8 halves
    paired across the wrong lane bit (i & 1 instead of h), every quarter-
    pel pass centred on the 16x16 winner instead of its block's own, and
    keys that order ties by lane instead of position."""
    for c in [c for c in CASES if c[7]]:
        got = case(c)
        k5, _ = emulate_k5(_t(got["d"]["cur_tiles"]).reshape(-1, 16, 16),
                           got["k4"], k5_lam(got["d"], c[2] * c[3]),
                           mutation)
        assert any(not np.array_equal(k5[k].numpy().astype(np.int64),
                                      v.numpy().astype(np.int64))
                   for k, v in got["plain_part"].items()), _ids(c)


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


def band_case(subpel=True):
    """Bands of 9 x 5 MBs deep in frames of 12 MB rows (row offsets 3, 1
    and 7): the grid of a tile on a band's first row must stop there."""
    d = me_inputs(85, 3, 9, 5, 20, lanes=1, frame_rows=12)
    d["row_offset"][:] = (3, 1, 7)
    return d, 9, 5, subpel


def deep_cut_case(subpel):
    """Planes cut to 100 x 100 above and left of the last tiles of bands
    at row offsets 6 and 3 (11 x 2 MBs, frames of 8 MB rows): the strips
    of those tiles start clamped, and windows start before where an
    unclamped strip would."""
    d = me_inputs(86, 2, 11, 2, 33, lanes=1, frame_rows=8)
    d["row_offset"][:] = (6, 3)
    d["y_pad"] = np.ascontiguousarray(d["y_pad"][:, :100, :100])
    return d, 11, 2, subpel


def _differs(k4, plain):
    return [k for k, v in _plain_fields(plain).items()
            if not np.array_equal(np.asarray(k4[k]).astype(np.int64).ravel(),
                                  np.asarray(v).astype(np.int64).ravel())]


def test_k4_schedule_stops_the_halo_at_the_band_top():
    d, mbw, mbh, subpel = band_case()
    k4 = emulate_k4(d, mbw, mbh, subpel)
    plain = plain_me(d, mbw, mbh, subpel)
    assert _differs(k4, plain) == []
    # each band's first row takes its left neighbour alone, though the
    # frame has rows above it
    first = (torch.arange(3)[:, None] * 45 + torch.arange(1, 9)).reshape(-1)
    assert torch.equal(k4["mvp_x"][first], 16 * k4["cx4"][first - 1])
    assert (d["row_offset"] > 0).all()


@pytest.mark.parametrize("subpel", [True, False])
def test_k4_schedule_clamps_the_strip_origin(subpel):
    d, mbw, mbh, subpel = deep_cut_case(subpel)
    k4 = emulate_k4(d, mbw, mbh, subpel)
    assert _differs(k4, plain_me(d, mbw, mbh, subpel)) == []
    # the clamp was reached: a tile's strip origin 16 (r0 + row offset) =
    # 96 lies below the plane's last window start, 100 - 34
    assert 16 * (0 + 6) > 100 - 34


@pytest.mark.parametrize("mutation", ["halo_above", "unclamped_strip",
                                      "lane_key"])
def test_k4_schedule_mutations_fail(mutation):
    """Each named fault in the schedule makes the emulation differ from
    the plain search on a case that exercises it: a coarse grid that
    reaches above the band's first row, a strip origin left unclamped, and
    keys that order ties by lane instead of raster index."""
    d, mbw, mbh, subpel = {"halo_above": band_case,
                           "unclamped_strip": deep_cut_case,
                           "lane_key": band_case}[mutation](True)
    k4 = emulate_k4(d, mbw, mbh, subpel, mutation)
    assert _differs(k4, plain_me(d, mbw, mbh, subpel)) != []


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
