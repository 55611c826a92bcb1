"""Deterministic synthetic test input: rotating chessboard.

Behavioral clone of the reference driver's asset-free input generator
(`src/minih264e_test.c:407-452`): an anti-aliased chessboard rotated by
0.01 rad/frame, gray chroma. Lets every test and benchmark run without
shipping video assets. Vectorized over the full frame; C truncation
semantics (`(int)x`, `i/16`) are reproduced with trunc operations.
"""

from __future__ import annotations

import functools

import numpy as np

_PAN_PAD = 64                       # noise_pan_frame's texture margin


def _pixel_field(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    mid = (np.abs(x) < 4) & (np.abs(y) < 4)
    i = np.trunc(x).astype(np.int64)
    j = np.trunc(y).astype(np.int64)
    idiv16 = np.trunc(i / 16.0).astype(np.int64)   # C truncating division
    jdiv16 = np.trunc(j / 16.0).astype(np.int64)
    black = np.where(mid, 128, idiv16)
    white = np.where(mid, 128, 255 - jdiv16)

    def cell(ii, jj):
        return np.where((((ii >> 4) + (jj >> 4)) & 1) != 0, white, black)

    c00 = cell(i, j)
    c01 = cell(i + 1, j)
    c10 = cell(i, j + 1)
    c11 = cell(i + 1, j + 1)
    fx = x - i
    fy = y - j
    s = ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
         + (c10 * (1 - fx) + c11 * fx) * fy + 0.5).astype(np.int64)
    return np.clip(s, 0, 255).astype(np.uint8)


def chessboard_frame(width: int, height: int, frame_idx: int) -> np.ndarray:
    """Luma plane (height, width) uint8 for frame `frame_idx`."""
    co = np.cos(0.01 * frame_idx)
    si = np.sin(0.01 * frame_idx)
    c = np.arange(width, dtype=np.float64)[None, :] - (width >> 1)
    r = np.arange(height, dtype=np.float64)[:, None] - (height >> 1)
    x = co * c + si * r
    y = -si * c + co * r
    return _pixel_field(x, y)


def chessboard_sequence(width: int, height: int, n_frames: int,
                        start: int = 0):
    """Yield (y, u, v) planes; chroma is constant mid-gray (128), matching
    the reference driver (`src/minih264e_test.c:580-583`)."""
    u = np.full((height // 2, width // 2), 128, dtype=np.uint8)
    v = np.full((height // 2, width // 2), 128, dtype=np.uint8)
    for t in range(start, start + n_frames):
        yield chessboard_frame(width, height, t), u, v


@functools.lru_cache(maxsize=4)
def _noise_texture(width: int, height: int, seed: int) -> np.ndarray:
    """The box-filtered, contrast-stretched random field that
    `noise_pan_frame` samples, made once per (width, height, seed) and
    kept for the last few sizes (read-only: every frame shares it)."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (height + 2 * _PAN_PAD, width + 2 * _PAN_PAD))
    tex = tex.astype(np.float64)
    for _ in range(2):                     # separable 5-tap box, twice
        k = np.ones(5) / 5.0
        tex = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 0, tex)
        tex = np.apply_along_axis(
            lambda m: np.convolve(m, k, mode="same"), 1, tex)
    tex = np.clip((tex - tex.mean()) * 3.0 + 128.0, 0, 255)
    tex.flags.writeable = False
    return tex


def noise_pan_frame(width: int, height: int, frame_idx: int,
                    seed: int = 7, vx: float = 1.5, vy: float = 0.5):
    """Low-pass-filtered random texture panning at a constant sub-pel
    velocity — a natural-content stand-in (smooth gradients + global
    motion) complementing the chessboard's hard periodic edges. The
    texture is a fixed random field box-filtered twice; frames sample it
    at a translated origin with bilinear interpolation, so motion
    estimation must track real sub-pel displacement."""
    tex = _noise_texture(width, height, seed)
    pad = _PAN_PAD
    ox = (pad + vx * frame_idx) % pad
    oy = (pad + vy * frame_idx) % pad
    i0, j0 = int(oy), int(ox)
    fy, fx = oy - i0, ox - j0
    w = tex[i0:i0 + height + 1, j0:j0 + width + 1]
    s = ((w[:-1, :-1] * (1 - fx) + w[:-1, 1:] * fx) * (1 - fy)
         + (w[1:, :-1] * (1 - fx) + w[1:, 1:] * fx) * fy + 0.5)
    return np.clip(s, 0, 255).astype(np.uint8)


def noise_pan_sequence(width: int, height: int, n_frames: int,
                       start: int = 0):
    """Yield (y, u, v) panning filtered-noise frames (gray chroma)."""
    u = np.full((height // 2, width // 2), 128, dtype=np.uint8)
    v = np.full((height // 2, width // 2), 128, dtype=np.uint8)
    for t in range(start, start + n_frames):
        yield noise_pan_frame(width, height, t), u, v


def color_chroma_sequence(width: int, height: int, n_frames: int,
                          seed: int = 11, start: int = 0):
    """Yield (y, u, v): the rotating chessboard's luma with non-flat
    chroma, each plane its own seeded noise field (`noise_pan_frame` of
    the chroma size, seeds `seed` and `seed + 1`) panning as the luma
    rotates. Chroma edges then differ across MB and slice boundaries, so
    a decoder that predicts chroma across a slice edge shows it, where
    the flat chroma of `chessboard_sequence` and `noise_pan_sequence`
    hides it. The other sequences' output is unchanged."""
    wc, hc = width // 2, height // 2
    for t in range(start, start + n_frames):
        yield (chessboard_frame(width, height, t),
               noise_pan_frame(wc, hc, t, seed=seed),
               noise_pan_frame(wc, hc, t, seed=seed + 1, vx=-0.75, vy=1.25))


def deblock_inputs(seed: int, n: int, mb_width: int, mb_height: int,
                   qp: int, per_mb_qp: bool = False,
                   band: bool = False) -> dict:
    """Seeded inputs of `models.mbscan.deblock_frame` for n frames or bands
    of mb_width x mb_height MBs, made so that every filter path runs:
    - recon: a wave that saturates at 0 and 255, with steps between 4x4
      blocks (small ones that the filters smooth, a few large ones they
      keep) and low noise; a third of the MBs flat, for the strong luma
      filter;
    - intra and inter MBs (sel), coded 4x4 blocks (nnz_blk) and MVs whose
      blocks differ by 4 or more or not at all: bS 0 to 4;
    - QPs around `qp` (+-4 per frame; +-6 more per MB with `per_mb_qp`),
      clipped to 0..51; the chroma QPs from them (spec Table 8-15);
    - with `band`, the first MB row and column unavailable (avail_top,
      avail_left false), as in a slice band.
    Returns numpy arrays keyed by `deblock_frame`'s argument names:
    recon_y (n, nmb, 16, 16), recon_u and recon_v (n, nmb, 8, 8) uint8;
    sel (n, nmb), nnz_blk, mv4_y, mv4_x (n, nmb, 4, 4), qp and qpc (n,) or
    (n, nmb) int32; avail_top, avail_left (nmb,) bool."""
    from h264lab_tpu_torch.ops.tables import QPC_FROM_QPY

    rng = np.random.default_rng(seed)
    nmb = mb_width * mb_height
    flat = rng.random((n, mb_height, mb_width)) < 1 / 3

    def tiles(t):
        h, w = mb_height * t, mb_width * t
        yy, xx = np.mgrid[0:h, 0:w]
        freq = rng.uniform(0.02, 0.08, (n, 2, 1, 1)) * 16 / t
        phase = rng.uniform(0, 2 * np.pi, (n, 1, 1))
        wave = 128 + 160 * np.sin(freq[:, 0] * xx + freq[:, 1] * yy + phase)
        steps = rng.integers(-6, 7, (n, h // 4, w // 4))
        steps[rng.random(steps.shape) < 0.05] *= 12
        noise = rng.integers(-1, 2, (n, h, w))
        rough = np.repeat(np.repeat(~flat, t, 1), t, 2)
        texture = np.repeat(np.repeat(steps, 4, 1), 4, 2) + noise
        p = np.clip(np.round(wave) + rough * texture, 0, 255).astype(np.uint8)
        return p.reshape(n, mb_height, t, mb_width, t).transpose(
            0, 1, 3, 2, 4).reshape(n, nmb, t, t)

    recon_y, recon_u, recon_v = tiles(16), tiles(8), tiles(8)
    sel = rng.choice(np.array([0, 0, 0, 1, 2], np.int32), (n, nmb))
    nnz = (rng.integers(1, 17, (n, nmb, 4, 4))
           * (rng.random((n, nmb, 4, 4)) < 0.3)).astype(np.int32)

    def mvs():
        base = rng.integers(-20, 21, (n, nmb, 1, 1))
        moved = rng.random((n, nmb, 4, 4)) < 0.25
        return (base + moved * rng.integers(-8, 9, (n, nmb, 4, 4))).astype(
            np.int32)

    mv4_y, mv4_x = mvs(), mvs()
    q = np.clip(qp + rng.integers(-4, 5, n), 0, 51)
    if per_mb_qp:
        q = np.clip(q[:, None] + rng.integers(-6, 7, (n, nmb)), 0, 51)
    q = q.astype(np.int32)
    row = np.arange(nmb) // mb_width
    col = np.arange(nmb) % mb_width
    return dict(recon_y=recon_y, recon_u=recon_u, recon_v=recon_v, sel=sel,
                nnz_blk=nnz, mv4_y=mv4_y, mv4_x=mv4_x, qp=q,
                qpc=QPC_FROM_QPY[q].astype(np.int32),
                avail_top=(row > 0) | (not band),
                avail_left=(col > 0) | (not band))


def wavefront_inputs(seed: int, n: int, mb_width: int, mb_height: int,
                     qp: int, inter: bool = False) -> dict:
    """Seeded inputs of `models.mbscan._select_wavefront` for n frames or
    bands of mb_width x mb_height MBs, made so that every candidate wins
    somewhere and ties are common:
    - source tiles, a kind per MB: flat (a constant, often 128, so the
      three Intra_16x16 modes tie), a gradient with low noise, a
      chessboard of two values in 2- or 4-pixel cells (SAD ties between
      modes), diagonal stripes (Intra_4x4's directional modes win) and
      strong noise saturating at 0 and 255; chroma likewise;
    - QPs: `qp` on the first frame, around it on the others (+-3,
      clipped to 0..51), the chroma QPs from them (spec Table 8-15);
    - with `inter`, the inter candidate: per MB a cost that is low (inter
      wins), mid or past any intra cost, and a reconstruction that is the
      source with a spread of +-6.
    Returns numpy arrays keyed by `_select_wavefront`'s argument names:
    src_y_mb (n, nmb, 16, 16), src_u_mb and src_v_mb (n, nmb, 8, 8) uint8;
    qp and qpc (n,) int32; avail_top, avail_left (nmb,) bool (the first
    row and column unavailable); with `inter` also inter_cost (n, nmb)
    int32, recon_y_inter (n, nmb, 16, 16), recon_u_inter and
    recon_v_inter (n, nmb, 8, 8) uint8."""
    from h264lab_tpu_torch.ops.tables import QPC_FROM_QPY

    rng = np.random.default_rng(seed)
    nmb = mb_width * mb_height

    def tiles(t):
        kind = rng.integers(0, 5, (n, nmb, 1, 1))
        yy, xx = np.mgrid[0:t, 0:t]
        level = np.where(rng.random((n, nmb, 1, 1)) < 0.5, 128,
                         rng.integers(0, 256, (n, nmb, 1, 1)))
        grad = (level + rng.integers(-6, 7, (n, nmb, 1, 1)) * (yy - t // 2)
                + rng.integers(-6, 7, (n, nmb, 1, 1)) * (xx - t // 2)
                + rng.integers(-2, 3, (n, nmb, t, t)))
        cell = np.where(rng.random((n, nmb, 1, 1)) < 0.5, 2, 4)
        lo, hi = (rng.integers(0, 256, (n, nmb, 1, 1)) for _ in range(2))
        chess = np.where((yy // cell + xx // cell) % 2 == 1, hi, lo)
        period = rng.integers(3, 9, (n, nmb, 1, 1))
        slope = np.where(rng.random((n, nmb, 1, 1)) < 0.5, 1, -1)
        stripes = np.where((xx + slope * yy) % period < period // 2, hi, lo)
        noise = level + rng.integers(-200, 201, (n, nmb, t, t))
        px = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                       [np.broadcast_to(level, (n, nmb, t, t)), grad, chess,
                        stripes], noise)
        return np.clip(px, 0, 255).astype(np.uint8)

    src_y, src_u, src_v = tiles(16), tiles(8), tiles(8)
    offsets = rng.integers(-3, 4, n)
    offsets[0] = 0
    q = np.clip(qp + offsets, 0, 51).astype(np.int32)
    row = np.arange(nmb) // mb_width
    col = np.arange(nmb) % mb_width
    out = dict(src_y_mb=src_y, src_u_mb=src_u, src_v_mb=src_v, qp=q,
               qpc=QPC_FROM_QPY[q].astype(np.int32), avail_top=row > 0,
               avail_left=col > 0)
    if inter:
        band = rng.integers(0, 3, (n, nmb))
        cost = np.select([band == 0, band == 1],
                         [rng.integers(0, 200, (n, nmb)),
                          rng.integers(200, 8000, (n, nmb))], 1 << 20)

        def spread(x):
            return np.clip(x.astype(np.int32)
                           + rng.integers(-6, 7, x.shape), 0, 255).astype(
                               np.uint8)
        out.update(inter_cost=cost.astype(np.int32),
                   recon_y_inter=spread(src_y), recon_u_inter=spread(src_u),
                   recon_v_inter=spread(src_v))
    return out


def me_inputs(seed: int, n: int, mb_width: int, mb_height: int, qp: int,
              lanes: int = 1, frame_rows: int | None = None,
              stripes: bool = False) -> dict:
    """Seeded inputs of the motion search (`ops.me.motion_search_tiles`,
    the plain `motion_search_dense`) for n frames or bands of mb_width x
    mb_height MBs that search `lanes` reference pictures of frame_rows MB
    rows (default mb_height), made so that ties and every candidate occur:
    - references: a smooth noise texture with MB-sized flat areas (all
      128) and chessboards of 2- or 4-pixel cells, guard-padded by edge
      replication (GUARD 64) with their 4x planes (`(sum + 8) >> 4`, guard
      16), as `refstate.prepare_reference` builds them;
    - current tiles, a kind per MB: flat 128 (ties everywhere on flat
      references), a chessboard (ties between periods), the reference
      texture moved by the frame's motion (none on the first frame, up to
      +-12 pixels on the others) with noise of +-2 or none, the rounded
      mean of two horizontally neighbouring such blocks (a half-pel
      match), and an unmatched patch of uniform noise;
    - frame k searches lane k % lanes at a band row offset in 0 ..
      frame_rows - mb_height; QPs: `qp` on the first frame, around it on
      the others (+-3, clipped to 0..51);
    - previous full-pel MVs from -70 to 70 (past the +-52 clip), a tenth
      zero, with +-52 and +-53 on some MBs; the first MB of the first
      frame is flat with a zero previous MV, the last MB of the last frame
      has the previous MV (-66, 61);
    - with `stripes`, every reference is vertical stripes of period 8 (4
      pixels at 0, 4 at 200), every tile that pattern moved by 4 pixels
      and every previous MV (0, 4): the candidate centres (0, -4) and (0,
      4) then tie where the predictor is zero (each band's first MB).
    Returns numpy arrays: y_pad (lanes, 16 frame_rows + 128, 16 mb_width
    + 128) and y4_pad (lanes, 4 frame_rows + 32, 4 mb_width + 32) uint8;
    cur_tiles (n, nmb, 16, 16) uint8; lane, row_offset, qp (n,) int32;
    prev_my, prev_mx (n, nmb) int32."""
    rng = np.random.default_rng(seed)
    frame_rows = mb_height if frame_rows is None else frame_rows
    nmb = mb_width * mb_height
    hf, wf = 16 * frame_rows, 16 * mb_width
    g = 64
    # the references: a smooth texture with flat and chessboard MBs
    tex = rng.integers(0, 256, (lanes, hf + 4, wf + 4)).astype(np.float64)
    tex = sum(tex[:, i:i + hf, j:j + wf] for i in range(5) for j in range(5))
    ref = np.clip((tex / 25 - 128) * 4 + 128, 0, 255).astype(np.int64)
    yy, xx = np.mgrid[0:16, 0:16]
    tiles = ref.reshape(lanes, frame_rows, 16, mb_width, 16).transpose(
        0, 1, 3, 2, 4)
    kind = rng.integers(0, 4, (lanes, frame_rows, mb_width))
    tiles[kind == 0] = 128
    cell = np.where(rng.random(int((kind == 1).sum())) < 0.5, 2, 4)
    lo, hi = rng.integers(0, 256, (2, len(cell)))
    chess = (yy // cell[:, None, None] + xx // cell[:, None, None]) % 2
    tiles[kind == 1] = np.where(chess == 1, hi[:, None, None],
                                lo[:, None, None])
    ref = tiles.transpose(0, 1, 3, 2, 4).reshape(lanes, hf, wf)
    y_pad = np.pad(ref, ((0, 0), (g, g), (g, g)), mode="edge")
    y4 = (ref.reshape(lanes, hf // 4, 4, wf // 4, 4).sum((2, 4)) + 8) >> 4
    y4_pad = np.pad(y4, ((0, 0), (g // 4, g // 4), (g // 4, g // 4)),
                    mode="edge")
    # the current tiles
    lane = np.arange(n) % lanes
    row_offset = rng.integers(0, frame_rows - mb_height + 1, n)
    move = rng.integers(-12, 13, (n, 2))
    move[0] = 0
    r = np.arange(nmb) // mb_width + row_offset[:, None]
    c = np.arange(nmb) % mb_width
    oy = g + 16 * r + move[:, :1]                           # (n, nmb)
    ox = g + 16 * c[None] + move[:, 1:]

    def block(dx):
        return y_pad[lane[:, None, None, None],
                     oy[..., None, None] + yy, ox[..., None, None] + xx + dx]

    moved = block(0)
    noise = rng.integers(-2, 3, (n, nmb, 16, 16)) * (
        rng.random((n, nmb, 1, 1)) < 0.5)
    kind = rng.integers(0, 8, (n, nmb, 1, 1))
    kind[0, 0] = 0
    cell = np.where(rng.random((n, nmb, 1, 1)) < 0.5, 2, 4)
    lo, hi = rng.integers(0, 256, (2, n, nmb, 1, 1))
    cur = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3],
        [np.full_like(moved, 128),
         np.where((yy // cell + xx // cell) % 2 == 1, hi, lo),
         (moved + block(1) + 1) >> 1,
         rng.integers(0, 256, moved.shape)], moved + noise)
    prev = rng.integers(-70, 71, (2, n, nmb))
    prev[:, rng.random((n, nmb)) < 0.1] = 0
    edge = rng.random((n, nmb)) < 0.1
    prev[:, edge] = rng.choice(np.array([-53, -52, 52, 53]),
                               (2, int(edge.sum())))
    prev[:, 0, 0] = 0
    prev[:, -1, -1] = (-66, 61)
    offsets = rng.integers(-3, 4, n)
    offsets[0] = 0
    if stripes:
        y_pad = np.broadcast_to(200 * ((np.arange(wf + 2 * g) // 4) % 2),
                                y_pad.shape).copy()
        y4_pad = np.broadcast_to(200 * ((np.arange(wf // 4 + g // 2)) % 2),
                                 y4_pad.shape).copy()
        cur = np.broadcast_to(200 * (((xx + 4) // 4) % 2), cur.shape).copy()
        prev[0], prev[1] = 0, 4
    i32 = np.int32
    return dict(y_pad=y_pad.astype(np.uint8), y4_pad=y4_pad.astype(np.uint8),
                cur_tiles=np.clip(cur, 0, 255).astype(np.uint8),
                lane=lane.astype(i32), row_offset=row_offset.astype(i32),
                qp=np.clip(qp + offsets, 0, 51).astype(i32),
                prev_my=prev[0].astype(i32), prev_mx=prev[1].astype(i32))


def sym_inputs(seed: int, n: int, mb_width: int, mb_height: int,
               has_inter: bool, plan: bool = False,
               dense: bool = False) -> dict:
    """Seeded inputs of `models.mbscan.symbolize` for n I or P slices of
    mb_width x mb_height MBs, made so that every branch of the symbolizer
    is taken:
    - MB kinds: P slices inter (partition shapes 0-3, each partition with
      its own MV, small or up to +-40 quarter-pel), Intra_16x16 and
      Intra_4x4 MBs; I slices Intra_16x16 and Intra_4x4; Intra_16x16 MBs
      with and without AC levels (their DC position 0, as the select stage
      leaves it);
    - residual blocks empty, sparse (levels +-1 to +-3, trailing ones) or
      dense (all 16 positions, or the 15 AC ones, nonzero, with levels up
      to +-3000 that take both escapes of the level code); dense blocks
      side by side give nC >= 8; 8x8 quarters without levels vary the cbp;
      chroma none (cbpc 0), DC only (1) or with AC (2);
    - P_Skip: inter MBs without residual and a zero MV, in runs across a
      row end and at each slice's end, and on an independent set of MBs
      (odd rows, every third column: no two of them neighbours) the
      P_Skip predictor's MV, often nonzero (`mbscan._mv_predictors` on
      the MBs around them);
    - Intra_4x4 symbols of 1 (the predicted mode) or 4 bits, Intra_16x16
      and chroma modes 0-3;
    - with `plan`, a row QP plan (n, mb_height) of QPs 0-51 that changes
      on most rows; MBs without mb_qp_delta (skipped, inter without
      residual) keep the running QP;
    - with `dense`, every position a block codes is nonzero instead (16
      of a luma or Intra_16x16 DC block, 15 of an AC block, 4 of a chroma
      DC block; no MB is quiet, so none is skipped), with levels of +-1,
      +-2 to 20, +-100 to 600 and +-2100 to 3000, so that blocks take both
      escapes and suffixLength climbs to 6: the content on which coding a
      block position by position costs the most.
    Returns numpy int32 arrays keyed by `symbolize`'s argument names: sel,
    mode16, cmode, shape (n, nmb); i4sym_v, i4sym_l (n, nmb, 16); mv4_y,
    mv4_x (n, nmb, 4, 4); dc_lev (n, nmb, 4, 4); ac_lev, lev_inter (n, nmb,
    4, 4, 4, 4); cdc_lev (n, nmb, 2, 2, 2); cac_lev (n, nmb, 2, 2, 2, 4, 4);
    and qp_rows (n, mb_height) or None."""
    import torch

    from h264lab_tpu_torch.models import mbscan

    rng = np.random.default_rng(seed)
    nmb = mb_width * mb_height
    i32 = np.int32
    idx = np.arange(nmb)
    if has_inter:
        sel = rng.choice([mbscan.SEL_INTER] * 3 + [mbscan.SEL_I16,
                                                   mbscan.SEL_I4], (n, nmb))
    else:
        sel = rng.choice([mbscan.SEL_I16, mbscan.SEL_I4], (n, nmb))
    inter = sel == mbscan.SEL_INTER
    # quiet inter MBs (no residual, zero MV): scattered, a run across the
    # first row end and the last one and a half rows of each slice
    quiet = inter & (rng.random((n, nmb)) < 0.25)
    # the MBs that get the P_Skip predictor's MV: an independent set (odd
    # rows, every third column), which the MVs they get leave as it is
    r, c = idx // mb_width, idx % mb_width
    pick = np.zeros((n, nmb), bool)
    if has_inter:
        run = (idx >= mb_width - 1) & (idx < mb_width + 1)
        tail = idx >= nmb - max(mb_width // 2 + 1, 2)
        pick = ((r % 2 == 1) & (c % 3 == 1) & ~tail) & (
            rng.random((n, nmb)) < 0.6)
        quiet[:, (run | tail) & (idx > 0)] = True
        quiet[:, 0] = False
        # their left and upper neighbours are coded inter MBs, so that the
        # predictor is seldom forced to zero
        near = np.zeros_like(pick)
        near[:, :-1] |= pick[:, 1:]
        near[:, :-mb_width] |= pick[:, mb_width:]
        quiet = (quiet & ~near) | pick
        sel[quiet | near] = mbscan.SEL_INTER
        inter = sel == mbscan.SEL_INTER

    def levels(shape, density):
        """Sparse small levels, or (on a few blocks) dense large ones."""
        small = rng.choice([-3, -2, -1, -1, 1, 1, 2, 3], shape)
        sparse = small * (rng.random(shape) < density)
        big = rng.choice([-1, 1], shape) * np.select(
            [rng.random(shape) < p for p in (0.3, 0.5, 0.7)],
            [rng.integers(1, 21, shape), rng.integers(100, 601, shape),
             rng.integers(2100, 3001, shape)], rng.integers(1, 4, shape))
        dense = rng.random(shape[:-2] + (1, 1)) < 0.08
        return np.where(dense, big, sparse)

    blk = (n, nmb, 4, 4, 4, 4)
    lev = levels(blk, 0.25)
    # 8x8 quarters without levels
    quarter = rng.random((n, nmb, 2, 1, 2, 1, 1, 1)) < 0.3
    lev = np.where(np.broadcast_to(quarter, (n, nmb, 2, 2, 2, 2, 1, 1))
                   .reshape(n, nmb, 4, 4, 1, 1), 0, lev)
    i16 = sel == mbscan.SEL_I16
    i4 = sel == mbscan.SEL_I4
    no_ac = i16 & (rng.random((n, nmb)) < 0.4)
    ac_lev = np.where((i4 | (i16 & ~no_ac))[..., None, None, None, None],
                      lev, 0)
    ac_lev[..., 0, 0] = np.where(i16[..., None, None], 0,
                                 ac_lev[..., 0, 0])      # I16: DC apart
    lev_inter = np.where((inter & ~quiet)[..., None, None, None, None],
                         levels(blk, 0.25), 0)
    dc_lev = np.where(i16[..., None, None], levels((n, nmb, 4, 4), 0.4), 0)
    chroma = rng.integers(0, 3, (n, nmb))
    chroma[quiet] = 0
    cdc_lev = np.where((chroma >= 1)[..., None, None, None],
                       levels((n, nmb, 2, 2, 2), 0.6), 0)
    cdc_lev[chroma == 1, 0, 0, 0] = 1             # cbpc 1 is really 1
    cac_lev = np.where((chroma == 2)[..., None, None, None, None, None],
                       levels((n, nmb, 2, 2, 2, 4, 4), 0.15), 0)
    cac_lev[..., 0, 0] = 0                         # chroma AC: DC apart
    cac_lev[chroma == 2, 0, 0, 0, 0, 1] = -1       # cbpc 2 is really 2

    # partition-constant MVs: shape 0 (16x16), 1 (16x8), 2 (8x16), 3 (8x8)
    shape = np.where(inter & ~quiet, rng.integers(0, 4, (n, nmb)), 0)
    mv = np.where(rng.random((2, n, nmb, 2, 2)) < 0.5,
                  rng.integers(-3, 4, (2, n, nmb, 2, 2)),
                  rng.integers(-40, 41, (2, n, nmb, 2, 2)))
    part = np.select([shape == 0, shape == 1, shape == 2],
                     [np.zeros((n, nmb), int), np.ones((n, nmb), int),
                      np.full((n, nmb), 2)], 3)[None, ..., None, None]
    q = np.where(part == 0, mv[..., :1, :1],
                 np.where(part == 1, mv[..., :, :1],
                          np.where(part == 2, mv[..., :1, :], mv)))
    q = np.broadcast_to(q, (2, n, nmb, 2, 2))
    mv4 = q.repeat(2, -2).repeat(2, -1)
    mv4 = np.where((inter & ~quiet)[None, ..., None, None], mv4, 0)
    if has_inter:
        t = torch.from_numpy
        _, sy, sx = mbscan._mv_predictors(
            t(mv4[0].astype(i32)), t(mv4[1].astype(i32)), t(~inter),
            mb_width, mb_height)
        for k, s in enumerate((sy, sx)):
            mv4[k] = np.where(pick[..., None, None], s.numpy()[..., None,
                                                                None], mv4[k])
    if dense:
        def full(shape):
            mag = np.select([rng.random(shape) < p for p in (0.1, 0.4, 0.7)],
                            [np.ones(shape, int), rng.integers(2, 21, shape),
                             rng.integers(100, 601, shape)],
                            rng.integers(2100, 3001, shape))
            return rng.choice([-1, 1], shape) * mag
        lev_inter = np.where(inter[..., None, None, None, None], full(blk), 0)
        ac_lev = np.where(inter[..., None, None, None, None], 0, full(blk))
        ac_lev[..., 0, 0] = np.where(i16[..., None, None], 0,
                                     ac_lev[..., 0, 0])
        dc_lev = np.where(i16[..., None, None], full((n, nmb, 4, 4)), 0)
        cdc_lev = full((n, nmb, 2, 2, 2))
        cac_lev = full((n, nmb, 2, 2, 2, 4, 4))
        cac_lev[..., 0, 0] = 0
    i4l = rng.choice([1, 4], (n, nmb, 16))
    out = dict(
        sel=sel, mode16=rng.integers(0, 4, (n, nmb)),
        cmode=rng.integers(0, 4, (n, nmb)),
        i4sym_v=np.where(i4l == 1, 1, rng.integers(0, 8, (n, nmb, 16))),
        i4sym_l=i4l, mv4_y=mv4[0], mv4_x=mv4[1], shape=shape,
        dc_lev=dc_lev, ac_lev=ac_lev, lev_inter=lev_inter, cdc_lev=cdc_lev,
        cac_lev=cac_lev)
    out = {k: np.ascontiguousarray(v, dtype=i32) for k, v in out.items()}
    out["qp_rows"] = None
    if plan:
        steps = rng.integers(-4, 5, (n, mb_height))
        steps[:, 0] = rng.integers(0, 52, n)
        out["qp_rows"] = np.clip(np.cumsum(steps, 1), 0, 51).astype(i32)
    return out


@functools.lru_cache(maxsize=None)
def _exact_kill_blocks(qp: int, thr_q8: int) -> np.ndarray:
    """Luma residual blocks (m, 4, 4) of small values whose largest
    transform coefficient, measured in `transform.zero_thr4x4(qp, thr_q8)`
    of its position class, sits exactly at the threshold: the zero-block
    kill's `<=` decides them. Found by a seeded search; none (m = 0) where
    the QP has none within reach."""
    from h264lab_tpu_torch.ops import tables

    mf = tables.QUANT_MF[qp % 6][tables.POS_CLASS].reshape(4, 4)
    thr = (thr_q8 << (7 + qp // 6)) // mf
    amp = max(4, int(thr.min()) // 6)         # residuals that reach it
    rng = np.random.default_rng(1000 * qp + thr_q8)
    res = rng.integers(-amp, amp + 1, (20000, 4, 4)).astype(np.int64)
    res[:10000] *= rng.random((10000, 4, 4)) < 0.3          # sparser ones
    cf = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1],
                   [1, -2, 2, -1]], np.int64)
    coef = np.einsum("ij,kjl,ml->kim", cf, res, cf)
    over = (np.abs(coef) - thr).reshape(-1, 16).max(axis=1)
    return res[over == 0][:64].astype(np.int32)


def inter_residual_inputs(seed: int, n: int, mb_width: int, mb_height: int,
                          qp: int, lanes: int = 1,
                          frame_rows: int | None = None, plan: bool = False,
                          parts: bool = False, qpel: bool = True,
                          reach: int = 55, noisy_guard: bool = False) -> dict:
    """Seeded inputs of `models.mbscan.inter_residual` (K7) for n P frames
    or bands of mb_width x mb_height MBs over `lanes` reference pictures of
    frame_rows MB rows (default mb_height), made so that every branch is
    taken:
    - reference chroma planes: noise with flat and chessboard areas,
      guard-padded by edge replication (qpel.GUARD // 2) as
      `refstate.prepare_reference` builds them; band k of a lane starts at
      MB row k * mb_height (`row0`), frames walk the lanes in turn;
    - MVs: the full-pel winner up to +-`reach` (the candidate clip 52 plus
      the +-3 refine: 55; past it, where the uniform window clamps into the
      plane), every MB of the frame's edges at the limit towards its edge,
      the final MV within +-3 quarter-pel of it (none without `qpel`); with
      `noisy_guard` the planes are noise, guard ring included, so that a
      window clamped into the plane reads other pixels than one left
      where it was;
    - with `parts`, K5's outputs (speed 0): partition MVs within +-2
      full-pel and +-3 quarter-pel of the winner, cost sums (int64) that
      make each of the four shapes win, some tied with a cheaper shape
      before them (the first wins), and int32 predictions;
    - luma: the search's prediction and a source of small to large
      residuals, with 4x4 blocks whose largest coefficient sits exactly at
      the first or the second kill threshold of the MB's QP; chroma
      sources of any value;
    - QPs: `qp` on the first frame, then spread over 0-51; with `plan`
      a per-row plan (n, mb_height) that takes each of QPs 0-51 once
      before any twice.
    Returns numpy arrays (and `parts`, a dict of them, or None) keyed by
    `inter_residual`'s argument names."""
    from h264lab_tpu_torch.ops import tables
    from h264lab_tpu_torch.ops.me import LAMBDA_ME
    from h264lab_tpu_torch.ops.tuning import (INTER_ZERO_THR2_Q8,
                                              INTER_ZERO_THR_Q8,
                                              PART_16X8_PENALTY_BITS,
                                              PART_8X8_PENALTY_BITS)

    rng = np.random.default_rng(seed)
    nmb = mb_width * mb_height
    k = n * nmb
    frame_rows = frame_rows or mb_height
    gc = 32                                      # qpel.GUARD // 2
    hc, wc = 8 * frame_rows, 8 * mb_width

    def plane():
        p = rng.integers(0, 256, (hc, wc))
        yy, xx = np.mgrid[0:hc, 0:wc]
        p = np.where(((yy // 8) + (xx // 8)) % 5 == 0, 128, p)
        p = np.where(((yy // 8) + (xx // 8)) % 5 == 1,
                     np.where((yy // 2 + xx // 2) % 2 == 0, 30, 220), p)
        if noisy_guard:
            return rng.integers(0, 256, (hc + 2 * gc, wc + 2 * gc)).astype(
                np.uint8)
        return np.pad(p, gc, mode="edge").astype(np.uint8)

    u_pad = np.stack([plane() for _ in range(lanes)])
    v_pad = np.stack([plane() for _ in range(lanes)])
    bands = max(frame_rows // mb_height, 1)
    lane = (np.arange(n) % lanes).astype(np.int32)
    row0 = ((np.arange(n) // lanes) % bands * mb_height).astype(np.int32)
    # full-pel winners, at the limit on the frame's edge MBs
    idx = np.arange(nmb)
    r, c = idx // mb_width, idx % mb_width
    full = rng.integers(-reach, reach + 1, (2, n, nmb))
    top = (r[None] + row0[:, None]) == 0
    bottom = (r[None] + row0[:, None]) == frame_rows - 1
    full[0] = np.where(top, -reach, np.where(bottom, reach, full[0]))
    full[1] = np.where(c == 0, -reach, np.where(c == mb_width - 1, reach,
                                                full[1]))
    step = rng.integers(-3, 4, (2, n, nmb)) if qpel else 0
    mv = full * 4 + step
    # QPs
    q = np.empty(n, np.int64)
    q[0] = qp
    q[1:] = rng.integers(0, 52, n - 1)
    q_mb = np.repeat(q, nmb).reshape(n, nmb)
    if plan:
        q = np.resize(rng.permutation(52), n * mb_height).reshape(
            n, mb_height)
        q[0, 0] = qp
        q_mb = np.repeat(q, mb_width, axis=1)
    # luma: prediction and residual
    pred16 = rng.integers(0, 256, (n, nmb, 16, 16))
    res = np.select(
        [rng.random((n, nmb, 1, 1)) < p for p in (0.3, 0.6, 0.8)],
        [rng.integers(-3, 4, (n, nmb, 16, 16)),
         rng.integers(-12, 13, (n, nmb, 16, 16)),
         rng.integers(-60, 61, (n, nmb, 16, 16))],
        rng.integers(-255, 256, (n, nmb, 16, 16)))
    src_y = np.clip(pred16 + res, 0, 255)
    # an eighth of the blocks exactly at a kill threshold of their MB's
    # QP: the prediction in range and the source the prediction plus the
    # residual
    blocks = src_y.reshape(n, nmb, 4, 4, 4, 4).transpose(0, 1, 2, 4, 3, 5)
    pblocks = pred16.reshape(n, nmb, 4, 4, 4, 4).transpose(0, 1, 2, 4, 3, 5)
    hit = rng.random((n, nmb, 4, 4)) < 0.125
    which = rng.integers(0, 2, (n, nmb, 4, 4))
    for qv in np.unique(q_mb):
        for t, thr in enumerate((INTER_ZERO_THR_Q8, INTER_ZERO_THR2_Q8)):
            bank = _exact_kill_blocks(int(qv), thr)
            at = hit & (q_mb == qv)[..., None, None] & (which == t)
            if not len(bank) or not at.any():
                continue
            res = bank[rng.integers(0, len(bank), int(at.sum()))]
            m = np.abs(res).max(axis=(1, 2), keepdims=True)
            p = m + (rng.random(m.shape) * (256 - 2 * m)).astype(np.int64)
            pblocks[at] = p
            blocks[at] = p + res
    pred16 = pblocks.transpose(0, 1, 2, 4, 3, 5).reshape(n, nmb, 16, 16)
    src_y = blocks.transpose(0, 1, 2, 4, 3, 5).reshape(n, nmb, 16, 16)
    out = dict(src_y_mb=src_y.astype(np.uint8),
               src_u_mb=rng.integers(0, 256, (n, nmb, 8, 8)).astype(np.uint8),
               src_v_mb=rng.integers(0, 256, (n, nmb, 8, 8)).astype(np.uint8),
               u_pad=u_pad, v_pad=v_pad, lane=lane, row0=row0,
               qp=q.astype(np.int32),
               qpc=tables.QPC_FROM_QPY[q].astype(np.int32),
               mv_y=mv[0].astype(np.int32), mv_x=mv[1].astype(np.int32),
               full_my=full[0].astype(np.int32),
               full_mx=full[1].astype(np.int32),
               cost16=rng.integers(-200, 20000, (n, nmb)).astype(np.int32),
               pred16=pred16.astype(np.uint8), parts=None)
    if parts:
        fk = full.reshape(2, k)

        def part_mvs(count):
            """(k, count, 2) MVs near the winner, inside the guard."""
            d = rng.integers(-2, 3, (k, count, 2)) * 4 + rng.integers(
                -3, 4, (k, count, 2))
            return (fk.T[:, None, :] * 4 + d).astype(np.int32)

        c16 = out["cost16"].reshape(k).astype(np.int64)
        win = rng.integers(0, 4, k)
        tie = rng.random(k) < 0.3
        # the lambda of each frame's first-row QP, as the shape choice
        lam = np.repeat(LAMBDA_ME[q[:, 0] if plan else q], nmb)
        costs = {}
        for s, (name, pen) in enumerate((
                ("cost16x8", PART_16X8_PENALTY_BITS),
                ("cost8x16", PART_16X8_PENALTY_BITS),
                ("cost8x8", PART_8X8_PENALTY_BITS))):
            base = np.where(win == s + 1, c16 - rng.integers(1, 500, k),
                            c16 + rng.integers(1, 500, k))
            # a tie with the cost before it: the earlier shape wins
            base = np.where(tie & (win == s + 1), c16, base)
            costs[name] = (base - lam * pen).astype(np.int64)
        out["parts"] = dict(
            mv16x8=part_mvs(2), mv8x16=part_mvs(2), mv8x8=part_mvs(4),
            **costs,
            **{name: rng.integers(0, 256, (k, 16, 16)).astype(np.int32)
               for name in ("pred16x8", "pred8x16", "pred8x8")})
    return out


def select_parallel_inputs(seed: int, n: int, mb_width: int, mb_height: int,
                           qp: int, plan: bool = False,
                           band: bool = False) -> dict:
    """Seeded inputs of `models.mbscan.select_parallel` (K8) for n P frames
    or bands: `wavefront_inputs`' source tiles (flat, gradient, chessboard,
    stripes, noise: the intra modes tie often) and its inter candidate,
    whose cost makes MBs want intra in clusters (runs across a row end,
    whole rows and columns, the first row and column) and alone; the inter
    stage's other fields (chroma levels, MVs of shapes 0-3, lev_inter)
    seeded; QPs spread over 0-51, with `plan` a per-row plan (n,
    mb_height) that takes each of QPs 0-51 once before any twice; with
    `band` the first row and column unavailable, as the encoders' frames
    and bands have them, else every MB's availability seeded, the first
    row's and column's too (the parallel path takes any). Returns numpy
    arrays keyed by `select_parallel`'s argument names, the inter stage's
    fields as a dict under `inter`."""
    from h264lab_tpu_torch.ops import tables

    d = wavefront_inputs(seed, n, mb_width, mb_height, qp, inter=True)
    rng = np.random.default_rng(seed + 1)
    nmb = mb_width * mb_height
    idx = np.arange(nmb)
    r, c = idx // mb_width, idx % mb_width
    cost = d["inter_cost"]
    # clusters of MBs that want intra: across a row end, a row, a column
    cluster = ((idx >= mb_width - 2) & (idx <= mb_width + 1)) | (r == 0) \
        | (c == mb_width - 1)
    pick = rng.random((n, 1)) < 0.7
    cost = np.where(cluster[None] & pick, 1 << 20, cost)
    q = np.empty(n, np.int64)
    q[0] = qp
    q[1:] = rng.integers(0, 52, n - 1)
    if plan:
        q = np.resize(rng.permutation(52), n * mb_height).reshape(
            n, mb_height)
        q[0, 0] = qp
    if band:
        avail_top, avail_left = r > 0, c > 0
    else:
        avail_top, avail_left = (rng.random(nmb) < 0.85 for _ in range(2))
    i32 = np.int32
    shape = rng.integers(0, 4, (n, nmb)).astype(i32)
    inter = dict(
        inter_cost=cost.astype(i32),
        recon_y_inter=d["recon_y_inter"], recon_u_inter=d["recon_u_inter"],
        recon_v_inter=d["recon_v_inter"],
        cdc_inter=rng.integers(-40, 41, (n, nmb, 2, 2, 2)).astype(i32),
        cac_inter=(rng.integers(-9, 10, (n, nmb, 2, 2, 2, 4, 4))
                   * (rng.random((n, nmb, 2, 2, 2, 4, 4)) < 0.3)).astype(i32),
        mv_y=rng.integers(-220, 221, (n, nmb)).astype(i32),
        mv_x=rng.integers(-220, 221, (n, nmb)).astype(i32),
        mv4_y=rng.integers(-220, 221, (n, nmb, 4, 4)).astype(i32),
        mv4_x=rng.integers(-220, 221, (n, nmb, 4, 4)).astype(i32),
        shape=shape,
        lev_inter=rng.integers(-5, 6, (n, nmb, 4, 4, 4, 4)).astype(i32))
    return dict(src_y_mb=d["src_y_mb"], src_u_mb=d["src_u_mb"],
                src_v_mb=d["src_v_mb"], qp=q.astype(i32),
                qpc=tables.QPC_FROM_QPY[q].astype(i32), avail_top=avail_top,
                avail_left=avail_left, inter=inter)
