"""Reference-picture preparation, lane-batched.

PyTorch counterpart of `h264lab_tpu/models/refstate.py` and of the `ref`
stage of `h264lab_tpu/parallel/gop.py` (`ref_fn`): the deblocked band
tiles of each lane are joined into the lane's full frame, then padded with
a replicated guard ring, and the 4x box pyramid of the luma plane is built
for the coarse motion search.
"""

from __future__ import annotations

import torch

from h264lab_tpu_torch.ops import qpel
from h264lab_tpu_torch.ops.me import downsample4


def tiles_to_planes(tiles: torch.Tensor, mb_height: int, mb_width: int):
    """(L, nmb, t, t) MB tiles -> (L, mb_height * t, mb_width * t)."""
    n, _, t, _ = tiles.shape
    return (tiles.reshape(n, mb_height, mb_width, t, t)
            .permute(0, 1, 3, 2, 4).reshape(n, mb_height * t, mb_width * t))


def prepare_reference(recon_y_tiles, recon_u_tiles, recon_v_tiles,
                      mb_width: int, mb_height: int) -> dict:
    """Reference planes of L pictures from their (L, nmb, t, t) recon
    tiles: y_pad/u_pad/v_pad with a GUARD (chroma GUARD//2) replicated
    ring, and y4_pad, the 4x pyramid `(sum + 8) >> 4` with a GUARD//4
    replicated ring. All uint8, leading axis L."""
    y, u, v = (tiles_to_planes(t, mb_height, mb_width)
               for t in (recon_y_tiles, recon_u_tiles, recon_v_tiles))
    return dict(y_pad=qpel.pad_guard(y, qpel.GUARD),
                u_pad=qpel.pad_guard(u, qpel.GUARD // 2),
                v_pad=qpel.pad_guard(v, qpel.GUARD // 2),
                y4_pad=qpel.pad_guard(downsample4(y), qpel.GUARD // 4))


def ref_stage(df_y, df_u, df_v, mv_y, mv_x, n_gop: int, mb_width: int,
              mb_height: int):
    """The `ref` stage of a step. df_* (G*B, nmb_band, t, t) deblocked band
    tiles, lane-major; mv_y/mv_x (G*B, nmb_band) quarter-pel MVs.

    Returns (refs, (fdy, fdu, fdv), pmv_y, pmv_x): the lanes' reference
    planes (`prepare_reference` of the full frames, mb_height MB rows),
    the (G, nmb, t, t) full-frame tiles of each lane, and the next step's
    full-pel MV candidates `mv >> 2` (arithmetic shift)."""
    flat = tuple(d.reshape((n_gop, -1) + d.shape[2:])
                 for d in (df_y, df_u, df_v))
    refs = prepare_reference(*flat, mb_width, mb_height)
    return refs, flat, mv_y >> 2, mv_x >> 2
