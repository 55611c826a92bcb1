"""Reference-picture preparation, lane-batched.

PyTorch counterpart of `h264lab_tpu/models/refstate.py` and of the `ref`
stage of `h264lab_tpu/parallel/gop.py` (`ref_fn`): the deblocked band
tiles of each lane are joined into the lane's full frame, then padded with
a replicated guard ring, and the 4x box pyramid of the luma plane is built
for the coarse motion search. On a ("gop", "band") mesh the bands of a
lane lie on several devices, and `exchange` gathers them first: the
all-gather that XLA inserts in the JAX mesh.

`prepare_reference` and `reference_chroma` dispatch on the tiles'
device: on CUDA tensors one launch of K11 (`ops/refplanes.planes_k11`,
`csrc/refplanes.cu`), on CPU tensors the plain version
`prepare_reference_plain`.
"""

from __future__ import annotations

import torch

from h264lab_tpu_torch.ops import cuda_build, me, qpel, refplanes


def tiles_to_planes(tiles: torch.Tensor, mb_height: int, mb_width: int):
    """(L, nmb, t, t) MB tiles -> (L, mb_height * t, mb_width * t)."""
    n, _, t, _ = tiles.shape
    return (tiles.reshape(n, mb_height, mb_width, t, t)
            .permute(0, 1, 3, 2, 4).reshape(n, mb_height * t, mb_width * t))


# tiles in the form K11 takes (it bulk-copies them); no copy where they
# are, as on every path's `ref` stage (K2's outputs and the exchange's
# joins are fresh allocations)
_k11_tiles = cuda_build.aligned16


def prepare_reference(recon_y_tiles, recon_u_tiles, recon_v_tiles,
                      mb_width: int, mb_height: int) -> dict:
    """Reference planes of L pictures from their (L, nmb, t, t) recon
    tiles: y_pad/u_pad/v_pad with a GUARD (chroma GUARD//2) replicated
    ring, and y4_pad, the 4x pyramid `(sum + 8) >> 4` with a GUARD//4
    replicated ring. All uint8, leading axis L. The `ref` stage of every
    path: on CUDA tensors one launch of K11, on CPU tensors
    `prepare_reference_plain`."""
    tiles = (recon_y_tiles, recon_u_tiles, recon_v_tiles)
    if recon_y_tiles.device.type == "cpu":
        return prepare_reference_plain(*tiles, mb_width, mb_height)
    return refplanes.planes_k11(*(_k11_tiles(t) for t in tiles), mb_width,
                                mb_height)


def prepare_reference_plain(recon_y_tiles, recon_u_tiles, recon_v_tiles,
                            mb_width: int, mb_height: int) -> dict:
    """`prepare_reference` in plain PyTorch, the reference K11 is held
    against."""
    y, u, v = (tiles_to_planes(t, mb_height, mb_width)
               for t in (recon_y_tiles, recon_u_tiles, recon_v_tiles))
    return dict(y_pad=qpel.pad_guard(y, qpel.GUARD),
                u_pad=qpel.pad_guard(u, qpel.GUARD // 2),
                v_pad=qpel.pad_guard(v, qpel.GUARD // 2),
                y4_pad=qpel.pad_guard(me.downsample4(y), qpel.GUARD // 4))


def reference_chroma(u_tiles, v_tiles, mb_width: int, mb_height: int):
    """`prepare_reference`'s u_pad and v_pad alone, from (L, nmb, 8, 8)
    tiles: on CUDA tensors one launch of K11 without luma, on CPU tensors
    `qpel.pad_guard` of the joined planes."""
    if u_tiles.device.type == "cpu":
        return tuple(qpel.pad_guard(tiles_to_planes(t, mb_height, mb_width),
                                    qpel.GUARD // 2)
                     for t in (u_tiles, v_tiles))
    out = refplanes.planes_k11(None, _k11_tiles(u_tiles),
                               _k11_tiles(v_tiles), mb_width, mb_height)
    return out["u_pad"], out["v_pad"]


def ref_stage(df_y, df_u, df_v, mv_y, mv_x, n_gop: int, mb_width: int,
              mb_height: int):
    """The `ref` stage of a step. df_* (G*B, nmb_band, t, t) deblocked band
    tiles, lane-major; mv_y/mv_x (G*B, nmb_band) quarter-pel MVs.

    Returns (refs, (fdy, fdu, fdv), pmv_y, pmv_x): the lanes' reference
    planes (`prepare_reference` of the full frames, mb_height MB rows),
    the (G, nmb, t, t) full-frame tiles of each lane, and the next step's
    full-pel MV candidates `mv >> 2` (arithmetic shift)."""
    (refs,), flat = exchange([(df_y, df_u, df_v)], [df_y.device], n_gop,
                             mb_width, mb_height)
    return refs, flat, mv_y >> 2, mv_x >> 2


def _join(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def exchange(band_tiles, devices, n_lanes: int, mb_width: int,
             mb_height: int):
    """The band-to-reference all-gather of one gop row of a mesh: motion
    vectors read the whole reference picture, so every device of the row
    needs every band of its lanes.

    band_tiles: per band shard of the row, in band order, its 3-tuple of
    (n_lanes * Bl, nmb_band, t, t) deblocked tiles (lane-major) on its
    device; devices: those shards' devices. Each shard's tiles are copied
    to each device of the row and joined in band order there; then
    `prepare_reference` runs once per distinct device. Returns (refs,
    tiles): per shard, the lanes' reference planes on its device, and the
    lanes' (n_lanes, nmb, t, t) whole-frame tiles on devices[0]."""
    joined = {}
    for dev in devices:
        if dev not in joined:
            joined[dev] = tuple(_join([
                part[p].to(dev, non_blocking=True).reshape(
                    (n_lanes, -1) + part[p].shape[2:])
                for part in band_tiles]) for p in range(3))
    refs = {dev: prepare_reference(*t, mb_width, mb_height)
            for dev, t in joined.items()}
    return [refs[dev] for dev in devices], joined[devices[0]]
