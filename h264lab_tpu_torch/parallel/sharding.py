"""All-intra batches of (frames x slice bands) over a ("gop", "band")
device mesh.

PyTorch counterpart of `h264lab_tpu/parallel/sharding.py`. Bands and
frames are independent slices, so the (n_gop, n_band, ...) batch splits
over the mesh with no exchange at all: mesh entry (i, j) encodes its
block of frames and bands on its own device, all entries at once on
their workers (`parallel.gop.ShardWorkers`), and the blocks are joined
in order afterwards (the reference's ordered concat of slice-thread
outputs, `src/h264-lab.h:6563-6567`). Each band is encoded as its own
slice: its top MB row sees no neighbour above.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from h264lab_tpu_torch.models import mbscan, wavefront
from h264lab_tpu_torch.parallel.gop import Mesh, ShardWorkers, make_mesh

__all__ = ["ShardedIntraEncoder", "make_mesh"]


class ShardedIntraEncoder:
    """Encodes batches of (frames x slice bands) over a device mesh.

    Each band covers `band_mb_rows` MB rows and is emitted as an
    independent slice (JAX's `ShardedIntraEncoder`)."""

    def __init__(self, mesh: Mesh, mb_width: int, band_mb_rows: int):
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.gop.Mesh (make_mesh), "
                            f"not {type(mesh).__name__}")
        self.mesh = mesh
        self.mb_width = mb_width
        self.band_mb_rows = band_mb_rows
        self._steps = wavefront.make_plan(mb_width, band_mb_rows,
                                          slope=2).steps
        nmb = mb_width * band_mb_rows
        # top rows of a band have no intra neighbours (slice boundary)
        self._avail_top = np.arange(nmb) // mb_width > 0
        self._avail_left = np.arange(nmb) % mb_width > 0
        self.workers = ShardWorkers(mesh.devices.reshape(-1))

    def encode_batch(self, tiles_y, tiles_u, tiles_v, qp: int, qpc: int):
        """tiles_*: (n_gop, n_band, nmb_band, 16, 16)/(.., 8, 8) uint8,
        numpy arrays or tensors. Returns the dict of batched outputs
        (leading (n_gop, n_band)) on `mesh.devices[0, 0]`. The leading
        axes must split over the mesh (`ValueError`, as JAX's
        `device_put`)."""
        grid = self.mesh.devices
        tiles = [torch.as_tensor(t) for t in (tiles_y, tiles_u, tiles_v)]
        n_gop, n_band = tiles[0].shape[:2]
        if n_gop % grid.shape[0] or n_band % grid.shape[1]:
            raise ValueError(
                f"a ({n_gop}, {n_band}) batch does not split over a "
                f"{grid.shape[0]}x{grid.shape[1]} mesh")
        gl, bl = n_gop // grid.shape[0], n_band // grid.shape[1]

        def run_entry(i: int, j: int) -> dict:
            dev = grid[i, j]
            block = [t[i * gl:(i + 1) * gl, j * bl:(j + 1) * bl]
                     .reshape((gl * bl,) + t.shape[2:]).to(dev)
                     for t in tiles]
            q = torch.full((gl * bl,), qp, dtype=torch.int32, device=dev)
            qc = torch.full((gl * bl,), qpc, dtype=torch.int32, device=dev)
            with self.workers.issue_lock:
                out = mbscan.encode_intra_frames(
                    *block, q, qc, self._steps, self._avail_top,
                    self._avail_left, self.mb_width, self.band_mb_rows)
            return {k: v.reshape((gl, bl) + v.shape[1:])
                    for k, v in out.items()}

        outs = self.workers.run([functools.partial(run_entry, i, j)
                                 for i in range(grid.shape[0])
                                 for j in range(grid.shape[1])])
        rows = [outs[k:k + grid.shape[1]]
                for k in range(0, len(outs), grid.shape[1])]
        home = grid[0, 0]
        return {k: torch.cat([torch.cat([o[k].to(home) for o in row], dim=1)
                              for row in rows]) for k in rows[0][0]}
