"""Driver entry point of the port: the counterpart of the JAX package's
`__graft_entry__.entry`.

    fn, args = entry()            # on the CUDA card; entry("cpu") on the CPU
    out = fn(*args)

`fn` is the wavefront intra frame encode (`mbscan.encode_intra_core`:
Intra_16x16, Intra_4x4 and chroma mode selection over the slope-2
wavefront, then CAVLC symbolization; no deblocking) at 128x96, and `args`
are the JAX entry point's example arguments, made the same way from
`np.random.default_rng(0)`, as tensors on the device. Without a card,
`entry()` raises; it never falls back to the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from h264lab_tpu_torch.models import mbscan, wavefront
from h264lab_tpu_torch.utils.device import resolve_device


def entry(device=None):
    """Returns (fn, example_args) on `device` (the card when None)."""
    dev = resolve_device(device)
    mb_w, mb_h = 8, 6  # 128x96
    plan = wavefront.make_plan(mb_w, mb_h, slope=2)
    nmb = mb_w * mb_h
    rng = np.random.default_rng(0)
    r = np.arange(nmb) // mb_w
    c = np.arange(nmb) % mb_w

    def on(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    fn = functools.partial(mbscan.encode_intra_core,
                           mb_width=mb_w, mb_height=mb_h)
    example_args = (
        on(rng.integers(0, 256, (nmb, 16, 16), dtype=np.uint8)),
        on(rng.integers(0, 256, (nmb, 8, 8), dtype=np.uint8)),
        on(rng.integers(0, 256, (nmb, 8, 8), dtype=np.uint8)),
        on(30, torch.int32),
        on(30, torch.int32),
        on(plan.steps),
        on(r > 0),
        on(c > 0),
    )
    return fn, example_args
