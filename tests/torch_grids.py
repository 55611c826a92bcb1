"""Seeded random symbol grids for the bit-pack tests (numpy only, so the
card tests can use them without JAX).

Grids are clamped to the packer's structural bounds, which real symbol
streams satisfy by construction: <= 640 bits per CAVLC unit and <= 3200
bits per MB (spec 7.4.5), as in tests/test_bitpack_fast.py.
"""

import numpy as np

UNIT_SLOTS = 34          # symbol slots per unit (cavlc.N_SLOTS)


def random_grid(rng, nmb, zero_frac):
    """(vals uint32, lens int32) of shape (nmb, 28 * UNIT_SLOTS)."""
    shape = (nmb, 28 * UNIT_SLOTS)
    lens = rng.integers(1, 29, shape).astype(np.int32)
    lens[rng.random(shape) < zero_frac] = 0
    lens[rng.random(shape) < 0.01] = 32
    u = lens.reshape(nmb, 28, UNIT_SLOTS)
    u[np.cumsum(u, axis=-1) > 640] = 0
    mcum = np.cumsum(u.reshape(nmb, -1), axis=-1).reshape(nmb, 28, UNIT_SLOTS)
    u[mcum > 3200] = 0
    vals = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return vals, u.reshape(shape)
