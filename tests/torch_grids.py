"""Seeded random symbol grids for the bit-pack tests (numpy only, so the
card tests can use them without JAX).

By default grids are clamped to the packer's structural bounds, which real
symbol streams satisfy by construction: <= 640 bits per CAVLC unit and
<= 3200 bits per MB (spec 7.4.5), as in tests/test_bitpack_fast.py.
Unclamped grids (`clamp=False`, `edge_grid`) pass the packers' drop
boundaries: 704 bits of a unit and 4096 bits of an MB.
"""

import numpy as np

UNIT_SLOTS = 34          # symbol slots per unit (cavlc.N_SLOTS)
MB_SLOTS = 28 * UNIT_SLOTS

# one frame each; every case but "all_empty" passes a drop boundary or
# holds empty MBs
EDGE_CASES = ("mb_4096", "mb_7616", "straddle_4096", "unit_over_704",
              "empty_runs", "all_empty")


def random_grid(rng, nmb, zero_frac, clamp=True):
    """(vals uint32, lens int32) of shape (nmb, 28 * UNIT_SLOTS)."""
    shape = (nmb, MB_SLOTS)
    lens = rng.integers(1, 29, shape).astype(np.int32)
    lens[rng.random(shape) < zero_frac] = 0
    lens[rng.random(shape) < 0.01] = 32
    if clamp:
        u = lens.reshape(nmb, 28, UNIT_SLOTS)
        u[np.cumsum(u, axis=-1) > 640] = 0
        mcum = np.cumsum(u.reshape(nmb, -1), axis=-1).reshape(u.shape)
        u[mcum > 3200] = 0
    vals = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return vals, lens


def _fit_bits(lens, bits):
    """Zero the tail of the 1-D `lens` and shorten its last kept symbol so
    that they sum to exactly `bits` (they must sum to more)."""
    c = np.cumsum(lens)
    i = int(np.searchsorted(c, bits))
    lens[i] -= c[i] - bits
    lens[i + 1:] = 0
    return i


def edge_grid(rng, case, nmb=48):
    """(vals, lens) of one (nmb, 952) frame showing one of EDGE_CASES.
    MB 1 carries the feature; the other MBs are a clamped background."""
    vals, lens = random_grid(rng, nmb, 0.9)
    dense = random_grid(rng, 1, 0.3, clamp=False)[1][0]    # ~9600 bits
    if case in ("mb_4096", "mb_7616"):
        _fit_bits(dense, int(case[3:]))
        lens[1] = dense
    elif case == "straddle_4096":
        i = _fit_bits(dense, 4080)
        dense[i + 1] = 32                      # bits 4080 .. 4111 of the MB
        dense[i + 2:i + 20] = rng.integers(1, 29, 18)
        lens[1] = dense
    elif case == "unit_over_704":
        u = lens[1].reshape(28, UNIT_SLOTS)
        u[3] = 32                              # 1088 bits
        u[7] = rng.integers(20, 33, UNIT_SLOTS)  # ~880, 704 inside a symbol
    elif case == "empty_runs":              # at the start, inside, at the end
        lens[0] = 0
        lens[nmb // 8:nmb // 2] = 0
        lens[nmb - 3:] = 0
    elif case == "all_empty":
        lens[:] = 0
    else:
        raise ValueError(case)
    return vals, lens
