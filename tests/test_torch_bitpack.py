"""The port's plain PyTorch packer against the JAX packers.

The same seeded random grids (tests/torch_grids.py) go through
`pack_frame_fast`, the Pallas stitch in interpret mode and
`h264lab_tpu_torch.ops.bitpack` on the CPU.
Tolerance: exact equality of the whole (cap_words + 256,) word array,
including a capacity the stream overflows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264lab_tpu.ops import bitpack as jbp
from h264lab_tpu_torch.ops import bitpack as tbp
from tests.torch_grids import UNIT_SLOTS, random_grid

S = jbp.UNIT_SLOTS
assert S == UNIT_SLOTS


def _torch(vals, lens):
    return torch.from_numpy(vals.view(np.int32)), torch.from_numpy(lens)


@pytest.mark.parametrize("nmb,zero_frac,overflow",
                         [(48, 0.97, False), (48, 0.6, False),
                          (6, 0.0, False), (48, 0.6, True)])
def test_plain_packer_matches_jax(nmb, zero_frac, overflow):
    rng = np.random.default_rng(nmb + int(zero_frac * 100))
    vals, lens = random_grid(rng, nmb, zero_frac)
    total = int(lens.sum())
    cap = 128
    while not overflow and cap * 32 < total:
        cap *= 2
    assert (total > 32 * (cap + tbp.SLACK_WORDS)) == overflow
    wf, tf = jbp.pack_frame_fast(jnp.asarray(vals), jnp.asarray(lens), cap)
    wp, tp = jbp.pack_frame_pallas(jnp.asarray(vals), jnp.asarray(lens), cap,
                                   interpret=True)
    tw, tt = tbp.pack_frame_plain(*_torch(vals, lens), cap)
    got = tw.numpy().view(np.uint32)
    assert got.shape == (cap + 256,)
    assert int(tt) == int(tf) == int(tp) == total
    np.testing.assert_array_equal(got, np.asarray(wf))
    if not overflow:
        # past the end the Pallas stitch clamps its 3-row window to the
        # last rows instead of dropping it, so it matches pack_frame_fast
        # (the main path's packer) only while the stream fits
        np.testing.assert_array_equal(got, np.asarray(wp))


def test_batched_cpu_wrapper_and_host_helpers():
    """`pack_frames` on CPU tensors is the plain packer over the leading
    frame axes; words_to_bytes and bucket_words equal the JAX helpers."""
    rng = np.random.default_rng(5)
    grids = [random_grid(rng, 12, 0.8) for _ in range(6)]
    vals = np.stack([g[0] for g in grids]).reshape(3, 2, 12, 28 * S)
    lens = np.stack([g[1] for g in grids]).reshape(3, 2, 12, 28 * S)
    cap = 512
    before = dict(tbp.LAUNCH_COUNTS)
    words, nbits = tbp.pack_frames(*_torch(vals, lens), cap)
    assert tbp.LAUNCH_COUNTS == before          # CPU: no kernel launch
    assert words.shape == (3, 2, cap + 256) and nbits.shape == (3, 2)
    for i in range(3):
        for j in range(2):
            wf, tf = jbp.pack_frame_fast(jnp.asarray(vals[i, j]),
                                         jnp.asarray(lens[i, j]), cap)
            w = words[i, j].numpy()
            np.testing.assert_array_equal(w.view(np.uint32), np.asarray(wf))
            assert int(nbits[i, j]) == int(tf)
            assert (tbp.words_to_bytes(w, int(tf))
                    == jbp.words_to_bytes(np.asarray(wf), int(tf)))
    for bits in (0, 1, 32767, 32768, 1 << 22):
        assert tbp.bucket_words(bits) == jbp.bucket_words(bits)
