"""The port's driver entry point (`h264lab_tpu_torch/entry.py`) against
the JAX package's (`__graft_entry__.entry`).

`entry(device="cpu")` makes the same example arguments (128x96 from
`np.random.default_rng(0)`), and its function, the wavefront intra frame
encode with CAVLC symbolization, returns the same keys with equal arrays:
symbols, bit counts, skip/cbp/MV-difference fields, recon and unfiltered
planes, MVs, shapes, modes. Without a card `entry()` raises. Tolerance:
exact equality (integer arithmetic).
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from h264lab_tpu_torch.entry import entry


def test_entry_equals_jax_entry():
    jfn, jargs = __graft_entry__.entry()
    fn, args = entry(device="cpu")
    assert len(args) == len(jargs)
    for a, b in zip(args, jargs):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want, got = jfn(*jargs), fn(*args)
    assert set(got) == set(want)
    for key, val in want.items():
        a = np.asarray(val)
        b = got[key].numpy()
        if a.dtype == np.uint32:                  # int32 bit patterns
            b = b.astype(np.int64) & 0xFFFFFFFF
        assert b.shape == a.shape, key
        np.testing.assert_array_equal(b.astype(np.int64),
                                      a.astype(np.int64), err_msg=key)
    assert int(got["total_bits"]) > 0


def test_entry_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        entry()
