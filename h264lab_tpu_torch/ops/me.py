"""Motion-estimation constants needed by the intra slice.

Only the mode-decision lambda lives here so far. The JAX package computes
it as `max(sqrt(0.85 * 2^((qp - 12) / 3)), 1)` truncated to int in
float32 (`h264lab_tpu/ops/me.py:lambda_me`); the port stores the 52
integers that function returns instead of recomputing them, so no
float rounding can differ. The tests check the table against the JAX
function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

LAMBDA_ME = np.array([
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2,
    2, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20,
    23, 26, 29, 33, 37, 41, 46, 52, 59, 66, 74, 83], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _lut(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(LAMBDA_ME, device=device)


def lambda_me(qp: torch.Tensor) -> torch.Tensor:
    """Integer mode-decision lambda for int QP tensors in [0, 51]."""
    return _lut(qp.device)[qp.long()]
