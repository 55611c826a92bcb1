"""Device selection for the port: the card unless the caller asks for the
CPU. There is no silent fallback — a missing card is an error."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card and raises when there is none; any other
    value is passed to `torch.device` as given (tests pass "cpu")."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "h264lab_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def card_label() -> str:
    """The first card's name and power limit as `nvidia-smi` reports them
    (a card may be capped below its full power, which slows it)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
