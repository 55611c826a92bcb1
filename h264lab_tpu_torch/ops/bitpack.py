"""Device-side variable-length bit packing of the CAVLC symbol grid.

PyTorch counterpart of `h264lab_tpu/ops/bitpack.py`. Two packers give the
words of `pack_frame_fast`, (cap_words + 256,) per frame with writes past
that length dropped:

- `pack_frames_plain`: plain PyTorch, the translation of the JAX
  `pack_bits_device` (exclusive bit prefix sum + non-overlapping
  scatter-add), one frame at a time. The CPU path and the reference the
  CUDA kernel is held against.
- `pack_frames`: the wrapper of K1, the CUDA kernel in `csrc/bitpack.cu`
  (the port of the TPU kernel `_stitch_kernel`); it takes the plain
  version only for tensors on the CPU.

Symbol values travel as int32 tensors holding uint32 bit patterns (torch
has no full uint32 support and `>>` on int32 is arithmetic); the plain
packer widens them to int64 and masks to 32 bits. Packed words come back
the same way: int32 carrying the uint32 bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

MB_WORDS = 128      # per-MB word cap (spec 7.4.5: <= 3200 bits per MB)
SLACK_WORDS = 256   # tail slack of every packed frame (pack_frame_fast)

# launches of each kernel wrapper; a run sets them to 0 and reads them to
# show that its main path went through the kernels
LAUNCH_COUNTS = {"bitpack": 0}

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "bitpack.cu"
_BUILD_DIR = _PKG / "_build"
_lib_handle = None

U32 = 0xFFFFFFFF


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_frame_plain(sym_vals: torch.Tensor, sym_lens: torch.Tensor,
                     cap_words: int):
    """Pack one frame's (nmb, S) symbol grid. Returns (words
    (cap_words + 256,) int32, total_bits int32)."""
    n_out = cap_words + SLACK_WORDS
    vals = sym_vals.reshape(-1).long() & U32
    lens = sym_lens.reshape(-1).long()
    mask = U32 >> (32 - torch.clamp(lens, 1, 32))
    vals = torch.where(lens > 0, vals & mask, 0)
    offs = torch.cumsum(lens, 0) - lens                 # exclusive prefix sum
    w = offs >> 5
    s = offs & 31
    hb = lens + s - 32                                  # bits spilling to w+1
    fits = hb <= 0
    hi = torch.where(fits, vals << torch.clamp(32 - s - lens, 0, 31),
                     vals >> torch.clamp(hb, 0, 31)) & U32
    lo = torch.where(fits, 0, vals << torch.clamp(32 - hb, 1, 31)) & U32
    # empty slots and words past the end go to a dump word that is cut off
    w = torch.where(lens > 0, w, n_out)
    words = torch.zeros((n_out + 1,), dtype=torch.long, device=vals.device)
    words.index_add_(0, torch.clamp(w, max=n_out), hi)
    words.index_add_(0, torch.clamp(w + 1, max=n_out), lo)
    return _to_i32_bits(words[:n_out]), lens.sum().to(torch.int32)


def pack_frames_plain(sym_vals: torch.Tensor, sym_lens: torch.Tensor,
                      cap_words: int):
    """`pack_frame_plain` over the leading frame axes of (..., nmb, S)
    grids. Returns (words (..., cap_words + 256) int32, nbits (...))."""
    lead = sym_vals.shape[:-2]
    v = sym_vals.reshape((-1,) + sym_vals.shape[-2:])
    l = sym_lens.reshape((-1,) + sym_lens.shape[-2:])
    outs = [pack_frame_plain(v[i], l[i], cap_words) for i in range(v.shape[0])]
    words = torch.stack([o[0] for o in outs])
    nbits = torch.stack([o[1] for o in outs])
    return (words.reshape(lead + (cap_words + SLACK_WORDS,)),
            nbits.reshape(lead))


# ---------------------------------------------------------------------------
# K1: the CUDA kernel, built with nvcc at first use and bound with ctypes
# ---------------------------------------------------------------------------

def build() -> tuple[Path, str]:
    """Compile `csrc/bitpack.cu` for sm_90a into `_build/` (once per source
    version). Returns (library path, compiler log; empty if cached)."""
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    out = _BUILD_DIR / f"libh264lab_bitpack_{digest}.so"
    if out.exists():
        return out, ""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SRC)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}\n"
                           f"{r.stderr}")
    os.replace(tmp, out)
    return out, r.stdout + r.stderr


def _lib():
    global _lib_handle
    if _lib_handle is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.h264lab_bitpack_mb_words.argtypes = [vp, vp, ll, ci, vp, vp, vp]
        lib.h264lab_bitpack_mb_words.restype = ci
        lib.h264lab_bitpack_stitch.argtypes = [vp, vp, ll, ci, ll, vp, vp]
        lib.h264lab_bitpack_stitch.restype = ci
        _lib_handle = lib
    return _lib_handle


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def pack_frames(sym_vals: torch.Tensor, sym_lens: torch.Tensor,
                cap_words: int):
    """Pack (..., nmb, S) int32 symbol grids (values as uint32 bit
    patterns, lengths in [0, 32]) into (words (..., cap_words + 256)
    int32, nbits (...) int32). CUDA tensors go through K1; CPU tensors
    through `pack_frames_plain`."""
    if sym_vals.device.type == "cpu" and sym_lens.device.type == "cpu":
        return pack_frames_plain(sym_vals, sym_lens, cap_words)
    dev = sym_vals.device
    if dev.type != "cuda" or sym_lens.device != dev:
        raise ValueError(f"pack_frames: tensors on {dev} and "
                         f"{sym_lens.device}; both must be on one CUDA device")
    if sym_vals.dtype != torch.int32 or sym_lens.dtype != torch.int32:
        raise TypeError("pack_frames: sym_vals and sym_lens must be int32")
    if sym_vals.shape != sym_lens.shape or sym_vals.ndim < 2:
        raise ValueError(f"pack_frames: grids of shapes {sym_vals.shape} "
                         f"and {sym_lens.shape}")
    if not (sym_vals.is_contiguous() and sym_lens.is_contiguous()):
        raise ValueError("pack_frames: grids must be contiguous")
    if cap_words % 128:
        raise ValueError("pack_frames: cap_words must be a multiple of 128")
    lead = sym_vals.shape[:-2]
    nmb, nslots = sym_vals.shape[-2:]
    n_frames = math.prod(lead)
    n_out = cap_words + SLACK_WORDS
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        mb_words = torch.empty((n_frames, nmb, MB_WORDS), dtype=torch.int32,
                               device=dev)
        mb_bits = torch.empty((n_frames, nmb), dtype=torch.int32, device=dev)
        _check(lib.h264lab_bitpack_mb_words(
            sym_vals.data_ptr(), sym_lens.data_ptr(), n_frames * nmb, nslots,
            mb_words.data_ptr(), mb_bits.data_ptr(), stream),
            "bitpack mb_words")
        offs = torch.cumsum(mb_bits, dim=1, dtype=torch.int32) - mb_bits
        words = torch.zeros((n_frames, n_out), dtype=torch.int32, device=dev)
        _check(lib.h264lab_bitpack_stitch(
            mb_words.data_ptr(), offs.data_ptr(), n_frames, nmb, n_out,
            words.data_ptr(), stream), "bitpack stitch")
        LAUNCH_COUNTS["bitpack"] += 1
        nbits = mb_bits.sum(1, dtype=torch.int32)
    return words.reshape(lead + (n_out,)), nbits.reshape(lead)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Packed words (int32 or uint32 bit patterns) -> MSB-first bytes."""
    w = np.asarray(words)
    if w.dtype == np.int32:
        w = w.view(np.uint32)
    nbytes = (int(total_bits) + 7) // 8
    return w.astype(">u4").tobytes()[:nbytes]


def bucket_words(total_bits: int) -> int:
    """Round word capacity up to a power-of-two bucket."""
    need = (int(total_bits) + 31) // 32 + 2
    cap = 1024
    while cap < need:
        cap *= 2
    return cap
