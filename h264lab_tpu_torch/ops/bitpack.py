"""Device-side variable-length bit packing of the CAVLC symbol grid.

PyTorch counterpart of `h264lab_tpu/ops/bitpack.py`. Two packers give the
words of `pack_frame_fast`, (cap_words + 256,) per frame:

- `pack_frames_plain`: plain PyTorch, the translation of the JAX
  `pack_bits_device` (exclusive bit prefix sum + non-overlapping
  scatter-add) with `pack_frame_fast`'s drop rules, one frame at a time.
  The CPU path and the reference the CUDA kernel is held against.
- `pack_frames`: the wrapper of K1, the CUDA kernel in `csrc/bitpack.cu`
  (the port of the TPU kernel `_stitch_kernel`); it takes the plain
  version only for tensors on the CPU.

The drop rules. A frame's (nmb, S) grid is MBs of S / 34 units of 34
slots, and the symbols are concatenated MSB-first in slot order. Every
offset and the returned total count every bit of every symbol, but a bit
is left out of the words (it reads as 0) if
  - its offset within its unit is 22 x 32 = 704 or more: JAX level L1
    keeps UNIT_WORDS = 22 words of a unit (h264lab_tpu/ops/bitpack.py:121-124);
  - its offset within its MB is 128 x 32 = 4096 or more: level L2 keeps
    MB_WORDS = 128 words of an MB (:143-148);
  - its frame word is cap_words + 256 or more: level L3 drops rows past the
    end (:234-235).
The offsets and totals count the dropped bits (:101-102, :134, :194-195).
A symbol across a boundary keeps its bits below it. All three boundaries
fall on word boundaries, so this is the JAX packer's word-granular drop.

Symbol values travel as int32 tensors holding uint32 bit patterns (torch
has no full uint32 support and `>>` on int32 is arithmetic); the plain
packer widens them to int64 and masks to 32 bits. Packed words come back
the same way: int32 carrying the uint32 bits.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import numpy as np
import torch

from h264lab_tpu_torch.ops import cuda_build
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS  # noqa: F401

UNIT_SLOTS = 34     # symbol slots per unit (cavlc.N_SLOTS; header padded)
UNIT_WORDS = 22     # words kept of a unit (630-bit worst-case block + spill)
MB_WORDS = 128      # words kept of an MB (spec 7.4.5: <= 3200 bits per MB)
SLACK_WORDS = 256   # tail slack of every packed frame (pack_frame_fast)
K1_SLOTS = 28 * UNIT_SLOTS  # slots per MB that K1 takes (mbscan.symbolize)

_SRC = cuda_build.CSRC / "bitpack.cu"
_VP, _LL, _CI = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_lib = cuda_build.Library(_SRC, {
    "h264lab_bitpack_tiles": ([_LL, _CI], _LL),
    "h264lab_bitpack": ([_VP, _VP, _LL, _CI, _LL, _VP, _VP, _VP, _VP], _CI)})

U32 = 0xFFFFFFFF


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_frame_plain(sym_vals: torch.Tensor, sym_lens: torch.Tensor,
                     cap_words: int):
    """Pack one frame's (nmb, S) symbol grid, S a multiple of 34, with the
    drop rules of the module docstring. Returns (words (cap_words + 256,)
    int32, total_bits int32)."""
    n_out = cap_words + SLACK_WORDS
    nmb, nslots = sym_lens.shape[-2:]
    if nslots % UNIT_SLOTS:
        raise ValueError(f"pack_frame_plain: {nslots} slots per MB is not "
                         f"a multiple of {UNIT_SLOTS}")
    lens = sym_lens.reshape(nmb, -1, UNIT_SLOTS).long()
    uoffs = torch.cumsum(lens, 2) - lens                # offset in the unit
    ubits = lens.sum(2)
    moffs = (torch.cumsum(ubits, 1) - ubits)[..., None] + uoffs  # in the MB
    mbits = ubits.sum(1)
    offs = ((torch.cumsum(mbits, 0) - mbits)[:, None, None]
            + moffs).reshape(-1)                        # in the frame
    # the leading bits of each symbol that lie below both drop boundaries
    keep = torch.minimum(lens, torch.minimum(32 * UNIT_WORDS - uoffs,
                                             32 * MB_WORDS - moffs))
    keep = torch.clamp(keep, min=0).reshape(-1)
    lens = lens.reshape(-1)
    vals = sym_vals.reshape(-1).long() & U32
    mask = U32 >> (32 - torch.clamp(keep, 1, 32))
    vals = torch.where(keep > 0, (vals >> (lens - keep)) & mask, 0)
    w = offs >> 5
    s = offs & 31
    hb = keep + s - 32                                  # bits spilling to w+1
    fits = hb <= 0
    hi = torch.where(fits, vals << torch.clamp(32 - s - keep, 0, 31),
                     vals >> torch.clamp(hb, 0, 31)) & U32
    lo = torch.where(fits, 0, vals << torch.clamp(32 - hb, 1, 31)) & U32
    # empty slots and words past the end go to a dump word that is cut off
    w = torch.where(keep > 0, w, n_out)
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

def build(src_path: Path = _SRC) -> tuple[Path, str]:
    """Compile `csrc/bitpack.cu` (or another source given) for sm_90a into
    `_build/`, once per source version (`cuda_build.build`). Returns
    (library path, compiler log; empty if cached)."""
    return cuda_build.build(src_path)


def pack_frames(sym_vals: torch.Tensor, sym_lens: torch.Tensor,
                cap_words: int):
    """Pack (..., nmb, S) int32 symbol grids (values as uint32 bit
    patterns, lengths in [0, 32]) into (words (..., cap_words + 256)
    int32, nbits (...) int32). CUDA tensors go through K1, one launch,
    and need S = 952 and 16-byte aligned grids; CPU tensors go through
    `pack_frames_plain`."""
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
    if nslots != K1_SLOTS:
        raise ValueError(f"pack_frames: K1 takes {K1_SLOTS} slots per MB, "
                         f"not {nslots}")
    if sym_vals.data_ptr() % 16 or sym_lens.data_ptr() % 16:
        raise ValueError("pack_frames: grids must be 16-byte aligned")
    n_frames = math.prod(lead)
    n_out = cap_words + SLACK_WORDS
    lib = _lib()
    with torch.cuda.device(dev):
        words = torch.zeros((n_frames, n_out), dtype=torch.int32, device=dev)
        n_tiles = lib.h264lab_bitpack_tiles(n_frames, nmb)
        if n_tiles == 0:                          # no MB: nothing to pack
            return (words.reshape(lead + (n_out,)),
                    torch.zeros(lead, dtype=torch.int32, device=dev))
        nbits = torch.empty((n_frames,), dtype=torch.int32, device=dev)
        # per tile one look-back word, then the tile ticket
        status = torch.zeros((n_tiles + 1,), dtype=torch.int64, device=dev)
        cuda_build.check(lib.h264lab_bitpack(
            sym_vals.data_ptr(), sym_lens.data_ptr(), n_frames, nmb, n_out,
            words.data_ptr(), nbits.data_ptr(), status.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "bitpack")
        cuda_build.count_launch("bitpack")
    return words.reshape(lead + (n_out,)), nbits.reshape(lead)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Packed words (int32 or uint32 bit patterns) -> MSB-first bytes."""
    w = np.asarray(words)[..., :(int(total_bits) + 31) // 32]
    if w.dtype == np.int32:
        w = w.view(np.uint32)
    return w.astype(">u4").tobytes()[:(int(total_bits) + 7) // 8]


def bucket_words(total_bits: int) -> int:
    """Round word capacity up to a power-of-two bucket."""
    need = (int(total_bits) + 31) // 32 + 2
    cap = 1024
    while cap < need:
        cap *= 2
    return cap
