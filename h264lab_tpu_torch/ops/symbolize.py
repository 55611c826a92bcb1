"""K6: CAVLC symbolization (the `sym` stage) of a batch of I or P slices,
three launches of the CUDA kernels in `csrc/symbolize.cu`, built with nvcc
at first use and bound with ctypes.

It replaces `h264lab_tpu/models/mbscan.py` `symbolize` with
`h264lab_tpu/ops/cavlc.py` `encode_blocks`, which the JAX package left to
XLA. Its plain version is `models/mbscan.symbolize_plain`;
`mbscan.symbolize` is the one entry of every encode path and packs K6's
arguments with `mbscan.symbolize_args`.

K6's tables are not typed by hand: `csrc/symbolize_tables.h`, which
`csrc/symbolize.cu` includes, holds them as K6_* macros written by
`tables_header` from `ops/tables.py` (zig-zag and block scans, the coded
block pattern's code numbers), `ops/tables_cavlc.py` (coeff_token,
total_zeros, run_before) and `models/mbscan.py` (the `sel` codes and the
partitions). `python -m h264lab_tpu_torch.ops.symbolize` writes it anew;
a test holds the committed file equal to `tables_header()`.
"""

from __future__ import annotations

import ctypes
import numpy as np
import torch

from h264lab_tpu_torch.ops import cuda_build, tables
from h264lab_tpu_torch.ops import tables_cavlc as tc
from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS  # noqa: F401

SRC = cuda_build.CSRC / "symbolize.cu"
HEADER = cuda_build.CSRC / "symbolize_tables.h"
MB_SLOTS = 952                  # 28 units of 34 slots (cavlc.N_SLOTS)
REC_BYTES = 32                  # pass A's record of an MB (K6's scratch)
SCAN_WORDS = 2                  # pass B's words per MB: mb_skip_run, dQP
_VP, _CI = ctypes.c_void_p, ctypes.c_int


def _vlc(vals, lens) -> np.ndarray:
    """A VLC table as K6 takes it: value | length << 16 per entry, in C
    order."""
    vals, lens = (np.asarray(t, dtype=np.int64).reshape(-1)
                  for t in (vals, lens))
    if vals.min() < 0 or vals.max() >= 1 << 16 or lens.max() > 32:
        raise ValueError("a VLC entry does not fit K6's packing")
    return vals | lens << 16


def _bits(values, width: int) -> int:
    """`values` packed `width` bits each, the first in the lowest bits."""
    word = 0
    for i, v in enumerate(values):
        if not 0 <= v < 1 << width:
            raise ValueError(f"{v} does not fit {width} bits")
        word |= int(v) << (width * i)
    if word >= 1 << 32:
        raise ValueError("more than 32 bits")
    return word


def tables_header() -> str:
    """The text of `csrc/symbolize_tables.h`: the K6_* macros of K6's
    tables, from the port's own tables."""
    from h264lab_tpu_torch.models import mbscan

    def arr(a):
        return "{" + ", ".join(str(int(v)) for v in np.asarray(a).reshape(
            -1)) + "}"

    parts = mbscan._PART_BLOCKS
    by = [parts[s][p][0] if p < len(parts[s]) else 0
          for s in range(4) for p in range(4)]
    bx = [parts[s][p][1] if p < len(parts[s]) else 0
          for s in range(4) for p in range(4)]
    lines = [
        "// K6's tables, written by "
        "`python -m h264lab_tpu_torch.ops.symbolize` from",
        "// ops/tables.py, ops/tables_cavlc.py and models/mbscan.py. Do not "
        "edit.",
        "#pragma once",
        f"#define K6_SEL_INTER {mbscan.SEL_INTER}",
        f"#define K6_SEL_I16 {mbscan.SEL_I16}",
        f"#define K6_SEL_I4 {mbscan.SEL_I4}",
        f"#define K6_ZIGZAG {arr(tables.ZIGZAG_4x4)}",
        f"#define K6_BLOCK_SCAN {arr(tables.BLOCK_SCAN_4x4)}",
        f"#define K6_CBP_TO_CODENUM {arr(tables.CBP_TO_CODENUM)}",
        "#define K6_COEFF_TOKEN "
        f"{arr(_vlc(tc.COEFF_TOKEN_VAL, tc.COEFF_TOKEN_LEN))}",
        "#define K6_TOTAL_ZEROS "
        f"{arr(_vlc(tc.TOTAL_ZEROS_VAL, tc.TOTAL_ZEROS_LEN))}",
        "#define K6_TOTAL_ZEROS_CDC "
        f"{arr(_vlc(tc.TOTAL_ZEROS_CDC_VAL, tc.TOTAL_ZEROS_CDC_LEN))}",
        "#define K6_RUN_BEFORE "
        f"{arr(_vlc(tc.RUN_BEFORE_VAL, tc.RUN_BEFORE_LEN))}",
        # the top-left block (by, bx) of partition p of shape s, 2 bits each
        f"#define K6_PART_BY(s, p) ((int)(({_bits(by, 2):#x}u >> "
        "(2 * (4 * (s) + (p)))) & 3u))",
        f"#define K6_PART_BX(s, p) ((int)(({_bits(bx, 2):#x}u >> "
        "(2 * (4 * (s) + (p)))) & 3u))",
        f"#define K6_N_PARTS(s) ((int)(({_bits(mbscan._N_PARTS, 3):#x}u >> "
        "(3 * (s))) & 7u))",
    ]
    return "\n".join(lines) + "\n"


_lib = cuda_build.Library(SRC, {"h264lab_symbolize": (
    [_VP] * 27 + [ctypes.c_longlong, _CI, _CI, _CI, _CI, _VP], _CI)})

# K6's inputs in order, and their trailing shapes after (n, nmb); the
# levels, which K6 loads in 16-byte pieces, are 16-byte aligned
INPUTS = (("sel", ()), ("mode16", ()), ("cmode", ()), ("i4sym_v", (16,)),
          ("i4sym_l", (16,)), ("mv4_y", (4, 4)), ("mv4_x", (4, 4)),
          ("shape", ()), ("dc_lev", (4, 4)), ("ac_lev", (4, 4, 4, 4)),
          ("lev_inter", (4, 4, 4, 4)), ("cdc_lev", (2, 2, 2)),
          ("cac_lev", (2, 2, 2, 4, 4)))
_ALIGNED = ("dc_lev", "ac_lev", "lev_inter", "cdc_lev", "cac_lev")


def _layout(n: int, nmb: int, mbh: int, plan: bool):
    """K6's int32 outputs and its scratch as (name, shape) in the order of
    one buffer, each starting on a 16-byte boundary."""
    out = [("sym_vals", (n, nmb, MB_SLOTS)), ("sym_lens", (n, nmb, MB_SLOTS)),
           ("scratch", (n * nmb * (REC_BYTES // 4 + SCAN_WORDS),)),
           ("cbp", (n, nmb)), ("cbpc", (n, nmb)), ("mvd_py", (n, nmb, 4)),
           ("mvd_px", (n, nmb, 4)), ("tail_val", (n,)), ("tail_len", (n,)),
           ("total_bits", (n,)), ("row_bits", (n, mbh))]
    if plan:
        out.append(("qp_dec", (n, nmb)))
    return out


def symbolize_tiles(sel, mode16, cmode, i4sym_v, i4sym_l, mv4_y, mv4_x,
                    shape, dc_lev, ac_lev, lev_inter, cdc_lev, cac_lev,
                    qp_rows, mb_width: int, mb_height: int, has_inter: bool,
                    svc_base_mode_bit: bool = False) -> dict:
    """K6: `mbscan.symbolize` of n slices of mb_width x mb_height MBs on
    the card, three launches in stream order (records, slice scans,
    codes). Takes `symbolize`'s arguments in the form
    `mbscan.symbolize_args` packs: every tensor int32, contiguous, of
    shape (n, nmb) + its trailing shape (`INPUTS`), on one CUDA device,
    the levels 16-byte aligned; qp_rows an (n, mb_height) int32 row plan
    or None. Returns the plain version's dict (`symbolize_plain`), every
    key with its dtype and shape; the int32 outputs are views of one
    buffer. Raises on any other input: the plain version is
    `mbscan.symbolize_plain`."""
    args = (sel, mode16, cmode, i4sym_v, i4sym_l, mv4_y, mv4_x, shape,
            dc_lev, ac_lev, lev_inter, cdc_lev, cac_lev)
    dev = sel.device
    tensors = args + (() if qp_rows is None else (qp_rows,))
    if dev.type != "cuda" or any(not isinstance(x, torch.Tensor)
                                 or x.device != dev for x in tensors):
        where = [getattr(x, "device", type(x)) for x in tensors]
        raise ValueError("symbolize_tiles: K6 takes tensors on one CUDA "
                         f"device, not {where}")
    if sel.ndim != 2:
        raise ValueError(f"symbolize_tiles: sel of shape {tuple(sel.shape)}")
    n, nmb = sel.shape
    if nmb != mb_width * mb_height:
        raise ValueError(f"symbolize_tiles: {nmb} MBs are not {mb_width} x "
                         f"{mb_height}")
    named = list(zip(INPUTS, args))
    if qp_rows is not None:
        named.append((("qp_rows", None), qp_rows))
    for (name, trail), x in named:
        want = (n, mb_height) if trail is None else (n, nmb) + trail
        if x.dtype != torch.int32:
            raise TypeError(f"symbolize_tiles: {name} is {x.dtype}, not "
                            "torch.int32")
        if tuple(x.shape) != want:
            raise ValueError(f"symbolize_tiles: {name} of shape "
                             f"{tuple(x.shape)}, not {want}")
        if not x.is_contiguous():
            raise ValueError(f"symbolize_tiles: {name} is not contiguous")
        if name in _ALIGNED and x.data_ptr() % 16:
            raise ValueError(f"symbolize_tiles: {name} is not 16-byte "
                             "aligned")
    layout = _layout(n, nmb, mb_height, qp_rows is not None)
    sizes = [int(np.prod(s)) for _, s in layout]
    starts = np.concatenate([[0], np.cumsum([-(-k // 4) * 4 for k in sizes])])
    with torch.cuda.device(dev):
        buf = torch.empty(int(starts[-1]), dtype=torch.int32, device=dev)
        out = {name: buf[a:a + k].view(s) for (name, s), a, k in zip(
            layout, starts.tolist(), sizes)}
        out["skip"] = torch.empty((n, nmb), dtype=torch.bool, device=dev)
        if n * nmb == 0:
            buf.zero_()
            out["skip"].zero_()
        else:
            cuda_build.check(_lib().h264lab_symbolize(
                *(x.data_ptr() for x in args),
                None if qp_rows is None else qp_rows.data_ptr(),
                *(out[k].data_ptr() for k in (
                    "sym_vals", "sym_lens", "tail_val", "tail_len",
                    "total_bits", "row_bits", "skip", "cbp", "cbpc",
                    "mvd_py", "mvd_px")),
                out["qp_dec"].data_ptr() if "qp_dec" in out else None,
                out["scratch"].data_ptr(), n, mb_width, mb_height,
                int(bool(has_inter)), int(bool(svc_base_mode_bit)),
                torch.cuda.current_stream(dev).cuda_stream), "symbolize")
            cuda_build.count_launch("symbolize")
    del out["scratch"]
    return out


if __name__ == "__main__":
    HEADER.write_text(tables_header())
