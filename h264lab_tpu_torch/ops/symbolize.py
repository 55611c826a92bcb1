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
import functools

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
    [_VP] * 27 + [ctypes.c_longlong, _CI, _CI, _CI, _CI, _CI, _VP], _CI)})

# K6's inputs in order, and their trailing shapes after (n, nmb); the
# levels, which K6 loads in 16-byte pieces, are 16-byte aligned
INPUTS = (("sel", ()), ("mode16", ()), ("cmode", ()), ("i4sym_v", (16,)),
          ("i4sym_l", (16,)), ("mv4_y", (4, 4)), ("mv4_x", (4, 4)),
          ("shape", ()), ("dc_lev", (4, 4)), ("ac_lev", (4, 4, 4, 4)),
          ("lev_inter", (4, 4, 4, 4)), ("cdc_lev", (2, 2, 2)),
          ("cac_lev", (2, 2, 2, 4, 4)))
_ALIGNED = ("dc_lev", "ac_lev", "lev_inter", "cdc_lev", "cac_lev")
# the inputs K6 reads in a base-mode slice (`symbolize_tiles`)
BASE_MODE_INPUTS = ("lev_inter", "cdc_lev", "cac_lev")
# the entry point's output pointers in order, after the inputs and qp_rows
_OUTPUT_ARGS = ("sym_vals", "sym_lens", "tail_val", "tail_len", "total_bits",
                "row_bits", "skip", "cbp", "cbpc", "mvd_py", "mvd_px",
                "qp_dec", "scratch")


def _layout(n: int, nmb: int, mbh: int, plan: bool):
    """K6's outputs and its scratch as (name, dtype, shape) in the order of
    one buffer, each starting on a 16-byte boundary."""
    i32 = torch.int32
    out = [("sym_vals", i32, (n, nmb, MB_SLOTS)),
           ("sym_lens", i32, (n, nmb, MB_SLOTS)),
           ("scratch", i32, (n * nmb * (REC_BYTES // 4 + SCAN_WORDS),)),
           ("cbp", i32, (n, nmb)), ("cbpc", i32, (n, nmb)),
           ("mvd_py", i32, (n, nmb, 4)), ("mvd_px", i32, (n, nmb, 4)),
           ("tail_val", i32, (n,)), ("tail_len", i32, (n,)),
           ("total_bits", i32, (n,)), ("row_bits", i32, (n, mbh))]
    if plan:
        out.append(("qp_dec", i32, (n, nmb)))
    out.append(("skip", torch.bool, (n, nmb)))
    return out


@functools.lru_cache(maxsize=64)
def _plan(n: int, nmb: int, mbh: int, plan: bool):
    """What a call of these sizes needs, worked out once: the inputs'
    shapes in order (qp_rows last with a plan), the buffer's bytes, each
    output's (name, dtype, shape, strides, offset in elements of its
    dtype), and the byte offsets of the entry point's output pointers
    (`_OUTPUT_ARGS`; None for an output this call does not have)."""
    shapes = tuple(torch.Size((n, nmb) + trail) for _, trail in INPUTS)
    if plan:
        shapes += (torch.Size((n, mbh)),)
    nbytes, views, offsets = cuda_build.buffer_plan(tuple(
        _layout(n, nmb, mbh, plan)))
    return shapes, nbytes, views, tuple(offsets.get(k) for k in
                                        _OUTPUT_ARGS)


@functools.lru_cache(maxsize=64)
def _checks(n: int, nmb: int, mbh: int, plan: bool, base_mode: bool = False):
    """The inputs' checks for `cuda_build.pointers`: int32 of their shapes,
    the levels 16-byte aligned; in a base-mode slice those of
    `BASE_MODE_INPUTS` only."""
    return tuple((name, torch.int32, shape, mask) for name, shape, mask
                 in zip(_NAMES, _plan(n, nmb, mbh, plan)[0], _ALIGN_MASK)
                 if not base_mode or name in BASE_MODE_INPUTS)


_NAMES = tuple(name for name, _ in INPUTS) + ("qp_rows",)
_ALIGN_MASK = tuple(15 if name in _ALIGNED else 0 for name in _NAMES)


def symbolize_tiles(sel, mode16, cmode, i4sym_v, i4sym_l, mv4_y, mv4_x,
                    shape, dc_lev, ac_lev, lev_inter, cdc_lev, cac_lev,
                    qp_rows, mb_width: int, mb_height: int, has_inter: bool,
                    svc_base_mode_bit: bool = False,
                    base_mode: bool = False) -> dict:
    """K6: `mbscan.symbolize` of n slices of mb_width x mb_height MBs on
    the card, three launches in stream order (records, slice scans,
    codes); with `base_mode`, n SVC base-mode slices in two (records,
    codes). Takes `symbolize`'s arguments in the form
    `mbscan.symbolize_args` packs: every tensor int32, contiguous, of
    shape (n, nmb) + its trailing shape (`INPUTS`), on one CUDA device,
    the levels 16-byte aligned; qp_rows an (n, mb_height) int32 row plan
    or None; in a base-mode slice the inputs of `BASE_MODE_INPUTS` and
    None for the others, no row plan, P slice or base_mode_flag bit.
    Returns the plain version's dict (`symbolize_plain`), every key with
    its dtype and shape, all of them views of one buffer. Raises on any
    other input: the plain version is `mbscan.symbolize_plain`.

    Its host time is kept short: the inputs are checked in one pass
    (`cuda_build.pointers`; `cuda_build.refuse` says what is wrong), the
    buffer's layout and the checks are worked out once per size
    (`_plan`), and one allocation holds every output."""
    tensors = (sel, mode16, cmode, i4sym_v, i4sym_l, mv4_y, mv4_x, shape,
               dc_lev, ac_lev, lev_inter, cdc_lev, cac_lev)
    what = "symbolize_tiles (K6)"
    if base_mode:
        given = [name for (name, _), x in zip(INPUTS, tensors)
                 if x is not None and name not in BASE_MODE_INPUTS]
        if given or has_inter or svc_base_mode_bit or qp_rows is not None:
            raise ValueError(f"{what}: a base-mode slice takes "
                             f"{', '.join(BASE_MODE_INPUTS)} only, without "
                             "has_inter, svc_base_mode_bit or qp_rows "
                             f"(given: {given})")
        tensors = (lev_inter, cdc_lev, cac_lev)
    elif qp_rows is not None:
        tensors += (qp_rows,)
    lead = tensors[0]
    index = cuda_build.card_of(what, lead)
    if lead.ndim < 2 or lead.shape[1] != mb_width * mb_height:
        raise ValueError(f"{what}: {'lev_inter' if base_mode else 'sel'} of "
                         f"shape {tuple(lead.shape)}, not of {mb_width} x "
                         f"{mb_height} MBs")
    n, nmb = lead.shape[:2]
    plan = qp_rows is not None
    _, nbytes, views, offsets = _plan(n, nmb, mb_height, plan)
    ptrs = cuda_build.pointers(what, tensors, _checks(
        n, nmb, mb_height, plan, bool(base_mode)), index)
    if base_mode:
        ptrs = [None] * 10 + ptrs
    buf = torch.empty(nbytes, dtype=torch.uint8, device=lead.device)
    out = cuda_build.buffer_views(buf, views)
    if n * nmb == 0:
        buf.zero_()
    else:
        base = buf.data_ptr()
        args = (*ptrs[:13], ptrs[13] if qp_rows is not None else None,
                *(None if o is None else base + o for o in offsets), n,
                mb_width, mb_height, int(bool(has_inter)),
                int(bool(svc_base_mode_bit)), int(bool(base_mode)),
                cuda_build.stream_of(index))
        if torch.cuda.current_device() == index:
            rc = _lib().h264lab_symbolize(*args)
        else:
            with torch.cuda.device(index):
                rc = _lib().h264lab_symbolize(*args)
        cuda_build.check(rc, "symbolize")
        cuda_build.count_launch("symbolize")
    del out["scratch"]
    return out


if __name__ == "__main__":
    HEADER.write_text(tables_header())
