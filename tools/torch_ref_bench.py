"""K11, the reference planes (`h264lab_tpu_torch/csrc/refplanes.cu`),
K9 and K10, the SVC 2x down- and upsampling (`csrc/resample.cu`
`downsample_kernel`, `upsample_kernel`), K12, the `pre` stage's padding
and tiling (`csrc/pretile.cu`), and K13, the temporal denoise
(`csrc/denoise.cu`), on the CUDA card: each wrapper's time and host time,
its kernel's device time, its byte bound and its share, in turns against
an earlier build (K12 and K13 also against their plain versions), beside
the card's achievable byte rate.

    python tools/torch_ref_bench.py [--baseline DIR] [--reps N]
                                    [--host-parts] [--variants]
                                    [--phases] [--sass DIR]
                                    [--kernels K9,K10,K11,K12,K13]

The inputs are the real ones of encodes on the card, recorded at the
stage entries: K11's (`refstate.prepare_reference`) of the first P step
of 16 GOP lanes of 1920x1088 at QP 33, speed 2 (lane g on frames g, g +
1, as `chip_smoke.py`'s main path) and of one lane of the same (one
frame, where the wrapper's host time sets the call); K9's
(`resample.downsample_planes`, the three 1080p planes) and K10's
(`resample.upsample_tiles`: the 960x544 base layer's deblocked tiles to
(1, 8160) tiles and (1, 608, 1024) padded chroma planes) of a two-layer
SVC IDR at 1920x1088 over 960x544 with inter-layer prediction, a
base-mode frame; K12's (`stages.source_tiles`: the uploaded planes) of the
same 16-lane and one-lane P steps; K13's (`denoise.denoise_planes`) of
the second P frame of `H264Encoder` at 1920x1088, speed 0, with
`temporal_denoise_flag` on a sub-pel noise pan. For each it prints the
wrapper's ms (`refplanes.planes_k11`, `resample.downsample_k9`,
`upsample_k10`, `pretile.tiles_k12`, `denoise.denoise_k13`; CUDA
events over `--reps` calls after a warm-up), its host us a call
(`torch_k78_bench.host_us`: the median of 5 x `--reps` calls issued
back to back), its kernel's device us (a trace of a second call,
`chip_smoke.kernel_launches`), the byte bound (`chip_smoke.stage_bytes`
at `chip_smoke.HBM_BYTES_PER_S`) and the share of it reached, and checks
the outputs against the plain version (`refstate.prepare_reference_plain`,
`resample.downsample2x`, `resample.upsample_tiles_plain`,
`stages.source_tiles_plain`, `denoise.denoise_plane`); K12 and K13 are
also timed in turns with their plain versions (kernel, plain, plain,
kernel). `--kernels` names the kernels to time (the others' inputs are
not recorded). As a
yardstick, a device-to-device `copy_` of a buffer half the bound's bytes
(it reads and writes them: the same bytes moved) is timed on each input
in the same call: by CUDA events (the byte rate this card reaches there;
at a few MB the host's issue sets it) and by its memcpy's device time in
a trace, which the kernel's device time is set against.

`--baseline DIR` names an earlier tree of the repository (the parent
commit, unpacked into a gitignored directory with `git archive`). The
script loads its wrappers (`DIR/h264lab_tpu_torch/ops/refplanes.py`,
`resample.py` and `denoise.py`, those it has, beside the current ones)
with its kernels (`DIR/h264lab_tpu_torch/csrc/refplanes.cu`,
`resample.cu` and `denoise.cu`, built too), checks on every input that
its outputs equal the current ones, and
times the two in turns: wrapper ms old, new, new, old, and host us a call
old, new, new, old twice (`torch_k78_bench.TURNS`), the medians of each
tree's four, all of them before the first profiler trace of the process
(a trace slows the host calls that follow it).

`--host-parts` splits the current wrappers' host time a call on the
one-frame step (K11), the SVC frame (K9, K10) and the denoise frame
(K13): the whole call, the
call without its launch (`cuda_build.call` stubbed), the input checks
(`cuda_build.pointers`), the allocation, the output views
(`cuda_build.buffer_views`) beside the same views cut by one
`split_with_sizes` and a `view` each and by one
`unflatten_dense_tensors`, the device's stream lookup, the
launch alone (`cuda_build.call` on the call's words) and the bare ctypes
call of the entry point on a prepared word array.

`--variants` times K10's and K13's design variants (`VARIANTS`: for K10
other chunk widths and block sizes, the source's `kUpChunk` and
`kUpThreads` replaced, and a kernel without the shared vertical pass,
each thread summing the vertical taps of its window from the shared base
tiles itself; for K13 tiles of 4 and 16 rows, 1 to 8 warps a block, the
gain pairs in shared memory, the tiles' rows bulk-copied into shared
memory on an mbarrier, and the rows copied by cp.async with a wait a
row; each written from the current source into the gitignored
`h264lab_tpu_torch/_build/variants/` with the headers beside it) in turns
with the source's build on the kernel's input (current, variant,
variant, current), outputs equal, with each build's ptxas line.

`--phases` times K10 and K13 cut short after or without each of their
phases (`PHASES`: K10's launch of the grid alone, its bulk copies alone,
the copies and the vertical pass, and the kernel without its vertical
pass, luma rows, chroma rows or padded planes; K13's launch of the grid
alone, its loads alone, its loads and stores without the arithmetic,
and the kernel without the gain shuffles or without the stores; builds
of the current source, written like the variants, their outputs not
checked) on the kernel's input, each build's device us twice in turns,
the source's first and last.

`--sass DIR` disassembles each build of `resample.cu`, `refplanes.cu`,
`pretile.cu` and `denoise.cu` (`cuobjdump -sass`) into DIR and prints
each kernel's instruction and opcode counts
(`torch_k6_bench.sass_counts`).

Every build's ptxas registers, shared memory, stack and spills are
printed. Needs a CUDA device; every line names the card and its power
limit. It imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import torch_k6_bench as k6b  # noqa: E402
from torch_k78_bench import TURNS, host_us  # noqa: E402
from h264lab_tpu_torch.config import EncoderConfig, RunConfig  # noqa: E402
from h264lab_tpu_torch.models import refstate, stages  # noqa: E402
from h264lab_tpu_torch.models.encoder import H264Encoder  # noqa: E402
from h264lab_tpu_torch.models.svc import SvcEncoder  # noqa: E402
from h264lab_tpu_torch.ops import (cuda_build, denoise, pretile,  # noqa: E402
                                   refplanes, resample)
from h264lab_tpu_torch.parallel.gop import GopBandEncoder  # noqa: E402
from h264lab_tpu_torch.utils.device import card_label  # noqa: E402
from h264lab_tpu_torch.utils.synthetic import (  # noqa: E402
    chessboard_sequence, noise_pan_sequence)

VARIANTS_DIR = cuda_build.BUILD_DIR / "variants"
# the kernels of each wrapper module the tool times, and back
MODULE_KERNELS = {"refplanes": ("K11",), "resample": ("K9", "K10"),
                  "pretile": ("K12",), "denoise": ("K13",)}
KERNEL_MODULES = {"K9": resample, "K10": resample, "K11": refplanes,
                  "K12": pretile, "K13": denoise}
SIZES = ("constexpr int kUpChunk = 8;        // enhancement MBs a block: "
         "4, 8 or 16\nconstexpr int kUpThreads = 128;\n")
# K10 without the shared vertical pass: each thread sums the vertical taps
# of its window from the shared base tiles (`direct_luma`,
# `direct_chroma`, put before the luma rows)
LUMA_ROWS = "// The chunk's luma tile rows: a thread per (row, MB)"
VERTICAL = ("  vertical(s, gy, gu, gv, r);\n"
            "  __syncthreads();                  // the vertical sums "
            "written\n")
LUMA_WINDOW = """    // win[t] is element 7 + t of the 24 sums read
    const uint4* v = reinterpret_cast<const uint4*>(
        &s.vy[row][8 * (k - g.c0e)]);
    const uint4 x = v[0], y = v[1], z = v[2];
    const uint32_t wd[6] = {x.w, y.x, y.y, y.z, y.w, z.x};
    uint32_t pr[10];
#pragma unroll
    for (int t = 0; t < 10; ++t)
      pr[t] = t & 1 ? wd[(t + 1) >> 1]
                    : __byte_perm(wd[t >> 1], wd[(t >> 1) + 1], 0x5432);
"""
LUMA_DIRECT = """    int win[11];
    direct_luma(s, g, r, row, k, win);
    uint32_t pr[10];
#pragma unroll
    for (int t = 0; t < 10; ++t)
      pr[t] = __byte_perm(win[t] + 1020, win[t + 1] + 1020, 0x5410);
"""
CHROMA_WINDOW = """    const int st = 4 * k - 1 - (p ? gv.vb : gu.vb);
    const uint4* v = reinterpret_cast<const uint4*>(
        &s.vc[p][row][8 * (st >> 3)]);
    const uint4 x = v[0], y = v[1];
    // the window's elements from st & 7 (3 or 7) on: words 1 .. 4 or 3 .. 6
    const bool at3 = (st & 7) == 3;
    const uint32_t wd[4] = {at3 ? x.y : x.w, at3 ? x.z : y.x,
                            at3 ? x.w : y.y, at3 ? y.x : y.z};
    uint32_t pr[5];
#pragma unroll
    for (int t = 0; t < 5; ++t)
      pr[t] = t & 1 ? wd[(t + 1) >> 1]
                    : __byte_perm(wd[t >> 1], wd[(t >> 1) + 1], 0x5432);
"""
CHROMA_DIRECT = """    int win[6];
    direct_chroma(s, p ? gv : gu, p, r, row, k, win);
    uint32_t pr[5];
#pragma unroll
    for (int t = 0; t < 5; ++t)
      pr[t] = __byte_perm(win[t], win[t + 1], 0x5410);
"""
DIRECT = r"""// The vertical sums of row `row` of the chunk at base columns clamp(8 k
// - 1 + t), t = 0 .. 10, from the shared base tiles.
__device__ __forceinline__ void direct_luma(const UpSmem& s, const Win& g,
                                            int r, int row, int k,
                                            int* win) {
  const int pair = row >> 1, i = min(8 * r + pair, g.h - 1);
  const bool even = (row & 1) == 0 && 8 * r + pair < g.h;
  int at[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int rr = clampi(i - 1 + kk, 0, g.h - 1);
    at[kk] = ((rr >> 4) - g.s0) * (kUpTiles * 256) + (rr & 15) * 16;
  }
#pragma unroll
  for (int t = 0; t < 11; ++t) {
    const int col = clampi(8 * k - 1 + t, 0, g.w - 1);
    const uint8_t* src = s.y[0] + ((col >> 4) - g.t0) * 256 + (col & 15);
    const int x0 = src[at[0]], x1 = src[at[1]], x2 = src[at[2]],
              x3 = src[at[3]];
    win[t] = even ? -3 * x0 + 28 * x1 + 8 * x2 - x3
                  : -x0 + 8 * x1 + 28 * x2 - 3 * x3;
  }
}

// The same of a chroma row at base columns clamp(4 k - 1 + t), t = 0 .. 5.
__device__ __forceinline__ void direct_chroma(const UpSmem& s, const Win& g,
                                              int p, int r, int row, int k,
                                              int* win) {
  const int pair = row >> 1, i = min(4 * r + pair, g.h - 1);
  const bool even = (row & 1) == 0 && 4 * r + pair < g.h;
  int at[3];
#pragma unroll
  for (int kk = 0; kk < 3; ++kk) {
    const int rr = clampi(i - 1 + kk, 0, g.h - 1);
    at[kk] = ((rr >> 3) - g.s0) * (kUpTiles * 64) + (rr & 7) * 8;
  }
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const int col = clampi(4 * k - 1 + t, 0, g.w - 1);
    const uint8_t* src = s.c[p] + ((col >> 3) - g.t0) * 64 + (col & 7);
    win[t] = even ? src[at[0]] + 3 * src[at[1]] : 3 * src[at[1]] + src[at[2]];
  }
}

"""


def _sub(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"variant anchor not found once: {old[:60]!r}")
    return text.replace(old, new)


def sizes(chunk, threads):
    """K10 with chunks of `chunk` MBs and `threads` threads a block."""
    return lambda src: _sub(src, SIZES, (
        f"constexpr int kUpChunk = {chunk};\n"
        f"constexpr int kUpThreads = {threads};\n"))


def direct(src):
    """K10 without the shared vertical pass (`DIRECT`)."""
    src = _sub(src, LUMA_ROWS, DIRECT + LUMA_ROWS)
    src = _sub(src, VERTICAL, "")
    src = _sub(src, LUMA_WINDOW, LUMA_DIRECT)
    return _sub(src, CHROMA_WINDOW, CHROMA_DIRECT)


# K10 cut short after or without its phases, for where its time goes:
# (name, the source's transform); `if (a.mbw > 0) return;` ends the
# kernel there without the compiler knowing it
BODY = "upsample_kernel(const UpArgs a) {\n  __shared__ UpSmem s;\n"
CALLS = {"vertical": "  vertical(s, gy, gu, gv, r);\n",
         "luma": "  luma_rows(a, s, gy, r, c0, n);\n",
         "chroma": "  chroma_rows_up(a, s, gu, gv, r, c0, n);\n",
         "pad": "  // U by the first half of the threads, V by the second\n"}
RETURN = "  if (a.mbw > 0) return;\n"


def cut_before(key):
    return lambda src: _sub(src, CALLS[key], RETURN + CALLS[key])


def without(key):
    return lambda src: _sub(src, CALLS[key], "")


# K13's tile (rows a warp marches down, warps a block), its gains and its
# phases, as transforms of `csrc/denoise.cu`
K13_SIZES = ("constexpr int kRows = 4, kWarps = 4;   // a tile's rows; "
             "warps a block\n")
K13_BODY = "denoise_kernel(const __grid_constant__ Args a) {\n"
K13_SHUFFLE = re.compile(r"__shfl_sync\(kAll, gain, ([^;]*)\);")
K13_PIXEL = re.compile(r"      const uint32_t lft = .*?      wd\[k\] = [^;]*;\n",
                       re.S)
K13_MARCH = "  // the march down the tile's rows"
K13_LOADS_ALONE = """  if (a.h[0] >= 0) {                   // the loads alone
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < kRows + 2; ++i)
      x ^= c[i].x ^ c[i].y ^ c[i].z ^ c[i].w ^ q[i].x ^ q[i].y ^ q[i].z ^
           q[i].w ^ ec[i] ^ eq[i];
    if (x == 0x9e3779b9u) a.out[p][0] = 1;
    return;
  }
"""
K13_STORE = """    if (wide_out)
      *reinterpret_cast<uint4*>(out + o) = v;
    else if (n > 0)
      store_strip(out + o, v, n);
"""
SMEM_GAINS = """  __shared__ uint32_t sgain[32];
  if (threadIdx.x < 32) sgain[threadIdx.x] = a.gain[threadIdx.x];
  __syncthreads();
"""


K13_INCLUDE = "#include <cuda_runtime.h>\n"
K13_WIDE = "  if (wide) {\n"
# K13 with each tile's rows bulk-copied into shared memory on an mbarrier
# (`csrc/tq.h`'s helpers, as K10 and K11 copy theirs) where the plane's
# width divides by 16 and cur and prev are 16-byte aligned, each lane's
# strip then read from there; other planes as the source
K13_BULK = """  const bool bulk = (W & 15) == 0 &&
      (((uintptr_t)cur | (uintptr_t)prev) & 15) == 0;
  if (bulk) {
    __shared__ __align__(128) uint8_t rows_s[kWarps][2][kRows + 2][kTileW];
    __shared__ unsigned long long bar_s[kWarps];
    const int wp = threadIdx.x >> 5;
    const int xt = x0 - kStrip * lane;
    const unsigned bytes = (unsigned)min(kTileW, W - xt);
    const int r0 = max(y0 - 1, 0), r1 = min(y0 + kRows, H - 1);
    if (lane == 0) {
      tq_mbar_init(&bar_s[wp]);
      tq_mbar_expect(&bar_s[wp], 2u * (unsigned)(r1 - r0 + 1) * bytes);
      for (int y = r0; y <= r1; ++y) {
        const long long o = (long long)y * W + xt;
        tq_load(rows_s[wp][0][y - y0 + 1], cur + o, bytes, &bar_s[wp]);
        tq_load(rows_s[wp][1][y - y0 + 1], prev + o, bytes, &bar_s[wp]);
      }
    }
    __syncwarp();
    tq_mbar_wait(&bar_s[wp]);
#pragma unroll
    for (int i = 0; i < kRows + 2; ++i) {
      c[i] = q[i] = make_uint4(0, 0, 0, 0);
      const int y = y0 - 1 + i;
      if (y < 0 || y >= H || n <= 0) continue;
      c[i] = *reinterpret_cast<const uint4*>(&rows_s[wp][0][i][kStrip * lane]);
      q[i] = *reinterpret_cast<const uint4*>(&rows_s[wp][1][i][kStrip * lane]);
    }
  } else if (wide) {
"""


def k13_bulk(src):
    """K13 with its tiles' rows bulk-copied into shared memory
    (`K13_BULK`)."""
    src = _sub(src, K13_INCLUDE, K13_INCLUDE + '#include "tq.h"\n')
    return _sub(src, K13_WIDE, K13_BULK)


# K13 with each wide strip's rows copied into shared memory by cp.async,
# a commit group a row, and each row waited for just before the march
# needs it (`cp.async.wait_group`), so that the arithmetic of a row
# overlaps the loads of the rows below it
K13_WAIT_ROWS = """__device__ __forceinline__ void wait_rows(int pending) {
  switch (pending) {
#define K13_WAIT(n) case n: asm volatile("cp.async.wait_group " #n ";"); break;
    K13_WAIT(0) K13_WAIT(1) K13_WAIT(2) K13_WAIT(3) K13_WAIT(4) K13_WAIT(5)
    K13_WAIT(6) K13_WAIT(7) K13_WAIT(8) K13_WAIT(9) K13_WAIT(10)
    K13_WAIT(11) K13_WAIT(12) K13_WAIT(13) K13_WAIT(14) K13_WAIT(15)
    K13_WAIT(16) K13_WAIT(17)
#undef K13_WAIT
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

"""
K13_LOAD_LOOP = """      const long long o = (long long)y * W + x0;
      c[i] = __ldg(reinterpret_cast<const uint4*>(cur + o));
      q[i] = __ldg(reinterpret_cast<const uint4*>(prev + o));
    }
"""
K13_CP_LOOP = """      const long long o = (long long)y * W + x0;
      cp_async16(&rows_s[wp][i][0][lane], cur + o);
      cp_async16(&rows_s[wp][i][1][lane], prev + o);
    }
"""
K13_SMEM = """  __shared__ __align__(16) uint4 rows_s[kWarps][kRows + 2][2][32];
  const int wp = threadIdx.x >> 5;
"""


def _k13_fetch(j):
    return (f"if (wide) {{ wait_rows(kRows + 1 - ({j})); "
            f"c[{j}] = rows_s[wp][{j}][0][lane]; "
            f"q[{j}] = rows_s[wp][{j}][1][lane]; }}\n    ")


def k13_cp_async(src):
    """K13 with a wait a row (`K13_WAIT_ROWS`): each wide strip's rows by
    cp.async into shared memory, a commit group a row (empty for rows
    outside the plane)."""
    src = _sub(src, "namespace {\n", "namespace {\n" + K13_WAIT_ROWS)
    src = _sub(src, K13_BODY, K13_BODY + K13_SMEM)
    src = _sub(src, "      if (y < 0 || y >= H) continue;\n" + K13_LOAD_LOOP,
               "      if (y >= 0 && y < H) {\n" + K13_CP_LOOP.replace(
                   "\n      ", "\n        ").replace("    }\n", "      }\n")
               + '      asm volatile("cp.async.commit_group;");\n    }\n')
    for j, call in (("1", "  abs_pairs(c[1], q[1], mlo, mhi);\n"),
                    ("0", "    abs_pairs(c[0], q[0], ulo, uhi);\n"),
                    ("i + 1", "      abs_pairs(c[i + 1], q[i + 1], dlo, dhi);\n")):
        indent = call[:len(call) - len(call.lstrip())]
        src = _sub(src, call, indent + _k13_fetch(j).rstrip() + "\n" + call)
    return src


def k13_sizes(rows, warps):
    """K13 with tiles of `rows` rows and `warps` warps a block."""
    return lambda src: _sub(src, K13_SIZES, (
        f"constexpr int kRows = {rows}, kWarps = {warps};\n"))


def _resub(src, pattern, new, count):
    out, n = pattern.subn(new, src)
    if n != count:
        raise RuntimeError(f"variant anchor found {n} times, not {count}: "
                           f"{pattern.pattern[:60]!r}")
    return out


def k13_shared_gains(src):
    """K13 with the gain pairs copied into shared memory once a block and
    read from there, not by a shuffle from the lane that holds them."""
    src = _sub(src, K13_BODY, K13_BODY + SMEM_GAINS)
    return _resub(src, K13_SHUFFLE, r"sgain[(\1) & 31];", 4)


PHASES = (("K10", "the launch of the grid alone",
           lambda src: _sub(src, BODY, BODY + RETURN)),
          ("K10", "the bulk copies alone", cut_before("vertical")),
          ("K10", "the copies and the vertical pass", cut_before("luma")),
          ("K10", "without the vertical pass", without("vertical")),
          ("K10", "without the luma rows", without("luma")),
          ("K10", "without the chroma rows", without("chroma")),
          ("K10", "without the padded planes", cut_before("pad")),
          ("K13", "the launch of the grid alone",
           lambda src: _sub(src, K13_BODY,
                            K13_BODY + "  if (a.h[0] >= 0) return;\n")),
          ("K13", "the loads alone",
           lambda src: _sub(src, K13_MARCH, K13_LOADS_ALONE + K13_MARCH)),
          ("K13", "loads and stores, no arithmetic",
           lambda src: _resub(src, K13_PIXEL, "      wd[k] = word_of(c[i], k) "
                              "^ word_of(q[i], k);\n", 1)),
          ("K13", "without the gain shuffle",
           lambda src: _resub(src, K13_SHUFFLE, r"gain ^ (\1);", 4)),
          ("K13", "without the stores",
           lambda src: _sub(src, K13_STORE, "    if (a.h[0] < 0) "
                            "store_strip(out + o, v, n);\n")))


# design variants: (kernel, name, the source's transform)
VARIANTS = (("K10", "chunk 4, 64 threads", sizes(4, 64)),
            ("K10", "chunk 4, 128 threads", sizes(4, 128)),
            ("K10", "chunk 8, 64 threads", sizes(8, 64)),
            ("K10", "chunk 8, 256 threads", sizes(8, 256)),
            ("K10", "chunk 16, 128 threads", sizes(16, 128)),
            ("K10", "chunk 16, 256 threads", sizes(16, 256)),
            ("K10", "no shared vertical pass", direct),
            ("K13", "2 rows, 4 warps a block", k13_sizes(2, 4)),
            ("K13", "8 rows, 2 warps a block", k13_sizes(8, 2)),
            ("K13", "8 rows, 4 warps a block", k13_sizes(8, 4)),
            ("K13", "16 rows, 2 warps a block", k13_sizes(16, 2)),
            ("K13", "4 rows, 1 warp a block", k13_sizes(4, 1)),
            ("K13", "4 rows, 2 warps a block", k13_sizes(4, 2)),
            ("K13", "4 rows, 8 warps a block", k13_sizes(4, 8)),
            ("K13", "gains in shared memory", k13_shared_gains),
            ("K13", "rows bulk-copied into shared memory", k13_bulk),
            ("K13", "rows by cp.async, a wait a row", k13_cp_async),
            ("K13", "rows by cp.async, 8 rows, 2 warps a block",
             lambda src: k13_cp_async(k13_sizes(8, 2)(src))))


def record_real(kernels):
    """The stage entries' arguments of the real inputs of `kernels`, on
    the host: {what: (kernel, args)}."""
    run = RunConfig(qp_min=chip_smoke.QP, qp_max=chip_smoke.QP,
                    encode_speed=2)
    cfg = EncoderConfig(width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT,
                        gop=chip_smoke.GOP, qp=chip_smoke.QP)
    out = {}
    if kernels & {"K11", "K12"}:
        out.update(record_gop(cfg, run, kernels))
    if kernels & {"K9", "K10"}:
        out.update(record_svc(cfg, run, kernels))
    if "K13" in kernels:
        out.update(record_denoise(cfg, run))
    return out


def record_gop(cfg, run, kernels):
    """K11's and K12's inputs: the first P step of 16 GOP lanes and of
    one."""
    lanes = chip_smoke.LANES
    frames = list(chessboard_sequence(cfg.width, cfg.height, lanes + 1))
    out = {}
    for what, n in ((f"{lanes}-lane P step", lanes),
                    ("one-frame P step", 1)):
        enc = GopBandEncoder(cfg, n_gop=n)
        enc.encode_step(frames[:n], run)
        refs, pre = [], []
        with chip_smoke.recorded_calls("prepare_reference", refs,
                                       "models.refstate"), \
                chip_smoke.recorded_calls("source_tiles", pre,
                                          "models.stages"):
            enc.encode_step(frames[1:n + 1], run)
        torch.cuda.synchronize()
        if "K11" in kernels:
            out[what] = ("K11", chip_smoke.to_device(refs[0], "cpu"))
        if "K12" in kernels:
            out[f"{what}'s pre"] = ("K12", chip_smoke.to_device(pre[0],
                                                                "cpu"))
        del enc, refs, pre
        torch.cuda.empty_cache()
    return out


def record_svc(cfg, run, kernels):
    """K9's and K10's inputs: a two-layer SVC base-mode IDR."""
    w, h = cfg.width, cfg.height
    svc = SvcEncoder(dataclasses.replace(cfg, num_layers=2,
                                         inter_layer_pred_flag=True))
    down, up = [], []
    with chip_smoke.recorded_calls("downsample_planes", down,
                                   "ops.resample"), \
            chip_smoke.recorded_calls("upsample_tiles", up, "ops.resample"):
        svc.encode(*next(iter(chessboard_sequence(w, h, 1))), run)
    torch.cuda.synchronize()
    out = {}
    if "K9" in kernels:
        out[f"{w}x{h} SVC frame"] = ("K9", chip_smoke.to_device(down[0],
                                                               "cpu"))
    if "K10" in kernels:
        out[f"{w}x{h} SVC base-mode frame"] = (
            "K10", chip_smoke.to_device(up[0], "cpu"))
    del svc, down, up
    torch.cuda.empty_cache()
    return out


def record_denoise(cfg, run):
    """K13's input: the second P frame of the 1080p denoise path."""
    dn = H264Encoder(dataclasses.replace(cfg, temporal_denoise_flag=True))
    calls = []
    with chip_smoke.recorded_calls("denoise_planes", calls, "ops.denoise"):
        for f in noise_pan_sequence(cfg.width, cfg.height, 3):
            dn.encode(*f, dataclasses.replace(run, encode_speed=0))
    torch.cuda.synchronize()
    out = {f"{cfg.width}x{cfg.height} denoise P frame": (
        "K13", chip_smoke.to_device(calls[-1], "cpu"))}
    del dn, calls
    torch.cuda.empty_cache()
    return out


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def baseline_modules(tree):
    """An earlier tree's K11, K9 / K10 and K13 wrapper modules (those it
    has), loaded beside the current ones, with that tree's kernels built
    and loaded under them. Returns ({kernel: module}, {source: (library
    path, build log)})."""
    ops = os.path.join(tree, "h264lab_tpu_torch", "ops")
    csrc = os.path.join(tree, "h264lab_tpu_torch", "csrc")
    names = [name for name in ("refplanes", "resample", "denoise")
             if os.path.exists(os.path.join(csrc, f"{name}.cu"))]
    built = cuda_build.build_all([os.path.join(csrc, f"{name}.cu")
                                  for name in names])
    mods = {}
    for name, (path, _) in zip(names, built):
        mod = load_module(os.path.join(ops, f"{name}.py"), f"baseline_{name}")
        mod._lib.use(path)
        for kernel in MODULE_KERNELS[name]:
            mods[kernel] = mod
    return mods, dict(zip(names, built))


def tiles_of(args):
    """K10's base tiles, (bnmb, t, t), from `upsample_tiles`' arguments."""
    return tuple(t.reshape((-1,) + t.shape[-2:]) for t in args[0])


def wrapper_of(kernel, mod, args):
    if kernel == "K12":
        return lambda: mod.tiles_k12(*args)
    if kernel == "K13":
        return lambda: mod.denoise_k13(*args[0], *args[1])
    if kernel == "K11":
        return lambda: mod.planes_k11(*args)
    if kernel == "K10":
        tiles = tiles_of(args)
        return lambda: mod.upsample_k10(*tiles, *args[1:])
    return lambda: mod.downsample_k9(*args)


def plain_of(kernel, args):
    if kernel == "K12":
        return stages.source_tiles_plain(*args)
    if kernel == "K13":
        return tuple(denoise.denoise_plane(c, p) for c, p in zip(*args))
    if kernel == "K11":
        return refstate.prepare_reference_plain(*args)
    if kernel == "K10":
        return resample.upsample_tiles_plain(tiles_of(args), *args[1:])
    return tuple(resample.downsample2x(p) for p in args)


def items(x):
    return list(x.items()) if isinstance(x, dict) else list(enumerate(x))


def equal(a, b):
    a, b = items(a), items(b)
    return [k for k, _ in a] == [k for k, _ in b] and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for (_, x), (_, y) in zip(a, b))


def ptxas_report(tag, source, log, label):
    lines = chip_smoke.ptxas_lines(log)
    numbers = chip_smoke.ptxas_numbers(lines)
    for name, v in numbers.items():
        print(f"  {tag} {source} {name} {label}: {v['registers']} "
              f"registers, {v['smem']} bytes of shared memory, {v['stack']} "
              f"bytes of stack, spills {v['spill_stores']} B stored and "
              f"{v['spill_loads']} B loaded", flush=True)
    return numbers


def copy_yardstick(nbytes, reps):
    """A device-to-device `copy_` that moves `nbytes` (reads and writes
    nbytes / 2): its ms (CUDA events over `reps` calls; at a few MB the
    host's issue sets it), its byte rate in TB/s from that, and the least
    and the median device us of its memcpy in a trace of `reps` copies,
    each waited for alone."""
    from torch.profiler import ProfilerActivity, profile

    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    ms = chip_smoke._cuda_ms(lambda: dst.copy_(src), reps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            dst.copy_(src)
            torch.cuda.synchronize()
    us = sorted(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "Memcpy" in e.name)
    del src, dst
    return (ms, 2 * (nbytes // 2) / ms / 1e9, us[0] if us else None,
            statistics.median(us) if us else None)


def host_parts(kernel, args, reps):
    """Where the current wrapper's host time a call goes (median us over
    5 x `reps` calls each)."""
    if kernel == "K11":
        y, u, v, mbw, mbh = args
        specs, nbytes, views, _, _ = refplanes._plan(u.shape[0], mbw, mbh,
                                                     True)
        tensors = (y, u, v)
    elif kernel == "K10":
        tensors = tiles_of(args)
        specs, nbytes, views, _, _ = resample._up_plan(
            tensors[0].shape[0], *args[1:])
    elif kernel == "K13":
        tensors = tuple(args[0]) + tuple(args[1])
        specs, nbytes, views, _, _ = denoise._plan(
            tuple(p.shape for p in args[0]))
    else:
        tensors = tuple(args)
        specs, nbytes, views, _, _ = resample._down_plan(
            tuple(p.shape for p in args))
    wrapper = wrapper_of(kernel, KERNEL_MODULES[kernel], args)
    index, dev = tensors[0].get_device(), tensors[0].device
    reps *= 5
    out = dict(call=host_us(wrapper, reps))
    launch = cuda_build.call
    cuda_build.call = lambda fn, words, what, index: None
    try:
        out["without the launch"] = host_us(wrapper, reps)
    finally:
        cuda_build.call = launch
    out["input checks"] = host_us(
        lambda: cuda_build.pointers("x", tensors, specs, index), reps)
    out["allocation"] = host_us(
        lambda: torch.empty(nbytes, dtype=torch.uint8, device=dev), reps)
    buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out[f"{len(views)} output views"] = host_us(
        lambda: cuda_build.buffer_views(buf, views), reps)
    sizes = [int(torch.Size(v[2]).numel()) for v in views]
    sizes.append(nbytes - sum(sizes))
    shapes = [v[2] for v in views]

    def split():
        parts = buf.split_with_sizes(sizes)
        return [t.view(shape) for t, shape in zip(parts, shapes)]
    if all(v[4] == sum(sizes[:k]) for k, v in enumerate(views)):
        out["the views by split_with_sizes"] = host_us(split, reps)
        meta = [torch.empty(shape, dtype=torch.uint8, device="meta")
                for shape in shapes]
        unflatten = torch._C._nn.unflatten_dense_tensors
        flat = buf[:sum(sizes[:-1])]
        out["the views by unflatten_dense_tensors"] = host_us(
            lambda: unflatten(flat, meta), reps)
    out["stream lookup"] = host_us(lambda: cuda_build.stream_of(index), reps)
    words = []
    cuda_build.call, launch = (lambda fn, w, what, index: words.append(
        (fn, list(w))), cuda_build.call)
    try:
        kept = wrapper()            # the outputs the launches below write
    finally:
        cuda_build.call = launch
    fn, w = words[0]
    out["launch (cuda_build.call)"] = host_us(
        lambda: cuda_build.call(fn, w, "x", index), reps)
    import array
    arr = array.array("q", w)
    ptr = arr.buffer_info()[0]
    out["bare ctypes call"] = host_us(lambda: fn(ptr), reps)
    torch.cuda.synchronize()
    del kept
    return out


def variant_builds(label, variants, tag):
    """Each of `variants` ((kernel, name, transform), ...) built from the
    kernel's current source (`KERNEL_MODULES[kernel].SRC`) with the
    headers beside it: {(kernel, name): library path}."""
    VARIANTS_DIR.mkdir(parents=True, exist_ok=True)
    for header in cuda_build.CSRC.glob("*.h"):
        shutil.copy(header, VARIANTS_DIR / header.name)
    paths = []
    for k, (kernel, name, transform) in enumerate(variants):
        src = KERNEL_MODULES[kernel].SRC
        path = VARIANTS_DIR / f"{src.stem}_{tag}{k}.cu"
        path.write_text(transform(src.read_text()))
        paths.append(path)
    built = cuda_build.build_all(paths)
    out = {}
    for (kernel, name, _), (path, log) in zip(variants, built):
        ptxas_report(tag, f"{kernel} ({name})", log, label)
        out[(kernel, name)] = path
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--host-parts", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--sass", metavar="DIR")
    ap.add_argument("--kernels", default=",".join(KERNEL_MODULES),
                    help="the kernels to time, comma-separated "
                    "(default: all)")
    opts = ap.parse_args()
    kernels = set(opts.kernels.split(","))
    if not kernels <= set(KERNEL_MODULES):
        ap.error(f"--kernels: not among {sorted(KERNEL_MODULES)}")
    if not torch.cuda.is_available():
        print("torch_ref_bench: no CUDA device", file=sys.stderr)
        return 2
    label = f"[{card_label()}]"
    print(label, flush=True)
    t_start = time.perf_counter()
    built = cuda_build.build_all([refplanes.SRC, resample.SRC, pretile.SRC,
                                  denoise.SRC])
    builds = {"new": {"refplanes": built[0], "resample": built[1],
                      "pretile": built[2], "denoise": built[3]}}
    result = dict(card=label, ptxas={"new": {}}, inputs={})
    mods = {"K11": {"new": refplanes}, "K9": {"new": resample},
            "K10": {"new": resample}, "K12": {"new": pretile},
            "K13": {"new": denoise}}
    if opts.baseline:
        old, builds["old"] = baseline_modules(opts.baseline)
        for kernel, mod in old.items():
            mods[kernel]["old"] = mod
    for tag, by_source in builds.items():
        result["ptxas"][tag] = {
            source: ptxas_report(tag, source, log, label)
            for source, (_, log) in by_source.items()}
    if opts.sass:
        result["sass"] = {}
        for tag, by_source in builds.items():
            for source, (path, _) in by_source.items():
                counts = k6b.sass_counts(path, opts.sass, f"{tag}_{source}")
                result["sass"][f"{tag} {source}"] = counts
                for fn, c in counts.items():
                    print(f"  {tag} {source} SASS {fn}: {c}", flush=True)
    variants = (variant_builds(label, [v for v in VARIANTS
                                       if v[0] in kernels], "variant")
                if opts.variants else {})
    phases = (variant_builds(label, [v for v in PHASES if v[0] in kernels],
                             "phase") if opts.phases else {})
    real = record_real(kernels)
    prepared = []
    for what, (kernel, args) in real.items():
        args = chip_smoke.to_device(args, "cuda")
        want = plain_of(kernel, args)
        fns = {tag: wrapper_of(kernel, mod, args)
               for tag, mod in mods[kernel].items()}
        row = dict(kernel=kernel, plain_equal={
            tag: equal(fn(), want) for tag, fn in fns.items()})
        moved = chip_smoke.stage_bytes(kernel, args, [w for _, w in
                                                      items(want)])
        row["bytes"] = moved
        row["bound_ms"] = moved / chip_smoke.HBM_BYTES_PER_S * 1e3
        del want
        prepared.append((what, kernel, args, fns, row))
        torch.cuda.synchronize()
    # every host time before the first trace
    for what, kernel, args, fns, row in prepared:
        if "old" in fns:
            hosts = [(tag, host_us(fns[tag], 5 * opts.reps))
                     for tag in TURNS]
            row["host_turns"] = hosts
            row["host_us"] = statistics.median(
                [us for t, us in hosts if t == "new"])
            row["old_host_us"] = statistics.median(
                [us for t, us in hosts if t == "old"])
        else:
            row["host_us"] = host_us(fns["new"], 5 * opts.reps)
        if opts.host_parts and kernel in ("K9", "K10", "K11", "K13") and (
                kernel != "K11" or what.startswith("one")):
            row["host_parts"] = host_parts(kernel, args, opts.reps)
            print(f"  {kernel} wrapper host us a call on the {what} {label}, "
                  "medians: " + ", ".join(
                      f"{k} {v:.1f}" for k, v in row["host_parts"].items()),
                  flush=True)
    for what, kernel, args, fns, row in prepared:
        if "old" in fns:
            row["old_equal"] = equal(fns["old"](), fns["new"]())
            turns = [(tag, chip_smoke._cuda_ms(fns[tag], opts.reps))
                     for tag in ("old", "new", "new", "old")]
            row["turns"] = turns
            row["ms"] = (turns[1][1] + turns[2][1]) / 2
            row["old_ms"] = (turns[0][1] + turns[3][1]) / 2
        else:
            row["ms"] = chip_smoke._cuda_ms(fns["new"], opts.reps)
        if kernel in ("K12", "K13"):
            plain = [(tag, chip_smoke._cuda_ms(
                fns["new"] if tag == "kernel" else
                (lambda: plain_of(kernel, args)), opts.reps))
                for tag in ("kernel", "plain", "plain", "kernel")]
            row["plain_turns"] = plain
            row["plain_ms"] = (plain[1][1] + plain[2][1]) / 2
        (row["copy_ms"], row["copy_tb_s"], row["copy_device_us"],
         row["copy_device_median_us"]) = copy_yardstick(row["bytes"],
                                                        opts.reps)
        for tag in TURNS[:4] if "old" in fns else ("new",):
            k, _ = chip_smoke.kernel_launches(fns[tag], traces=6)
            row.setdefault(f"{tag}_device_turns", []).append(k)
        for tag in fns:
            row[f"{tag}_device"] = row[f"{tag}_device_turns"][0]
        result["inputs"][what] = row
        dev = {tag: sum(us for _, us in row[f"{tag}_device"])
               for tag in fns}
        line = (f"  {kernel} on the {what} {label}: {row['ms']:.4f} ms, "
                f"host {row['host_us']:.1f} us a call, device "
                + ", ".join(f"{n} {us:.1f} us" for n, us in
                            row["new_device"])
                + f"; bound {row['bound_ms'] * 1e3:.2f} us for "
                f"{row['bytes'] / 1e6:.2f} MB ({100 * row['bound_ms'] / row['ms']:.1f}%"
                " of the wrapper's time"
                + (f", {100e3 * row['bound_ms'] / dev['new']:.1f}% of the "
                   "device time" if dev["new"] else "")
                + f"); copy_ of the same bytes {row['copy_ms'] * 1e3:.2f} us"
                f" ({row['copy_tb_s']:.2f} TB/s"
                + (f", the kernel at {100 * row['copy_ms'] * 1e3 / dev['new']:.1f}%"
                   " of its rate" if dev["new"] else "")
                + ("" if row["copy_device_us"] is None else
                   f"; its memcpy's device time {row['copy_device_us']:.2f} "
                   f"us least, {row['copy_device_median_us']:.2f} median"
                   + (f", the kernel's device time "
                      f"{dev['new'] / row['copy_device_us']:.3f} of the least"
                      if dev["new"] else ""))
                + f"); equal to the plain version: {row['plain_equal']}"
                + ("" if "plain_turns" not in row else
                   "; in turns kernel, plain, plain, kernel: " + ", ".join(
                       f"{ms:.4f}" for _, ms in row["plain_turns"])
                   + f" ms, plain / kernel "
                   f"{row['plain_ms'] / row['ms']:.1f}x"))
        if "old" in fns:
            line += (f"; in turns old, new, new, old: " + ", ".join(
                f"{ms:.4f}" for _, ms in row["turns"])
                + f" ms, new / old {row['ms'] / row['old_ms']:.3f}; device "
                "us in turns old, new, new, old: " + ", ".join(
                    f"{sum(us for _, us in k):.1f}"
                    for k in row["old_device_turns"][:1]
                    + row["new_device_turns"]
                    + row["old_device_turns"][1:])
                + (f" (new / old {dev['new'] / dev['old']:.3f})"
                   if dev["new"] and dev["old"] else "")
                + "; host us a call in turns: " + ", ".join(
                    f"{t} {us:.1f}" for t, us in row["host_turns"])
                + f" (medians new / old "
                f"{row['host_us'] / row['old_host_us']:.3f}); outputs equal "
                f"to the old build's: {row['old_equal']}")
        print(line, flush=True)
    for (kernel, name), path in variants.items():
        mod = load_module(KERNEL_MODULES[kernel].__file__, "variant_module")
        mod._lib.use(path)
        for what, k, args, fns, row in prepared:
            if k != kernel:
                continue
            var = wrapper_of(kernel, mod, args)
            same = equal(var(), fns["new"]())
            turns = [(tag, chip_smoke._cuda_ms(
                fns["new"] if tag == "current" else var, opts.reps))
                for tag in ("current", "variant", "variant", "current")]
            dev = [(tag, chip_smoke.kernel_launches(
                fns["new"] if tag == "current" else var, traces=6)[0])
                for tag in ("current", "variant", "variant", "current")]
            result["inputs"][f"{what}, {name}"] = dict(
                turns=turns, device=dev, equal=same)
            print(f"  {kernel} {name} on the {what} {label}: in turns "
                  "current, variant, variant, current: " + ", ".join(
                      f"{ms:.4f}" for _, ms in turns) + " ms; device us "
                  + ", ".join(f"{sum(us for _, us in k):.1f}"
                              for _, k in dev)
                  + f"; outputs equal: {same}", flush=True)
    result["phases"] = {}
    for kernel in sorted({k for k, _ in phases}):
        inputs = [(args, fns) for _, k, args, fns, _ in prepared
                  if k == kernel]
        if not inputs:
            continue
        args, fns = inputs[0]
        builds = {"the source": fns["new"]}
        for (k, name), path in phases.items():
            if k == kernel:
                mod = load_module(KERNEL_MODULES[kernel].__file__,
                                  "phase_module")
                mod._lib.use(path)
                builds[name] = wrapper_of(kernel, mod, args)
        times = {}
        for name in list(builds) * 2 + ["the source"]:
            k, _ = chip_smoke.kernel_launches(builds[name], traces=6)
            times.setdefault(name, []).append(sum(us for _, us in k))
        result["phases"][kernel] = times
        for name, us in times.items():
            print(f"  {kernel} phases, {name} {label}: device us "
                  + ", ".join(f"{v:.2f}" for v in us), flush=True)
    print(f"torch_ref_bench {time.perf_counter() - t_start:.1f} s {label}")
    print(json.dumps(result, default=str))
    ok = all(all(r["plain_equal"].values()) and r.get("old_equal", True)
             for r in result["inputs"].values() if "plain_equal" in r)
    ok = ok and all(r["equal"] for r in result["inputs"].values()
                    if "equal" in r)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
