#!/usr/bin/env python3
"""Smoke run of the PyTorch port (h264lab_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. print the card's name and power limit (nvidia-smi);
  2. build the bit-pack kernel K1 (h264lab_tpu_torch/csrc/bitpack.cu),
     the deblocking kernel K2 (csrc/deblock.cu), the wavefront kernel K3
     (csrc/wavefront.cu), the motion search kernels K4 and K5
     (csrc/me.cu), the CAVLC symbolization kernel K6
     (csrc/symbolize.cu, with its tables in csrc/symbolize_tables.h), the
     inter residual kernel K7 (csrc/inter.cu), the parallel P select
     kernel K8 (csrc/select.cu; both with csrc/tq.h and its tables in
     csrc/tq_tables.h), the SVC 2x down- and upsampling kernels K9 and
     K10 (csrc/resample.cu), the reference planes kernel K11
     (csrc/refplanes.cu), the padding and tiling kernel K12
     (csrc/pretile.cu) and the temporal denoise kernel K13
     (csrc/denoise.cu), one nvcc each, started together, and print what
     ptxas reports (registers, shared memory, spills);
  3. the main path, the bench configuration: 1920x1088 chessboard input,
     IPPP with GOP 20, 16 GOP lanes in one dispatch at QP 33,
     encode_speed 2, lane g walking consecutive frames g, g+1, ...:
     step 0 (IDR) and step 1 (the first P step), untimed, with their
     reconstructions; three timed P steps (no synchronization inside a
     step) for P frames/s; one P step with per-stage times (each stage
     between device synchronizations); one forced FrameType.KEY step with
     per-stage times; one more forced KEY step without synchronization
     inside it, timed as t_IDR. From these a GOP-20 frames/s, derived as
     16 * 20 / (t_IDR + 19 * t_P). The RBSPs that the two stage steps
     escape and the bit writers they pack are kept for phase 6, their
     deblocking and wavefront inputs for phase 4, its motion search
     inputs for phase 18, the two stage steps' symbolize inputs for phase
     19, its K7 and K8 inputs for phase 20; the main path must have
     launched K1 and K2 on every step, K3 once on each of its three IDR
     steps, K4, K7 and K8 once on each of its five P steps (no K5 at speed
     2), K6, K11 (its `ref` stage) and K12 (its `pre`) once on every step
     and no K9, K10 or K13 (the steps' `ref` inputs of both stage steps
     and the P stage step's `pre` inputs kept for phase 21). From here to
     phase 15 no `downsample2x`, `upsample2x_luma`, `upsample2x_chroma`,
     `qpel.pad_guard`, `me.downsample4`, `stages.pad_to` or
     `denoise.denoise_plane` call may take a tensor on the card
     (`plain_stages_on_card`), and no `ref`
     stage may copy its tiles before K11 nor an `up` stage before K10
     (`tile_copies`: every path hands K11 and K10 fresh, 16-byte aligned
     tiles);
  4. hold K1 against the plain PyTorch packer on the real (16, 1, 8160,
     952) symbol grids of the IDR step and of a P step, each at its
     capacity and at 1024 words, and on a synthetic 16 x 8160-MB grid with
     what the real grids lack (runs of empty MBs, an empty frame, MBs over
     4096 bits, units over 704 bits): the words and bit counts must be
     equal; hold K2 against the plain filter (`deblock_frame_plain`) on
     the IDR and P steps' (16, 8160) deblocking inputs: equal tiles; hold
     K3 against the plain wavefront (`_select_wavefront_plain`) on the IDR
     step's (16, 8160) wavefront inputs: all 13 outputs equal;
  5. encode lane 0's first two frames (IDR, P) with the port on the CPU:
     their bytes must equal lane 0 of the card's steps 0 and 1; then
     decode lane 0's stream of those two steps with the port's decoder
     (numpy, on the host) in a worker process, beside phases 6 to 22:
     both frames must equal the card's reconstruction; before the results
     the script waits for it and prints the decode seconds per 1080p
     frame (a host time, taken while the other phases run);
  6. NAL escaping on the RBSPs of phase 3's stage steps (16 lanes): the
     per-byte loop the port used until the numpy escape replaced it,
     against `nal.escape_rbsp`, in turns (loop, numpy, numpy, loop): equal
     bytes, and each one's ms beside the steps' `host` stage ms; then RBSP
     packing on the bit writers of those steps (each slice's header, K1's
     words as a word run, the tail and the trailing bits; the IDR's SPS
     and PPS): the per-bit packer the port used until the word-level one
     replaced it (`pack_per_bit`) against `BitWriter.to_bytes`, in turns
     (per-bit, words, words, per-bit): equal bytes, and each one's ms;
  7. the sequential path, the CLI's default: H264Encoder at 1920x1088,
     chessboard, QP 33, GOP 20, encode_speed 0 (partitions, Intra_4x4 in
     P through the wavefront with the inter candidate): an IDR (untimed,
     first use), one P frame timed without synchronization inside it
     (seconds per frame, frames/s) and one P frame with per-stage times
     (its motion search and partition search inputs kept for phase 18,
     its symbolize inputs for phase 19, its K7 inputs with K5's
     partitions for phase 20, its `ref` inputs for phase 21); the path
     must have launched K1, K2, K3, K6, K11 and K12 on every frame, K4, K5
     and K7 on each P frame and K8, K9, K10 and K13 on none;
  8. hold K1 against the plain packer on that P frame's (1, 8160, 952)
     grid, at its capacity and at 1024 words, K2 against the plain
     filter on its deblocking inputs and K3 against the plain wavefront on
     its wavefront inputs (with the inter candidate);
  9. card bytes against CPU bytes at 352x288 (CIF): H264Encoder at speed
     0 (IDR, P, P), at speed 10 (full-pel, deblocking off: IDR, P) and at
     speed 1 with `temporal_denoise_flag` on a sub-pel noise pan (IDR, P,
     P: K13 once on each P frame), and a 2-lane GopBandEncoder at speed 1
     (IDR, P); each card stream (both lanes) decodes bit-exactly to the
     card's reconstruction; the card encoders must have launched K4 and K7
     on each of their six P frames or steps, K5 on the two at speed 0, K8
     on the one at speed 10 and K6 once for each of their symbolize
     calls;
  10. the CLI on the card (`h264lab_tpu_torch.cli.main`, --gen 352x288,
     3 frames, --psnr): it must return 0, write a stream that starts with
     an SPS and decodes to 3 frames of 352x288, and launch K6 once for
     each symbolize call and K7 on each of its 2 P frames (K8 on none: the
     CLI's speed is 0);
  11. two-layer SVC: SvcEncoder at 1920x1088 over 960x544 with
     inter-layer prediction, chessboard, QP 33, GOP 20, encode_speed 2:
     an IDR (untimed, first use), a P frame timed without synchronization
     inside it (seconds per two-layer frame), a P frame and a forced
     FrameType.KEY frame (the base-mode IDR) with per-stage times of the
     base layer, the enhancement layer and the resampling (its seconds
     and its `base_mode`, `up` and `down` ms printed on a line of their
     own); K1 and K2 must have launched at least once per layer and
     frame, K2 also for the base-mode frame's own deblocking, K3 once for
     each of the two base layer IDRs, K4, K7 and K8 once per layer of
     each P frame (the stage P frame's motion search inputs of both
     layers kept for phase 18, its K7 and K8 inputs of both layers for
     phase 20), K6 once per layer of every frame. Each IDR's enhancement
     layer is a base-mode frame (`svc.base_mode_symbols`): exactly one K7
     launch (its TQ, zero MVs, the kills off) and K6 twice (the base
     layer's I slice and the enhancement's base-mode slice, one call in
     K6's base-mode kind), counted by `cuda_build.count_launch`, and no
     `cavlc.encode_blocks` call (the stage P frame's symbolize inputs of
     both layers, the enhancement's with the base_mode_flag bit, kept for
     phase 19); K9 once per frame (its `down`), K10 once per base-mode IDR
     (its `up`: the prediction tiles and the guard-padded chroma planes
     that `base_mode_symbols` takes), K11 and K12 once per layer of every
     frame (the stage P frame's `ref` inputs of both layers and the forced
     base-mode IDR's `down`, `up` and enhancement `ref` and `pre` inputs
     kept for phase 21);
  12. hold K1 against the plain packer on the base-mode frame's (1, 8160,
     952) grid and on the base layer's P grid (1, 2040, 952), each at its
     capacity and at 1024 words, K2 against the plain filter on the
     base-mode frame's and the base P frame's deblocking inputs, K3
     against the plain wavefront on the base-mode frame's base (1, 2040)
     wavefront inputs, and on the base-mode frame's real enhancement
     inputs K6 in its base-mode kind against `symbolize_plain` and its
     `inter_residual` call (K7) against `inter_residual_plain`, 20
     launches each, every output equal (as phases 19 and 20 check them);
  13. card bytes against CPU bytes of SvcEncoder at 352x288 over 176x144:
     inter-layer prediction at speed 0 (IDR, P, P) and none at speed 2
     (IDR, P); each card stream decodes bit-exactly to the card's
     reconstructions: the enhancement layer whole, the base layer with
     NAL types 14, 15 and 20 stripped; the card encoders launch K6 once
     for each of their symbolize calls, K7 once per layer of each P frame
     and once for the base-mode IDR, and K8 once per layer of the speed-2
     P frame;
  14. `entry()` (the driver entry point: the 128x96 wavefront intra
     encode) on the card: every output equals `entry("cpu")`'s, and it
     launched K3 once and K6 once (its symbolize inputs kept for phase
     19);
  15. the ("gop", "band") mesh: `dryrun_multichip(8)` and `(3)` (64-wide
     IPPP over (4, 2) and (3, 1) meshes; lane 0 decoded bit-exactly,
     every lane equal); then GopBandEncoder at 1920x1088 with two slice
     bands over a (2, 2) mesh, two lanes (one per gop row) walking frames
     as the main path's, QP 33, speed 2, every shard issued from its own
     worker thread on its own CUDA stream, one stage of one shard at a
     time (the workers' issue lock): an IDR and a P step with the
     per-shard stage table (each shard's stream synchronized alone), the
     exchange ms and the step s (stage syncs inside), then a P step timed
     without stage syncs (it reads a reference that the exchange built
     from a P step, and its time compares with the unsharded run's); for
     each step, every shard's host interval of issue, which must overlap.
     The meshes use distinct cards when there are enough, else entries
     that all name cuda:0 (printed). Every lane's bytes of every step must
     equal an unsharded GopBandEncoder on the card with the same
     configuration, whose lane 0 IDR and first P must equal a CPU encode;
     K1, K2 and K6 must have launched exactly once for every shard and
     step, K3 for every shard of the IDR step, K4, K7 and K8 for every
     shard of the two P steps, K11 once per step, gop row and distinct
     device of the row (the exchange, on the calling thread's stream; a
     gop row's inputs of the first P step kept for phase 21), K12 once for
     every shard and step (a shard's `pre` inputs, its lanes' block rows,
     of the first P step kept for phase 21), and no plain
     resampling or padding call may have reached the card since phase 3
     (a band-1 shard's motion search and K7
     inputs of the first P step kept for phases 18 and 20, a shard's
     symbolize and K8 inputs of that step for phases 19 and 20). Then a
     forced IDR step and a P step without
     stage syncs, the mesh's and the unsharded encoder's in turns, and
     the pipelined loop (`encode_step_async` of step t + 1 before
     `finish_step(t)`, MESH_PIPELINED P steps) on each: the bytes equal,
     the seconds a step printed side by side. K1 must equal the plain
     packer on shard (0, 0)'s grid of the last counted P step, K2 the
     plain filter on a shard's (1, 4080) deblocking inputs of that step,
     K3 the plain wavefront on a shard's (1, 4080) IDR wavefront inputs;
  16. hold K2 against the plain filter on seeded inputs
     (`utils.synthetic.deblock_inputs`: bS 0 to 4, flat areas, per-frame
     and per-MB QPs) at the main paths' shapes: (16, 8160), (1, 8160) with
     per-MB QPs, (1, 2040), a (1, 4080) band whose first row and column
     are unavailable, (3, 12) at 4 x 3 MBs, and two frames one MB high (6
     x 1) and one MB wide (1 x 6): equal tiles. Every K2 check (here and
     in phases 4, 8, 12 and 15) launches K2 20 times, each output equal to
     the plain filter's, and prints K2's wrapper ms (CUDA events over 20
     calls), the `deblock` stage's (the packing and K2), the plain
     filter's (one call) and the byte bound;
  17. hold K3 against the plain wavefront on seeded inputs
     (`utils.synthetic.wavefront_inputs`: flat, gradient, chessboard,
     stripe and noise MBs) at the main paths' shapes: (16, 8160), (1,
     8160) with an inter candidate, (1, 2040), a (1, 4080) band with an
     inter candidate, (3, 12) at 4 x 3 MBs and QP 0, 6 x 1 MBs at QP 51
     and 1 x 6 MBs at QP 12: all 13 outputs equal. Every K3 check (here
     and in phases 4, 8, 12 and 15) launches K3 20 times, each output
     equal to the plain wavefront's, and prints K3's wrapper ms (CUDA
     events over 20 calls) and its us per MB step (the ms over the chain
     of mbw + 2 (mbh - 1) MB steps), the packing's and K3's ms, the plain
     wavefront's (one call) and the bound (bytes or operations,
     `k3_bound`); the phase prints K3's ptxas registers, shared memory and
     spills, its resident blocks per SM and resident clusters of 8, 4
     and 2 MB rows at 1080p's 120 MBs a row (`wavefront.occupancy`), then
     the ms, us per MB step and rows per cluster
     (`wavefront.cluster_rows`) of every K3 check;
  18. hold K4 (the dense 16x16 motion search, `me.motion_search_tiles`)
     against the plain search (`me.motion_search_plain`) and K5 (the
     partition search, `me.partition_tiles`) against the plain one
     (`me.partition_plain`): on the real inputs of the 16-lane P step
     (16, 8160), the sequential speed-0 P frame (1, 8160, K5 on K4's
     planes of it), the SVC stage P frame's enhancement (1, 8160) and base
     (1, 2040) layers and a band-1 mesh shard's (1, 4080) band at its row
     offset; then on seeded inputs (`utils.synthetic.me_inputs`: flat,
     chessboard, shifted-noise, half-pel and unmatched MBs, previous MVs
     past the +-52 clip) at (16, 8160) over 16 lanes, (1, 8160) with and
     without the sub-pel stage, (1, 2040), a (1, 4080) band at a row
     offset, 4 x 3 MBs at QP 0, 6 x 1 MBs at QP 51 and 1 x 6 MBs
     without sub-pel, 11 x 3 MBs (K4's tiles of 2 x 8 MBs cut at the right
     and bottom edges) and 9 x 5 MB bands deep in their frames (K5 on K4's
     planes of each sub-pel case). Every check launches the kernel 20
     times, each output equal to the plain version's, and prints its
     wrapper ms (CUDA events over 20 calls), the plain version's ms (one
     call) and the bound (bytes or operations, `search_bound`); the phase
     prints K4's and K5's ptxas registers, shared memory and spills, K4's
     threads, dynamic shared memory and resident blocks an SM
     (`me.occupancy`), K5's warps, threads, shared memory and resident
     blocks an SM (`me.partition_occupancy`), and the kernel launches in
     one call of K4 on the 16-lane P step's inputs and of K5 on the speed-0
     P frame's (the fullest of up to ten `torch.profiler` traces, as the
     profiler drops records; each must be one);
  19. hold K6 (CAVLC symbolization, `symbolize.symbolize_tiles` through
     `mbscan.symbolize`) against `mbscan.symbolize_plain`, every output
     key (names, dtypes, shapes, values): on the real inputs of the
     16-lane IDR and P steps, the speed-0 P frame, both SVC layers' P
     frame (the enhancement with the base_mode_flag bit), a mesh shard's
     band and `entry()`'s intra frame; then on seeded inputs
     (`utils.synthetic.sym_inputs`) at (16, 8160) in P and I slices, (1,
     8160) with a row QP plan, (1, 2040), (1, 8160) with the
     base_mode_flag bit, a (1, 4080) band, 4 x 3, 6 x 1, 1 x 6 and 11 x 3
     MBs in I and P slices, and 16 P slices of 1080p in which every
     block codes all its positions (levels in both escapes, suffixLength
     up to 6). Every check launches K6 20 times, one count a
     call, each output equal, and prints K6's wrapper ms (CUDA events over
     20 calls), the `sym` stage's (`symbolize`: the packing and K6), the
     plain version's (one call), the byte bound and its share, each of
     K6's kernels' ptxas registers, shared memory, stack and spills, and
     the kernels one call launches (the fullest of up to ten
     `torch.profiler` traces, each of a second call inside the trace:
     once the encoder has run, the profiler drops the first hand-kernel
     record of most traces; K6's kernels and no other, all three in the
     16-lane P step's, whose device time goes into the kernels line; a
     check's device time only from a trace that holds all three);
  20. hold K7 (the inter residual, `residual.inter_tiles` through
     `mbscan.inter_residual`) against `mbscan.inter_residual_plain` and
     K8 (the parallel P select, `residual.select_tiles` through
     `mbscan.select_parallel`) against `mbscan.select_parallel_plain`,
     every output (names in order, dtypes, shapes, values): on the real
     inputs of the 16-lane P step, the speed-0 P frame (K7, with K5's
     partitions), both SVC layers' P frame and a mesh shard's band; then
     on seeded inputs (`utils.synthetic.inter_residual_inputs`,
     `select_parallel_inputs`) at (16, 8160), (1, 8160) with a row QP
     plan (K7 at speed 0), (1, 2040), a (1, 4080) band, 4 x 3, 6 x 1, 1 x
     6, 11 x 3 and 9 x 5 MBs, 16 frames of 119 x 68 MBs (the kernels'
     tiles of 16 MBs end short and cross frames), and for K7 MVs past the
     search's reach on planes with a noise guard. Every check launches the
     kernel 20 times, one
     count a call, each output equal, and prints its wrapper ms (CUDA
     events over 20 calls), its host us a call, the entry's ms (the
     packing and the kernel), the plain version's ms (one call), the byte
     bound and its share (`k7_bytes`, `k8_bytes`), and on the real inputs
     the device us of its kernels (the fullest of up to ten
     `torch.profiler` traces; none where all ten lost a record); the
     phase prints each kernel's registers, shared memory, stack and
     spills; then a stream with non-flat chroma
     (`utils.synthetic.color_chroma_sequence`, 176x144, 3 slice bands,
     speed 2, an IDR and two P frames) encoded on the card and on the CPU,
     equal bytes, decoded by the port's decoder to the card's
     reconstruction (`color_chroma_check`);
  21. hold K9 (`resample.downsample_k9` through
     `resample.downsample_planes`), K10 (`resample.upsample_k10` through
     `resample.upsample_tiles`), K11 (`refplanes.planes_k11` through
     `refstate.prepare_reference`) and K12 (`pretile.tiles_k12` through
     `stages.source_tiles`) against their plain versions (`downsample2x`
     of each plane, `upsample_tiles_plain`, `prepare_reference_plain`,
     `source_tiles_plain`), every output (keys, dtypes, shapes, values),
     on the paths' real inputs: K11 on the 16-lane IDR and P steps' `ref`
     tiles, the speed-0 P frame's, both SVC layers' P frame, the SVC
     base-mode frame's enhancement and a mesh gop row's exchange; K9 and
     K10 on the SVC base-mode frame's `down` and `up` inputs; K12 on the
     16-lane P step's uploaded planes, the SVC base-mode frame's
     enhancement planes, a mesh shard's block rows, and two cropped
     1917x1079 frames at an odd address (its byte-wise loads). Every
     check launches the kernel 20 times, one count a call, each output
     equal, and prints its wrapper ms (CUDA events over 20 calls), its
     host us a call, the entry's ms, the plain version's ms (one call) and
     the byte bound and its share (`stage_bytes`); K11 on the P step, K9
     and K10 on the base-mode frame and K12 on every input also the device
     us of their kernel from a trace; the phase prints each kernel's
     ptxas registers, shared memory, stack and spills; then `pre`'s parts
     on the 16-lane P step's frames (`pre_parts`): the host copy into the
     pinned staging, the upload and K12, beside a pinned `copy_` of the
     same bytes (the host link's rate, the upload's bound) and the `pre`
     the port had before K12;
  22. the denoise path: H264Encoder at 1920x1088, speed 0, QP 33,
     `temporal_denoise_flag` on `utils.synthetic.noise_pan_sequence` (a
     sub-pel pan, so that the gains between 0 and 192 all occur): an IDR
     and two P frames (the last with per-stage times, `denoise` among
     them); K11 and K12 must launch once per frame, K13 once on each frame
     after the first, and no `PLAIN_STAGES` function may take a tensor on
     the card; then K13 (`denoise.denoise_k13` through
     `denoise.denoise_planes`) against `denoise_plane` of each plane on
     the last frame's real planes, 20 launches, as the checks of phase
     21, with its device us from a trace;
  23. print the kernels line (JSON), then the result line (JSON).

It imports torch, numpy and the port, nothing of JAX. Without a CUDA
device, or without the port beside it, it exits non-zero and prints no
result.
"""

import contextlib
import dataclasses
import json
import multiprocessing
import os
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

WIDTH, HEIGHT, QP, LANES, GOP = 1920, 1088, 33, 16, 20
TIMED_STEPS = 3
STEPS = 2 + TIMED_STEPS + 3          # the main path's steps
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)
SYNTH_SEED = 7
SEQ_SPEED = 0                    # the CLI's default encode speed
CIF = (352, 288)
SVC_FRAMES = 4                   # IDR, timed P, P and IDR with stage times
MESH = (2, 2)                    # phase 15's (gop, band) mesh
MESH_STEPS = ("IDR", "P", "P")    # its launches are counted
MESH_PIPELINED = 3               # P steps of phase 15's pipelined loop
# phase 16: (what, seed, frames, mb_width, mb_height, qp, per-MB QPs, band)
K2_CASES = (
    ("16 lanes of 1080p", 21, LANES, 120, 68, QP, False, False),
    ("1080p, per-MB QPs", 22, 1, 120, 68, QP, True, False),
    ("the SVC base layer", 23, 1, 60, 34, QP, False, False),
    ("a mesh band", 24, 1, 120, 34, QP, False, True),
    ("4 x 3 MBs", 25, 3, 4, 3, 14, True, True),
    ("6 x 1 MBs", 26, 2, 6, 1, QP, True, False),
    ("1 x 6 MBs", 27, 2, 1, 6, QP, True, False),
)
K2_REPEATS = 20                  # launches of K2 per check, all equal
# phase 17: (what, seed, frames, mb_width, mb_height, qp, inter candidate)
K3_CASES = (
    ("16 lanes of 1080p", 31, LANES, 120, 68, QP, False),
    ("1080p with an inter candidate", 32, 1, 120, 68, QP, True),
    ("the SVC base layer", 33, 1, 60, 34, QP, False),
    ("a mesh band", 34, 1, 120, 34, QP, True),
    ("4 x 3 MBs", 35, 3, 4, 3, 0, True),
    ("6 x 1 MBs", 36, 2, 6, 1, 51, True),
    ("1 x 6 MBs", 37, 2, 1, 6, 12, False),
)
K3_REPEATS = 20                  # launches of K3 per check, all equal
# K3's integer operations per MB, counted on the plain algorithm: Intra_4x4
# 16 blocks x (9 predictions and SAD terms of 16 pixels, about 6 operations
# each; the argmin; the 4x4 transform, quantisation and reconstruction,
# about 290), Intra_16x16 (3 SADs of 256 pixels, 16 block transforms, the
# DC Hadamards) and chroma (3 SADs of 128 pixels, 8 block transforms):
# about 19,000 + 7,200 + 3,500
K3_OPS_PER_MB = 30_000
INT32_OPS_PER_S = 67e12          # H100 SXM float32 rate without tensor cores
# phase 18: (what, seed, frames, mb_width, mb_height, qp, lanes, frame
# rows, sub-pel); K5 runs on K4's planes of the sub-pel cases
K4_CASES = (
    ("16 lanes of 1080p", 51, LANES, 120, 68, QP, LANES, 68, True),
    ("1080p", 52, 1, 120, 68, QP, 1, 68, True),
    ("1080p full-pel", 53, 1, 120, 68, QP, 1, 68, False),
    ("the SVC base layer", 54, 1, 60, 34, QP, 1, 34, True),
    ("a mesh band", 55, 1, 120, 34, QP, 1, 68, True),
    ("4 x 3 MBs", 56, 3, 4, 3, 0, 2, 5, True),
    ("6 x 1 MBs", 57, 2, 6, 1, 51, 1, 2, True),
    ("1 x 6 MBs", 58, 2, 1, 6, 12, 2, 8, False),
    # K4's tiles of 2 x 8 MBs: partial tiles at the right and bottom edges,
    # and bands deep in their frames (the halo stops at a band's first row)
    ("11 x 3 MBs", 59, 2, 11, 3, 33, 2, 6, True),
    ("9 x 5 MB bands", 60, 3, 9, 5, 20, 1, 40, True),
)
ME_REPEATS = 20                  # launches of K4 and K5 per check, all equal
# the motion search's integer operations per MB, counted on the plain
# algorithm (ops/me.py) at 3 per SAD term (difference, absolute value,
# sum) and 3 per rounded mean, 11 per 6-tap sum: K4 without the sub-pel
# stage: the downsample (272), 289 coarse positions x 16 terms (13,872),
# 3 centres and 49 full-pel positions x 256 terms (2,304 + 37,632); with
# it also the half-pel planes (22 x 27 vertical sums, 3 x 484 outputs:
# 22,022) and 49 quarter-pel positions x 256 means and terms (75,264). K5:
# 25 full-pel positions x 256 terms once (19,200: the 16x8 and 8x16 SADs
# at a full-pel position are sums of the 8x8 quadrants'), and per geometry
# 49 quarter-pel positions x 256 means and terms (75,264), three
# geometries. K5_OPS_PER_MB is the older count, with a full-pel sweep per
# geometry (3 x 94,464), kept so that shares against it stay comparable
# with those taken before the shared full-pel pass
K4_OPS_FULLPEL = 54_080
K4_OPS_SUBPEL = 151_366
K5_OPS_NEEDED_PER_MB = 244_992
K5_OPS_PER_MB = 283_392
# phase 19: (what, seed, slices, mb_width, mb_height, P slices, row QP
# plan, base_mode bit)
K6_CASES = (
    ("16 lanes of 1080p, P", 61, LANES, 120, 68, True, False, False),
    ("16 lanes of 1080p, I", 62, LANES, 120, 68, False, False, False),
    ("1080p P, a row QP plan", 63, 1, 120, 68, True, True, False),
    ("the SVC base layer", 64, 1, 60, 34, True, False, False),
    ("1080p P with base_mode_flag", 65, 1, 120, 68, True, False, True),
    ("a mesh band", 66, 1, 120, 34, True, False, False),
    ("4 x 3 MBs", 67, 3, 4, 3, True, True, False),
    ("6 x 1 MBs", 68, 2, 6, 1, False, True, False),
    ("1 x 6 MBs", 69, 2, 1, 6, True, False, True),
    ("11 x 3 MBs, P", 70, 2, 11, 3, True, True, False),
    ("11 x 3 MBs, I", 71, 2, 11, 3, False, False, True),
)
# every block codes all its positions, levels in both escapes, suffixLength
# up to 6 (`sym_inputs(dense=True)`)
K6_DENSE_CASE = ("16 lanes of 1080p, P, dense", 72, LANES, 120, 68, True,
                 False, False)
K6_REPEATS = 20                  # launches of K6 per check, all equal
TRACE_MARGIN_S = 0.02            # host time in a trace before and after a
                                 # traced call (`trace_kernels`)
TRACE_TRIES = 10                 # traces of a check until one holds all of
                                 # its kernels (the profiler drops records);
                                 # each retry doubles the margin, up to 16x
# phase 20: K7 (what, seed, frames, mb_width, mb_height, qp, lanes, lane
# frame rows, row QP plan, partitions, quarter-pel, full-pel reach, noise
# guard) and K8 (what, seed, frames, mb_width, mb_height, qp, row QP plan,
# band)
K7_CASES = (
    ("16 lanes of 1080p", 81, LANES, 120, 68, QP, LANES, None, False, False,
     True, 55, False),
    ("1080p speed 0, a row QP plan", 82, 1, 120, 68, QP, 1, None, True,
     True, True, 55, False),
    ("the SVC base layer", 83, 1, 60, 34, QP, 1, None, False, False, True,
     55, False),
    ("a mesh band, full-pel", 84, 2, 120, 34, QP, 1, 68, False, False, False,
     55, False),
    ("4 x 3 MBs, speed 0", 85, 3, 4, 3, 0, 2, 6, False, True, True, 55,
     False),
    ("6 x 1 MBs", 86, 2, 6, 1, 51, 1, 4, True, False, True, 55, False),
    ("1 x 6 MBs, speed 0", 87, 2, 1, 6, 12, 1, None, False, True, True, 55,
     False),
    ("11 x 3 MBs, a row QP plan", 88, 2, 11, 3, 40, 2, 9, True, False, True,
     55, False),
    ("4 x 3 MBs past the reach", 89, 2, 4, 3, 28, 1, 6, False, False, True,
     63, True),
    ("9 x 5 MBs", 80, 3, 9, 5, 24, 3, None, False, False, True, 55, False),
    ("16 frames of 119 x 68 MBs", 79, LANES, 119, 68, QP, LANES, None, False,
     False, True, 55, False),
)
K8_CASES = (
    ("16 lanes of 1080p", 91, LANES, 120, 68, QP, False, True),
    ("1080p, a row QP plan", 92, 1, 120, 68, QP, True, False),
    ("the SVC base layer", 93, 1, 60, 34, QP, False, True),
    ("a mesh band", 94, 2, 120, 34, QP, False, True),
    ("4 x 3 MBs", 95, 3, 4, 3, 0, True, False),
    ("6 x 1 MBs", 96, 2, 6, 1, 51, False, False),
    ("1 x 6 MBs", 97, 2, 1, 6, 12, True, True),
    ("11 x 3 MBs", 98, 2, 11, 3, 40, False, False),
    ("9 x 5 MBs", 90, 3, 9, 5, 24, False, False),
    ("16 frames of 119 x 68 MBs", 99, LANES, 119, 68, QP, False, True),
)
RESIDUAL_REPEATS = 20            # launches of K7 and K8 per check, all equal
RESAMPLE_REPEATS = 20            # launches of K9, K10, K11 per check


def _require(ok: bool, what: str):
    """A failed phase ends the run with a non-zero exit (also under -O)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def _cuda_ms(fn, reps):
    """Device ms per call of `fn` over `reps` calls after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_launches():
    """Set every kernel's launch count to 0 before a path runs."""
    from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


@contextlib.contextmanager
def recorded_calls(name, calls, module="models.mbscan"):
    """Append the arguments of every call of `<module>.<name>` (a module of
    the port) made inside the block to `calls`, each as the tuple of all
    its parameters in order, those passed by keyword and those left at
    their defaults included. Every encode path deblocks through
    `mbscan.deblock_frame`, runs its wavefront through
    `mbscan._select_wavefront`, its motion search through
    `me.motion_search_tiles` and `me.partition_tiles` and its CAVLC
    symbolization through `mbscan.symbolize`."""
    import importlib
    import inspect

    mod = importlib.import_module(f"h264lab_tpu_torch.{module}")
    fn = getattr(mod, name)
    sig = inspect.signature(fn)

    def recorded(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append(bound.args)
        return fn(*args, **kwargs)

    setattr(mod, name, recorded)
    try:
        yield calls
    finally:
        setattr(mod, name, fn)


def k2_bytes(k2_args):
    """The bytes K2 must move on its packed arguments: each input read once
    (the tiles, sel, the blocks' counts and MVs, the QPs and the
    availability; about 970 B per MB with per-MB QPs) and each output tile
    written once."""
    import torch

    tensors = [x for x in k2_args if isinstance(x, torch.Tensor)]
    return (sum(x.numel() * x.element_size() for x in tensors)
            + sum(x.numel() for x in tensors[:3]))


def check_k2(args, what, label):
    """K2 against the plain filter on one call's `deblock_frame` arguments
    on their card: `deblock_frame` (the packing and one K2 launch), run
    K2_REPEATS times, and `deblock_frame_plain` must give equal tiles every
    time. Returns K2's numbers: ms (its wrapper `deblock_tiles`), stage_ms
    (`deblock_frame`), both from CUDA events over 20 calls; plain_ms (the
    checked call); bound_ms (the bytes K2 must move at 3.35 TB/s);
    max_abs_err."""
    import torch
    from h264lab_tpu_torch.models import mbscan
    from h264lab_tpu_torch.ops import deblock

    with torch.cuda.device(args[0].device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        want = mbscan.deblock_frame_plain(*args)
        end.record()
        torch.cuda.synchronize()
        err = 0
        for _ in range(K2_REPEATS):
            got = mbscan.deblock_frame(*args)
            err = max([err] + [int((a.int() - b.int()).abs().max())
                               for a, b in zip(got, want)])
            _require(err == 0 and all(a.dtype == b.dtype == torch.uint8
                                      for a, b in zip(got, want)),
                     f"K2 differs from the plain filter on {what} (largest "
                     f"difference {err})")
        k2_args = mbscan.deblock_tiles_args(*args)
        out = dict(ms=_cuda_ms(lambda: deblock.deblock_tiles(*k2_args), 20),
                   stage_ms=_cuda_ms(lambda: mbscan.deblock_frame(*args), 20),
                   plain_ms=start.elapsed_time(end), max_abs_err=err)
    n, nmb = args[3].shape
    moved = k2_bytes(k2_args)
    out["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
    print(f"  K2 == plain on {what} ({n}, {nmb}), {K2_REPEATS} launches "
          f"{label}: K2 {out['ms']:.3f} ms (the deblock stage's packing and "
          f"K2 {out['stage_ms']:.3f} ms; plain {out['plain_ms']:.1f} ms; "
          f"bound {out['bound_ms']:.4f} ms for {moved / 1e6:.2f} MB, "
          f"{100 * out['bound_ms'] / out['ms']:.2f}% of it reached)")
    return out


def require_k3(calls, launches, n_frames, what):
    """A path ran its wavefront `n_frames` times on the card, each a K3
    launch."""
    _require(len(calls) == n_frames and launches == n_frames,
             f"{what}: {len(calls)} wavefront calls and {launches} K3 "
             f"launches, not {n_frames} of each")


def k3_bound(k3_args, outs):
    """The least time of K3's work on its packed arguments: the larger of
    the bytes it must move (each input tensor read once, each output
    written once: about 2.6 KB per MB, 3 KB with an inter candidate) at
    3.35 TB/s, and its integer operations (K3_OPS_PER_MB) at 67 T/s, the
    data sheet's float32 rate outside the tensor cores (it lists no int32
    rate). Returns (bound ms, "bytes" or "operations", bytes)."""
    import torch

    tensors = [x for x in k3_args if isinstance(x, torch.Tensor)]
    moved = sum(x.numel() * x.element_size()
                for x in tensors + list(outs.values()))
    n_mb = k3_args[0].shape[0] * k3_args[0].shape[1]
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n_mb * K3_OPS_PER_MB / INT32_OPS_PER_S * 1e3
    return ((bytes_ms, "bytes", moved) if bytes_ms >= ops_ms
            else (ops_ms, "operations", moved))


def k3_case_args(seed, n, mbw, mbh, qp, inter):
    """`_select_wavefront`'s arguments of a seeded K3 case
    (`utils.synthetic.wavefront_inputs`) on the card."""
    import torch
    from h264lab_tpu_torch.models.wavefront import make_plan
    from h264lab_tpu_torch.utils.synthetic import wavefront_inputs

    d = wavefront_inputs(seed, n, mbw, mbh, qp, inter=inter)
    t = {k: torch.from_numpy(v).cuda() for k, v in d.items()}
    cand = {k: t[k] for k in ("inter_cost", "recon_y_inter",
                              "recon_u_inter", "recon_v_inter")} \
        if inter else None
    return (t["src_y_mb"], t["src_u_mb"], t["src_v_mb"], t["qp"], t["qpc"],
            make_plan(mbw, mbh, 2).steps, d["avail_top"], d["avail_left"],
            mbw, cand)


def check_k3(args, what, label):
    """K3 against the plain wavefront on one call's `_select_wavefront`
    arguments on their card: `_select_wavefront` (the packing and one K3
    launch), run K3_REPEATS times, and `_select_wavefront_plain` must give
    equal outputs every time. Returns K3's numbers: ms (its wrapper
    `wavefront_tiles`), stage_ms (`_select_wavefront`), both from CUDA
    events over 20 calls; us_per_step (ms over the chain of mbw + 2 (mbh -
    1) MB steps); plain_ms (the checked call); bound_ms and bound_by
    (`k3_bound`); max_abs_err."""
    import torch
    from h264lab_tpu_torch.models import mbscan
    from h264lab_tpu_torch.ops import wavefront

    with torch.cuda.device(args[0].device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        want = mbscan._select_wavefront_plain(*args)
        end.record()
        torch.cuda.synchronize()
        err = 0
        for _ in range(K3_REPEATS):
            got = mbscan._select_wavefront(*args)
            _require(set(got) == set(want) and all(
                got[k].dtype == v.dtype for k, v in want.items()),
                f"K3's outputs differ in kind from the plain wavefront's on "
                f"{what}")
            err = max([err] + [int((got[k].long() - v.long()).abs().max())
                               for k, v in want.items()])
            _require(err == 0, f"K3 differs from the plain wavefront on "
                     f"{what} (largest difference {err})")
        k3_args = mbscan.select_wavefront_args(*args)
        out = dict(ms=_cuda_ms(lambda: wavefront.wavefront_tiles(*k3_args),
                               20),
                   stage_ms=_cuda_ms(lambda: mbscan._select_wavefront(*args),
                                     20),
                   plain_ms=start.elapsed_time(end), max_abs_err=err)
    n, nmb = args[0].shape[:2]
    mbw = args[8]
    chain = mbw + 2 * (nmb // mbw - 1)
    out["us_per_step"] = 1e3 * out["ms"] / chain
    out["cluster"] = wavefront.cluster_rows(n, mbw, nmb // mbw,
                                              args[0].device)
    out["bound_ms"], out["bound_by"], moved = k3_bound(k3_args, want)
    sels = [int((want["sel"] == k).sum()) for k in range(3)]
    print(f"  K3 == plain on {what} ({n}, {nmb}), {K3_REPEATS} launches "
          f"{label}: K3 {out['ms']:.3f} ms, {out['us_per_step']:.2f} us per "
          f"MB step of {chain} (the packing and K3 "
          f"{out['stage_ms']:.3f} ms; plain {out['plain_ms']:.1f} ms; bound "
          f"{out['bound_ms']:.4f} ms by {out['bound_by']}, "
          f"{moved / 1e6:.2f} MB, {100 * out['bound_ms'] / out['ms']:.2f}% "
          f"of it reached); MBs inter, I16, I4: {sels}")
    return out


def to_device(args, device):
    """Recorded arguments with their tensors, and those of a dict or a
    plain tuple among them (K10's base tiles), moved to `device` (the host
    keeps a path's inputs until phase 18)."""
    import torch

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if type(x) is tuple:
            return tuple(move(v) for v in x)
        return x
    return tuple(move(x) for x in args)


def search_bound(tensors, n_ops):
    """The least time of a search kernel's work: the larger of the bytes it
    must move (each input and output tensor read or written once) at 3.35
    TB/s and its integer operations at 67 T/s. Returns (bound ms, "bytes"
    or "operations", bytes)."""
    moved = sum(x.numel() * x.element_size() for x in tensors)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    return ((bytes_ms, "bytes", moved) if bytes_ms >= ops_ms
            else (ops_ms, "operations", moved))


def _search_outputs(out):
    """A search's output tensors by name: K4's tuple (with its aux fields)
    or K5's dict."""
    if isinstance(out, dict):
        return out
    named = dict(zip(("mv_y", "mv_x", "cost", "pred"), out[:4]))
    named.update((k, v) for k, v in out[4].items() if v is not None)
    return named


def check_search(kernel, plain, args, n_ops, what, label):
    """A search kernel's wrapper against its plain version on one recorded
    call's arguments on their card: `kernel` run ME_REPEATS times must give
    every output of `plain` (same names, dtypes and values). Returns its
    numbers: ms (CUDA events over 20 calls), plain_ms (the checked call),
    bound_ms and bound_by (`search_bound`: the call's tensors, the outputs
    and n_ops operations), max_abs_err."""
    import torch

    with torch.cuda.device(args[0].device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        want = _search_outputs(plain(*args))
        end.record()
        torch.cuda.synchronize()
        err = 0
        for _ in range(ME_REPEATS):
            got = _search_outputs(kernel(*args))
            _require(set(got) == set(want) and all(
                got[k].dtype == v.dtype and got[k].shape == v.shape
                for k, v in want.items()),
                f"{kernel.__name__}'s outputs differ in kind from the plain "
                f"version's on {what}")
            err = max([err] + [int((got[k].long() - v.long()).abs().max())
                               for k, v in want.items() if v.numel()])
            _require(err == 0, f"{kernel.__name__} differs from the plain "
                     f"version on {what} (largest difference {err})")
        out = dict(ms=_cuda_ms(lambda: kernel(*args), 20),
                   plain_ms=start.elapsed_time(end), max_abs_err=err)
    tensors = [x for x in args if isinstance(x, torch.Tensor)]
    out["bound_ms"], out["bound_by"], moved = search_bound(
        tensors + list(got.values()), n_ops)
    shape = tuple(args[2].shape[:2]) if len(args) > 7 else (
        args[0].shape[0],)
    print(f"  {kernel.__name__} == plain on {what} {shape}, {ME_REPEATS} "
          f"launches {label}: {out['ms']:.3f} ms (plain "
          f"{out['plain_ms']:.1f} ms; bound {out['bound_ms']:.4f} ms by "
          f"{out['bound_by']}, {moved / 1e6:.2f} MB, "
          f"{100 * out['bound_ms'] / out['ms']:.2f}% of it reached)")
    return out


def check_k4(args, what, label):
    """K4 against `me.motion_search_plain` on the arguments of one call of
    `me.motion_search_tiles` (`check_search`)."""
    from h264lab_tpu_torch.ops import me

    n_mb = args[2].shape[0] * args[2].shape[1]
    ops = K4_OPS_SUBPEL if args[10] else K4_OPS_FULLPEL    # enable_subpel
    return check_search(me.motion_search_tiles, me.motion_search_plain, args,
                        n_mb * ops, what, label)


def check_k5(args, what, label):
    """K5 against `me.partition_plain` on the arguments of one call of
    `me.partition_tiles` (`check_search`), its bound on the operations the
    function needs; beside it the bound on the older count
    (`K5_OPS_PER_MB`) as `bound_ms_old_count`."""
    from h264lab_tpu_torch.ops import me

    n_mb = args[0].shape[0]
    out = check_search(me.partition_tiles, me.partition_plain, args,
                       n_mb * K5_OPS_NEEDED_PER_MB, what, label)
    out["bound_ms_old_count"] = max(
        out["bound_ms"], n_mb * K5_OPS_PER_MB / INT32_OPS_PER_S * 1e3)
    print(f"    on the older count of {K5_OPS_PER_MB:,} operations an MB: "
          f"bound {out['bound_ms_old_count']:.4f} ms, "
          f"{100 * out['bound_ms_old_count'] / out['ms']:.2f}% of it reached")
    return out


def k4_case_args(seed, n, mbw, mbh, qp, lanes, rows, subpel):
    """`me.motion_search_tiles`' arguments of a seeded K4 case
    (`utils.synthetic.me_inputs`) on the card, the planes with sub-pel."""
    import torch
    from h264lab_tpu_torch.utils.synthetic import me_inputs

    d = me_inputs(seed, n, mbw, mbh, qp, lanes=lanes, frame_rows=rows)
    t = [torch.from_numpy(d[k]).cuda() for k in (
        "y_pad", "y4_pad", "cur_tiles", "lane", "row_offset", "qp",
        "prev_my", "prev_mx")]
    return (*t, mbw, mbh, subpel, subpel)


def k5_args(k4_args):
    """`me.partition_tiles`' arguments on K4's planes of a sub-pel call."""
    from h264lab_tpu_torch.ops import me

    out = me.motion_search_tiles(*k4_args)
    n, nmb = k4_args[2].shape[:2]
    kk = n * nmb
    return (k4_args[2].reshape(kk, 16, 16), out[4]["wins"], *(
        out[4][k].reshape(kk) for k in ("full_my", "full_mx", "mvp_y",
                                        "mvp_x")),
        me.lambda_me(k4_args[5]).repeat_interleave(nmb))


def cuda_calls(calls):
    """How many of the recorded calls (`recorded_calls`) took their first
    tensor on the card (a base-mode `symbolize` call passes None for its
    first ten)."""
    import torch

    return sum(next(a for a in args if isinstance(a, torch.Tensor)).is_cuda
               for args in calls)


def require_k6(on_card, launches, what):
    """A path called `mbscan.symbolize` on the card at least once, and
    every such call launched K6 once: `on_card` its calls on the card
    (`cuda_calls`), `launches` K6's count over the same calls."""
    _require(on_card > 0 and launches == on_card,
             f"{what}: {on_card} symbolize calls on the card and {launches} "
             "K6 launches")
    return launches


def k6_bytes(k6_args, outs):
    """The bytes K6 must move on its packed arguments, from what this
    data needs: each output written once (the 952-slot grid, 7,616 B per
    MB, and about 41 B of the others) and each input that an output
    depends on read once. Of every MB: sel, cmode, the Intra 4x4 symbol
    values, the luma DC and chroma levels (the plain version keeps their
    codes in slots of length 0 too) and its luma levels, lev_inter's if
    it is inter, else ac_lev's; on P slices its MVs and shape (an intra
    MB's MV differences are outputs too); mode16 of an I16 MB, the Intra
    4x4 lengths of an I4 MB; and the row plan. About 9.5 KB per MB of a
    P slice. A base-mode slice reads only its MBs' luma and chroma levels
    (1.6 KB per MB)."""
    import torch
    from h264lab_tpu_torch.models import mbscan
    from h264lab_tpu_torch.ops.symbolize import INPUTS

    x = dict(zip((name for name, _ in INPUTS), k6_args))
    qp_rows, has_inter = k6_args[13], k6_args[16]
    outputs = sum(t.numel() * t.element_size() for t in outs.values())
    if k6_args[18]:
        # a base-mode slice reads its luma and chroma levels only
        return outputs + sum(x[k].numel() * x[k].element_size()
                             for k in ("lev_inter", "cdc_lev", "cac_lev"))
    sel = x["sel"]
    n_mb = sel.numel()
    n_of = {v: int((sel == v).sum()) for v in (
        mbscan.SEL_INTER, mbscan.SEL_I16, mbscan.SEL_I4)}

    def per_mb(name):
        return x[name].numel() // max(n_mb, 1) * x[name].element_size()

    reads = n_mb * sum(per_mb(k) for k in (
        "sel", "cmode", "i4sym_v", "dc_lev", "cdc_lev", "cac_lev"))
    reads += (n_of[mbscan.SEL_INTER] * per_mb("lev_inter")
              + (n_mb - n_of[mbscan.SEL_INTER]) * per_mb("ac_lev")
              + n_of[mbscan.SEL_I16] * per_mb("mode16")
              + n_of[mbscan.SEL_I4] * per_mb("i4sym_l"))
    if has_inter:
        reads += n_mb * sum(per_mb(k) for k in ("mv4_y", "mv4_x", "shape"))
    if qp_rows is not None:
        reads += qp_rows.numel() * qp_rows.element_size()
    return reads + outputs


def check_k6(call, what, label, ptxas):
    """K6 against `symbolize_plain` on one call's `symbolize` arguments
    (all of them in order, as `recorded_calls` keeps them), moved to the
    card: `symbolize` (the packing and K6's
    three launches), run K6_REPEATS times, must give every output of
    `symbolize_plain` (names, dtypes, shapes, values), one count a call.
    Returns K6's numbers: ms (its wrapper `symbolize_tiles`), stage_ms
    (`symbolize`), both from CUDA events over 20 calls; plain_ms (the
    checked call); bound_ms (the bytes K6 must move at 3.35 TB/s,
    `k6_bytes`); the kernels one call launches (`kernel_launches`) and,
    when that trace holds all of them (three, two in a base-mode slice),
    device_us, their device time, else None; max_abs_err."""
    import torch
    from h264lab_tpu_torch.models import mbscan
    from h264lab_tpu_torch.ops import symbolize as k6
    from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    args = to_device(call, "cuda")
    with torch.cuda.device(args[10].device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        want = mbscan.symbolize_plain(*args)
        end.record()
        torch.cuda.synchronize()
        err = 0
        for _ in range(K6_REPEATS):
            before = LAUNCH_COUNTS["symbolize"]
            got = mbscan.symbolize(*args)
            _require(LAUNCH_COUNTS["symbolize"] == before + 1,
                     f"symbolize did not launch K6 once on {what}")
            _require(set(got) == set(want) and all(
                got[k].dtype == v.dtype and got[k].shape == v.shape
                for k, v in want.items()),
                f"K6's outputs differ in kind from the plain version's on "
                f"{what}")
            err = max([err] + [int((got[k].long() - v.long()).abs().max())
                               for k, v in want.items() if v.numel()])
            _require(err == 0, f"K6 differs from the plain version on {what}"
                     f" (largest difference {err})")
        k6_args = mbscan.symbolize_args(*args)
        out = dict(ms=_cuda_ms(lambda: k6.symbolize_tiles(*k6_args), 20),
                   stage_ms=_cuda_ms(lambda: mbscan.symbolize(*args), 20),
                   plain_ms=start.elapsed_time(end), max_abs_err=err)
        # a base-mode slice has no slice scans
        n_kernels = 2 if k6_args[18] else 3
        kernels, taken = kernel_launches(
            lambda: k6.symbolize_tiles(*k6_args), traces=TRACE_TRIES,
            want=n_kernels)
    moved = k6_bytes(k6_args, want)
    out["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
    out["kernels"] = kernels
    out["traces"] = taken
    out["n_kernels"] = n_kernels
    out["device_us"] = (sum(us for _, us in kernels)
                        if len(kernels) == n_kernels else None)
    n, nmb = want["cbp"].shape
    skips = int(want["skip"].sum())
    print(f"  K6 == plain on {what} ({n}, {nmb}), {K6_REPEATS} launches "
          f"{label}: K6 {out['ms']:.3f} ms (the packing and K6 "
          f"{out['stage_ms']:.3f} ms; plain {out['plain_ms']:.1f} ms; bound "
          f"{out['bound_ms']:.4f} ms for {moved / 1e6:.2f} MB, "
          f"{100 * out['bound_ms'] / out['ms']:.2f}% of it reached); "
          f"skipped MBs {skips}, bits {int(want['total_bits'].sum())}")
    print(f"    its kernel launches in one call: " + ", ".join(
        f"{k} {us:.1f} us" for k, us in kernels)
        + f" ({taken} profiler trace(s) taken); ptxas "
        + "; ".join(x.split("ptxas info    : ")[-1] if "Used" in x else x
                    for x in ptxas))
    return out


def k6_case_call(seed, n, mbw, mbh, has_inter, plan, flag, dense=False):
    """`symbolize`'s arguments, all in order, of a seeded K6 case
    (`utils.synthetic.sym_inputs`) on the host."""
    import torch
    from h264lab_tpu_torch.ops.symbolize import INPUTS
    from h264lab_tpu_torch.utils.synthetic import sym_inputs

    d = sym_inputs(seed, n, mbw, mbh, has_inter, plan=plan, dense=dense)
    qp = d["qp_rows"]
    return (*(torch.from_numpy(d[k]) for k, _ in INPUTS), mbw, mbh,
            has_inter, None if qp is None else torch.from_numpy(qp), flag)


def trace_kernels(fn, margin=TRACE_MARGIN_S, warm=True):
    """The device kernels of `csrc/*.cu` (the hand kernels' anonymous
    namespace) that one call of `fn` launches, from one `torch.profiler`
    trace: ([(name, device us)], lead us). The call runs `margin` seconds
    after the trace starts and ends that long before it stops; with
    `warm`, a first call of `fn` runs inside the trace before it, and
    only the kernels that start after the midpoint of the `margin`
    seconds between the warm call's end (its synchronization) and the
    traced call's host start are kept, so that a device clock up to
    margin / 2 ahead of or behind the host's in the trace moves no kernel
    across the cut: once the encoder has run in a process, the profiler
    drops the first hand-kernel record of most traces
    (`tools/torch_profiler_drops.py`, PERF.md §6). Lead: the device start
    of the first kernel kept less the host start of the traced call,
    None without a kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        if warm:
            fn()
            torch.cuda.synchronize()
            with record_function("warm call done"):
                pass
            time.sleep(margin)
        with record_function("traced call"):
            fn()
            torch.cuda.synchronize()
        time.sleep(margin)
    events = prof.events()

    def host_start(name):
        return min(e.time_range.start for e in events if e.name == name)
    start = host_start("traced call")
    cut = ((host_start("warm call done") + start) / 2 if warm
           else start - 1e6 * margin / 2)
    kept = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "anonymous namespace" in e.name
                   and e.time_range.start >= cut),
                  key=lambda e: e.time_range.start)
    lead = kept[0].time_range.start - start if kept else None
    return [(kernel_name(e.name), e.time_range.end - e.time_range.start)
            for e in kept], lead


def kernel_name(name):
    """A traced kernel's name without its namespace, parameters and return
    type; of K6's passes A and C (templates on the base-mode kind) the
    base-mode instantiations keep their `<true>`."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").replace("<false>", "")


def kernel_launches(fn, traces=3, want=1):
    """The device kernels of `csrc/*.cu` that one call of `fn` launches,
    from a trace of it after a warm-up call (`trace_kernels`): ([(name,
    device us)], the traces taken). A trace that holds fewer than `want`
    of them is taken again, its margin doubled each time up to 16
    TRACE_MARGIN_S, at most `traces` times in all, and the fullest is
    returned."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = []
    for taken in range(1, traces + 1):
        kernels, _ = trace_kernels(
            fn, margin=TRACE_MARGIN_S * 2 ** min(taken - 1, 4))
        if len(kernels) > len(best):
            best = kernels
        if len(best) >= want:
            break
    return best, taken


def ptxas_lines(log):
    """What ptxas reports of each kernel of a build log: registers, shared
    memory and spills, each line led by its kernel's name."""
    import re

    lines, kernel = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"([a-z_]+_kernel)", line)
            kernel = m.group(1) if m else ""
        elif "registers" in line or "spill" in line:
            lines.append(f"{kernel}: {line.strip()}" if kernel
                         else line.strip())
    return lines


def ptxas_numbers(lines):
    """Per kernel of `ptxas_lines`' lines: registers, shared memory bytes,
    stack frame bytes and spill stores and loads (0 where not reported)."""
    import re

    out = {}
    for line in lines:
        kernel, _, text = line.partition(": ")
        v = out.setdefault(kernel, dict(registers=0, smem=0, stack=0,
                                        spill_stores=0, spill_loads=0))
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem"),
                         ("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, text)
            if m:
                v[key] = int(m.group(1))
    return out


def residual_record():
    """What the paths keep of K7 and K8 for phase 20 and the kernels line:
    "calls", each kernel's real inputs by path (`inter_residual` and
    `select_parallel` arguments, on the host), and "launches", (K7, K8)
    launches by path."""
    return {"calls": {"inter_residual": {}, "select_parallel": {}},
            "launches": {}}


def require_k7_k8(what, k4, k7, k8, k8_calls, base_mode_frames=0):
    """A path's residual kernels: K7 once wherever K4 searched (one
    `inter_stage_core` call each) and once for each SVC base-mode frame
    (`base_mode_frames`: its TQ), and K8 once for each `select_parallel`
    call on the card (`k8_calls`, the P frames at speed 2 and up)."""
    _require(k7 == k4 + base_mode_frames and k8 == k8_calls,
             f"{what}: K4 launched {k4} times, K7 {k7} ({base_mode_frames} "
             f"base-mode frames); {k8_calls} parallel selects on the card, "
             f"K8 launched {k8} times")
    print(f"  K7 launches of {what}: {k7} (one where K4 searched, one for "
          f"each of {base_mode_frames} base-mode frames); K8 launches {k8} "
          "(one for each parallel P select)")


def k7_bytes(args, outs):
    """The bytes K7 must move on `inter_residual`'s arguments, from what
    this data needs: each output written once (2,088 B per MB), and of
    each MB its source (384 B), its 16x16 search's MVs, winner and cost,
    the luma prediction of its chosen shape (256 B of K4's, or 1,024 B of
    K5's int32 one), with partitions its costs and the chosen shape's MVs,
    and the chroma reference pixels its prediction reads (9 x 9 a plane
    for one MV, a partition's 9 x 5 or 5 x 9, a quadrant's 5 x 5); the
    QPs, lanes and row offsets."""
    import torch

    (sy, su, sv, u_pad, v_pad, lane, row0, qp, qpc, mvy, mvx, fmy, fmx,
     cost16, pred16, parts) = args[:16]
    shape = outs["shape"].reshape(-1)
    k = shape.numel()
    per_shape = torch.bincount(shape.long(), minlength=4).tolist()
    moved = sum(t.numel() * t.element_size() for t in outs.values())
    moved += sum(x.numel() * x.element_size() for x in (
        sy, su, sv, mvy, mvx, fmy, fmx, cost16, lane, row0, qp, qpc))
    moved += per_shape[0] * 256 + (k - per_shape[0]) * 1024
    window = (81, 90, 90, 100)
    moved += 2 * sum(n * w for n, w in zip(per_shape, window))
    if parts is not None:
        moved += k * 3 * 8 + per_shape[1] * 16 + per_shape[2] * 16 \
            + per_shape[3] * 32
    return moved


def k8_bytes(args, outs):
    """The bytes K8 must move on `select_parallel`'s arguments, from what
    this data needs: each output written once (about 2.4 KB per MB) and
    each input read once: of every MB its
    source (384 B), inter cost and inter reconstruction (384 B, copied or
    a neighbour's edge), of an inter MB also its chroma levels, MVs and
    shape (684 B); the availability and the QPs."""
    import torch
    from h264lab_tpu_torch.models import mbscan

    sy, su, sv, qp, qpc, _, _, inter = args[:8]
    k = sy.shape[0] * sy.shape[1]
    n_inter = int((outs["sel"] == mbscan.SEL_INTER).sum())
    moved = sum(t.numel() * t.element_size() for name, t in outs.items()
                if name != "lev_inter")
    moved += sum(x.numel() * x.element_size() for x in (sy, su, sv, qp, qpc))
    moved += 2 * sy.shape[1]
    moved += sum(inter[n].numel() * inter[n].element_size() for n in (
        "inter_cost", "recon_y_inter", "recon_u_inter", "recon_v_inter"))
    moved += n_inter * sum(
        inter[n].numel() * inter[n].element_size() // k for n in (
            "cdc_inter", "cac_inter", "mv_y", "mv_x", "mv4_y", "mv4_x",
            "shape"))
    return moved


def k7_case_args(seed, n, mbw, mbh, qp, lanes, rows, plan, parts, qpel,
                 reach, noisy):
    """`inter_residual`'s arguments of a seeded K7 case
    (`utils.synthetic.inter_residual_inputs`) on the card."""
    import torch
    from h264lab_tpu_torch.utils.synthetic import inter_residual_inputs

    d = inter_residual_inputs(seed, n, mbw, mbh, qp, lanes=lanes,
                              frame_rows=rows, plan=plan, parts=parts,
                              qpel=qpel, reach=reach, noisy_guard=noisy)
    p = d.pop("parts")
    t = {k: torch.from_numpy(v).cuda() for k, v in d.items()}
    return (t["src_y_mb"], t["src_u_mb"], t["src_v_mb"], t["u_pad"],
            t["v_pad"], t["lane"], t["row0"], t["qp"], t["qpc"], t["mv_y"],
            t["mv_x"], t["full_my"], t["full_mx"], t["cost16"], t["pred16"],
            None if p is None else {k: torch.from_numpy(v).cuda()
                                    for k, v in p.items()}, mbw, mbh, True)


def k8_case_args(seed, n, mbw, mbh, qp, plan, band):
    """`select_parallel`'s arguments of a seeded K8 case
    (`utils.synthetic.select_parallel_inputs`) on the card."""
    import torch
    from h264lab_tpu_torch.utils.synthetic import select_parallel_inputs

    d = select_parallel_inputs(seed, n, mbw, mbh, qp, plan=plan, band=band)
    return (*(torch.from_numpy(d[k]).cuda() for k in (
        "src_y_mb", "src_u_mb", "src_v_mb", "qp", "qpc")),
        d["avail_top"], d["avail_left"],
        {k: torch.from_numpy(v).cuda() for k, v in d["inter"].items()}, mbw)


def check_residual(kernel, args, what, label, trace=False):
    """K7 (`kernel` "K7") or K8 ("K8") against its plain version on one
    call's `inter_residual` or `select_parallel` arguments on the card:
    the entry (the packing and K7's or K8's one launch), run
    RESIDUAL_REPEATS times, must give every output of the plain version
    (names in order, dtypes, shapes, values), one count a call. Returns
    its numbers: ms (its wrapper, `residual.inter_tiles` or
    `select_tiles`), stage_ms (the entry), both from CUDA events over 20
    calls; host_us (the wrapper's host time a call, 20 calls issued
    without a sync); plain_ms (the checked call); bound_ms (the bytes it
    must move at 3.35 TB/s, `k7_bytes` / `k8_bytes`); with `trace`, the
    kernels one call launches and their device us (`kernel_launches`);
    max_abs_err."""
    import torch
    from h264lab_tpu_torch.models import mbscan
    from h264lab_tpu_torch.ops import residual
    from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    k7 = kernel == "K7"
    entry, plain, pack, wrapper, count, n_kernels = (
        (mbscan.inter_residual, mbscan.inter_residual_plain,
         mbscan.inter_residual_args, residual.inter_tiles, "inter_residual",
         1) if k7 else
        (mbscan.select_parallel, mbscan.select_parallel_plain,
         mbscan.select_parallel_args, residual.select_tiles,
         "select_parallel", 1))
    with torch.cuda.device(args[0].device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        want = plain(*args)
        end.record()
        torch.cuda.synchronize()
        err = 0
        for _ in range(RESIDUAL_REPEATS):
            before = LAUNCH_COUNTS[count]
            got = entry(*args)
            _require(LAUNCH_COUNTS[count] == before + 1,
                     f"the entry did not launch {kernel} once on {what}")
            _require(list(got) == list(want) and all(
                got[k].dtype == v.dtype and got[k].shape == v.shape
                for k, v in want.items()),
                f"{kernel}'s outputs differ in kind from the plain "
                f"version's on {what}")
            err = max([err] + [int((got[k].long() - v.long()).abs().max())
                               for k, v in want.items() if v.numel()])
            _require(err == 0, f"{kernel} differs from the plain version on "
                     f"{what} (largest difference {err})")
        packed = pack(*args)
        out = dict(ms=_cuda_ms(lambda: wrapper(*packed), 20),
                   stage_ms=_cuda_ms(lambda: entry(*args), 20),
                   plain_ms=start.elapsed_time(end), max_abs_err=err)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            wrapper(*packed)
        out["host_us"] = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        out["kernels"], out["device_us"] = [], None
        if trace:
            kernels, _ = kernel_launches(lambda: wrapper(*packed),
                                         traces=TRACE_TRIES,
                                         want=n_kernels)
            out["kernels"] = kernels
            if len(kernels) == n_kernels:
                out["device_us"] = sum(us for _, us in kernels)
    moved = (k7_bytes if k7 else k8_bytes)(args, want)
    out["bound_ms"] = moved / HBM_BYTES_PER_S * 1e3
    n, nmb = args[0].shape[:2]
    if k7:
        shapes = torch.bincount(want["shape"].reshape(-1).long(),
                                minlength=4)
        detail = f"MBs of shapes 0-3 {shapes.tolist()}"
    else:
        detail = f"I16 MBs {int((want['sel'] == mbscan.SEL_I16).sum())}"
    dev = ("" if out["device_us"] is None else
           f"; device {out['device_us']:.1f} us: " + ", ".join(
               f"{k} {us:.1f}" for k, us in out["kernels"]))
    print(f"  {kernel} == plain on {what} ({n}, {nmb}), {RESIDUAL_REPEATS} "
          f"launches {label}: {kernel} {out['ms']:.3f} ms, host "
          f"{out['host_us']:.0f} us a call (the entry with its packing "
          f"{out['stage_ms']:.3f} ms; plain {out['plain_ms']:.1f} ms; bound "
          f"{out['bound_ms']:.4f} ms for {moved / 1e6:.2f} MB, "
          f"{100 * out['bound_ms'] / out['ms']:.2f}% of it reached{dev}); "
          f"{detail}")
    return out


def color_chroma_check(label):
    """A stream with non-flat chroma and slices beside and below each
    other: `utils.synthetic.color_chroma_sequence` at 176x144, 3 slice
    bands, QP 28, speed 2, an IDR and two P frames on one GOP lane, on the
    card and on the CPU. The card's bytes must equal the CPU's, the card
    must launch K7 and K8 once on each P frame (its bands in one batch),
    and the port's decoder must
    give exactly the card's reconstruction in every plane."""
    from h264lab_tpu_torch.config import EncoderConfig, RunConfig
    from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from h264lab_tpu_torch.parallel.gop import GopBandEncoder
    from h264lab_tpu_torch.utils.synthetic import color_chroma_sequence

    w, h, qp = 176, 144, 28
    cfg = EncoderConfig(width=w, height=h, gop=GOP, qp=qp, slice_bands=3)
    run = RunConfig(qp_min=qp, qp_max=qp, encode_speed=2)
    card = GopBandEncoder(cfg, n_gop=1)
    cpu = GopBandEncoder(cfg, n_gop=1, device="cpu")
    before = (LAUNCH_COUNTS["inter_residual"],
              LAUNCH_COUNTS["select_parallel"])
    res = []
    for t, f in enumerate(color_chroma_sequence(w, h, 3)):
        a = card.encode_step([f], run, return_recon=True)[0]
        b = cpu.encode_step([f], run)[0]
        _require(a.payload == b.payload, f"colour-chroma 3-band stream frame "
                 f"{t}: card bytes differ from CPU bytes")
        res.append(a)
    k7 = LAUNCH_COUNTS["inter_residual"] - before[0]
    k8 = LAUNCH_COUNTS["select_parallel"] - before[1]
    _require(k7 == 2 and k8 == 2, f"the colour-chroma stream launched K7 "
             f"{k7} and K8 {k8} times on its two P frames, not once each")
    print(f"colour-chroma {w}x{h} stream, 3 slice bands, speed 2 {label}: "
          f"card bytes == CPU bytes ({[len(a.payload) for a in res]} B); "
          f"K7 launches {k7}, K8 {k8}")
    decode_check(b"".join(a.payload for a in res), [a.recon for a in res],
                 "the colour-chroma 3-band stream")


def stage_record():
    """What the paths keep of K9 to K13 for phases 21 and 22 and the
    kernels line: "calls", each kernel's real inputs by path (the
    arguments of its stage entry, `resample.downsample_planes`,
    `resample.upsample_tiles`, `refstate.prepare_reference`,
    `stages.source_tiles` and `denoise.denoise_planes`, on the host), and
    "launches", (K9, K10, K11, K12, K13) launches by path."""
    return {"calls": {k: {} for k, _ in STAGE_KERNELS}, "launches": {}}


# the launch counts of K9 to K13
STAGE_KERNELS = (("K9", "resample_down"), ("K10", "resample_up"),
                 ("K11", "refplanes"), ("K12", "pad_tiles"),
                 ("K13", "denoise"))
# the plain functions K9 to K13 replace on every encode path: none may
# take a tensor on the card between phases 3 and 15, nor in phase 22's
# encode
PLAIN_STAGES = (("ops.resample", "downsample2x"),
                ("ops.resample", "upsample2x_luma"),
                ("ops.resample", "upsample2x_chroma"),
                ("ops.qpel", "pad_guard"), ("ops.me", "downsample4"),
                ("models.stages", "pad_to"),
                ("ops.denoise", "denoise_plane"))


def require_stage_launches(record, path, what, want):
    """A path's K9 to K13 launches (since the counts were set to 0) must
    be `want`; they are kept in `record["launches"][path]`."""
    from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    got = tuple(LAUNCH_COUNTS[count] for _, count in STAGE_KERNELS)
    _require(got == tuple(want), f"{what}: K9 to K13 launched {got} "
             f"times, not {tuple(want)}")
    record["launches"][path] = got
    print(f"  K9, K10, K11, K12 and K13 launches of {what}: {got}")


@contextlib.contextmanager
def plain_stages_on_card(seen):
    """Append to `seen` the name of every `PLAIN_STAGES` function called
    inside the block, by any thread, with a tensor on the card; nothing of
    the calls is kept."""
    import importlib

    import torch

    saved = []
    try:
        for module, name in PLAIN_STAGES:
            mod = importlib.import_module(f"h264lab_tpu_torch.{module}")
            fn = getattr(mod, name)

            def counted(*args, _fn=fn, _name=name, **kwargs):
                if any(isinstance(a, torch.Tensor) and a.is_cuda
                       for a in args):
                    seen.append(_name)
                return _fn(*args, **kwargs)
            setattr(mod, name, counted)
            saved.append((mod, name, fn))
        yield seen
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


# the functions that hand K11 and K10 their tiles, copying those the
# kernel cannot take as they are (not contiguous or not 16-byte aligned)
TILE_HANDLERS = (("K11", "models.refstate", "_k11_tiles"),
                 ("K10", "ops.resample", "_k10_tiles"))


@contextlib.contextmanager
def tile_copies(seen):
    """Count in `seen` ({kernel: [calls, copies]}) the calls of each of
    `TILE_HANDLERS` inside the block, by any thread, and the copies they
    make."""
    import importlib

    saved = []
    try:
        for kernel, module, name in TILE_HANDLERS:
            mod = importlib.import_module(f"h264lab_tpu_torch.{module}")
            fn = getattr(mod, name)
            count = seen.setdefault(kernel, [0, 0])

            def counted(tiles, _fn=fn, _count=count):
                out = _fn(tiles)
                _count[0] += 1
                _count[1] += out is not tiles
                return out
            setattr(mod, name, counted)
            saved.append((mod, name, fn))
        yield seen
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def stage_bytes(kernel, args, outs):
    """The bytes K9 to K13 must move on its stage entry's arguments, from
    what the data needs: each output byte written once; read once, K9 the
    2x2 boxes of its outputs (an odd last row or column is not read), K10
    the cropped base picture (not its padded MBs), K11 its tiles, K12 the
    source planes' pixels within the padded picture, K13 the current and
    previous planes."""
    import torch

    out = sum(o.numel() * o.element_size() for o in outs)
    if kernel == "K9":
        read = 4 * out
    elif kernel == "K10":
        read = sum(h * w for h, w in args[2])
    elif kernel == "K12":
        planes, mbw, mbh = args
        read = sum(min(x.shape[0], mbh * t) * min(x.shape[1], mbw * t)
                   for lanes, t in zip(planes, (16, 8, 8)) for x in lanes)
    elif kernel == "K13":
        read = sum(x.numel() for frame in args for x in frame)
    else:
        read = sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor))
    return read + out


def check_stage(kernel, args, what, label, trace=False):
    """K9 to K13 (`kernel`) against its plain version on one call's
    stage-entry arguments on the card (`downsample_planes`,
    `upsample_tiles`, `prepare_reference`, `stages.source_tiles`,
    `denoise.denoise_planes`): the entry, run RESAMPLE_REPEATS times, must
    give every output of the plain version (keys in order, dtypes, shapes,
    values), one count a call. Returns its numbers: ms (its wrapper,
    `downsample_k9`, `upsample_k10`, `planes_k11`, `tiles_k12` or
    `denoise_k13`) and stage_ms (the entry), from CUDA events over 20
    calls; host_us (the wrapper's host time a call, 20 calls issued
    without a sync); plain_ms (the checked call); bound_ms (the bytes it
    must move at 3.35 TB/s, `stage_bytes`); with `trace`, the kernels one
    call launches and their device us (`kernel_launches`); max_abs_err."""
    import torch
    from h264lab_tpu_torch.models import refstate, stages
    from h264lab_tpu_torch.ops import denoise, pretile, refplanes, resample
    from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS

    count = dict(STAGE_KERNELS)[kernel]
    if kernel == "K12":
        entry = stages.source_tiles
        plain = stages.source_tiles_plain

        def wrapper():
            return pretile.tiles_k12(*args)
    elif kernel == "K13":
        entry = denoise.denoise_planes

        def plain(cur, prev):
            return tuple(denoise.denoise_plane(c, p)
                         for c, p in zip(cur, prev))

        def wrapper():
            return denoise.denoise_k13(*args[0], *args[1])
    elif kernel == "K9":
        entry = resample.downsample_planes

        def plain(*planes):
            return tuple(resample.downsample2x(p) for p in planes)

        def wrapper():
            return resample.downsample_k9(*args)
    elif kernel == "K10":
        entry = resample.upsample_tiles
        tiles = tuple(t.reshape((-1,) + t.shape[-2:]) for t in args[0])

        def plain(_, *sizes):
            return resample.upsample_tiles_plain(tiles, *sizes)

        def wrapper():
            return resample.upsample_k10(*tiles, *args[1:])
    else:
        entry = refstate.prepare_reference
        plain = refstate.prepare_reference_plain

        def wrapper():
            return refplanes.planes_k11(*args)

    def items(x):
        return list(x.items()) if isinstance(x, dict) else list(enumerate(x))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want = items(plain(*args))
    end.record()
    torch.cuda.synchronize()
    err = 0
    for _ in range(RESAMPLE_REPEATS):
        before = LAUNCH_COUNTS[count]
        got = items(entry(*args))
        _require(LAUNCH_COUNTS[count] == before + 1,
                 f"the entry did not launch {kernel} once on {what}")
        _require([k for k, _ in got] == [k for k, _ in want] and all(
            g.dtype == w.dtype and g.shape == w.shape and g.is_cuda
            for (_, g), (_, w) in zip(got, want)),
            f"{kernel}'s outputs differ in kind from the plain version's on "
            f"{what}")
        err = max([err] + [int((g.int() - w.int()).abs().max())
                           for (_, g), (_, w) in zip(got, want)])
        _require(err == 0, f"{kernel} differs from the plain version on "
                 f"{what} (largest difference {err})")
    out = dict(ms=_cuda_ms(wrapper, 20),
               stage_ms=_cuda_ms(lambda: entry(*args), 20),
               plain_ms=start.elapsed_time(end), max_abs_err=err)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        wrapper()
    out["host_us"] = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    out["kernels"], out["device_us"] = [], None
    if trace:
        out["kernels"], _ = kernel_launches(wrapper, traces=TRACE_TRIES)
        if len(out["kernels"]) == 1:
            out["device_us"] = out["kernels"][0][1]
    moved_bytes = stage_bytes(kernel, args, [w for _, w in want])
    out["bound_ms"] = moved_bytes / HBM_BYTES_PER_S * 1e3
    shapes = [tuple(w.shape) for _, w in want]
    dev = ("" if out["device_us"] is None else
           f"; device {out['device_us']:.1f} us, "
           f"{100e3 * out['bound_ms'] / out['device_us']:.1f}% of the bound "
           "reached: " + ", ".join(f"{k} {us:.1f}" for k, us in
                                   out["kernels"]))
    print(f"  {kernel} == plain on {what}, {RESAMPLE_REPEATS} launches "
          f"{label}: {kernel} {out['ms']:.4f} ms, host {out['host_us']:.0f}"
          f" us a call (the entry {out['stage_ms']:.4f} ms; plain "
          f"{out['plain_ms']:.3f} ms; bound {out['bound_ms']:.4f} ms for "
          f"{moved_bytes / 1e6:.2f} MB, "
          f"{100 * out['bound_ms'] / out['ms']:.2f}% of it reached{dev}); "
          f"outputs {shapes}")
    return out


def pre_parts(frames, mbw, mbh, label, reps=5):
    """The `pre` stage of G lanes' numpy frames in its three parts, each
    timed apart over `reps` calls after a warm one (medians): the host
    copy into the pinned staging buffer (`Staging.fill`, host ms; on the
    staging's threads, and on one thread in turns with them: 1, N, N, 1),
    the upload (`Staging.send`: its one non-blocking `copy_`, CUDA events)
    and K12 (`stages.source_tiles`, CUDA events); beside them, the host
    link's
    rate from a pinned `copy_` of the same bytes into a card buffer (the
    bound of the upload), and the `pre` the port had before K12 (the
    lanes stacked on the host, a pageable `.to`, `pad_to` and the tiling).
    Returns the numbers."""
    import statistics

    import numpy as np
    import torch
    from h264lab_tpu_torch.models import stages

    card = torch.device("cuda", 0)
    staging = stages.Staging(card)
    nbytes = sum(np.asarray(p).nbytes for f in frames for p in f)

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    stages.source_tiles(tuple(zip(*staging.upload(frames))), mbw, mbh)
    torch.cuda.synchronize()
    threads = staging.threads
    host, upload, k12, whole, turns = [], [], [], [], []
    for n in (1, threads, threads, 1):
        staging.threads = n
        for i in range(reps + 1):
            e = events()
            t0 = time.perf_counter()
            filled = staging.fill(frames)
            t1 = time.perf_counter()
            e[0].record()
            planes = staging.send(filled)
            e[1].record()
            stages.source_tiles(tuple(zip(*planes)), mbw, mbh)
            e[2].record()
            torch.cuda.synchronize()
            if i == 0:
                continue
            turns.append((n, 1e3 * (t1 - t0)))
            if n == threads:
                whole.append(time.perf_counter() - t0)
                host.append(1e3 * (t1 - t0))
                upload.append(e[0].elapsed_time(e[1]))
                k12.append(e[1].elapsed_time(e[2]))
    staging.threads = threads
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=card)
    link = []
    for _ in range(reps + 1):
        e = events()
        e[0].record()
        dst.copy_(pinned, non_blocking=True)
        e[1].record()
        torch.cuda.synchronize()
        link.append(e[0].elapsed_time(e[1]))
    del pinned, dst

    def old_pre():
        out = []
        for i, t in enumerate((16, 8, 8)):
            p = torch.stack([torch.from_numpy(np.ascontiguousarray(
                f[i], np.uint8)) for f in frames]).to(card)
            p = stages.pad_to(p, mbh * t, mbw * t)
            out.append(p.reshape(len(frames), mbh, t, mbw, t)
                       .permute(0, 1, 3, 2, 4).reshape(len(frames), -1, t, t))
        torch.cuda.synchronize()
        return out
    old_pre()
    old = []
    for _ in range(reps):
        t0 = time.perf_counter()
        old_pre()
        old.append(1e3 * (time.perf_counter() - t0))
    med = statistics.median
    out = dict(bytes=nbytes, threads=threads, host_copy_ms=med(host),
               host_copy_1_thread_ms=med([ms for n, ms in turns if n == 1]),
               upload_ms=med(upload), k12_ms=med(k12),
               pre_ms=1e3 * med(whole), link_ms=med(link[1:]),
               old_pre_ms=med(old))
    out["link_gb_s"] = nbytes / out["link_ms"] / 1e6
    out["host_copy_gb_s"] = nbytes / out["host_copy_ms"] / 1e6
    out["bound_ms"] = out["link_ms"]
    print(f"  pre of {len(frames)} lanes ({nbytes / 1e6:.2f} MB of numpy "
          f"planes) {label}, medians: host copy into the pinned staging "
          f"{out['host_copy_ms']:.3f} ms on {threads} threads "
          f"({out['host_copy_gb_s']:.2f} GB/s; on one thread "
          f"{out['host_copy_1_thread_ms']:.3f} ms, in turns 1, {threads}, "
          f"{threads}, 1 threads: " + ", ".join(
              f"{statistics.median([ms for k, ms in turns[j:j + reps]]):.3f}"
              for j in range(0, len(turns), reps)) + " ms), upload "
          f"{out['upload_ms']:.3f} ms, K12 {out['k12_ms']:.4f} ms; the "
          f"three {out['pre_ms']:.3f} ms (host wall, synchronized); a pinned "
          f"copy_ of the same bytes {out['link_ms']:.3f} ms "
          f"({out['link_gb_s']:.2f} GB/s: the upload's bound), the upload "
          f"at {100 * out['link_ms'] / out['upload_ms']:.1f}% of it; the "
          f"pre before K12 (stack, pageable .to, pad_to, tiling) "
          f"{out['old_pre_ms']:.3f} ms")
    return out


def odd_planes(shapes, lanes, seed):
    """Seeded planes on the card, each at an odd address (one byte past a
    fresh allocation): (Y, U, V), each `lanes` 2-D uint8 planes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        row = []
        for _ in range(lanes):
            buf = torch.empty(shape[0] * shape[1] + 16, dtype=torch.uint8,
                              device="cuda")
            p = buf[1:1 + shape[0] * shape[1]].view(shape)
            p.copy_(torch.from_numpy(rng.integers(0, 256, shape,
                                                  dtype=np.uint8)))
            row.append(p)
        out.append(tuple(row))
    return tuple(out)


def escape_loop(rbsp: bytes) -> bytes:
    """The port's `nal.escape_rbsp` before its numpy form: the same fast
    exit, then a Python loop over the bytes (kept to time against it)."""
    import numpy as np

    data = np.frombuffer(rbsp, dtype=np.uint8)
    if len(data) < 3:
        return rbsp
    cand = (data[2:] <= 3) & (data[1:-1] == 0) & (data[:-2] == 0)
    if not cand.any():
        return rbsp
    result = bytearray()
    zeros = 0
    for b in data:
        b = int(b)
        if zeros >= 2 and b <= 3:
            result.append(3)
            zeros = 0
        result.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(result)


def pack_per_bit(bw) -> bytes:
    """`BitWriter.to_bytes` before the word-level packer: every field as a
    (value, nbits) symbol, K1's words split into 32-bit symbols, expanded
    to one byte per bit (`to_bits`) and packed by `np.packbits` (kept to
    time against it)."""
    import numpy as np

    return np.packbits(bw.to_bits()).tobytes()


def in_turns(fns, items, what):
    """Two host functions of one result over `items`: their outputs must
    be equal; then each one's seconds over all items, in turns (a, b, b,
    a). Returns (the outputs, {name: [s, s]})."""
    (a, _), (b, _) = fns.items()
    outs = {k: [f(x) for x in items] for k, f in fns.items()}
    _require(outs[a] == outs[b], f"{what} differ between {a} and {b}")
    times = {a: [], b: []}
    for k in (a, b, b, a):
        t0 = time.perf_counter()
        for x in items:
            fns[k](x)
        times[k].append(time.perf_counter() - t0)
    return outs[a], times


def escape_turns(rbsps, what, label):
    """Phase 6 on one step's RBSPs: the loop and `nal.escape_rbsp` must
    give equal bytes; each one's seconds over all RBSPs, in turns (loop,
    numpy, numpy, loop). Returns dict(loop=[s, s], numpy=[s, s])."""
    from h264lab_tpu_torch.bitstream import nal

    escaped, times = in_turns(dict(loop=escape_loop, numpy=nal.escape_rbsp),
                              rbsps, f"escaped bytes ({what})")
    n_bytes = sum(len(r) for r in rbsps)
    grown = sum(len(o) for o in escaped) - n_bytes
    print(f"escape on the {what} step's {len(rbsps)} RBSPs ({n_bytes} B, "
          f"{grown} bytes 0x03 inserted) {label}: loop "
          + ", ".join(f"{1e3 * s:.1f}" for s in times["loop"])
          + " ms; numpy " + ", ".join(f"{1e3 * s:.2f}" for s in times["numpy"])
          + " ms (in turns loop, numpy, numpy, loop)")
    return times


def pack_turns(writers, what, label):
    """Phase 6 on one step's bit writers (each slice's header, K1's words
    as a word run, the tail and the trailing bits): the per-bit packer and
    `BitWriter.to_bytes` must give equal bytes; each one's seconds over all
    writers, in turns (per-bit, words, words, per-bit)."""
    from h264lab_tpu_torch.bitstream.bitwriter import BitWriter

    packed, times = in_turns({"per-bit": pack_per_bit,
                              "words": BitWriter.to_bytes}, writers,
                             f"packed bytes ({what})")
    print(f"RBSP packing of the {what} step's {len(writers)} bit writers "
          f"({sum(len(b) for b in packed)} B) {label}: per-bit "
          + ", ".join(f"{1e3 * s:.1f}" for s in times["per-bit"])
          + " ms; word-level " + ", ".join(f"{1e3 * s:.2f}"
                                           for s in times["words"])
          + " ms (in turns per-bit, words, words, per-bit)")
    return times


def _same_frames(frames, recons, what):
    """Decoded frames against (y, u, v) reconstructions, plane by plane."""
    import numpy as np

    _require(len(frames) == len(recons), f"{what}: {len(frames)} frames "
             f"decoded, not {len(recons)}")
    for t, (f, r) in enumerate(zip(frames, recons)):
        _require(all(np.array_equal(a, b)
                     for a, b in zip(f.cropped(f.sps), r)),
                 f"{what}: decoded frame {t} differs from the card's "
                 "reconstruction")


def decode_check(stream, recons, what, enh_recons=None):
    """Decode `stream` with the port's decoder (numpy, on the host): its
    frames must equal `recons` (and its enhancement-layer frames
    `enh_recons`), plane by plane. Returns the decode seconds."""
    from h264lab_tpu_torch.decoder.decoder import H264Decoder

    dec = H264Decoder()
    t0 = time.perf_counter()
    dec.decode(stream)
    s = time.perf_counter() - t0
    _same_frames(dec.frames, recons, what)
    _same_frames(dec.enh_frames, enh_recons or [], f"{what}, enhancement")
    print(f"{what}: {len(dec.frames)} frames"
          + (f" and {len(dec.enh_frames)} enhancement frames"
             if enh_recons else "")
          + f" decode bit-exactly to the card's recon ({s:.1f} s)")
    return s


def decode_lane0(payloads, recons):
    """Phase 5's decode, in a worker process: lane 0's step payloads in
    turn, each decoded frame equal to the card's reconstruction. Returns
    the decode seconds per frame."""
    from h264lab_tpu_torch.decoder.decoder import H264Decoder

    dec, secs = H264Decoder(), []
    for t, (payload, recon) in enumerate(zip(payloads, recons)):
        t0 = time.perf_counter()
        dec.decode(payload)
        secs.append(time.perf_counter() - t0)
        _same_frames(dec.frames[t:], [recon], f"lane 0 step {t}")
    return secs


def main_path_setup():
    """The main path's inputs: (EncoderConfig, RunConfig, LANES + STEPS - 1
    consecutive frames). Lane g encodes frames[g + t] at step t
    (`lane_frames`)."""
    from h264lab_tpu_torch.config import EncoderConfig, RunConfig
    from h264lab_tpu_torch.utils.synthetic import chessboard_sequence

    cfg = EncoderConfig(width=WIDTH, height=HEIGHT, gop=GOP, qp=QP)
    run = RunConfig(qp_min=QP, qp_max=QP, encode_speed=2)
    return cfg, run, list(chessboard_sequence(WIDTH, HEIGHT,
                                              LANES + STEPS - 1))


def lane_frames(frames, t, lanes=LANES):
    return [frames[g + t] for g in range(lanes)]


def synthetic_grid(n_frames=LANES, nmb=(WIDTH // 16) * (HEIGHT // 16),
                   seed=SYNTH_SEED):
    """A (n_frames, nmb, 952) symbol grid (vals uint32, lens int32), built
    with numpy from a fixed seed, with what an all-intra grid lacks: runs
    of empty MBs, one empty frame, MBs over 4096 bits and units over 704
    bits (K1's drop boundaries)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (n_frames, nmb, 952)
    lens = rng.integers(1, 29, shape, dtype=np.int32)
    lens[rng.random(shape, dtype=np.float32) < 0.9] = 0
    f = np.arange(n_frames)[:, None]
    big = rng.integers(0, nmb, (n_frames, 64))       # ~9600 bits each
    lens[f, big] = (rng.integers(1, 29, (n_frames, 64, 952), dtype=np.int32)
                    * (rng.random((n_frames, 64, 952)) < 0.7))
    wide = rng.integers(0, nmb, (n_frames, 64))      # one unit of ~820 bits
    unit = rng.integers(0, 28, (n_frames, 64))
    lens.reshape(n_frames, nmb, 28, 34)[f, wide, unit] = rng.integers(
        16, 33, (n_frames, 64, 34), dtype=np.int32)
    for i in range(n_frames):                        # runs of empty MBs
        for a, n in zip(rng.integers(0, nmb, 24), rng.integers(1, 300, 24)):
            lens[i, a:a + n] = 0
    lens[3] = 0                                      # one empty frame
    vals = rng.integers(0, 1 << 32, shape, dtype=np.uint32)
    return vals, lens


def check_k1(vals, lens, caps, what):
    """K1 against the plain packer at each capacity: the words and bit
    counts must be equal. Returns (largest |difference| of a word, the bit
    counts)."""
    import torch
    from h264lab_tpu_torch.ops import bitpack

    max_err = 0
    for c in caps:
        wk, nk = bitpack.pack_frames(vals, lens, c)
        wp, np_ = bitpack.pack_frames_plain(vals, lens, c)
        torch.cuda.synchronize()
        _require(torch.equal(nk, np_), f"K1 bit counts differ ({what})")
        diff = (wk.long() & 0xFFFFFFFF) - (wp.long() & 0xFFFFFFFF)
        max_err = max(max_err, int(diff.abs().max()))
        _require(torch.equal(wk, wp), f"K1 words differ at cap {c} ({what})")
        print(f"  {what}, cap {c}: K1 == plain on all {nk.numel()} frames "
              f"(overflowing: {int((nk > 32 * c).sum())})")
    return max_err, nk


def k1_numbers(vals, lens, cap, nk):
    """K1's wrapper ms, the plain packer's ms and the bound ms on one grid.
    The bound counts the bytes the function must move on this grid's
    data: every length, the value of every slot that holds a symbol (an
    empty slot's value never reaches the words), the words and bit counts
    written once."""
    from h264lab_tpu_torch.ops import bitpack

    k1_ms = _cuda_ms(lambda: bitpack.pack_frames(vals, lens, cap), 20)
    plain_ms = _cuda_ms(lambda: bitpack.pack_frames_plain(vals, lens, cap), 2)
    n_sym = int((lens > 0).sum())
    moved = 4 * (lens.numel() + n_sym
                 + nk.numel() * (cap + bitpack.SLACK_WORDS + 1))
    return dict(ms=k1_ms, plain_ms=plain_ms,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, moved=moved,
                n_sym=n_sym)


def svc_phases(cfg, run, label, numbers, k2_numbers, k3_numbers, me_calls,
               sym_calls, residual, cif, cif_frames, ptxas, bm_numbers,
               stages):
    """Phases 11 to 13: SvcEncoder at WIDTH x HEIGHT with inter-layer
    prediction (stage frames timed), K1 on its base-mode and base P grids,
    K2 on their deblocking inputs, K3 on the base-mode frame's base
    wavefront inputs, K6 in its base-mode kind and K7 on the base-mode
    frame's enhancement (their numbers go into `numbers`, `k2_numbers`,
    `k3_numbers` and `bm_numbers`, {"K6": ..., "K7": ...}; the stage P
    frame's K4 calls into `me_calls`, its two symbolize calls into
    `sym_calls` and its K7 and K8 calls and the path's launches into
    `residual` (`residual_record`), on the host; the stage P frame's two
    `ref` stages and the base-mode IDR's `down`, `up` and enhancement
    `ref` into `stages` (`stage_record`), with the path's K9, K10 and K11
    launches), and SVC card bytes against CPU bytes at CIF. Returns (K1
    launches of the SVC frames, K2 launches, K3 launches, K4 launches, K6
    launches, K6 launches in the base-mode kind, largest K1 error)."""
    import torch
    from h264lab_tpu_torch.bitstream.nal import split_annexb
    from h264lab_tpu_torch.config import FrameType
    from h264lab_tpu_torch.models.svc import SvcEncoder
    from h264lab_tpu_torch.ops import bitpack
    from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from h264lab_tpu_torch.utils.synthetic import chessboard_sequence

    key = dataclasses.replace(run, frame_type=FrameType.KEY)
    max_err = 0
    svc_cfg = dataclasses.replace(cfg, num_layers=2,
                                  inter_layer_pred_flag=True)
    svc_frames = list(chessboard_sequence(WIDTH, HEIGHT, SVC_FRAMES))
    nmb = (WIDTH // 16) * (HEIGHT // 16)
    svc = SvcEncoder(svc_cfg)
    torch.cuda.reset_peak_memory_stats()
    grids = []                   # (vals, lens, cap) of the stage frames
    k1 = bitpack.pack_frames

    def recorded(vals, lens, cap):
        grids.append((vals, lens, cap))
        return k1(vals, lens, cap)

    svc_wf = []                 # the SVC frames' wavefront calls
    svc_sym = []                # their symbolize calls
    svc_k7, svc_k8 = [], []     # their inter residuals, parallel selects
    svc_blocks = []             # their `cavlc.encode_blocks` calls

    def svc_frame(t, kind, r=run):
        t0 = time.perf_counter()
        with recorded_calls("_select_wavefront", svc_wf), \
                recorded_calls("symbolize", svc_sym), \
                recorded_calls("inter_residual", svc_k7), \
                recorded_calls("select_parallel", svc_k8), \
                recorded_calls("encode_blocks", svc_blocks, "ops.cavlc"):
            res = svc.encode(*svc_frames[t], r)
        s = time.perf_counter() - t0
        _require(res.frame_type == kind and len(res.base_payload) > 0
                 and len(res.enh_payload) > 0,
                 f"SVC frame {t} is {res.frame_type}, not {kind}")
        return res, s

    def svc_table(name, s, res):
        print(f"SVC {name} stage frame {label}: {s:.3f} s; bytes base "
              f"{len(res.base_payload)}, enhancement {len(res.enh_payload)}")
        for layer, times in svc.stage_times.items():
            for k, v in times.items():
                print(f"  {layer:4s} stage {k:9s} {1e3 * v:10.1f} ms "
                      f"{label}")

    def base_mode_launches(before, what):
        """A base-mode IDR's kernels: K7 once (the enhancement's TQ), K6
        twice (the base layer's I slice and the enhancement's base-mode
        slice, of which one call in the base-mode kind), no K4 or K8, and
        no `encode_blocks` call."""
        got = {k: LAUNCH_COUNTS[k] - before[k] for k in LAUNCH_COUNTS}
        bm_sym = [a for a in svc_sym[-2:] if a[18]]
        _require(got["inter_residual"] == 1 and got["symbolize"] == 2
                 and got["me"] == got["select_parallel"] == 0
                 and len(bm_sym) == 1 and bm_sym[0][10].is_cuda
                 and len(svc_k7) == 1 and not svc_k7[0][-1]
                 and not svc_blocks,
                 f"{what}: launches {got}, {len(bm_sym)} base-mode "
                 f"symbolize calls, {len(svc_k7)} inter residuals, "
                 f"{len(svc_blocks)} encode_blocks calls")
        print(f"  {what}: one K7 launch (zero MVs, no kills) and K6 "
              "launches 2 (the base layer's, the base-mode slice's); no "
              "encode_blocks call")
        return bm_sym[0]

    reset_launches()
    before = dict(LAUNCH_COUNTS)
    res, s = svc_frame(0, "IDR")
    print(f"SVC IDR (untimed, first use): {s:.2f} s; bytes base "
          f"{len(res.base_payload)}, enhancement {len(res.enh_payload)}")
    base_mode_launches(before, "the first SVC IDR (base-mode)")
    svc_k7.clear()
    res, t_svc = svc_frame(1, "P")
    n_k8 = cuda_calls(svc_k8)
    svc_k7.clear()
    svc_k8.clear()
    print(f"SVC P frame {label}: {t_svc:.3f} s per two-layer frame "
          f"({WIDTH}x{HEIGHT} over {WIDTH // 2}x{HEIGHT // 2}), "
          f"{1 / t_svc:.4f} frames/s; bytes base {len(res.base_payload)}, "
          f"enhancement {len(res.enh_payload)}")
    bitpack.pack_frames = recorded
    svc.stage_times = {}
    p_calls, bm_calls, svc_me, refs = [], [], [], []
    n_sym = len(svc_sym)
    with recorded_calls("deblock_frame", p_calls), \
            recorded_calls("motion_search_tiles", svc_me, "ops.me"), \
            recorded_calls("prepare_reference", refs, "models.refstate"):
        res, s = svc_frame(2, "P")
    svc_table("P", s, res)
    _require(sorted(a[0].shape[1] for a in refs) == [nmb // 4, nmb],
             f"the SVC P frame's {len(refs)} ref stages")
    for a in refs:
        layer = "base" if a[0].shape[1] == nmb // 4 else "enhancement"
        stages["calls"]["K11"][f"SVC {layer} P frame"] = to_device(a, "cpu")
    _require(len(svc_k7) == len(svc_k8) == 2, f"the SVC P frame's "
             f"{len(svc_k7)} inter residuals, {len(svc_k8)} parallel selects")
    for name, calls in (("inter_residual", svc_k7),
                        ("select_parallel", svc_k8)):
        for a in calls:
            layer = "base" if a[0].shape[1] == nmb // 4 else "enhancement"
            residual["calls"][name][f"SVC {layer} P frame"] = to_device(
                a, "cpu")
    n_k8 += cuda_calls(svc_k8)
    svc_k7.clear()
    svc_k8.clear()
    # symbolize's parameters: the 13 tensors, mb_width, mb_height,
    # has_inter, qp_rows, svc_base_mode_bit, base_mode
    sym_shapes = sorted((tuple(a[0].shape), a[17]) for a in svc_sym[n_sym:])
    _require(sym_shapes == [((1, nmb // 4), False), ((1, nmb), True)],
             f"the SVC P frame's symbolize calls (shape, base_mode_flag "
             f"bit): {sym_shapes}")
    for a in svc_sym[n_sym:]:
        layer = "base" if a[0].shape[1] == nmb // 4 else "enhancement"
        sym_calls[f"SVC {layer} P frame"] = to_device(a, "cpu")
    svc.stage_times = {}
    before = dict(LAUNCH_COUNTS)
    refs.clear()
    down, up, pre = [], [], []
    with recorded_calls("deblock_frame", bm_calls), \
            recorded_calls("prepare_reference", refs, "models.refstate"), \
            recorded_calls("downsample_planes", down, "ops.resample"), \
            recorded_calls("upsample_tiles", up, "ops.resample"), \
            recorded_calls("source_tiles", pre, "models.stages"):
        res, s = svc_frame(3, "IDR", key)
    enh_refs = [a for a in refs if a[0].shape[1] == nmb]
    # the enhancement's `pre`: the 1080p planes of its base-mode frame
    enh_pre = [a for a in pre if a[1] * a[2] == nmb]
    _require(len(refs) == 2 and len(enh_refs) == len(down) == len(up) == 1
             and len(pre) == 2 and len(enh_pre) == 1,
             f"the base-mode IDR's {len(refs)} ref stages, {len(down)} down "
             f"and {len(up)} up stages, {len(pre)} pre stages")
    for kernel, a in (("K9", down[0]), ("K10", up[0]), ("K11", enh_refs[0]),
                      ("K12", enh_pre[0])):
        stages["calls"][kernel]["SVC base-mode frame"] = to_device(a, "cpu")
    del refs, enh_refs, down, up, pre, enh_pre
    bm_launches = LAUNCH_COUNTS["deblock"] - before["deblock"]
    svc_table("IDR (base-mode)", s, res)
    bm_sym = base_mode_launches(before, "the forced SVC IDR (base-mode)")
    bm_k7 = svc_k7[0]
    times = svc.stage_times
    print(f"SVC base-mode IDR {label}: {s:.3f} s (stage syncs inside); "
          f"base_mode {1e3 * times['enh']['base_mode']:.2f} ms, up "
          f"{1e3 * times['svc']['up']:.2f} ms, down "
          f"{1e3 * times['svc']['down']:.2f} ms")
    svc.stage_times = None
    bitpack.pack_frames = k1
    print(f"  peak device memory of the SVC path "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # K9 once per frame, K10 once per base-mode IDR, K11 and K12 once per
    # layer and frame (the base-mode frame's `ref` and `pre` included)
    require_stage_launches(stages, "svc", f"the SVC path's {SVC_FRAMES} "
                           "frames", (SVC_FRAMES, 2, 2 * SVC_FRAMES,
                                      2 * SVC_FRAMES, 0))
    svc_launches = LAUNCH_COUNTS["bitpack"]
    svc_db_launches = LAUNCH_COUNTS["deblock"]
    svc_wf_launches = LAUNCH_COUNTS["wavefront"]
    svc_me_launches = LAUNCH_COUNTS["me"]
    # two symbolize calls in every frame: each layer's; an IDR's
    # enhancement layer is a base-mode slice (`svc.base_mode_symbols`)
    svc_sym_launches = require_k6(cuda_calls(svc_sym),
                                  LAUNCH_COUNTS["symbolize"],
                                  f"the SVC path's {SVC_FRAMES} frames")
    svc_bm_launches = sum(bool(a[18]) for a in svc_sym)
    _require(svc_sym_launches == 8 and svc_bm_launches == 2,
             f"the SVC path launched K6 {svc_sym_launches} times in "
             f"{SVC_FRAMES} frames, {svc_bm_launches} in the base-mode "
             "kind, not 8 and 2")
    print(f"K1 launches in the SVC path's {SVC_FRAMES} frames: "
          f"{svc_launches}; K2 launches {svc_db_launches}, {bm_launches} "
          f"of them in the base-mode frame; K3 launches {svc_wf_launches}; "
          f"K4 launches {svc_me_launches}; K6 launches {svc_sym_launches}, "
          f"{svc_bm_launches} of them in the base-mode kind")
    me_shapes = sorted(tuple(c[2].shape[:2]) for c in svc_me)
    _require(svc_me_launches == 4 and me_shapes == [(1, nmb // 4), (1, nmb)],
             f"the SVC path launched K4 {svc_me_launches} times in its 2 P "
             f"frames (the stage P frame's searches: {me_shapes})")
    n_k8 += cuda_calls(svc_k8)
    _require(n_k8 == 4, f"the SVC path's 2 P frames made {n_k8} parallel "
             "selects on the card, not one per layer and frame")
    require_k7_k8(f"the SVC path's {SVC_FRAMES} frames", svc_me_launches,
                  LAUNCH_COUNTS["inter_residual"],
                  LAUNCH_COUNTS["select_parallel"], n_k8,
                  base_mode_frames=2)
    residual["launches"]["svc"] = (LAUNCH_COUNTS["inter_residual"],
                                LAUNCH_COUNTS["select_parallel"])
    del svc_k7, svc_k8
    for c in svc_me:
        layer = "base" if c[2].shape[1] == nmb // 4 else "enhancement"
        me_calls[f"SVC {layer} P frame"] = to_device(c, "cpu")
    require_k3(svc_wf, svc_wf_launches, 2, "the SVC path's two base-layer "
               "IDRs")
    _require(tuple(svc_wf[1][0].shape[:2]) == (1, nmb // 4),
             f"the base-mode frame's wavefront ran on "
             f"{tuple(svc_wf[1][0].shape[:2])}")
    _require(svc_launches >= 2 * SVC_FRAMES, "the SVC path did not launch "
             "K1 for both layers on every frame")
    _require(svc_db_launches >= 2 * SVC_FRAMES and bm_launches >= 2,
             "the SVC path did not launch K2 for both layers on every "
             "frame, the base-mode frame's own deblocking included")
    _require(len(grids) == 4, f"{len(grids)} K1 calls in 2 SVC frames")
    db_shapes = [tuple(a[3].shape) for a in p_calls + bm_calls]
    _require(db_shapes == [(1, nmb // 4), (1, nmb)] * 2,
             f"deblocking calls of shapes {db_shapes} in 2 SVC frames")

    # 12. K1 against the plain packer on the base-mode and base P grids
    for name, (vals, lens, cap), shape in (
            ("SVC base-mode", grids[3], (1, nmb, 952)),
            ("SVC base P", grids[0], (1, nmb // 4, 952))):
        _require(tuple(vals.shape) == shape,
                 f"{name} grid {tuple(vals.shape)}, not {shape}")
        print(f"{name} symbol grid {shape}, cap_words {cap}")
        err, nk = check_k1(vals, lens, (cap, 1024), f"{name} grid")
        max_err = max(max_err, err)
        numbers[name] = n = k1_numbers(vals, lens, cap, nk)
        print(f"  K1 on the {name} grid {label}: {n['ms']:.3f} ms (plain "
              f"{n['plain_ms']:.3f} ms, bound {n['bound_ms']:.4f} ms for "
              f"{n['moved'] / 1e9:.3f} GB, {100 * n['bound_ms'] / n['ms']:.0f}"
              f"% of it reached; {n['n_sym']} symbols, {int(nk.max())} bits)")
    grids.clear()
    # K2 on the base-mode frame's own deblocking and on the base P frame's
    k2_numbers["SVC base-mode"] = check_k2(bm_calls[1], "the SVC base-mode "
                                           "frame's deblocking inputs", label)
    k2_numbers["SVC base P"] = check_k2(p_calls[0], "the SVC base P frame's "
                                        "deblocking inputs", label)
    k3_numbers["SVC base-mode"] = check_k3(
        svc_wf[1], "the SVC base-mode frame's base wavefront inputs", label)
    # K6 in the base-mode kind and K7 with zero MVs on the base-mode
    # frame's enhancement
    bm_numbers["K6"] = check_k6(bm_sym, "the SVC base-mode frame's "
                                "base-mode slice", label, ptxas["K6"])
    bm_numbers["K7"] = check_residual(
        "K7", bm_k7, "the SVC base-mode frame's TQ inputs", label,
        trace=True)
    del svc, vals, lens, p_calls, bm_calls, svc_wf, svc_me, bm_sym, bm_k7
    torch.cuda.empty_cache()

    # 13. SVC card bytes against CPU bytes at CIF, and both layers decoded
    t0 = time.perf_counter()
    cif_sym, cif_k8 = [], []
    before = LAUNCH_COUNTS["symbolize"]
    res_before = dict(LAUNCH_COUNTS)
    for ilp, speed, n_frames in ((True, 0, 3), (False, 2, 2)):
        c = dataclasses.replace(cif, num_layers=2, inter_layer_pred_flag=ilp)
        r = dataclasses.replace(run, encode_speed=speed)
        on_card, on_cpu = SvcEncoder(c), SvcEncoder(c, device="cpu")
        card_res = []
        for t in range(n_frames):
            with recorded_calls("symbolize", cif_sym), \
                    recorded_calls("select_parallel", cif_k8):
                a = on_card.encode(*cif_frames[t], r, return_recon=True)
            b = on_cpu.encode(*cif_frames[t], r)
            _require(a.payload == b.payload, f"CIF SVC ilp={ilp} speed "
                     f"{speed} frame {t}: card bytes differ from CPU bytes")
            print(f"CIF SvcEncoder ilp={ilp} speed {speed} frame {t} "
                  f"({a.frame_type}): card bytes == CPU bytes "
                  f"({len(a.payload)} B)")
            card_res.append(a)
        stream = b"".join(a.payload for a in card_res)
        base_recons = [a.base_recon for a in card_res]
        decode_check(stream, base_recons, f"CIF SVC ilp={ilp} speed {speed}",
                     enh_recons=[a.recon for a in card_res])
        base = b"".join(b"\x00\x00\x00\x01" + m for m in split_annexb(stream)
                        if m[0] & 0x1F not in (14, 15, 20))
        decode_check(base, base_recons, f"CIF SVC ilp={ilp} speed {speed}, "
                     "the base layer without NAL 14, 15, 20")
    n = require_k6(cuda_calls(cif_sym), LAUNCH_COUNTS["symbolize"] - before,
                   "the CIF SVC card encoders")
    print(f"  K6 launches of the CIF SVC card encoders: {n}, one for each "
          "of their symbolize calls")
    k7, k8 = (LAUNCH_COUNTS[k] - res_before[k]
              for k in ("inter_residual", "select_parallel"))
    # P frames of two layers: 2 at speed 0, 1 at speed 2 (parallel
    # select); one base-mode IDR (inter-layer prediction)
    _require(k7 == 7 and cuda_calls(cif_k8) == 2, f"the CIF SVC card "
             f"encoders launched K7 {k7} times in 3 two-layer P frames and "
             f"a base-mode IDR and made {cuda_calls(cif_k8)} parallel "
             "selects")
    require_k7_k8("the CIF SVC card encoders",
                  LAUNCH_COUNTS["me"] - res_before["me"], k7, k8,
                  cuda_calls(cif_k8), base_mode_frames=1)
    residual["launches"]["svc cif"] = (k7, k8)
    print(f"  CIF SVC comparisons and decodes {time.perf_counter() - t0:.1f}"
          " s")
    return (svc_launches, svc_db_launches, svc_wf_launches, svc_me_launches,
            svc_sym_launches, svc_bm_launches, max_err)


def mesh_devices(n):
    """`make_mesh` devices for an n-entry mesh: the cards when there are
    n, else n entries of cuda:0 (a virtual mesh). Returns (devices,
    what)."""
    import torch

    if torch.cuda.device_count() >= n:
        return None, f"{n} distinct cards"
    return ["cuda:0"] * n, f"a virtual mesh, {n} x cuda:0"


def issue_intervals(enc, label):
    """Print each shard's host interval of issue in the encoder's last mesh
    step (ms from the step's start) and require that they overlap: every
    shard started before any shard ended."""
    iv = enc.workers.intervals
    _require(len(iv) == len(enc.shards) and
             max(a for a, _ in iv) < min(b for _, b in iv),
             f"the mesh shards' issue intervals do not overlap: {iv}")
    print("  shards' issue intervals, ms from the step's start " + label
          + ": " + ", ".join(f"{sh.name} {1e3 * a:.1f}-{1e3 * b:.1f}"
                             for sh, (a, b) in zip(enc.shards, iv))
          + "; all in flight together")


def mesh_phases(cfg, run, frames, label, numbers, k2_numbers, k3_numbers,
                me_calls, sym_calls, residual, stages):
    """Phase 15: the dryruns, then the 1080p mesh run against the unsharded
    card run (and that against the CPU), each step's shard issue
    intervals, a forced IDR and a P step and the pipelined loop in turns
    with the unsharded encoder, K1 on a shard's grid, K2 on a shard's
    deblocking inputs and K3 on a shard's IDR wavefront inputs (their
    numbers go into `numbers`, `k2_numbers` and `k3_numbers`; a band-1
    shard's K4 and K7 calls and a shard's symbolize and K8 calls of the
    first P step into `me_calls`, `sym_calls` and `residual`, on the host,
    and the run's K7 and K8 launches into `residual`; the first P step's
    first `ref` stage (a gop row's, in the exchange) and the run's K9, K10
    and K11 launches into `stages`). Returns (K1 launches
    of the
    mesh run, K2 launches, K3 launches, K4 launches, K6 launches, largest
    K1 error)."""
    from h264lab_tpu_torch.config import FrameType
    from h264lab_tpu_torch.entry import dryrun_multichip
    from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from h264lab_tpu_torch.parallel.gop import GopBandEncoder, make_mesh

    for n in (8, 3):
        devices, what = mesh_devices(n)
        t0 = time.perf_counter()
        streams = dryrun_multichip(n, devices)
        print(f"dryrun_multichip({n}) on {what}: {len(streams)} equal lane "
              f"streams of {len(streams[0])} B, lane 0 decoded bit-exactly "
              f"({time.perf_counter() - t0:.1f} s)")

    n_gop, n_band = MESH
    mcfg = dataclasses.replace(cfg, slice_bands=n_band)
    devices, what = mesh_devices(n_gop * n_band)
    enc = GopBandEncoder(mcfg, n_gop=n_gop,
                         mesh=make_mesh(n_gop, n_band, devices))
    print(f"mesh {n_gop}x{n_band} on {what}: {WIDTH}x{HEIGHT}, {n_band} "
          f"slice bands, {n_gop} lanes, QP {QP}, speed {run.encode_speed}; "
          "one worker thread and one CUDA stream per shard, one stage "
          "issued at a time")
    reset_launches()
    mesh_res, db_calls, mesh_wf, mesh_me = [], [], [], []
    mesh_sym, mesh_k7, mesh_k8, mesh_refs, mesh_pre = [], [], [], [], []
    for t, kind in enumerate(MESH_STEPS):
        # the last step runs without stage syncs: the mesh's step time
        staged = t < len(MESH_STEPS) - 1
        enc.stage_times = {} if staged else None
        db_calls.clear()
        t0 = time.perf_counter()
        with recorded_calls("deblock_frame", db_calls), \
                recorded_calls("_select_wavefront", mesh_wf), \
                recorded_calls("motion_search_tiles",
                               mesh_me if t == 1 else [], "ops.me"), \
                recorded_calls("symbolize", mesh_sym), \
                recorded_calls("inter_residual",
                               mesh_k7 if t == 1 else []), \
                recorded_calls("select_parallel", mesh_k8), \
                recorded_calls("prepare_reference",
                               mesh_refs if t == 1 else [],
                               "models.refstate"), \
                recorded_calls("source_tiles", mesh_pre if t == 1 else [],
                               "models.stages"):
            if t == 1:
                n_sym = len(mesh_sym)
                n_k8 = len(mesh_k8)
            pending = enc.encode_step_async(lane_frames(frames, t, n_gop),
                                            run)
            res = enc.finish_step(pending)
        s = time.perf_counter() - t0
        _require([r.frame_type for r in res] == [kind] * n_gop,
                 f"mesh step {t} is {res[0].frame_type}, not {kind}")
        sizes = ", ".join(str(len(r.payload)) for r in res)
        mesh_res.append(res)
        if not staged:
            print(f"mesh step {t} ({kind}) without stage syncs {label}: "
                  f"{s:.3f} s; bytes {sizes}")
            issue_intervals(enc, label)
            continue
        times = enc.stage_times
        print(f"mesh step {t} ({kind}) with stage syncs {label}: {s:.3f} s; "
              f"exchange {1e3 * times['exchange']:.1f} ms, host "
              f"{1e3 * times['host']:.1f} ms; bytes {sizes}")
        issue_intervals(enc, label)
        for name, st in times.items():
            if isinstance(st, dict):
                print(f"  {name} (its own stream): " + ", ".join(
                    f"{k} {1e3 * v:.1f}" for k, v in st.items())
                    + f" ms {label}")
    enc.stage_times = None
    # shard 0,0's symbol grid of the last P step, for K1's check below
    vals, lens = pending.outs[0]["sym_vals"], pending.outs[0]["sym_lens"]
    cap = enc.p_cap_words
    launches = LAUNCH_COUNTS["bitpack"]
    db_launches = LAUNCH_COUNTS["deblock"]
    wf_launches = LAUNCH_COUNTS["wavefront"]
    me_launches = LAUNCH_COUNTS["me"]
    sym_launches = require_k6(cuda_calls(mesh_sym),
                              LAUNCH_COUNTS["symbolize"], "the mesh run")
    print(f"K1 launches in the mesh run's {len(MESH_STEPS)} steps over "
          f"{len(enc.shards)} shards: {launches}; K2 launches {db_launches}; "
          f"K3 launches {wf_launches}; K4 launches {me_launches}; K6 "
          f"launches {sym_launches}")
    require_k3(mesh_wf, wf_launches, len(enc.shards),
               "the mesh run's IDR step over its shards")
    n_p = MESH_STEPS.count("P")
    _require(me_launches == n_p * len(enc.shards)
             and len(mesh_me) == len(enc.shards),
             f"the mesh run launched K4 {me_launches} times in {n_p} P steps "
             f"over {len(enc.shards)} shards")
    # the shards run at once, so their calls come in any order
    bands = [c for c in mesh_me if int(c[4][0]) > 0]
    _require(len(bands) == n_gop and all(
        int(c[4][0]) == HEIGHT // 16 // n_band for c in bands),
        "the band-1 shards' motion searches start at MB rows "
        f"{[int(c[4][0]) for c in mesh_me]}")
    me_calls["mesh band-1 shard"] = to_device(bands[0], "cpu")
    del mesh_me, bands
    _require(cuda_calls(mesh_k8) == n_p * len(enc.shards)
             and len(mesh_k7) == len(enc.shards),
             f"the mesh run made {cuda_calls(mesh_k8)} parallel selects in "
             f"{n_p} P steps over {len(enc.shards)} shards")
    require_k7_k8("the mesh run", me_launches,
                  LAUNCH_COUNTS["inter_residual"],
                  LAUNCH_COUNTS["select_parallel"], cuda_calls(mesh_k8))
    residual["launches"]["mesh"] = (LAUNCH_COUNTS["inter_residual"],
                                 LAUNCH_COUNTS["select_parallel"])
    k7_band = [a for a in mesh_k7 if int(a[6][0]) > 0][0]
    k8_band = mesh_k8[n_k8:n_k8 + len(enc.shards)]
    _require(len(k8_band) == len(enc.shards), "the mesh P step's selects")
    residual["calls"]["inter_residual"]["mesh band-1 shard"] = to_device(
        k7_band, "cpu")
    residual["calls"]["select_parallel"]["mesh shard band"] = to_device(
        k8_band[0], "cpu")
    del mesh_k7, mesh_k8, k7_band, k8_band
    n_k12 = len(enc.shards) * len(MESH_STEPS)
    _require(launches == n_k12 and db_launches == n_k12
             and sym_launches == n_k12,
             f"the mesh run launched K1 {launches}, K2 {db_launches} and K6 "
             f"{sym_launches} times, not once for every shard and step "
             f"({n_k12})")
    mesh_sym_p = mesh_sym[n_sym:n_sym + len(enc.shards)]
    _require(len(mesh_sym_p) == len(enc.shards) and all(
        tuple(a[0].shape) == (1, (HEIGHT // 16 // n_band) * (WIDTH // 16))
        for a in mesh_sym_p), "the mesh P step's symbolize calls")
    sym_calls["mesh shard band"] = to_device(mesh_sym_p[0], "cpu")
    del mesh_sym, mesh_sym_p
    _require(len(db_calls) == len(enc.shards), f"{len(db_calls)} deblocking"
             f" calls in a mesh step over {len(enc.shards)} shards")
    # K11 once per step, gop row and distinct device of the row (the
    # exchange)
    devs = [sh.stages.device for sh in enc.shards]
    per_step = sum(len(set(devs[k:k + n_band]))
                   for k in range(0, len(devs), n_band))
    _require(len(mesh_refs) == per_step, f"the mesh P step's "
             f"{len(mesh_refs)} ref stages, not {per_step}")
    stages["calls"]["K11"]["mesh exchange (a gop row)"] = to_device(
        mesh_refs[0], "cpu")
    del mesh_refs
    # each shard's `pre`: its lanes' block rows
    _require(len(mesh_pre) == len(enc.shards) and all(
        (len(a[0][0]), a[1], a[2]) == (n_gop // MESH[0], WIDTH // 16,
                                       HEIGHT // 16 // MESH[1])
        for a in mesh_pre), f"the mesh P step's {len(mesh_pre)} pre stages")
    stages["calls"]["K12"]["mesh shard's block rows"] = to_device(
        mesh_pre[0], "cpu")
    del mesh_pre
    # K11 once per step, gop row and distinct device, K12 once per shard
    # and step
    require_stage_launches(stages, "mesh", "the mesh run",
                           (0, 0, per_step * len(MESH_STEPS),
                            len(enc.shards) * len(MESH_STEPS), 0))

    flat = GopBandEncoder(mcfg, n_gop=n_gop)
    for t, kind in enumerate(MESH_STEPS):
        t0 = time.perf_counter()
        res = flat.encode_step(lane_frames(frames, t, n_gop), run)
        s = time.perf_counter() - t0
        _require(all(a.payload == b.payload
                     for a, b in zip(res, mesh_res[t])),
                 f"mesh step {t}: lane bytes differ from the unsharded run")
        print(f"mesh step {t} ({kind}): every lane's bytes == the unsharded "
              f"card run's ({s:.3f} s unsharded, without stage syncs)")
    t0 = time.perf_counter()
    cpu = GopBandEncoder(mcfg, n_gop=1, device="cpu")
    for t in range(2):
        got = cpu.encode_step(lane_frames(frames, t, 1), run)
        _require(got[0].payload == mesh_res[t][0].payload,
                 f"unsharded {n_band}-band lane 0 step {t}: card bytes differ "
                 "from CPU bytes")
    print(f"unsharded {n_band}-band lane 0 steps 0 and 1: card bytes == CPU "
          f"bytes ({time.perf_counter() - t0:.1f} s on the CPU)")

    # a forced IDR and a P step without stage syncs, the mesh's and the
    # unsharded encoder's in turns, then the pipelined loop
    # (`encode_step_async` of step t + 1 before `finish_step(t)`) on each
    key = dataclasses.replace(run, frame_type=FrameType.KEY)
    t = len(MESH_STEPS)
    for kind, r in (("IDR", key), ("P", run)):
        lanes = lane_frames(frames, t, n_gop)
        secs = []
        for e in (enc, flat):
            t0 = time.perf_counter()
            res = e.finish_step(e.encode_step_async(lanes, r))
            secs.append(time.perf_counter() - t0)
            _require([x.frame_type for x in res] == [kind] * n_gop,
                     f"step {t} is {res[0].frame_type}, not {kind}")
            if e is enc:
                want = [x.payload for x in res]
        _require([x.payload for x in res] == want, f"mesh step {t} ({kind}):"
                 " lane bytes differ from the unsharded step")
        print(f"mesh step {t} ({kind}{', forced' if kind == 'IDR' else ''}) "
              f"without stage syncs {label}: {secs[0]:.3f} s, the unsharded "
              f"step {secs[1]:.3f} s; bytes equal")
        issue_intervals(enc, label)
        t += 1
    pipe = {}
    for name, e in (("mesh", enc), ("unsharded", flat)):
        steps = range(t, t + MESH_PIPELINED)
        res = []
        t0 = time.perf_counter()
        pending = e.encode_step_async(lane_frames(frames, steps[0], n_gop),
                                      run)
        for u in steps[1:]:
            nxt = e.encode_step_async(lane_frames(frames, u, n_gop), run)
            res.append(e.finish_step(pending))
            pending = nxt
        res.append(e.finish_step(pending))
        pipe[name] = ((time.perf_counter() - t0) / MESH_PIPELINED,
                      [[x.payload for x in r] for r in res])
    _require(pipe["mesh"][1] == pipe["unsharded"][1], "the mesh's pipelined "
             "loop: lane bytes differ from the unsharded pipelined loop")
    print(f"pipelined loop of {MESH_PIPELINED} P steps (steps {t} to "
          f"{t + MESH_PIPELINED - 1}) {label}: mesh {pipe['mesh'][0]:.3f} s a "
          f"step, unsharded {pipe['unsharded'][0]:.3f} s a step; every lane's "
          "bytes equal")

    print(f"mesh shard 0,0 P symbol grid {tuple(vals.shape)}, cap_words {cap}")
    err, nk = check_k1(vals, lens, (cap, 1024), "mesh shard 0,0 P grid")
    numbers["mesh"] = n = k1_numbers(vals, lens, cap, nk)
    print(f"  K1 on the mesh shard grid {label}: {n['ms']:.3f} ms (plain "
          f"{n['plain_ms']:.3f} ms, bound {n['bound_ms']:.4f} ms for "
          f"{n['moved'] / 1e9:.3f} GB, {100 * n['bound_ms'] / n['ms']:.0f}% "
          f"of it reached; {n['n_sym']} symbols, {int(nk.max())} bits)")
    k2_numbers["mesh"] = check_k2(db_calls[0], "a mesh shard's band of the "
                                  "last P step", label)
    k3_numbers["mesh"] = check_k3(mesh_wf[0], "a mesh shard's band of the "
                                  "IDR step", label)
    return launches, db_launches, wf_launches, me_launches, sym_launches, err


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from h264lab_tpu_torch import cli
    from h264lab_tpu_torch.bitstream import nal
    from h264lab_tpu_torch.bitstream.bitwriter import BitWriter
    from h264lab_tpu_torch.config import EncoderConfig, FrameType
    from h264lab_tpu_torch.decoder.decoder import H264Decoder
    from h264lab_tpu_torch.entry import entry
    from h264lab_tpu_torch.models.encoder import H264Encoder
    from h264lab_tpu_torch.ops import bitpack, cuda_build, me, wavefront
    from h264lab_tpu_torch.ops import symbolize as k6
    from h264lab_tpu_torch.ops.cuda_build import LAUNCH_COUNTS
    from h264lab_tpu_torch.parallel.gop import GopBandEncoder
    from h264lab_tpu_torch.utils.device import card_label
    from h264lab_tpu_torch.utils.synthetic import (chessboard_sequence,
                                                   deblock_inputs,
                                                   noise_pan_sequence)

    t_start = time.perf_counter()

    # 1. the card
    card = card_label()
    print(card)
    label = f"[{card}]"
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    # 2. build K1, K2, K3, K4 with K5, K6, K7, K8, K9 with K10, K11, K12
    # and K13, one nvcc each, started together
    t0 = time.perf_counter()
    built = cuda_build.build_all([cuda_build.CSRC / "bitpack.cu",
                                  cuda_build.CSRC / "deblock.cu",
                                  cuda_build.CSRC / "wavefront.cu",
                                  cuda_build.CSRC / "me.cu",
                                  cuda_build.CSRC / "symbolize.cu",
                                  cuda_build.CSRC / "inter.cu",
                                  cuda_build.CSRC / "select.cu",
                                  cuda_build.CSRC / "resample.cu",
                                  cuda_build.CSRC / "refplanes.cu",
                                  cuda_build.CSRC / "pretile.cu",
                                  cuda_build.CSRC / "denoise.cu"])
    print(f"K1 to K13 built in {time.perf_counter() - t0:.1f} s")
    ptxas = {}
    for name, (lib_path, log) in zip(("K1", "K2", "K3", "K4 and K5", "K6",
                                      "K7", "K8", "K9 and K10", "K11", "K12",
                                      "K13"), built):
        print(f"  {name}: {os.path.relpath(lib_path, ROOT)}")
        ptxas[name] = ptxas_lines(log)
        for line in ptxas[name]:
            print(f"  {name} ptxas:", line)

    # 3. the main path: 16 lanes of 1080p IPPP, GOP 20
    t0 = time.perf_counter()
    cfg, run, frames = main_path_setup()
    print(f"input: {len(frames)} frames {WIDTH}x{HEIGHT} in "
          f"{time.perf_counter() - t0:.1f} s")
    enc = GopBandEncoder(cfg, n_gop=LANES)
    gop_wf = []                 # the main path's wavefront calls
    gop_sym = [0]               # its symbolize calls on the card
    gop_k8 = [0]                # its parallel selects on the card
    sym_calls = {}              # the paths' K6 inputs, for phase 19
    residual = residual_record()  # the paths' K7 and K8, for phase 20
    res_calls = {}              # the last step's K7 and K8 inputs
    stages = stage_record()     # the paths' K9 to K13, for phases 21, 22
    # no plain resampling or padding call may reach the card on any path
    # of phases 3 to 15
    plain_seen = []
    plain_window = contextlib.ExitStack()
    plain_window.enter_context(plain_stages_on_card(plain_seen))
    # nor may a `ref` stage copy its tiles before K11, or an `up` stage
    # before K10
    copies = {}
    plain_window.enter_context(tile_copies(copies))

    def step(t, kind, r=run, return_recon=False):
        """Step t; returns (its pending step, results, seconds, its
        symbolize calls)."""
        sym = []
        res_calls.clear()
        t0 = time.perf_counter()
        with recorded_calls("_select_wavefront", gop_wf), \
                recorded_calls("symbolize", sym), \
                recorded_calls("inter_residual",
                               res_calls.setdefault("inter_residual", [])), \
                recorded_calls("select_parallel",
                               res_calls.setdefault("select_parallel", [])):
            p = enc.encode_step_async(lane_frames(frames, t), r,
                                      return_recon)
            res = enc.finish_step(p)
        s = time.perf_counter() - t0
        _require(len(res) == LANES and all(len(x.payload) > 0 for x in res),
                 f"step {t} returned empty lanes")
        _require(all(x.frame_type == kind for x in res),
                 f"step {t} is {res[0].frame_type}, not {kind}")
        gop_sym[0] += cuda_calls(sym)
        gop_k8[0] += cuda_calls(res_calls["select_parallel"])
        return p, res, s, sym

    def stage_table(name, s, res):
        print(f"{name} stage step {label}: {s:.3f} s")
        for k, v in enc.stage_times.items():
            print(f"  stage {k:8s} {1e3 * v:10.1f} ms {label}")
        print(f"  bytes lane 0: {len(res[0].payload)}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    reset_launches()
    _, first, s0, _ = step(0, "IDR", return_recon=True)
    print(f"step 0 (IDR, untimed, first use): {s0:.2f} s")
    _, second, s1, _ = step(1, "P", return_recon=True)
    print(f"step 1 (P, untimed, first use): {s1:.2f} s")
    step_s = [step(t, "P")[2] for t in range(2, 2 + TIMED_STEPS)]
    t_p = sum(step_s) / TIMED_STEPS
    print(f"timed P steps {label}: " + ", ".join(f"{s:.3f} s" for s in step_s)
          + f"; {LANES / t_p:.3f} P frames/s ({LANES} lanes x "
          f"{TIMED_STEPS} steps)")
    rbsps, writers, host_ms, db_args = {}, {}, {}, {}

    def stage_step(t, kind, r=run):
        """A step with per-stage times that keeps the RBSPs it escapes, the
        bit writers it packs and its deblocking inputs."""
        escape, to_bytes = nal.escape_rbsp, BitWriter.to_bytes
        rbsps[kind], writers[kind], calls, refs, pre = [], [], [], [], []
        nal.escape_rbsp = lambda rbsp: rbsps[kind].append(rbsp) or escape(
            rbsp)
        BitWriter.to_bytes = lambda bw: writers[kind].append(bw) or to_bytes(
            bw)
        enc.stage_times = {}
        try:
            with recorded_calls("deblock_frame", calls), \
                    recorded_calls("prepare_reference", refs,
                                   "models.refstate"), \
                    recorded_calls("source_tiles", pre, "models.stages"):
                pending, res, s, sym = step(t, kind, r)
        finally:
            nal.escape_rbsp = escape
            BitWriter.to_bytes = to_bytes
        _require(len(calls) == 1, f"{len(calls)} deblocking calls in a step")
        _require(len(refs) == 1, f"{len(refs)} ref stages in a step")
        stages["calls"]["K11"][f"{LANES}-lane {kind} step"] = to_device(
            refs[0], "cpu")
        _require(len(pre) == 1 and len(pre[0][0][0]) == LANES,
                 f"{len(pre)} pre stages in a step")
        if kind == "P":
            stages["calls"]["K12"][f"{LANES}-lane P step"] = to_device(
                pre[0], "cpu")
        del pre
        _require(len(sym) == 1, f"{len(sym)} symbolize calls in a step")
        db_args[kind] = calls[0]
        sym_calls[f"{LANES}-lane {kind} step"] = to_device(sym[0], "cpu")
        if kind == "P":
            for name, c in res_calls.items():
                _require(len(c) == 1, f"{len(c)} {name} calls in a P step")
                residual["calls"][name][f"{LANES}-lane P step"] = to_device(
                    c[0], "cpu")
        res_calls.clear()
        stage_table(kind, s, res)
        host_ms[kind] = 1e3 * enc.stage_times["host"]
        enc.stage_times = None
        return pending

    me_calls = {}               # the paths' K4 and K5 inputs, for phase 18
    gop_me = []
    with recorded_calls("motion_search_tiles", gop_me, "ops.me"):
        p_pending = stage_step(2 + TIMED_STEPS, "P")
    key = dataclasses.replace(run, frame_type=FrameType.KEY)
    idr_pending = stage_step(3 + TIMED_STEPS, "IDR", key)
    t_idr = step(4 + TIMED_STEPS, "IDR", key)[2]
    launches = LAUNCH_COUNTS["bitpack"]
    db_launches = LAUNCH_COUNTS["deblock"]
    wf_launches = LAUNCH_COUNTS["wavefront"]
    me_launches = LAUNCH_COUNTS["me"]
    sym_launches = require_k6(gop_sym[0], LAUNCH_COUNTS["symbolize"],
                              f"the main path's {STEPS} steps")
    _require(sym_launches == STEPS, f"the main path launched K6 "
             f"{sym_launches} times in its {STEPS} steps")
    _require(len(gop_me) == 1 and tuple(gop_me[0][2].shape[:2]) == (
        LANES, (WIDTH // 16) * (HEIGHT // 16)), "the P stage step did not "
        "search its 16 lanes in one K4 call")
    me_calls["16-lane P step"] = to_device(gop_me[0], "cpu")
    del gop_me
    print(f"GOP-{GOP} frames/s {label}, derived as {LANES} * {GOP} / (t_IDR"
          f" + {GOP - 1} * t_P) with t_IDR {t_idr:.3f} s (an IDR step "
          f"without stage syncs) and t_P {t_p:.3f} s: "
          f"{LANES * GOP / (t_idr + (GOP - 1) * t_p):.3f}")
    print(f"K1 launches in the main path's {STEPS} steps: {launches}; K2 "
          f"launches {db_launches}; K3 launches {wf_launches}; K4 launches "
          f"{me_launches}; K5 launches {LAUNCH_COUNTS['partition']}; K6 "
          f"launches {sym_launches}")
    _require(launches >= STEPS, "the main path did not launch K1 each step")
    _require(db_launches >= STEPS, "the main path did not launch K2 each "
             "step")
    require_k3(gop_wf, wf_launches, 3, "the main path's 3 IDR steps")
    _require(me_launches == STEPS - 3 and LAUNCH_COUNTS["partition"] == 0,
             f"the main path launched K4 {me_launches} times and K5 "
             f"{LAUNCH_COUNTS['partition']} times in its {STEPS - 3} P steps")
    _require(gop_k8[0] == STEPS - 3, f"the main path made {gop_k8[0]} "
             f"parallel selects on the card in its {STEPS - 3} P steps")
    require_k7_k8(f"the main path's {STEPS} steps", me_launches,
                  LAUNCH_COUNTS["inter_residual"],
                  LAUNCH_COUNTS["select_parallel"], gop_k8[0])
    residual["launches"]["gop"] = (LAUNCH_COUNTS["inter_residual"],
                                LAUNCH_COUNTS["select_parallel"])
    # K11 once per step (its `ref` stage), K12 once per step (its `pre`),
    # no resampling and no denoise
    require_stage_launches(stages, "gop", f"the main path's {STEPS} steps",
                           (0, 0, STEPS, STEPS, 0))

    # 4. K1 against the plain packer on the real IDR and P grids and on a
    # synthetic grid past the drop boundaries
    max_err = 0
    numbers = {}
    for name, pend, cap in (("IDR", idr_pending, enc.idr_cap_words),
                            ("P", p_pending, enc.p_cap_words)):
        vals, lens = pend.outs[0]["sym_vals"], pend.outs[0]["sym_lens"]
        print(f"{name} symbol grid {tuple(vals.shape)}, cap_words {cap}")
        err, nk = check_k1(vals, lens, (cap, 1024), f"{name} grid")
        max_err = max(max_err, err)
        if name == "IDR":
            _require(int(nk.max()) > 32 * 1024, "the small cap did not "
                     "overflow")
        numbers[name] = k1_numbers(vals, lens, cap, nk)
        n = numbers[name]
        print(f"  {name} grid: largest MB {int(lens.sum(-1).max())} bits; "
              f"frame bits {int(nk.min())} .. {int(nk.max())}; slots "
              f"holding a symbol {n['n_sym']} of {lens.numel()} "
              f"({100 * n['n_sym'] / lens.numel():.2f}%)")
        print(f"  K1 on the {name} grid {label}: {n['ms']:.3f} ms (plain "
              f"{n['plain_ms']:.3f} ms, bound {n['bound_ms']:.3f} ms for "
              f"{n['moved'] / 1e9:.3f} GB, "
              f"{100 * n['bound_ms'] / n['ms']:.0f}% of it reached)")
    del idr_pending, p_pending, vals, lens
    # K2 on the two stage steps' deblocking inputs
    k2_numbers = {}
    for kind in ("P", "IDR"):
        k2_numbers[kind] = check_k2(db_args[kind], f"the {LANES}-lane {kind} "
                                    "step's deblocking inputs", label)
    del db_args
    # K3 on the IDR stage step's wavefront inputs
    k3_numbers = {"IDR": check_k3(gop_wf[1], f"the {LANES}-lane IDR step's "
                                  "wavefront inputs", label)}
    del gop_wf
    t0 = time.perf_counter()
    s_vals, s_lens = synthetic_grid()
    units = s_lens.reshape(s_lens.shape[:2] + (28, 34)).sum(-1)
    s_mb = units.sum(-1)
    features = dict(empty_mbs=int((s_mb == 0).sum()),
                    empty_frames=int((s_mb.sum(-1) == 0).sum()),
                    mbs_over_4096=int((s_mb > 4096).sum()),
                    units_over_704=int((units > 704).sum()))
    print(f"synthetic grid {s_lens.shape} (seed {SYNTH_SEED}, "
          f"{time.perf_counter() - t0:.1f} s): {features}")
    _require(all(features.values()), "the synthetic grid lacks a feature")
    s_vals = torch.from_numpy(s_vals.view("int32")).to(enc.device)
    s_lens = torch.from_numpy(s_lens).to(enc.device)
    s_cap = bitpack.bucket_words(int(s_lens.sum((1, 2)).max()))
    err, _ = check_k1(s_vals, s_lens, (s_cap, 1024), "synthetic grid")
    max_err = max(max_err, err)
    del s_vals, s_lens

    # 5. lane 0's first two frames on the CPU, and decoded
    t0 = time.perf_counter()
    cpu = GopBandEncoder(cfg, n_gop=1, device="cpu")
    for t, want in enumerate((first, second)):
        got = cpu.encode_step([frames[t]], run)
        _require(got[0].payload == want[0].payload,
                 f"lane 0 step {t} bytes differ between the card and the CPU")
        print(f"lane 0 step {t} ({got[0].frame_type}): card bytes == CPU "
              f"bytes ({len(got[0].payload)} B)")
    print(f"  CPU encode {time.perf_counter() - t0:.1f} s")
    # the decode is host work: a worker process runs it beside phases 6 to
    # 22 (at exit, even a failed one, the pool waits for it and stops it)
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
        "spawn"))
    decoding = pool.submit(decode_lane0, [r[0].payload for r in (first,
                                                                 second)],
                           [r[0].recon for r in (first, second)])
    del first, second

    # 6. NAL escaping: the per-byte loop against the numpy escape; RBSP
    # packing: the per-bit packer against the word-level one
    for kind in ("P", "IDR"):
        escape_turns(rbsps[kind], f"{LANES}-lane {kind}", label)
        pack_turns(writers[kind], f"{LANES}-lane {kind}", label)
        print(f"  the {kind} step's host stage {label}: {host_ms[kind]:.1f}"
              " ms")
    del rbsps, writers

    # 7. the sequential path: H264Encoder, 1080p, speed 0
    del enc
    torch.cuda.empty_cache()
    seq_frames = list(chessboard_sequence(WIDTH, HEIGHT, 3))
    seq = H264Encoder(cfg)
    seq_run = dataclasses.replace(run, encode_speed=SEQ_SPEED)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()

    seq_sym, seq_k8 = [], []

    def seq_frame(t, kind):
        t0 = time.perf_counter()
        with recorded_calls("symbolize", seq_sym), \
                recorded_calls("select_parallel", seq_k8):
            p = seq.encode_async(*seq_frames[t], seq_run)
            res = seq.finish(p)
        s = time.perf_counter() - t0
        _require(res.frame_type == kind and len(res.payload) > 0,
                 f"sequential frame {t} is {res.frame_type}, not {kind}")
        return p, res, s

    seq_wf = []
    with recorded_calls("_select_wavefront", seq_wf):
        _, res, s = seq_frame(0, "IDR")
    print(f"sequential speed {SEQ_SPEED}: IDR (untimed, first use) {s:.2f} s, "
          f"{len(res.payload)} B")
    with recorded_calls("_select_wavefront", seq_wf):
        _, res, t_seq = seq_frame(1, "P")
    print(f"sequential speed {SEQ_SPEED} P frame {label}: {t_seq:.3f} s per "
          f"frame, {1 / t_seq:.4f} frames/s ({len(res.payload)} B)")
    seq.stage_times = {}
    seq_calls, seq_me, seq_part, seq_k7, seq_refs = [], [], [], [], []
    n_sym = len(seq_sym)
    with recorded_calls("deblock_frame", seq_calls), \
            recorded_calls("_select_wavefront", seq_wf), \
            recorded_calls("motion_search_tiles", seq_me, "ops.me"), \
            recorded_calls("partition_tiles", seq_part, "ops.me"), \
            recorded_calls("inter_residual", seq_k7), \
            recorded_calls("prepare_reference", seq_refs, "models.refstate"):
        seq_pending, res, s = seq_frame(2, "P")
    _require(len(seq_refs) == 1, f"{len(seq_refs)} ref stages in a frame")
    stages["calls"]["K11"]["speed-0 P frame"] = to_device(seq_refs[0], "cpu")
    del seq_refs
    _require(len(seq_k7) == 1 and seq_k7[0][15] is not None, "the speed-0 "
             "P frame's inter residual did not take K5's partitions")
    residual["calls"]["inter_residual"]["speed-0 P frame"] = to_device(
        seq_k7[0], "cpu")
    del seq_k7
    sym = seq_sym[n_sym:]
    _require(len(sym) == 1, f"{len(sym)} symbolize calls in a frame")
    sym_calls["speed-0 P frame"] = to_device(sym[0], "cpu")
    del sym
    print(f"sequential P stage frame {label}: {s:.3f} s")
    for k, v in seq.stage_times.items():
        print(f"  stage {k:8s} {1e3 * v:10.1f} ms {label}")
    print(f"  bytes: {len(res.payload)}; peak device memory of the "
          f"sequential path {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB")
    seq.stage_times = None
    seq_launches = LAUNCH_COUNTS["bitpack"]
    seq_db_launches = LAUNCH_COUNTS["deblock"]
    seq_wf_launches = LAUNCH_COUNTS["wavefront"]
    seq_me_launches = LAUNCH_COUNTS["me"]
    seq_part_launches = LAUNCH_COUNTS["partition"]
    seq_sym_launches = require_k6(cuda_calls(seq_sym),
                                  LAUNCH_COUNTS["symbolize"],
                                  "the sequential path's 3 frames")
    print(f"K1 launches in the sequential path's 3 frames: {seq_launches}; "
          f"K2 launches {seq_db_launches}; K3 launches {seq_wf_launches}; K4 "
          f"launches {seq_me_launches}; K5 launches {seq_part_launches}; K6 "
          f"launches {seq_sym_launches}")
    _require(seq_me_launches == 2 and seq_part_launches == 2
             and len(seq_me) == len(seq_part) == 1, "the sequential path did "
             "not launch K4 and K5 once on each speed-0 P frame")
    require_k7_k8("the sequential path's 3 frames", seq_me_launches,
                  LAUNCH_COUNTS["inter_residual"],
                  LAUNCH_COUNTS["select_parallel"], cuda_calls(seq_k8))
    residual["launches"]["seq"] = (LAUNCH_COUNTS["inter_residual"],
                                LAUNCH_COUNTS["select_parallel"])
    require_stage_launches(stages, "seq", "the sequential path's 3 frames",
                           (0, 0, 3, 3, 0))
    me_calls["speed-0 P frame"] = to_device(seq_me[0], "cpu")
    part_calls = {"speed-0 P frame": to_device(seq_part[0], "cpu")}
    del seq_me, seq_part
    require_k3(seq_wf, seq_wf_launches, 3, "the sequential path's IDR and "
               "two speed-0 P frames")
    _require(seq_launches >= 3, "the sequential path did not launch K1 on "
             "every frame")
    _require(seq_db_launches >= 3 and len(seq_calls) == 1, "the sequential "
             "path did not launch K2 on every frame")

    # 8. K1 against the plain packer on the sequential P frame's grid
    vals, lens = seq_pending.out["sym_vals"], seq_pending.out["sym_lens"]
    cap = seq_pending.out["cap_words"]
    print(f"sequential P symbol grid {tuple(vals.shape)}, cap_words {cap}")
    err, nk = check_k1(vals, lens, (cap, 1024), "sequential P grid")
    max_err = max(max_err, err)
    numbers["seq"] = n = k1_numbers(vals, lens, cap, nk)
    print(f"  K1 on the sequential P grid {label}: {n['ms']:.3f} ms (plain "
          f"{n['plain_ms']:.3f} ms, bound {n['bound_ms']:.3f} ms for "
          f"{n['moved'] / 1e9:.3f} GB, {100 * n['bound_ms'] / n['ms']:.0f}% "
          f"of it reached; {n['n_sym']} symbols, {int(nk.max())} bits)")
    k2_numbers["seq"] = check_k2(seq_calls[0], "the sequential P frame's "
                                 "deblocking inputs", label)
    _require(seq_wf[2][9] is not None, "the speed-0 P frame's wavefront "
             "has no inter candidate")
    k3_numbers["seq"] = check_k3(seq_wf[2], "the sequential speed-0 P "
                                 "frame's wavefront inputs (with inter)",
                                 label)
    del seq, seq_pending, vals, lens, seq_calls, seq_wf
    torch.cuda.empty_cache()

    # 9. card bytes against CPU bytes at CIF, and decoded
    t0 = time.perf_counter()
    reset_launches()
    cif_sym = []                # the CIF encoders' symbolize calls
    cif_k8 = []                 # and parallel selects
    cif_frames = list(chessboard_sequence(*CIF, 3))
    cif = EncoderConfig(width=CIF[0], height=CIF[1], gop=GOP, qp=QP)
    # speed 1 with the temporal denoise on a sub-pel noise pan (the
    # chessboard's large temporal differences mostly take gain 0)
    noise_frames = list(noise_pan_sequence(*CIF, 3))
    for speed, n_frames, dn in ((0, 3, False), (10, 2, False),
                                (1, 3, True)):
        r = dataclasses.replace(run, encode_speed=speed)
        c = dataclasses.replace(cif, temporal_denoise_flag=dn)
        what = f"speed {speed}" + (" with the denoise" if dn else "")
        src = noise_frames if dn else cif_frames
        on_card, on_cpu = H264Encoder(c), H264Encoder(c, device="cpu")
        card_res = []
        for t in range(n_frames):
            with recorded_calls("symbolize", cif_sym), \
                    recorded_calls("select_parallel", cif_k8):
                a = on_card.encode(*src[t], r, return_recon=True)
            b = on_cpu.encode(*src[t], r)
            _require(a.payload == b.payload, f"CIF {what} frame {t}: "
                     "card bytes differ from CPU bytes")
            print(f"CIF H264Encoder {what} frame {t} ({a.frame_type}):"
                  f" card bytes == CPU bytes ({len(a.payload)} B)")
            card_res.append(a)
        decode_check(b"".join(a.payload for a in card_res),
                     [a.recon for a in card_res], f"CIF H264Encoder {what}")
    _require(LAUNCH_COUNTS["denoise"] == 2, f"the CIF denoise encoder "
             f"launched K13 {LAUNCH_COUNTS['denoise']} times in its 2 P "
             "frames")
    cif_k13 = LAUNCH_COUNTS["denoise"]
    r = dataclasses.replace(run, encode_speed=1)
    on_card = GopBandEncoder(cif, n_gop=2)
    on_cpu = GopBandEncoder(cif, n_gop=2, device="cpu")
    card_steps = []
    for t in range(2):
        lanes = [cif_frames[t], cif_frames[t + 1]]
        with recorded_calls("symbolize", cif_sym), \
                recorded_calls("select_parallel", cif_k8):
            card_steps.append(on_card.encode_step(lanes, r,
                                                  return_recon=True))
        for a, b in zip(card_steps[-1], on_cpu.encode_step(lanes, r)):
            _require(a.payload == b.payload, f"CIF GOP lanes step {t}: card "
                     "bytes differ from CPU bytes")
        print(f"CIF GopBandEncoder 2 lanes speed 1 step {t} "
              f"({a.frame_type}): card bytes == CPU bytes")
    for g in range(2):
        decode_check(b"".join(st[g].payload for st in card_steps),
                     [st[g].recon for st in card_steps],
                     f"CIF GopBandEncoder speed 1 lane {g}")
    cif_sym_launches = require_k6(cuda_calls(cif_sym),
                                  LAUNCH_COUNTS["symbolize"],
                                  "the CIF card encoders")
    print(f"K6 launches of the CIF card encoders: {cif_sym_launches}, one "
          "for each of their symbolize calls on the card")
    cif_me = (LAUNCH_COUNTS["me"], LAUNCH_COUNTS["partition"])
    print(f"K4 and K5 launches of the CIF card encoders (P frames: 2 at "
          f"speed 0, 1 at speed 10, 2 denoised at speed 1, a 2-lane step at "
          f"speed 1): {cif_me}; K13 launches {cif_k13}")
    _require(cif_me == (6, 2), "the CIF card encoders did not launch K4 on "
             "every P frame or step and K5 on every speed-0 P frame")
    _require(cuda_calls(cif_k8) == 1, f"the CIF card encoders made "
             f"{cuda_calls(cif_k8)} parallel selects, not 1 (speed 10's P)")
    require_k7_k8("the CIF card encoders", cif_me[0],
                  LAUNCH_COUNTS["inter_residual"],
                  LAUNCH_COUNTS["select_parallel"], cuda_calls(cif_k8))
    residual["launches"]["cif"] = (LAUNCH_COUNTS["inter_residual"],
                                LAUNCH_COUNTS["select_parallel"])
    del cif_k8
    print(f"  CIF comparisons and decodes {time.perf_counter() - t0:.1f} s")

    # 10. the CLI on the card
    cli_sym = []
    before = LAUNCH_COUNTS["symbolize"]
    cli_before = dict(LAUNCH_COUNTS)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cli.264")
        with recorded_calls("symbolize", cli_sym):
            rc = cli.main(["--gen", "--size", f"{CIF[0]}x{CIF[1]}",
                           "--maxframes", "3", "--psnr", "--output", out])
        with open(out, "rb") as f:
            stream = f.read()
    cli_sym_launches = require_k6(cuda_calls(cli_sym),
                                  LAUNCH_COUNTS["symbolize"] - before,
                                  "the CLI on the card")
    cli_k7, cli_k8 = (LAUNCH_COUNTS[k] - cli_before[k]
                      for k in ("inter_residual", "select_parallel"))
    require_k7_k8("the CLI on the card (speed 0)",
                  LAUNCH_COUNTS["me"] - cli_before["me"], cli_k7, cli_k8, 0)
    _require(cli_k7 == 2, f"the CLI's 2 P frames launched K7 {cli_k7} times")
    residual["launches"]["cli"] = (cli_k7, cli_k8)
    _require(rc == 0 and stream[:4] == b"\x00\x00\x00\x01"
             and stream[4] & 0x1F == 7, "the CLI did not write an SPS first")
    dec = H264Decoder()
    n_dec = len(dec.decode(stream))
    _require(n_dec == 3 and (dec.sps.width, dec.sps.height) == CIF,
             f"the CLI's stream decodes to {n_dec} frames of "
             f"{dec.sps.width}x{dec.sps.height}, not 3 of {CIF}")
    print("CLI on the card: exit 0, the stream starts with an SPS and "
          f"decodes to 3 frames of {CIF[0]}x{CIF[1]}; K6 launches "
          f"{cli_sym_launches}")

    # 11 to 13. two-layer SVC
    bm_numbers = {}             # K6 and K7 on the base-mode frame
    (svc_launches, svc_db_launches, svc_wf_launches, svc_me_launches,
     svc_sym_launches, svc_bm_launches, err) = svc_phases(
        cfg, run, label, numbers, k2_numbers, k3_numbers, me_calls,
        sym_calls, residual, cif, cif_frames, ptxas, bm_numbers, stages)
    max_err = max(max_err, err)

    # 14. entry() on the card against the CPU
    fn, args = entry()
    before = dict(LAUNCH_COUNTS)
    sym = []
    with recorded_calls("symbolize", sym):
        got = fn(*args)
    entry_wf_launches = LAUNCH_COUNTS["wavefront"] - before["wavefront"]
    entry_sym_launches = LAUNCH_COUNTS["symbolize"] - before["symbolize"]
    _require(entry_wf_launches == 1, f"entry() launched K3 "
             f"{entry_wf_launches} times, not once")
    _require(len(sym) == 1 and entry_sym_launches == 1, f"entry() made "
             f"{len(sym)} symbolize calls and {entry_sym_launches} K6 "
             "launches, not one")
    sym_calls["entry() intra frame"] = to_device(sym[0], "cpu")
    del sym
    cfn, cargs = entry(device="cpu")
    want = cfn(*cargs)
    _require(set(got) == set(want) and all(
        torch.equal(got[k].cpu(), want[k]) for k in want),
        "entry() on the card differs from the CPU")
    print(f"entry() on the card: all {len(want)} outputs equal the CPU's "
          f"({int(got['total_bits'])} bits; one K3 launch, one K6 launch)")

    # 15. the mesh
    t0 = time.perf_counter()
    (mesh_launches, mesh_db_launches, mesh_wf_launches, mesh_me_launches,
     mesh_sym_launches, err) = mesh_phases(cfg, run, frames, label, numbers,
                                           k2_numbers, k3_numbers, me_calls,
                                           sym_calls, residual, stages)
    max_err = max(max_err, err)
    print(f"  mesh phase {time.perf_counter() - t0:.1f} s")
    plain_window.close()
    _require(not plain_seen, f"plain resampling, padding or denoise on the "
             f"card in phases 3 to 15: {sorted(set(plain_seen))} "
             f"({len(plain_seen)} calls)")
    for kernel, stage in (("K11", "ref"), ("K10", "up")):
        calls, made = copies[kernel]
        _require(calls > 0 and made == 0,
                 f"{made} of the {calls} tile tensors of the `{stage}` "
                 f"stages in phases 3 to 15 copied before {kernel}")
        print(f"the `{stage}` stages of phases 3 to 15 handed {kernel} "
              f"their {calls} tile tensors without a copy")
    print("no " + ", ".join(f"{m}.{n}" for m, n in PLAIN_STAGES) + " call "
          "took a tensor on the card in phases 3 to 15")

    # 16. K2 against the plain filter on seeded inputs at the main paths'
    # shapes
    t0 = time.perf_counter()
    for what, seed, n, mbw, mbh, qp, per_mb, band in K2_CASES:
        args = [torch.from_numpy(np.asarray(v)).cuda() for v in
                deblock_inputs(seed, n, mbw, mbh, qp, per_mb_qp=per_mb,
                               band=band).values()]
        k2_numbers[what] = check_k2(args + [mbw, mbh], f"seeded inputs, "
                                    f"{what} (seed {seed})", label)
    del args
    print(f"  K2 on seeded inputs {time.perf_counter() - t0:.1f} s")

    # 17. K3 against the plain wavefront on seeded inputs at the main paths'
    # shapes, and its time per MB step beside its registers and residency
    t0 = time.perf_counter()
    card = torch.device("cuda", 0)
    k3_clusters = {c: wavefront.occupancy(120, c, card)[1]
                   for c in wavefront.CLUSTERS}
    k3_resident = wavefront.occupancy(120, wavefront.CLUSTERS[0], card)[0]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"K3 {label}: ptxas {ptxas['K3']}; at 120 MBs a row "
          f"{k3_resident} resident blocks (MB rows) per SM, "
          f"{k3_resident * n_sm} on the card; resident clusters by rows "
          f"per cluster {k3_clusters}")
    for what, seed, n, mbw, mbh, qp, inter in K3_CASES:
        args = k3_case_args(seed, n, mbw, mbh, qp, inter)
        k3_numbers[what] = check_k3(args, f"seeded inputs, {what} (seed "
                                    f"{seed}, QP {qp})", label)
    del args
    for what, v in k3_numbers.items():
        print(f"  K3 on {what} {label}: {v['ms']:.3f} ms, "
              f"{v['us_per_step']:.2f} us per MB step, clusters of "
              f"{v['cluster']} rows")
    print(f"  K3 on seeded inputs {time.perf_counter() - t0:.1f} s")

    # 18. K4 and K5 against the plain searches on the paths' real inputs
    # and on seeded inputs at the paths' shapes
    t0 = time.perf_counter()
    print(f"K4 and K5 {label}: ptxas {ptxas['K4 and K5']}")
    k4_occ = me.occupancy(card)
    print(f"K4 {label}: {k4_occ['threads']} threads and "
          f"{k4_occ['smem_bytes']} bytes of shared memory a block (a tile of "
          f"{k4_occ['tile'][0]} x {k4_occ['tile'][1]} MBs), "
          f"{k4_occ['blocks_per_sm']} resident blocks an SM")
    k4_numbers, k5_numbers = {}, {}
    # K4's kernel launches in one call on the 16-lane P step's inputs
    args = to_device(me_calls["16-lane P step"], "cuda")
    k4_kernels, taken = kernel_launches(
        lambda: me.motion_search_tiles(*args), traces=TRACE_TRIES)
    print(f"K4's kernel launches in one call {label}: "
          + ", ".join(f"{k} {us:.1f} us" for k, us in k4_kernels)
          + f" ({taken} profiler trace(s) taken)")
    _require(len(k4_kernels) == 1, f"K4 launched {len(k4_kernels)} kernels "
             "in one call, not one")
    # K5's build, launch shape and kernel launches in one call on the
    # speed-0 P frame's inputs
    k5_ptxas = [x for x in ptxas["K4 and K5"]
                if x.startswith("partition_kernel")]
    k5_occ = me.partition_occupancy(card)
    print(f"K5 {label}: ptxas {k5_ptxas}; {k5_occ['warps']} warps (an MB "
          f"each), {k5_occ['threads']} threads and {k5_occ['smem_bytes']} "
          f"bytes of shared memory a block, {k5_occ['blocks_per_sm']} "
          "resident blocks an SM")
    args = to_device(part_calls["speed-0 P frame"], "cuda")
    k5_kernels, taken = kernel_launches(lambda: me.partition_tiles(*args),
                                        traces=TRACE_TRIES)
    print(f"K5's kernel launches in one call {label}: "
          + ", ".join(f"{k} {us:.1f} us" for k, us in k5_kernels)
          + f" ({taken} profiler trace(s) taken)")
    _require(len(k5_kernels) == 1, f"K5 launched {len(k5_kernels)} kernels "
             "in one call, not one")
    del args
    for what, args in me_calls.items():
        k4_numbers[what] = check_k4(to_device(args, "cuda"), f"the {what}'s "
                                    "motion search inputs", label)
    for what, args in part_calls.items():
        k5_numbers[what] = check_k5(to_device(args, "cuda"), f"the {what}'s "
                                    "partition search inputs", label)
    del me_calls, part_calls
    for what, seed, n, mbw, mbh, qp, lanes, rows, subpel in K4_CASES:
        args = k4_case_args(seed, n, mbw, mbh, qp, lanes, rows, subpel)
        case = (f"seeded inputs, {what} (seed {seed}, QP {qp}, row offsets "
                f"{args[4].tolist()[:4]})")
        k4_numbers[what] = check_k4(args, case, label)
        if subpel:
            k5_numbers[what] = check_k5(k5_args(args), case, label)
    del args
    torch.cuda.empty_cache()
    print(f"  K4 and K5 checks {time.perf_counter() - t0:.1f} s")

    # 19. K6 against the plain symbolizer on the paths' real inputs and on
    # seeded inputs at the paths' shapes
    t0 = time.perf_counter()
    k6_ptxas = ptxas["K6"]
    k6_build = ptxas_numbers(k6_ptxas)
    for kernel, v in k6_build.items():
        print(f"K6 {kernel} {label}: {v['registers']} registers, "
              f"{v['smem']} bytes of shared memory, {v['stack']} bytes of "
              f"stack, spills {v['spill_stores']} B stored and "
              f"{v['spill_loads']} B loaded")
    if not k6_build:
        print(f"K6 {label}: a cached build, no ptxas report")
    k6_numbers = {"SVC base-mode frame": bm_numbers["K6"]}
    for what, call in sym_calls.items():
        k6_numbers[what] = check_k6(call, f"the {what}'s symbolize inputs",
                                    label, k6_ptxas)
    del sym_calls
    for case in [c + (False,) for c in K6_CASES] + [K6_DENSE_CASE + (True,)]:
        what, seed, n, mbw, mbh, has_inter, plan, flag, dense = case
        call = k6_case_call(seed, n, mbw, mbh, has_inter, plan, flag,
                            dense=dense)
        k6_numbers[what] = check_k6(call, f"seeded inputs, {what} (seed "
                                    f"{seed})", label, k6_ptxas)
    del call
    torch.cuda.empty_cache()
    # the traces hold K6's kernels and no other, each at most once; the P
    # step's, whose device time goes into the kernels line, all three (a
    # check whose fullest trace of ten lacks one gives no device time)
    k6_names = {"sym_records_kernel", "sym_scan_kernel", "sym_codes_kernel",
                "sym_records_kernel<true>", "sym_codes_kernel<true>"}
    seen = {k: [name for name, _ in v["kernels"]]
            for k, v in k6_numbers.items()}
    _require(all(set(v) <= k6_names and len(v) == len(set(v))
                 for v in seen.values())
             and set(seen[f"{LANES}-lane P step"]) == {
                 "sym_records_kernel", "sym_scan_kernel", "sym_codes_kernel"}
             and set(seen["SVC base-mode frame"]) <= {
                 "sym_records_kernel<true>", "sym_codes_kernel<true>"},
             f"K6's traced kernel launches: {seen}")
    incomplete = [k for k, v in seen.items()
                  if len(v) < k6_numbers[k]["n_kernels"]]
    print(f"  K6 checks whose fullest trace lacks a kernel (no device "
          f"time): {incomplete}")
    print(f"  K6 checks {time.perf_counter() - t0:.1f} s")

    # 20. K7 and K8 against their plain versions on the paths' real inputs
    # and on seeded inputs at the paths' shapes
    t0 = time.perf_counter()
    res_build = {}
    for kernel in ("K7", "K8"):
        res_build[kernel] = ptxas_numbers(ptxas[kernel])
        for name, v in res_build[kernel].items():
            print(f"{kernel} {name} {label}: {v['registers']} registers, "
                  f"{v['smem']} bytes of shared memory, {v['stack']} bytes "
                  f"of stack, spills {v['spill_stores']} B stored and "
                  f"{v['spill_loads']} B loaded")
    k7_numbers = {"SVC base-mode frame": bm_numbers["K7"]}
    k8_numbers = {}
    for kernel, name, numbers_of in (("K7", "inter_residual", k7_numbers),
                                     ("K8", "select_parallel", k8_numbers)):
        for what, call in residual["calls"][name].items():
            numbers_of[what] = check_residual(
                kernel, to_device(call, "cuda"), f"the {what}'s inputs",
                label, trace=True)
    residual["calls"].clear()
    for what, *case in K7_CASES:
        k7_numbers[what] = check_residual(
            "K7", k7_case_args(*case), f"seeded inputs, {what} (seed "
            f"{case[0]})", label)
    for what, *case in K8_CASES:
        k8_numbers[what] = check_residual(
            "K8", k8_case_args(*case), f"seeded inputs, {what} (seed "
            f"{case[0]})", label)
    torch.cuda.empty_cache()
    color_chroma_check(label)
    # the traces hold K7's kernel, K8's, and no other
    # (the profiler may drop a record: a trace that lacks one gives no
    # device time)
    for kernel, numbers_of, names in (
            ("K7", k7_numbers, ["inter_residual_kernel"]),
            ("K8", k8_numbers, ["select_parallel_kernel"])):
        for what, v in numbers_of.items():
            seen = [k for k, _ in v["kernels"]]
            _require(seen == [k for k in names if k in seen],
                     f"{kernel}'s traced kernels on {what}: {seen}")
    print(f"  K7 and K8 checks {time.perf_counter() - t0:.1f} s")

    # 21. K9 to K12 against their plain versions on the paths' real
    # inputs (K12 also on a cropped frame at an odd address), and `pre`'s
    # parts on the 16-lane P step's frames
    t0 = time.perf_counter()
    for kernel in ("K9 and K10", "K11", "K12", "K13"):
        for name, v in ptxas_numbers(ptxas[kernel]).items():
            print(f"{kernel} {name} {label}: {v['registers']} registers, "
                  f"{v['smem']} bytes of shared memory, {v['stack']} bytes "
                  f"of stack, spills {v['spill_stores']} B stored and "
                  f"{v['spill_loads']} B loaded")
    stage_numbers = {k: {} for k, _ in STAGE_KERNELS}
    traced = {"K9": "SVC base-mode frame", "K10": "SVC base-mode frame",
              "K11": f"{LANES}-lane P step", "K12": f"{LANES}-lane P step",
              "K13": "denoise path P frame"}
    for kernel, calls in stages["calls"].items():
        for what, args in calls.items():
            stage_numbers[kernel][what] = check_stage(
                kernel, to_device(args, "cuda"), f"the {what}'s inputs", label,
                trace=what == traced[kernel] or kernel == "K12")
    stages["calls"].clear()
    odd = ("cropped 1917x1079 frames at an odd address (2 lanes)",
           odd_planes(((1079, 1917), (539, 958), (539, 958)), 2, 13))
    stage_numbers["K12"][odd[0]] = check_stage(
        "K12", (odd[1], WIDTH // 16, HEIGHT // 16), f"{odd[0]}", label,
        trace=True)
    del odd
    torch.cuda.empty_cache()
    pre_numbers = pre_parts(lane_frames(frames, 2 + TIMED_STEPS),
                            WIDTH // 16, HEIGHT // 16, label)
    torch.cuda.empty_cache()
    print(f"  K9 to K12 checks {time.perf_counter() - t0:.1f} s")

    # 22. the denoise path: H264Encoder at 1080p, speed 0, QP 33, the
    # temporal denoise on a sub-pel noise pan: IDR, P, P
    t0 = time.perf_counter()
    dn = H264Encoder(dataclasses.replace(cfg, temporal_denoise_flag=True))
    dn_run = dataclasses.replace(run, encode_speed=SEQ_SPEED)
    dn_frames = list(noise_pan_sequence(WIDTH, HEIGHT, 3))
    dn_seen, dn_calls = [], []
    reset_launches()
    with plain_stages_on_card(dn_seen), \
            recorded_calls("denoise_planes", dn_calls, "ops.denoise"):
        for t, kind in enumerate(("IDR", "P", "P")):
            if t == 2:
                dn.stage_times = {}
            t1 = time.perf_counter()
            res = dn.encode(*dn_frames[t], dn_run)
            s = time.perf_counter() - t1
            _require(res.frame_type == kind and len(res.payload) > 0,
                     f"denoise path frame {t} is {res.frame_type}, not "
                     f"{kind}")
            print(f"denoise path frame {t} ({kind}) {label}: {s:.3f} s"
                  + (", stage syncs inside" if t == 2 else
                     " (first use)" if t < 2 else "")
                  + f"; {len(res.payload)} B")
    for k, v in dn.stage_times.items():
        print(f"  stage {k:8s} {1e3 * v:10.2f} ms {label}")
    dn.stage_times = None
    _require(not dn_seen, f"plain padding or denoise on the card in the "
             f"denoise path: {sorted(set(dn_seen))}")
    _require(len(dn_calls) == 2 and all(
        a[0][0].is_cuda for a in dn_calls), f"the denoise path's "
        f"{len(dn_calls)} denoise calls")
    # K11 and K12 once per frame, K13 once per frame after the first
    require_stage_launches(stages, "denoise", "the denoise path's 3 frames",
                           (0, 0, 3, 3, 2))
    stage_numbers["K13"][traced["K13"]] = check_stage(
        "K13", dn_calls[-1], "the 1080p denoise path's second P frame's "
        "planes", label, trace=True)
    del dn, dn_frames, dn_calls
    torch.cuda.empty_cache()
    # the traces hold the kernel and no other
    for kernel, name in (("K9", "downsample_kernel"),
                         ("K10", "upsample_kernel"),
                         ("K11", "reference_planes_kernel"),
                         ("K12", "pad_tiles_kernel"),
                         ("K13", "denoise_kernel")):
        for what, v in stage_numbers[kernel].items():
            seen = [k for k, _ in v["kernels"]]
            _require(seen in ([], [name]), f"{kernel}'s traced kernels on "
                     f"{what}: {seen}")
    print(f"  the denoise path and K13 {time.perf_counter() - t0:.1f} s")

    # phase 5's decode
    t0 = time.perf_counter()
    decode_s = decoding.result()
    pool.shutdown()
    print(f"lane 0 steps 0 and 1 decode bit-exactly to the card's recon "
          f"(waited {time.perf_counter() - t0:.1f} s for the worker); decode "
          f"seconds per {WIDTH}x{HEIGHT} frame {label} (the port's numpy "
          f"decoder, a host time beside phases 6 to 22): IDR "
          f"{decode_s[0]:.2f}, P {decode_s[1]:.2f}")

    # 23. results: K1's, K2's, K4's, K6's, K7's, K8's, K11's and K12's
    # entries hold the GOP path's P step (19 of 20 frames of a GOP), K3's
    # its IDR step, K5's the speed-0 P frame, K9's and K10's the SVC
    # base-mode frame, K13's the denoise path's P frame; their launches
    # count every path
    p, i, q = numbers["P"], numbers["IDR"], numbers["seq"]
    bm, bp = numbers["SVC base-mode"], numbers["SVC base P"]
    m = numbers["mesh"]
    kernels = [dict(
        name="bitpack", route="cuda",
        source="h264lab_tpu_torch/csrc/bitpack.cu",
        replaces="h264lab_tpu/ops/bitpack.py:152",
        launches=launches + seq_launches + svc_launches + mesh_launches,
        equal=True,
        max_abs_err=max_err,
        ms=p["ms"], plain_ms=p["plain_ms"], bound_ms=p["bound_ms"],
        bound_by="bytes", library_ms=None, grid="P step",
        idr_ms=i["ms"], idr_plain_ms=i["plain_ms"],
        idr_bound_ms=i["bound_ms"], gop_launches=launches,
        seq_launches=seq_launches, seq_ms=q["ms"], seq_plain_ms=q["plain_ms"],
        seq_bound_ms=q["bound_ms"], svc_launches=svc_launches,
        svc_bm_ms=bm["ms"], svc_bm_plain_ms=bm["plain_ms"],
        svc_bm_bound_ms=bm["bound_ms"], svc_base_p_ms=bp["ms"],
        svc_base_p_plain_ms=bp["plain_ms"],
        svc_base_p_bound_ms=bp["bound_ms"], mesh_launches=mesh_launches,
        mesh_ms=m["ms"], mesh_plain_ms=m["plain_ms"],
        mesh_bound_ms=m["bound_ms"])]
    k2p = k2_numbers["P"]
    kernels.append(dict(
        name="deblock", route="cuda",
        source="h264lab_tpu_torch/csrc/deblock.cu",
        replaces="h264lab_tpu/models/mbscan.py:793 (XLA scan, no Pallas "
                 "kernel)",
        launches=(db_launches + seq_db_launches + svc_db_launches
                  + mesh_db_launches),
        equal=True,
        max_abs_err=max(v["max_abs_err"] for v in k2_numbers.values()),
        ms=k2p["ms"], plain_ms=k2p["plain_ms"], bound_ms=k2p["bound_ms"],
        bound_by="bytes", library_ms=None, grid="P step",
        gop_launches=db_launches, seq_launches=seq_db_launches,
        svc_launches=svc_db_launches, mesh_launches=mesh_db_launches,
        inputs={k: dict(ms=v["ms"], stage_ms=v["stage_ms"],
                        plain_ms=v["plain_ms"], bound_ms=v["bound_ms"])
                for k, v in k2_numbers.items()}))
    k3i = k3_numbers["IDR"]
    kernels.append(dict(
        name="wavefront", route="cuda",
        source="h264lab_tpu_torch/csrc/wavefront.cu",
        replaces="h264lab_tpu/models/mbscan.py:541 with h264lab_tpu/ops/"
                 "intra4.py:175 (XLA scans, no Pallas kernel)",
        launches=(wf_launches + seq_wf_launches + svc_wf_launches
                  + mesh_wf_launches + entry_wf_launches),
        equal=True,
        max_abs_err=max(v["max_abs_err"] for v in k3_numbers.values()),
        ms=k3i["ms"], plain_ms=k3i["plain_ms"], bound_ms=k3i["bound_ms"],
        bound_by=k3i["bound_by"], library_ms=None, grid="IDR step",
        gop_launches=wf_launches, seq_launches=seq_wf_launches,
        svc_launches=svc_wf_launches, mesh_launches=mesh_wf_launches,
        entry_launches=entry_wf_launches, ptxas=ptxas["K3"],
        resident_blocks_per_sm=k3_resident,
        resident_clusters=k3_clusters,
        inputs={k: dict(ms=v["ms"], us_per_step=v["us_per_step"],
                        cluster=v["cluster"],
                        stage_ms=v["stage_ms"], plain_ms=v["plain_ms"],
                        bound_ms=v["bound_ms"], bound_by=v["bound_by"])
                for k, v in k3_numbers.items()}))
    k4p = k4_numbers["16-lane P step"]
    kernels.append(dict(
        name="me", route="cuda", source="h264lab_tpu_torch/csrc/me.cu",
        replaces="h264lab_tpu/ops/me.py:385 (XLA fori_loops, no Pallas "
                 "kernel)",
        launches=(me_launches + seq_me_launches + svc_me_launches
                  + mesh_me_launches),
        equal=True,
        max_abs_err=max(v["max_abs_err"] for v in k4_numbers.values()),
        ms=k4p["ms"], plain_ms=k4p["plain_ms"], bound_ms=k4p["bound_ms"],
        bound_by=k4p["bound_by"], library_ms=None, grid="P step",
        gop_launches=me_launches, seq_launches=seq_me_launches,
        svc_launches=svc_me_launches, mesh_launches=mesh_me_launches,
        cif_launches=cif_me[0], ptxas=ptxas["K4 and K5"],
        kernel_launches_per_call=len(k4_kernels),
        device_us=k4_kernels[0][1], occupancy=k4_occ,
        inputs={k: dict(ms=v["ms"], plain_ms=v["plain_ms"],
                        bound_ms=v["bound_ms"], bound_by=v["bound_by"])
                for k, v in k4_numbers.items()}))
    k5s = k5_numbers["speed-0 P frame"]
    kernels.append(dict(
        name="partition", route="cuda", source="h264lab_tpu_torch/csrc/me.cu",
        replaces="h264lab_tpu/ops/me.py:575 (XLA, no Pallas kernel)",
        launches=seq_part_launches, equal=True,
        max_abs_err=max(v["max_abs_err"] for v in k5_numbers.values()),
        ms=k5s["ms"], plain_ms=k5s["plain_ms"], bound_ms=k5s["bound_ms"],
        bound_by=k5s["bound_by"], bound_ms_old_count=k5s[
            "bound_ms_old_count"], library_ms=None, grid="speed-0 P frame",
        seq_launches=seq_part_launches, cif_launches=cif_me[1],
        ptxas=k5_ptxas, kernel_launches_per_call=len(k5_kernels),
        device_us=k5_kernels[0][1], occupancy=k5_occ,
        inputs={k: dict(ms=v["ms"], plain_ms=v["plain_ms"],
                        bound_ms=v["bound_ms"], bound_by=v["bound_by"],
                        bound_ms_old_count=v["bound_ms_old_count"])
                for k, v in k5_numbers.items()}))
    k6p = k6_numbers[f"{LANES}-lane P step"]
    kernels.append(dict(
        name="symbolize", route="cuda",
        source="h264lab_tpu_torch/csrc/symbolize.cu",
        replaces="h264lab_tpu/models/mbscan.py:1046 with h264lab_tpu/ops/"
                 "cavlc.py:107 (XLA lax.scan, no Pallas kernel)",
        launches=(sym_launches + seq_sym_launches + svc_sym_launches
                  + mesh_sym_launches + entry_sym_launches),
        equal=True,
        max_abs_err=max(v["max_abs_err"] for v in k6_numbers.values()),
        ms=k6p["ms"], plain_ms=k6p["plain_ms"], bound_ms=k6p["bound_ms"],
        bound_by="bytes", library_ms=None, grid="P step",
        gop_launches=sym_launches, seq_launches=seq_sym_launches,
        svc_launches=svc_sym_launches, mesh_launches=mesh_sym_launches,
        entry_launches=entry_sym_launches, cif_launches=cif_sym_launches,
        cli_launches=cli_sym_launches,
        svc_base_mode_launches=svc_bm_launches, ptxas=k6_ptxas,
        build=k6_build,
        kernel_launches_per_call=len(k6p["kernels"]),
        traced_kernels=[k for k, _ in k6p["kernels"]],
        traces_taken=k6p["traces"],
        device_us=k6p["device_us"],
        inputs={k: dict(ms=v["ms"], stage_ms=v["stage_ms"],
                        plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                        device_us=v["device_us"],
                        kernels=[k for k, _ in v["kernels"]])
                for k, v in k6_numbers.items()}))
    for kernel, name, numbers_of, replaces, source in (
            ("K7", "inter_residual", k7_numbers,
             "h264lab_tpu/models/mbscan.py:221-293 (XLA, no Pallas kernel)",
             "h264lab_tpu_torch/csrc/inter.cu"),
            ("K8", "select_parallel", k8_numbers,
             "h264lab_tpu/models/mbscan.py:338-405 and :415-428 (XLA, no "
             "Pallas kernel)", "h264lab_tpu_torch/csrc/select.cu")):
        main = numbers_of[f"{LANES}-lane P step"]
        launches = {path: v[0 if kernel == "K7" else 1]
                    for path, v in residual["launches"].items()}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(launches[k] for k in ("gop", "seq", "svc",
                                               "mesh")),
            equal=True,
            max_abs_err=max(v["max_abs_err"] for v in numbers_of.values()),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by="bytes", library_ms=None,
            grid="P step", host_us=main["host_us"],
            device_us=main["device_us"], path_launches=launches,
            svc_base_mode_launches=svc_bm_launches if kernel == "K7" else 0,
            ptxas=ptxas[kernel], build=res_build[kernel],
            traced_kernels=[k for k, _ in main["kernels"]],
            inputs={k: dict(ms=v["ms"], stage_ms=v["stage_ms"],
                            plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                            host_us=v["host_us"], device_us=v["device_us"])
                    for k, v in numbers_of.items()}))
    for kernel, name, source, replaces in (
            ("K9", "resample_down", "h264lab_tpu_torch/csrc/resample.cu",
             "h264lab_tpu/ops/resample.py:26 (XLA, no Pallas kernel)"),
            ("K10", "resample_up", "h264lab_tpu_torch/csrc/resample.cu",
             "h264lab_tpu/ops/resample.py:56 and :64 with h264lab_tpu/"
             "models/svc.py:316-330 (XLA, no Pallas kernel)"),
            ("K11", "refplanes", "h264lab_tpu_torch/csrc/refplanes.cu",
             "h264lab_tpu/models/refstate.py:28-47 (XLA, no Pallas "
             "kernel)"),
            ("K12", "pad_tiles", "h264lab_tpu_torch/csrc/pretile.cu",
             "h264lab_tpu/models/wavefront.py:70-75 (numpy on the host) "
             "with h264lab_tpu/parallel/gop.py:94-106 (XLA, no Pallas "
             "kernel)"),
            ("K13", "denoise", "h264lab_tpu_torch/csrc/denoise.cu",
             "h264lab_tpu/ops/denoise.py:23-41 (XLA, no Pallas kernel)")):
        numbers_of = stage_numbers[kernel]
        main = numbers_of[traced[kernel]]
        i = [k for k, _ in STAGE_KERNELS].index(kernel)
        launches = {path: v[i] for path, v in stages["launches"].items()}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(launches.values()), equal=True,
            max_abs_err=max(v["max_abs_err"] for v in numbers_of.values()),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by="bytes", library_ms=None,
            grid=traced[kernel], host_us=main["host_us"],
            device_us=main["device_us"], path_launches=launches,
            tile_tensors=copies.get(kernel, [None])[0],
            tile_copies=copies.get(kernel, [None, None])[1],
            ptxas=[x for x in ptxas["K9 and K10" if kernel in ("K9", "K10")
                                    else kernel]
                   if x.startswith(("downsample" if kernel == "K9" else
                                    "upsample" if kernel == "K10" else
                                    ""))],
            pre_parts=pre_numbers if kernel == "K12" else None,
            inputs={k: dict(ms=v["ms"], stage_ms=v["stage_ms"],
                            plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                            host_us=v["host_us"], device_us=v["device_us"])
                    for k, v in numbers_of.items()}))
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s "
          "(the build included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
