"""Numeric constant tables from the H.264 specification (ITU-T Rec. H.264).

Only spec-defined constants live here (quantization scale factors, scan
orders, chroma QP mapping, CAVLC VLC tables, deblocking thresholds).
Encoder *tuning* constants (deadzones, lambdas, thresholds) live in
`h264lab_tpu_torch/ops/tuning.py`.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Quantization (spec 8.5.9 / JM encoder tables)
# ---------------------------------------------------------------------------

# Forward quantizer multipliers MF (per qp%6, per position class a/b/c):
# class a = (0,0),(0,2),(2,0),(2,2); class b = (1,1),(1,3),(3,1),(3,3);
# class c = the rest. level = (|W|*MF + f) >> (15 + qp//6).
QUANT_MF = np.array([
    [13107, 5243, 8066],
    [11916, 4660, 7490],
    [10082, 4194, 6554],
    [9362, 3647, 5825],
    [8192, 3355, 5243],
    [7282, 2893, 4559],
], dtype=np.int32)

# Dequantizer scale V (spec LevelScale4x4): W' = level * V << (qp//6)
DEQUANT_V = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], dtype=np.int32)

# Position class per raster index in a 4x4 block: 0=a, 1=b, 2=c
POS_CLASS = np.array([
    0, 2, 0, 2,
    2, 1, 2, 1,
    0, 2, 0, 2,
    2, 1, 2, 1,
], dtype=np.int32)

# Chroma QP mapping (spec Table 8-15), indexed by clipped luma QP 0..51
QPC_FROM_QPY = np.array(
    list(range(30)) +
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35,
     36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39],
    dtype=np.int32)
assert len(QPC_FROM_QPY) == 52

# ---------------------------------------------------------------------------
# Scan orders (spec 8.5.6)
# ---------------------------------------------------------------------------

# zigzag[i] = raster index of i-th coefficient in zig-zag scan order
ZIGZAG_4x4 = np.array(
    [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15], dtype=np.int32)

# inverse: raster index -> scan position
ZIGZAG_4x4_INV = np.argsort(ZIGZAG_4x4).astype(np.int32)

# 4x4 luma block coding order within a macroblock (spec figure 6-10):
# blocks are coded in 8x8 quadrant order, raster within each quadrant.
# BLOCK_SCAN[k] = raster(4x4-grid) index of the k-th coded block.
BLOCK_SCAN_4x4 = np.array(
    [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15], dtype=np.int32)
BLOCK_SCAN_4x4_INV = np.argsort(BLOCK_SCAN_4x4).astype(np.int32)

# ---------------------------------------------------------------------------
# Coded block pattern mapping (spec Table 9-4): cbp -> codeNum for ue(v)
# column 0: Intra_4x4 / Intra_NxN, column 1: Inter
# ---------------------------------------------------------------------------
CBP_TO_CODENUM = np.array([
    # (intra, inter) indexed by coded_block_pattern 0..47
    (3, 0), (29, 2), (30, 3), (17, 7), (31, 4), (18, 8), (37, 17), (8, 13),
    (32, 5), (38, 18), (19, 9), (9, 14), (20, 10), (10, 15), (11, 16), (2, 11),
    (16, 1), (33, 32), (34, 33), (21, 36), (35, 34), (22, 37), (39, 44), (4, 40),
    (36, 35), (40, 45), (23, 38), (5, 41), (24, 39), (6, 42), (7, 43), (1, 19),
    (41, 6), (42, 24), (43, 25), (25, 20), (44, 26), (26, 21), (46, 46), (12, 28),
    (45, 27), (47, 47), (27, 22), (13, 29), (28, 23), (14, 30), (15, 31), (0, 12),
], dtype=np.int32)

# ---------------------------------------------------------------------------
# Deblocking filter thresholds (spec Table 8-16): alpha, beta indexed by
# indexA/indexB 0..51; tc0 (Table 8-17) indexed by [indexA][bS-1]
# ---------------------------------------------------------------------------
ALPHA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
    32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144,
    162, 182, 203, 226, 255, 255], dtype=np.int32)

BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
    9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15,
    16, 16, 17, 17, 18, 18], dtype=np.int32)

TC0_TABLE = np.array([
    [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
    [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0],
    [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 0], [0, 0, 1],
    [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1], [1, 1, 1],
    [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2], [1, 1, 2],
    [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4], [2, 3, 4],
    [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7], [4, 5, 8],
    [5, 6, 9], [6, 7, 10], [6, 8, 11], [7, 9, 13], [8, 10, 16], [9, 12, 18],
    [10, 13, 20], [11, 15, 23], [13, 17, 25], [13, 17, 25]], dtype=np.int32)
