// K7's and K8's tables, written by `python -m h264lab_tpu_torch.ops.residual` from
// ops/tables.py, ops/me.py and models/mbscan.py. Do not edit.
#pragma once
#define TQ_SEL_INTER 0
#define TQ_SEL_I16 1
#define TQ_QUANT_MF {13107, 5243, 8066, 11916, 4660, 7490, 10082, 4194, 6554, 9362, 3647, 5825, 8192, 3355, 5243, 7282, 2893, 4559}
#define TQ_DEQUANT_V {10, 16, 13, 11, 18, 14, 13, 20, 16, 14, 23, 18, 16, 25, 20, 18, 29, 23}
#define TQ_LAMBDA_ME {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 23, 26, 29, 33, 37, 41, 46, 52, 59, 66, 74, 83}
#define TQ_POS_CLASS(i) ((int)((0x66886688u >> (2 * (i))) & 3u))
