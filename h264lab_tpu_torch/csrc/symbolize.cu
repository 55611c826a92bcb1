// K6 of h264lab_tpu_torch: CAVLC symbolization (spec 7.3.5 and 9.2) of a
// batch of I or P slices, the whole `sym` stage, written by hand for
// NVIDIA Hopper (sm_90a).
//
// Replaces h264lab_tpu/models/mbscan.py:1046 `symbolize`, which the JAX
// package left to XLA (no Pallas kernel), with its block coder
// h264lab_tpu/ops/cavlc.py:107 `encode_blocks` (the 16-step `lax.scan` of
// the level suffix at :194). It takes what the port's plain version
// `symbolize_plain` (models/mbscan.py) takes, in the form
// `mbscan.symbolize_args` packs, and writes what it returns, array for
// array and slot for slot: the (n, nmb, 952) grid of every MB's syntax
// and residual codes (values as uint32 bit patterns in int32, lengths),
// the slice tails, the bit counts, skip, cbp, cbpc, the MV differences
// and, with a row QP plan, the decoded per-MB QPs. A slot whose length is
// 0 keeps the value the plain version computes there too (a luma block
// outside the cbp, the DC unit of a non-I16 MB, the `1` of an inactive
// sub_mb_type, ...): K1 ignores them, the tests compare them.
//
// Bound. Each output is written once, 7,616 B of grid per MB and about
// 41 B of the others, and each input that an output depends on is read
// once: of every MB sel, cmode, the Intra 4x4 symbol values, the luma DC
// and chroma levels (the plain version keeps their codes in slots of
// length 0 too) and its luma levels, lev_inter's if it is inter, else
// ac_lev's (1,704 B); on P slices its MVs and shape too (132 B: an intra
// MB's MV differences are outputs); mode16 of an I16 MB, the Intra 4x4
// lengths of an I4 MB. About 9.5 KB per MB of a P slice, 0.37 ms for 16
// frames of 1080p at 3.35 TB/s. The arithmetic is small (a few hundred
// integer operations per block), so the bytes bound it.
//
// Design: three launches, in stream order.
//   A. records (`sym_records_kernel`): a warp per MB. The lanes load the MB's
//      luma levels (lev_inter's or ac_lev's, as its type needs) and chroma
//      AC levels in 16-byte pieces, count each 4x4 block's nonzeros with
//      shuffles and derive cbp, cbpc and the coded nonzero counts that
//      nC reads (luma of inter, Intra_4x4 and coded Intra_16x16 MBs,
//      chroma AC where cbpc is 2; a skipped MB has cbp 0, so skipping
//      changes no count). Lanes 0-3 derive the MV predictor of each
//      partition of the MB's shape and lane 4 the 16x16 one and P_Skip's
//      (spec 8.4.1.1 and 8.4.1.3, as `_mv_predictors` lists them), from
//      the neighbours' MVs and intra flags, which are inputs. It writes
//      skip, cbp, cbpc, the MV differences and a 32-byte record per MB:
//      the 16 luma and 8 chroma AC coded counts.
//   B. slice scans (`sym_scan_kernel`): a block of 1024 threads per slice
//      walks its MBs in chunks of 1024 with a carry: a max-scan of the
//      coded MBs' indices gives each coded MB its mb_skip_run and the
//      slice its trailing run (the tail); a max-scan of the MBs that carry
//      mb_qp_delta gives, under a row plan, each MB's dQP and decoded QP.
//      It sets total_bits to the tail's length and row_bits to 0.
//   C. codes (`sym_codes_kernel`): a warp per MB, 4 warps a block. The MB's
//      own record and its left and upper neighbours' (within the slice:
//      a band's first row has no upper neighbour) go to shared memory.
//      Lane u codes unit u of the MB for u = 1..27 (the luma DC, the 16
//      luma blocks in BLOCK_SCAN_4x4 order, chroma DC, chroma AC) with
//      `encode_blocks`' sequence, walking the block's positions in
//      reverse scan once for TrailingOnes and once for the levels (with
//      the suffixLength recurrence) and the runs; lanes 0 and 28-31 build
//      the 34 header slots. The units are staged in shared memory (7.6
//      KB a warp) and written out with 16-byte stores; lane 0 adds the
//      MB's bits to its row's and its slice's counts (integer atomics:
//      the sums are exact in any order).
// No launch reads a ticket or a look-back buffer, so the wrapper zeroes
// nothing; the records and the scans' results go to one scratch tensor.
//
// The tables (coeff_token, total_zeros, run_before, the coded block
// pattern's code numbers, the zig-zag and block scans, the partitions)
// are K6_* macros in symbolize_tables.h, which `ops/symbolize.py` writes
// from ops/tables.py, ops/tables_cavlc.py and models/mbscan.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "symbolize_tables.h"

namespace {

constexpr int kSlots = 34;                  // slots per unit
constexpr int kUnits = 28;                  // units per MB
constexpr int kMbSlots = kSlots * kUnits;   // 952
constexpr int kRecBytes = 32;               // bytes of an MB's record
constexpr int kWarpsA = 8;                  // warps (MBs) per block, pass A
constexpr int kWarpsC = 4;                  // pass C
constexpr int kScanThreads = 1024;          // pass B

// VLC tables, each entry value | length << 16
__device__ const uint32_t kCoeffToken[] = K6_COEFF_TOKEN;    // [5][17][4]
__device__ const uint32_t kTotalZeros[] = K6_TOTAL_ZEROS;    // [16][16]
__device__ const uint32_t kTotalZerosCdc[] = K6_TOTAL_ZEROS_CDC;  // [4][4]
__device__ const uint32_t kRunBefore[] = K6_RUN_BEFORE;      // [8][15]
__device__ const int32_t kCbpCode[] = K6_CBP_TO_CODENUM;     // [48][2]

struct Args {
  const int32_t *sel, *mode16, *cmode, *shape, *i4v, *i4l, *mvy, *mvx;
  const int32_t *dc, *ac, *inter, *cdc, *cac, *qp_rows;
  int32_t *vals, *lens, *tail_val, *tail_len, *total_bits, *row_bits;
  int32_t *cbp, *cbpc, *mvd_py, *mvd_px, *qp_dec;
  uint8_t* skip;
  uint8_t* rec;       // (n, nmb, 32) records
  int32_t* scan;      // (n, nmb, 2): mb_skip_run, dQP
  long long n;
  int mbw, mbh, has_inter, base_mode_bit, has_plan;
};

__device__ __forceinline__ int bitlen(int v) {
  return v > 0 ? 32 - __clz(v) : 0;
}
// ue(v) and se(v) Exp-Golomb codes (`mbscan._ue_codes`, `_se_codes`)
__device__ __forceinline__ int ue_val(int v) { return v + 1; }
__device__ __forceinline__ int ue_len(int v) { return 2 * bitlen(v + 1) - 1; }
__device__ __forceinline__ int se_map(int v) {
  return v > 0 ? 2 * v - 1 : -2 * v;
}

__device__ __forceinline__ int count_nz(int4 q) {
  return (q.x != 0) + (q.y != 0) + (q.z != 0) + (q.w != 0);
}

__device__ __forceinline__ int median3(int a, int b, int c) {
  return max(min(max(a, b), c), min(a, b));
}

// ---------------------------------------------------------------------------
// pass A: records, cbp, skip, MV differences
// ---------------------------------------------------------------------------

struct Nb {
  int y, x;
  bool ref, avail;
};

// The 4x4 block at MB-relative block offset (dy, dx) of MB (r, c) in its
// slice's block grid (`_mv_predictors`' `blk`): available inside the grid
// where `stat` (the static availability of decode order) allows it, a
// reference when its MB is inter, its MV 0 otherwise.
__device__ Nb nb_block(const Args& a, long long slice, int r, int c, int dy,
                       int dx, bool stat) {
  const int gy = 4 * r + dy, gx = 4 * c + dx;
  Nb o{0, 0, false,
       stat && gy >= 0 && gy < 4 * a.mbh && gx >= 0 && gx < 4 * a.mbw};
  if (o.avail) {
    const long long mb = slice + (gy >> 2) * a.mbw + (gx >> 2);
    if (a.sel[mb] == K6_SEL_INTER) {
      const int b = (gy & 3) * 4 + (gx & 3);
      o.y = a.mvy[mb * 16 + b];
      o.x = a.mvx[mb * 16 + b];
      o.ref = true;
    }
  }
  return o;
}

// Neighbours A, B, C, D of one partition: (dy, dx, static availability)
// each, and the directional rule (0 none, 1 A, 2 B, 3 C), as
// `_mv_predictors` lists them for shape s, partition p.
struct PartSpec {
  int8_t v[4][3];
  int8_t dir;
};

__device__ __forceinline__ PartSpec part_spec(int s, int p) {
  // shape 0; shape 1 (16x8) p 0, 1; shape 2 (8x16) p 0, 1; shape 3 p 0-3
  const int k = s == 0 ? 0 : s == 1 ? 1 + p : s == 2 ? 3 + p : 5 + p;
  switch (k) {
    case 0: return {{{0, -1, 1}, {-1, 0, 1}, {-1, 4, 1}, {-1, -1, 1}}, 0};
    case 1: return {{{0, -1, 1}, {-1, 0, 1}, {-1, 4, 1}, {-1, -1, 1}}, 2};
    case 2: return {{{2, -1, 1}, {1, 0, 1}, {0, 0, 0}, {1, -1, 1}}, 1};
    case 3: return {{{0, -1, 1}, {-1, 0, 1}, {-1, 2, 1}, {-1, -1, 1}}, 1};
    case 4: return {{{0, 1, 1}, {-1, 2, 1}, {-1, 4, 1}, {-1, 1, 1}}, 3};
    case 5: return {{{0, -1, 1}, {-1, 0, 1}, {-1, 2, 1}, {-1, -1, 1}}, 0};
    case 6: return {{{0, 1, 1}, {-1, 2, 1}, {-1, 4, 1}, {-1, 1, 1}}, 0};
    case 7: return {{{2, -1, 1}, {1, 0, 1}, {1, 2, 1}, {1, -1, 1}}, 0};
    default: return {{{2, 1, 1}, {1, 2, 1}, {0, 0, 0}, {1, 1, 1}}, 0};
  }
}

// The MV predictor of one partition (spec 8.4.1.3, `derive`).
__device__ void predict(const Args& a, long long slice, int r, int c,
                        const PartSpec& sp, int& py, int& px) {
  const Nb na = nb_block(a, slice, r, c, sp.v[0][0], sp.v[0][1], sp.v[0][2]);
  Nb nb = nb_block(a, slice, r, c, sp.v[1][0], sp.v[1][1], sp.v[1][2]);
  Nb nc = nb_block(a, slice, r, c, sp.v[2][0], sp.v[2][1], sp.v[2][2]);
  const Nb nd = nb_block(a, slice, r, c, sp.v[3][0], sp.v[3][1], sp.v[3][2]);
  const bool cav2 = nc.avail || nd.avail;
  if (!nc.avail) {                       // C unavailable: D
    nc.y = nd.y;
    nc.x = nd.x;
    nc.ref = nd.ref;
  }
  if (!nb.avail && !cav2 && na.avail) {  // only A available: B = C = A
    nb.y = nc.y = na.y;
    nb.x = nc.x = na.x;
    nb.ref = nc.ref = na.ref;
  }
  const int cnt = na.ref + nb.ref + nc.ref;
  if (cnt == 1 && na.ref) {
    py = na.y; px = na.x;
  } else if (cnt == 1 && nb.ref) {
    py = nb.y; px = nb.x;
  } else if (cnt == 1 && nc.ref) {
    py = nc.y; px = nc.x;
  } else {
    py = median3(na.y, nb.y, nc.y);
    px = median3(na.x, nb.x, nc.x);
  }
  if (sp.dir == 1 && na.ref) { py = na.y; px = na.x; }
  if (sp.dir == 2 && nb.ref) { py = nb.y; px = nb.x; }
  if (sp.dir == 3 && nc.ref) { py = nc.y; px = nc.x; }
}

// 16-bit mask of the blocks whose count is nonzero, from two ballots in
// which lane 4b + j (j < 4) holds block b (first) and block 8 + b (second)
__device__ __forceinline__ uint32_t block_mask(uint32_t b0, uint32_t b1) {
  uint32_t m = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    m |= (((b0 >> (4 * b)) & 1u) << b) | (((b1 >> (4 * b)) & 1u) << (b + 8));
  return m;
}

// coded_block_pattern luma bits of a 16-bit block mask (`cbp_luma_bits`)
__device__ __forceinline__ int cbp_bits(uint32_t m) {
  return ((m & 0x0033u) != 0) | (((m & 0x00CCu) != 0) << 1)
         | (((m & 0x3300u) != 0) << 2) | (((m & 0xCC00u) != 0) << 3);
}

__global__ void __launch_bounds__(kWarpsA * 32)
sym_records_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long nmb = (long long)a.mbw * a.mbh;
  const long long g = (long long)blockIdx.x * kWarpsA + (threadIdx.x >> 5);
  if (g >= a.n * nmb) return;
  const long long slice = g - g % nmb;
  const int m = (int)(g % nmb), r = m / a.mbw, c = m % a.mbw;
  const int sel = a.sel[g];
  const bool is_inter = sel == K6_SEL_INTER, is_i4 = sel == K6_SEL_I4;

  // nonzero counts: lane 4b + j reads piece j of block b and of block 8 + b
  // of the MB's luma levels, lev_inter's if it is inter, else ac_lev's
  const int4* lv = reinterpret_cast<const int4*>(
      (is_inter ? a.inter : a.ac) + g * 256);
  const int4* ca = reinterpret_cast<const int4*>(a.cac + g * 128);
  int n_l0 = count_nz(lv[lane]), n_l1 = count_nz(lv[lane + 32]);
  int n_ca = count_nz(ca[lane]);
  const bool cdc_nz = lane < 8 && a.cdc[g * 8 + lane] != 0;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    n_l0 += __shfl_xor_sync(0xffffffffu, n_l0, off);
    n_l1 += __shfl_xor_sync(0xffffffffu, n_l1, off);
    n_ca += __shfl_xor_sync(0xffffffffu, n_ca, off);
  }
  const uint32_t luma_m = block_mask(__ballot_sync(0xffffffffu, n_l0 > 0),
                                     __ballot_sync(0xffffffffu, n_l1 > 0));
  const bool cac_any = __any_sync(0xffffffffu, n_ca > 0);
  const bool cdc_any = __any_sync(0xffffffffu, cdc_nz);
  const bool cbpl_i16 = !is_inter && luma_m != 0;
  const int cbpc = cac_any ? 2 : cdc_any ? 1 : 0;
  const int cbp_luma = is_i4 || is_inter ? cbp_bits(luma_m)
                                         : (cbpl_i16 ? 15 : 0);
  const int cbp = cbp_luma + (cbpc << 4);
  const int shape = a.has_inter ? a.shape[g] : 0;

  // MV predictors: lanes 0-3 the partitions of the MB's shape, lane 4 the
  // 16x16 one and P_Skip's
  int py = 0, px = 0, mvd_y = 0, mvd_x = 0, skip = 0;
  if (a.has_inter) {
    if (lane < 4 && shape >= 0 && shape <= 3 && lane < K6_N_PARTS(shape)) {
      predict(a, slice, r, c, part_spec(shape, lane), py, px);
      const int by = K6_PART_BY(shape, lane), bx = K6_PART_BX(shape, lane);
      mvd_y = a.mvy[g * 16 + by * 4 + bx] - py;
      mvd_x = a.mvx[g * 16 + by * 4 + bx] - px;
    }
    if (lane == 4) {
      predict(a, slice, r, c, part_spec(0, 0), py, px);
      const Nb na = nb_block(a, slice, r, c, 0, -1, true);
      const Nb nb = nb_block(a, slice, r, c, -1, 0, true);
      const bool force0 = !na.avail || !nb.avail
                          || (na.ref && na.y == 0 && na.x == 0)
                          || (nb.ref && nb.y == 0 && nb.x == 0);
      skip = is_inter && shape == 0 && cbp == 0
             && a.mvy[g * 16] == (force0 ? 0 : py)
             && a.mvx[g * 16] == (force0 ? 0 : px);
    }
  }
  skip = __shfl_sync(0xffffffffu, skip, 4);
  if (lane < 4) {
    a.mvd_py[g * 4 + lane] = mvd_y;
    a.mvd_px[g * 4 + lane] = mvd_x;
  }
  if (lane == 0) {
    a.skip[g] = (uint8_t)skip;
    a.cbp[g] = cbp;
    a.cbpc[g] = cbpc;
  }
  // the record: luma counts nC reads (raster blocks), then chroma AC's
  if ((lane & 3) == 0) {
    const int b = lane >> 2;
    const bool luma = is_inter || is_i4 || cbpl_i16;
    const int l0 = skip || !luma ? 0 : n_l0;
    const int l1 = skip || !luma ? 0 : n_l1;
    uint8_t* rec = a.rec + g * kRecBytes;
    rec[b] = (uint8_t)l0;
    rec[8 + b] = (uint8_t)l1;
    rec[16 + b] = (uint8_t)(cbpc == 2 && !skip ? n_ca : 0);
  }
}

// ---------------------------------------------------------------------------
// pass B: the slice scans
// ---------------------------------------------------------------------------

// inclusive max-scan over the block's threads in thread order; `carry`
// (the chunk before) and `total` (the block's maximum) are read by all
__device__ __forceinline__ void block_max_scan(int v, int* totals, int& incl,
                                               int& excl, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int w = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, w, off);
    if (lane >= off) w = max(w, up);
  }
  int wex = __shfl_up_sync(0xffffffffu, w, 1);
  if (lane == 0) wex = -1;
  if (lane == 31) totals[warp] = w;
  __syncthreads();
  int before = -1;
  total = -1;
  for (int k = 0; k < kScanThreads / 32; ++k) {
    if (k < warp) before = max(before, totals[k]);
    total = max(total, totals[k]);
  }
  incl = max(before, w);
  excl = max(before, wex);
  __syncthreads();                      // `totals` is reused
}

__global__ void __launch_bounds__(kScanThreads)
sym_scan_kernel(const Args a) {
  __shared__ int totals[2][kScanThreads / 32];
  const int nmb = a.mbw * a.mbh;
  const long long slice = (long long)blockIdx.x * nmb;
  const int32_t* qrow = a.qp_rows + (a.has_plan ? blockIdx.x * a.mbh : 0);
  int carry_c = -1, carry_d = -1;        // last coded / dQP MB so far
  for (int s = 0; s < nmb; s += kScanThreads) {
    const int i = s + threadIdx.x;
    bool coded = false, dqp = false;
    if (i < nmb) {
      const long long g = slice + i;
      coded = !a.skip[g];
      dqp = coded && (a.sel[g] == K6_SEL_I16 || a.cbp[g] != 0);
    }
    int inc_c, exc_c, tot_c, inc_d, exc_d, tot_d;
    block_max_scan(coded ? i : -1, totals[0], inc_c, exc_c, tot_c);
    block_max_scan(dqp ? i : -1, totals[1], inc_d, exc_d, tot_d);
    exc_c = max(exc_c, carry_c);
    exc_d = max(exc_d, carry_d);
    inc_d = max(inc_d, carry_d);
    if (i < nmb) {
      const long long g = slice + i;
      int dqp_delta = 0;
      if (a.has_plan) {
        // the running QP: the QP of the last MB with mb_qp_delta, or the
        // plan's first row before any
        const int q = qrow[i / a.mbw];
        const int prev = exc_d >= 0 ? qrow[exc_d / a.mbw] : qrow[0];
        dqp_delta = q - prev;
        a.qp_dec[g] = inc_d >= 0 ? qrow[inc_d / a.mbw] : qrow[0];
      }
      a.scan[2 * g] = coded ? i - 1 - exc_c : 0;
      a.scan[2 * g + 1] = dqp_delta;
    }
    carry_c = max(carry_c, tot_c);
    carry_d = max(carry_d, tot_d);
  }
  for (int k = threadIdx.x; k < a.mbh; k += kScanThreads)
    a.row_bits[(long long)blockIdx.x * a.mbh + k] = 0;
  if (threadIdx.x == 0) {
    const int trailing = nmb - 1 - carry_c;
    const int tl = a.has_inter && trailing > 0 ? ue_len(trailing) : 0;
    a.tail_val[blockIdx.x] = a.has_inter ? ue_val(trailing) : 0;
    a.tail_len[blockIdx.x] = tl;
    a.total_bits[blockIdx.x] = tl;
  }
}

// ---------------------------------------------------------------------------
// pass C: the codes
// ---------------------------------------------------------------------------

// VLC of levelCode `lc` at suffixLength `sl` (`cavlc._level_code_bits`)
__device__ __forceinline__ void level_code(int lc, int sl, int& v, int& n) {
  const int prefix = lc >> sl;
  if (sl == 0 && lc < 14) {
    v = 1;
    n = lc + 1;
  } else if (sl == 0 && lc < 30) {
    v = (1 << 4) | (lc - 14);
    n = 19;
  } else if (sl > 0 && prefix < 15) {
    v = (1 << sl) | (lc & ((1 << sl) - 1));
    n = prefix + 1 + sl;
  } else {
    const int rem = lc - ((15 << sl) + (sl == 0 ? 15 : 0));
    if (rem < 4096) {
      v = (1 << 12) | rem;
      n = 28;
    } else {
      v = (1 << 13) | (rem - 4096);
      n = 30;
    }
  }
}

// One block's 34 slots (`cavlc.encode_blocks`): lv the levels in scan
// order (positions at and past max_coeff are 0), nc its nC (-1 for chroma
// DC, which also takes the chroma DC total_zeros table), `keep` whether
// its lengths stand. sv and sl are the unit's slots in shared memory, all
// 0. Returns the bits kept.
__device__ __forceinline__ int code_block(const int (&lv)[16], int nc,
                                          int max_coeff, bool keep, int* sv,
                                          int* sl) {
  uint32_t nz = 0;
#pragma unroll
  for (int p = 0; p < 16; ++p) nz |= (uint32_t)(lv[p] != 0) << p;
  const int total = __popc(nz);
  // TrailingOnes: the leading run of +-1 in reverse scan order, at most 3
  int t1 = 0, signs = 0, k = 0;
  bool ones = true;
#pragma unroll
  for (int p = 15; p >= 0; --p) {
    if (lv[p] != 0) {
      if (k < 3 && ones && (lv[p] == 1 || lv[p] == -1)) {
        ++t1;
        signs = (signs << 1) | (lv[p] < 0);
      } else {
        ones = false;
      }
      ++k;
    }
  }
  int bits = 0;
  auto put = [&](int slot, int v, int n) {
    sv[slot] = v;
    if (keep) {
      sl[slot] = n;
      bits += n;
    }
  };
  const int ctx = nc < 0 ? 4 : nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
  const uint32_t ct = kCoeffToken[(ctx * 17 + total) * 4 + t1];
  put(0, (int)(ct & 0xffffu), (int)(ct >> 16));
  put(1, signs, t1);
  // the levels past the trailing ones, with the adaptive suffixLength, and
  // run_before of every coefficient but the last
  int suffix = total > 10 && t1 < 3 ? 1 : 0;
  int prev = 0, first = 0;
  k = 0;
#pragma unroll
  for (int p = 15; p >= 0; --p) {
    const int l = lv[p];
    if (l != 0) {
      if (k == 0) {
        first = p;
      } else {
        const int zeros_left = prev - (total - k);
        if (zeros_left > 0) {
          const uint32_t rb = kRunBefore[min(zeros_left, 7) * 15
                                         + min(prev - p - 1, 14)];
          put(19 + k - 1, (int)(rb & 0xffffu), (int)(rb >> 16));
        }
      }
      if (k >= t1) {
        const int al = abs(l);
        int lc = 2 * (al - 1) + (l < 0);
        if (k == t1 && t1 < 3) lc -= 2;
        int v, n;
        level_code(max(lc, 0), suffix, v, n);
        put(2 + k, v, n);
        int next = suffix == 0 ? 1 : suffix;
        if (al > (3 << (next - 1))) ++next;
        suffix = min(next, 6);
      }
      prev = p;
      ++k;
    }
  }
  if (total > 0 && total < max_coeff) {
    const int tz = first + 1 - total;
    const uint32_t t = nc < 0
        ? kTotalZerosCdc[min(total, 3) * 4 + min(tz, 3)]
        : kTotalZeros[min(total, 15) * 16 + tz];
    put(18, (int)(t & 0xffffu), (int)(t >> 16));
  }
  return bits;
}

// nC of block (by, bx) of an n x n grid (`_block_nc`): counts at own[],
// left[] and top[] (the neighbour MBs' records, when they exist)
__device__ __forceinline__ int block_nc(const uint8_t* own,
                                        const uint8_t* left,
                                        const uint8_t* top, int n, int by,
                                        int bx, bool has_left, bool has_top) {
  const bool la = bx > 0 || has_left, ta = by > 0 || has_top;
  const int na = bx > 0 ? own[by * n + bx - 1] : la ? left[by * n + n - 1] : 0;
  const int nb = by > 0 ? own[(by - 1) * n + bx] : ta ? top[(n - 1) * n + bx]
                                                       : 0;
  return la && ta ? (na + nb + 1) >> 1 : la ? na : ta ? nb : 0;
}

__device__ __forceinline__ void load16(const int32_t* src, int (&raw)[16]) {
  const int4* q = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int4 v = q[j];
    raw[4 * j] = v.x;
    raw[4 * j + 1] = v.y;
    raw[4 * j + 2] = v.z;
    raw[4 * j + 3] = v.w;
  }
}

__global__ void __launch_bounds__(kWarpsC * 32)
sym_codes_kernel(const Args a) {
  __shared__ int4 stage_v[kWarpsC][kMbSlots / 4];
  __shared__ int4 stage_l[kWarpsC][kMbSlots / 4];
  __shared__ uint32_t recs[kWarpsC][3 * kRecBytes / 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nmb = (long long)a.mbw * a.mbh;
  const long long g = (long long)blockIdx.x * kWarpsC + warp;
  if (g >= a.n * nmb) return;
  const int m = (int)(g % nmb), r = m / a.mbw, c = m % a.mbw;
  const bool has_left = c > 0, has_top = r > 0;
  const long long n_i = g / nmb;

  int* sv = reinterpret_cast<int*>(stage_v[warp]);
  int* sl = reinterpret_cast<int*>(stage_l[warp]);
  for (int k = lane; k < kMbSlots / 4; k += 32) {
    stage_v[warp][k] = make_int4(0, 0, 0, 0);
    stage_l[warp][k] = make_int4(0, 0, 0, 0);
  }
  // the records of the MB, its left and its upper neighbour
  if (lane < 24) {
    const int w = lane & 7, which = lane >> 3;
    const bool there = which == 0 || (which == 1 ? has_left : has_top);
    const long long src = which == 0 ? g : which == 1 ? g - 1 : g - a.mbw;
    recs[warp][lane] = there ? reinterpret_cast<const uint32_t*>(
        a.rec + src * kRecBytes)[w] : 0u;
  }
  __syncwarp();
  const uint8_t* own = reinterpret_cast<const uint8_t*>(recs[warp]);
  const uint8_t* left = own + kRecBytes;
  const uint8_t* top = own + 2 * kRecBytes;

  const int sel = a.sel[g];
  const bool is_inter = sel == K6_SEL_INTER, is_i16 = sel == K6_SEL_I16;
  const bool is_i4 = sel == K6_SEL_I4;
  const int cbp = a.cbp[g], cbpc = a.cbpc[g];
  const bool coded = !a.skip[g];
  const bool cbpl_i16 = (cbp & 15) != 0;   // of MBs neither inter nor I4
  int bits = 0;
  int* uv = sv + lane * kSlots;
  int* ul = sl + lane * kSlots;
  auto put = [&](int slot, int v, int n, bool keep) {
    uv[slot] = v;
    if (keep) {
      ul[slot] = n;
      bits += n;
    }
  };

  if (lane >= 1 && lane < kUnits) {
    // a residual block: its levels in scan order, its nC and its mask
    constexpr int zz[16] = K6_ZIGZAG;
    constexpr int scan[16] = K6_BLOCK_SCAN;
    int raw[16];
    int view;                            // 0 zig-zag, 1 AC (zig-zag 1..15)
    int nc = -1, max_coeff = 16;
    bool keep;
    if (lane == 1) {                     // luma DC (Intra_16x16)
      load16(a.dc + g * 16, raw);
      view = 0;
      nc = block_nc(own, left, top, 4, 0, 0, has_left, has_top);
      keep = is_i16;
    } else if (lane < 18) {              // luma, BLOCK_SCAN_4x4 order
      int b = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j) b = lane - 2 == j ? scan[j] : b;
      load16((is_inter ? a.inter : a.ac) + (g * 16 + b) * 16, raw);
      view = is_i16 ? 1 : 0;
      max_coeff = is_i16 ? 15 : 16;
      nc = block_nc(own, left, top, 4, b >> 2, b & 3, has_left, has_top);
      const int grp = (b >> 3) * 2 + ((b & 3) >> 1);
      keep = is_i16 ? cbpl_i16
                    : coded && (is_inter || is_i4) && ((cbp >> grp) & 1);
    } else if (lane < 20) {              // chroma DC, raster 2x2
      const int4 q = reinterpret_cast<const int4*>(a.cdc + g * 8)[lane - 18];
#pragma unroll
      for (int j = 4; j < 16; ++j) raw[j] = 0;
      raw[0] = q.x;
      raw[1] = q.y;
      raw[2] = q.z;
      raw[3] = q.w;
      view = 2;
      max_coeff = 4;
      keep = cbpc >= 1 && coded;
    } else {                             // chroma AC
      const int k = lane - 20;
      load16(a.cac + (g * 8 + k) * 16, raw);
      view = 1;
      max_coeff = 15;
      nc = block_nc(own + 16 + (k & 4), left + 16 + (k & 4),
                    top + 16 + (k & 4), 2, (k >> 1) & 1, k & 1, has_left,
                    has_top);
      keep = cbpc == 2 && coded;
    }
    int lv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      lv[i] = view == 0 ? raw[zz[i]]
              : view == 1 ? (i < 15 ? raw[zz[i + 1]] : 0) : raw[i];
    bits = code_block(lv, nc, max_coeff, keep, uv, ul);
  } else if (lane == 0) {
    // header: mb_skip_run, base_mode_flag, mb_type, sub_mb_type, chroma
    // mode, coded_block_pattern, mb_qp_delta
    const int shape = a.shape[g];
    const bool is_intra = !is_inter;
    const int run = a.scan[2 * g], dqp_delta = a.scan[2 * g + 1];
    if (a.has_inter) put(0, ue_val(run), ue_len(run), coded);
    put(1, 0, 1, a.base_mode_bit && coded);
    const int i16code = 1 + a.mode16[g] + 4 * cbpc + 12 * cbpl_i16;
    const int mb_type = a.has_inter
        ? (is_inter ? shape : is_i4 ? 5 : 5 + i16code)
        : (is_i4 ? 0 : i16code);
    put(2, ue_val(mb_type), ue_len(mb_type), coded);
    for (int j = 0; j < 4; ++j)
      put(3 + j, 1, 1, coded && is_inter && shape == 3);
    const int cmode = a.cmode[g];
    put(31, ue_val(cmode), ue_len(cmode), coded && is_intra);
    const int code = kCbpCode[min(max(cbp, 0), 47) * 2 + (is_i4 ? 0 : 1)];
    put(32, ue_val(code), ue_len(code), coded && (is_inter || is_i4));
    const bool dqp = coded && (is_i16 || cbp != 0);
    if (a.has_plan)
      put(33, ue_val(se_map(dqp_delta)), ue_len(se_map(dqp_delta)), dqp);
    else
      put(33, 1, 1, dqp);
  } else {
    // header: partition p's MV differences (x, y) and Intra 4x4 symbols
    // 4p..4p+3
    const int p = lane - kUnits;
    const int shape = a.shape[g];
    const int n_parts = K6_N_PARTS(min(max(shape, 0), 3));
    const bool active = p < n_parts && coded && is_inter;
    const int dx = se_map(a.mvd_px[g * 4 + p]);
    const int dy = se_map(a.mvd_py[g * 4 + p]);
    // these slots lie in unit 0, written through the header's pointers
    uv = sv;
    ul = sl;
    put(7 + 2 * p, ue_val(dx), ue_len(dx), active);
    put(8 + 2 * p, ue_val(dy), ue_len(dy), active);
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * p + j;
      put(15 + i, a.i4v[g * 16 + i], a.i4l[g * 16 + i], is_i4);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    bits += __shfl_xor_sync(0xffffffffu, bits, off);
  __syncwarp();
  int4* ov = reinterpret_cast<int4*>(a.vals + g * kMbSlots);
  int4* ol = reinterpret_cast<int4*>(a.lens + g * kMbSlots);
  for (int k = lane; k < kMbSlots / 4; k += 32) {
    ov[k] = stage_v[warp][k];
    ol[k] = stage_l[warp][k];
  }
  if (lane == 0) {
    atomicAdd(a.row_bits + n_i * a.mbh + r, bits);
    atomicAdd(a.total_bits + n_i, bits);
  }
}

}  // namespace

extern "C" int h264lab_symbolize(
    const void* sel, const void* mode16, const void* cmode, const void* i4v,
    const void* i4l, const void* mvy, const void* mvx, const void* shape,
    const void* dc, const void* ac, const void* inter, const void* cdc,
    const void* cac, const void* qp_rows, void* vals, void* lens,
    void* tail_val, void* tail_len, void* total_bits, void* row_bits,
    void* skip, void* cbp, void* cbpc, void* mvd_py, void* mvd_px,
    void* qp_dec, void* scratch, long long n, int mbw, int mbh, int has_inter,
    int base_mode_bit, void* stream) {
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  const long long mbs = n * mbw * mbh;
  if (mbs * kMbSlots >= (1ll << 40) || n >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  Args a{(const int32_t*)sel, (const int32_t*)mode16, (const int32_t*)cmode,
         (const int32_t*)shape, (const int32_t*)i4v, (const int32_t*)i4l,
         (const int32_t*)mvy, (const int32_t*)mvx, (const int32_t*)dc,
         (const int32_t*)ac, (const int32_t*)inter, (const int32_t*)cdc,
         (const int32_t*)cac, (const int32_t*)qp_rows, (int32_t*)vals,
         (int32_t*)lens, (int32_t*)tail_val, (int32_t*)tail_len,
         (int32_t*)total_bits, (int32_t*)row_bits, (int32_t*)cbp,
         (int32_t*)cbpc, (int32_t*)mvd_py, (int32_t*)mvd_px,
         (int32_t*)qp_dec, (uint8_t*)skip, (uint8_t*)scratch,
         (int32_t*)((uint8_t*)scratch + mbs * kRecBytes), n, mbw, mbh,
         has_inter, base_mode_bit, qp_rows != nullptr};
  cudaStream_t s = (cudaStream_t)stream;
  sym_records_kernel<<<(unsigned)((mbs + kWarpsA - 1) / kWarpsA),
                       kWarpsA * 32, 0, s>>>(a);
  sym_scan_kernel<<<(unsigned)n, kScanThreads, 0, s>>>(a);
  sym_codes_kernel<<<(unsigned)((mbs + kWarpsC - 1) / kWarpsC),
                     kWarpsC * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}
