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
// integer operations per block), so the bytes bound it. Measured, pass C
// is held by instruction issue instead (PERF.md; its SASS has about 270
// instructions on the path of a step of two blocks with the suffixLength
// scan, 205 without it, 70 when both blocks are empty, and about 460 for
// an MB's loads, descriptors and header), so its design spends none on
// divergence, a stack or a zero pass.
//
// Design: three launches, in stream order.
//   A. records (`sym_records_kernel`): a warp per MB. The lanes load the MB's
//      luma levels (lev_inter's or ac_lev's, as its type needs) and chroma
//      AC levels in 16-byte pieces, count each 4x4 block's nonzeros with
//      shuffles and derive cbp, cbpc and the coded nonzero counts that
//      nC reads (luma of inter, Intra_4x4 and coded Intra_16x16 MBs,
//      chroma AC where cbpc is 2; a skipped MB has cbp 0, so skipping
//      changes no count). Lanes 0-3 derive the MV predictor of each
//      partition of the MB's shape and, at the same time, lane 4 the
//      16x16 one and P_Skip's (spec 8.4.1.1 and 8.4.1.3, as
//      `_mv_predictors` lists them), from the neighbours' MVs and intra
//      flags, which are inputs. It writes skip, cbp, cbpc, the MV
//      differences and a 32-byte record per MB: the 16 luma and 8 chroma
//      AC coded counts.
//   B. slice scans (`sym_scan_kernel`): a block of 1024 threads per slice,
//      each thread a run of consecutive MBs: one max-scan over the threads
//      of the last coded MB and the last MB that carries mb_qp_delta in
//      each run gives each coded MB its mb_skip_run and the slice its
//      trailing run (the tail), and, under a row plan, each MB its dQP and
//      decoded QP. It sets total_bits to the tail's length and row_bits to
//      0.
//   C. codes (`sym_codes_kernel`): a warp per MB, 4 warps a block, 12
//      blocks an SM. The MB's levels (its luma, lev_inter's or ac_lev's,
//      chroma AC, luma DC, chroma DC: 1,632 B) arrive in shared memory in
//      16-byte pieces, with its own record and its left and upper
//      neighbours' (within the slice: a band's first row has no upper
//      neighbour). Lane u derives unit u's descriptor (where its levels
//      lie, its view of them, nC, max_coeff, whether its lengths stand);
//      the whole warp builds the 34 header slots, a slot a lane. Then a
//      half-warp codes a 4x4 block, one lane per scan position, two units
//      a step, 14 steps: ballots of the nonzero and the |level| > 1
//      levels give TotalCoeff, each coefficient's rank in reverse scan
//      order and TrailingOnes, whose signs an OR over the warp gathers;
//      the next nonzero below gives run_before; the suffixLength
//      recurrence of `encode_blocks` is an exclusive scan of the levels'
//      transfer maps (8 nibbles, composed with byte permutes) over the
//      half-warp in 4 shuffle steps, skipped when no half has two levels
//      past its trailing ones; a step whose two blocks are both empty
//      takes a short path. Every slot is written once into a pair buffer
//      in shared memory (each lane one level slot and one run_before
//      slot, lanes 0-2 the other three), values and lengths apart, and
//      each pair of units (272 B of values and of lengths, 16-byte
//      aligned) goes out after its step in 16-byte stores; lane 0 adds
//      the MB's bits to its row's and its slice's counts (integer
//      atomics: the sums are exact in any order).
// No launch reads a ticket or a look-back buffer, so the wrapper zeroes
// nothing; the records and the scans' results go to one scratch tensor.
//
// SVC base-mode slices (`models/svc.py` `base_mode_symbols`) are a kind of
// their own, chosen per call: passes A and C are instantiated for it
// (`kBaseMode`), so the I and P slices' kernels compile as they were and
// no warp branches on the kind. Every MB is inter and coded, none has an
// MV, and K6 reads only lev_inter, cdc and cac (the other inputs may be
// null): pass A skips the predictors and zeroes the slice's counts and
// tail, pass B has no runs to scan and does not run, pass C writes the
// header base_mode_flag 1, coded_block_pattern and mb_qp_delta se(0) in
// slots 0-2 and an empty luma-DC unit (values too).
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
constexpr int kLumaCounts = 16;             // its chroma AC counts' offset
constexpr int kWarpsA = 8;                  // warps (MBs) per block, pass A
constexpr int kWarpsC = 4;                  // pass C
constexpr int kScanThreads = 1024;          // pass B

// The VLC tables in one array (a lane takes what it needs with one
// load), each entry value | length << 16
struct VlcTables {
  uint32_t coeff_token[5 * 17 * 4];
  uint32_t total_zeros[16 * 16];
  uint32_t total_zeros_cdc[4 * 4];
  uint32_t run_before[8 * 15];
};
constexpr int kTzAt = 5 * 17 * 4, kCdcTzAt = kTzAt + 16 * 16;
constexpr int kRbAt = kCdcTzAt + 4 * 4;
__device__ const VlcTables kVlc = {K6_COEFF_TOKEN, K6_TOTAL_ZEROS,
                                   K6_TOTAL_ZEROS_CDC, K6_RUN_BEFORE};
constexpr uint32_t kCheckCt[] = K6_COEFF_TOKEN, kCheckTz[] = K6_TOTAL_ZEROS;
constexpr uint32_t kCheckCdc[] = K6_TOTAL_ZEROS_CDC;
constexpr uint32_t kCheckRb[] = K6_RUN_BEFORE;
static_assert(sizeof(kCheckCt) == sizeof(VlcTables::coeff_token)
              && sizeof(kCheckTz) == sizeof(VlcTables::total_zeros)
              && sizeof(kCheckCdc) == sizeof(VlcTables::total_zeros_cdc)
              && sizeof(kCheckRb) == sizeof(VlcTables::run_before),
              "the VLC tables' sizes");
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

// The MV predictor of one partition (spec 8.4.1.3, `derive`); na and nb
// its neighbours A and B as found
__device__ void predict(const Args& a, long long slice, int r, int c,
                        const PartSpec& sp, int& py, int& px, Nb& na,
                        Nb& nb_found) {
  na = nb_block(a, slice, r, c, sp.v[0][0], sp.v[0][1], sp.v[0][2]);
  Nb nb = nb_block(a, slice, r, c, sp.v[1][0], sp.v[1][1], sp.v[1][2]);
  nb_found = nb;
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

template <bool kBaseMode>
__global__ void __launch_bounds__(kWarpsA * 32)
sym_records_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long nmb = (long long)a.mbw * a.mbh;
  const long long g = (long long)blockIdx.x * kWarpsA + (threadIdx.x >> 5);
  if (g >= a.n * nmb) return;
  const long long slice = g - g % nmb;
  const int m = (int)(g % nmb), r = m / a.mbw, c = m % a.mbw;
  // a base-mode MB is inter, coded and without MVs; pass B does not run,
  // so the first MB of each row zeroes its row's count and the first of
  // the slice the slice's count and tail, before pass C adds to them
  if (kBaseMode && lane == 0 && c == 0) {
    const long long s_i = g / nmb;
    a.row_bits[s_i * a.mbh + r] = 0;
    if (r == 0) a.total_bits[s_i] = a.tail_val[s_i] = a.tail_len[s_i] = 0;
  }
  const int sel = kBaseMode ? K6_SEL_INTER : a.sel[g];
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
  const bool has_inter = !kBaseMode && a.has_inter;
  const int shape = has_inter ? a.shape[g] : 0;

  // MV predictors, side by side: lanes 0-3 the partitions of the MB's
  // shape, lane 4 the 16x16 one and P_Skip's (whose neighbours A and B
  // are the 16x16 predictor's)
  int py = 0, px = 0, mvd_y = 0, mvd_x = 0, skip = 0;
  const bool part = lane < 4 && shape >= 0 && shape <= 3
                    && lane < K6_N_PARTS(shape);
  if (has_inter && (part || lane == 4)) {
    Nb na, nb;
    predict(a, slice, r, c, part ? part_spec(shape, lane) : part_spec(0, 0),
            py, px, na, nb);
    if (part) {
      const int by = K6_PART_BY(shape, lane), bx = K6_PART_BX(shape, lane);
      mvd_y = a.mvy[g * 16 + by * 4 + bx] - py;
      mvd_x = a.mvx[g * 16 + by * 4 + bx] - px;
    } else {
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

// exclusive max-scans of two values over the block's threads in thread
// order (-1 before the first thread), and their maxima over the block
__device__ __forceinline__ void block_max_scan2(int c, int d, int* totals,
                                                int& exc_c, int& exc_d,
                                                int& tot_c, int& tot_d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int wc = c, wd = d;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up_c = __shfl_up_sync(0xffffffffu, wc, off);
    const int up_d = __shfl_up_sync(0xffffffffu, wd, off);
    if (lane >= off) {
      wc = max(wc, up_c);
      wd = max(wd, up_d);
    }
  }
  int ec = __shfl_up_sync(0xffffffffu, wc, 1);
  int ed = __shfl_up_sync(0xffffffffu, wd, 1);
  if (lane == 0) ec = ed = -1;
  if (lane == 31) {
    totals[warp] = wc;
    totals[kScanThreads / 32 + warp] = wd;
  }
  __syncthreads();
  int bc = -1, bd = -1;
  tot_c = tot_d = -1;
  for (int k = 0; k < kScanThreads / 32; ++k) {
    const int tc = totals[k], td = totals[kScanThreads / 32 + k];
    if (k < warp) {
      bc = max(bc, tc);
      bd = max(bd, td);
    }
    tot_c = max(tot_c, tc);
    tot_d = max(tot_d, td);
  }
  exc_c = max(bc, ec);
  exc_d = max(bd, ed);
}

__global__ void __launch_bounds__(kScanThreads)
sym_scan_kernel(const Args a) {
  __shared__ int totals[2 * kScanThreads / 32];
  const int nmb = a.mbw * a.mbh;
  const long long slice = (long long)blockIdx.x * nmb;
  const int32_t* qrow = a.qp_rows + (a.has_plan ? blockIdx.x * a.mbh : 0);
  // thread k takes the MBs [lo, hi) of the slice in order: the last coded
  // MB and the last that carries mb_qp_delta among them, scanned over the
  // threads, start its second walk, which reads the flags of its first 32
  // MBs from registers
  const int per = (nmb + kScanThreads - 1) / kScanThreads;
  const int lo = min((int)threadIdx.x * per, nmb), hi = min(lo + per, nmb);
  auto flags = [&](int i, bool& coded, bool& dqp) {
    const long long g = slice + i;
    coded = !a.skip[g];
    dqp = coded && (a.sel[g] == K6_SEL_I16 || a.cbp[g] != 0);
  };
  int last_c = -1, last_d = -1;
  uint32_t coded_bits = 0, dqp_bits = 0;
#pragma unroll 8
  for (int i = lo; i < hi; ++i) {
    bool coded, dqp;
    flags(i, coded, dqp);
    last_c = coded ? i : last_c;
    last_d = dqp ? i : last_d;
    if (i - lo < 32) {
      coded_bits |= (uint32_t)coded << (i - lo);
      dqp_bits |= (uint32_t)dqp << (i - lo);
    }
  }
  int run_c, run_d, tot_c, tot_d;
  block_max_scan2(last_c, last_d, totals, run_c, run_d, tot_c, tot_d);
#pragma unroll 8
  for (int i = lo; i < hi; ++i) {
    const long long g = slice + i;
    bool coded, dqp;
    if (i - lo < 32) {
      coded = (coded_bits >> (i - lo)) & 1;
      dqp = (dqp_bits >> (i - lo)) & 1;
    } else {
      flags(i, coded, dqp);
    }
    int dqp_delta = 0;
    if (a.has_plan) {
      // the running QP: the QP of the last MB with mb_qp_delta, or the
      // plan's first row before any
      const int q = qrow[i / a.mbw];
      const int prev = run_d >= 0 ? qrow[run_d / a.mbw] : qrow[0];
      dqp_delta = q - prev;
      a.qp_dec[g] = dqp ? q : prev;
    }
    a.scan[2 * g] = coded ? i - 1 - run_c : 0;
    a.scan[2 * g + 1] = dqp_delta;
    run_c = coded ? i : run_c;
    run_d = dqp ? i : run_d;
  }
  for (int k = threadIdx.x; k < a.mbh; k += kScanThreads)
    a.row_bits[(long long)blockIdx.x * a.mbh + k] = 0;
  if (threadIdx.x == 0) {
    const int trailing = nmb - 1 - tot_c;   // after the last coded MB
    const int tl = a.has_inter && trailing > 0 ? ue_len(trailing) : 0;
    a.tail_val[blockIdx.x] = a.has_inter ? ue_val(trailing) : 0;
    a.tail_len[blockIdx.x] = tl;
    a.total_bits[blockIdx.x] = tl;
  }
}

// ---------------------------------------------------------------------------
// pass C: the codes
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
// an MB's levels in shared memory (ints): luma (16 raster blocks of 16),
// chroma AC (8 blocks of 16), luma DC (16), chroma DC (2 x 4)
constexpr int kCacAt = 256, kDcAt = 384, kCdcAt = 400, kLevInts = 408;
constexpr int kPairSlots = 2 * kSlots;   // units 2t, 2t + 1: 272 B, aligned
constexpr int kSteps = kUnits / 2;       // a step codes a pair of units

// 16 values below 16 as the nibbles of a word, the first lowest
constexpr uint64_t nibbles(const int (&t)[16]) {
  uint64_t w = 0;
  for (int i = 0; i < 16; ++i) w |= (uint64_t)(t[i] & 15) << (4 * i);
  return w;
}
constexpr int kZigzagTab[16] = K6_ZIGZAG;
constexpr int kBlockScanTab[16] = K6_BLOCK_SCAN;
constexpr uint64_t kZigzag = nibbles(kZigzagTab);

__device__ __forceinline__ int nib(uint64_t w, int i) {
  return (int)((w >> (4 * i)) & 15);
}

// What lane u's unit u is, whatever the MB: where its levels start in the
// MB's shared levels (9 bits), its block (by, bx) in its grid (2 + 2),
// the offset of its grid's counts in a record (5), its 8x8 group of the
// coded_block_pattern (2) and its kind (0 the luma DC, 1 luma in
// BLOCK_SCAN_4x4 order, 2 chroma DC, 3 chroma AC)
struct UnitTable {
  uint32_t w[32];
};
constexpr UnitTable unit_table() {
  UnitTable t{};
  for (int u = 0; u < 32; ++u) {
    int at = kDcAt, by = 0, bx = 0, o = 0, grp = 0, kind = 0;
    if (u >= 20 && u < kUnits) {
      const int k = u - 20;
      at = kCacAt + 16 * k;
      by = (k >> 1) & 1;
      bx = k & 1;
      o = kLumaCounts + (k & 4);
      kind = 3;
    } else if (u == 18 || u == 19) {
      at = kCdcAt + 4 * (u - 18);
      kind = 2;
    } else if (u >= 2 && u < 18) {
      const int b = kBlockScanTab[u - 2];
      at = 16 * b;
      by = b >> 2;
      bx = b & 3;
      grp = (b >> 3) * 2 + ((b & 3) >> 1);
      kind = 1;
    }
    t.w[u] = (uint32_t)(at | by << 9 | bx << 11 | o << 13 | grp << 18
                        | kind << 20);
  }
  return t;
}
__device__ const UnitTable kUnitTable = unit_table();

// suffixLength's transfer maps: nibble s of a map holds the state that
// follows state s (states 0-6; nibble 7 is never read). A level of
// magnitude al takes s to min(6, max(s, 1) + (al > 3 << (max(s, 1) - 1))):
// max(s, 1), plus one at the states 0..k whose threshold al passes
// (states 0 and 1 share the first, 3), which never reaches past 6.
constexpr uint32_t kMapIdentity = 0x76543210u;
constexpr uint32_t kMapFloor = 0x76543211u;    // s -> max(s, 1)

__device__ __forceinline__ uint32_t level_map(int al) {
  // the thresholds 3 << (m - 1) that al passes, m = 1..5: al - 1 >= 3 <<
  // (m - 1), the bit length of (al - 1) / 3
  const int k = min(32 - __clz(__umulhi((unsigned)(al - 1), 0x55555556u)),
                    5);
  return kMapFloor + (k ? 0x111111u >> (4 * (5 - k)) : 0u);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// A map spread to bytes: byte s of (lo, hi) holds nibble s
__device__ __forceinline__ void map_bytes(uint32_t w, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t even = w & 0x0f0f0f0fu, odd = (w >> 4) & 0x0f0f0f0fu;
  lo = prmt(even, odd, 0x5140);
  hi = prmt(even, odd, 0x7362);
}

// g after f, with g spread to bytes (lo, hi) and f as nibbles: f's
// nibbles select g's bytes; the result comes back in both forms
__device__ __forceinline__ uint32_t compose(uint32_t& lo, uint32_t& hi,
                                           uint32_t f) {
  const uint32_t r0 = prmt(lo, hi, f), r1 = prmt(lo, hi, f >> 16);
  lo = r0;
  hi = r1;
  return prmt(r0, r1, 0x6420) + (prmt(r0, r1, 0x7531) << 4);
}

// VLC of levelCode `lc` at suffixLength `sl` (`cavlc._level_code_bits`),
// without branches: level_prefix lc >> sl and sl suffix bits, but at
// suffixLength 0 level_prefix 14 with a 4-bit suffix from levelCode 14,
// and from the escape's start level_prefix 15 (12-bit suffix) or 16
// (13-bit)
__device__ __forceinline__ void level_code(int lc, int sl, int& v, int& n) {
  const int start = (15 << sl) + (sl == 0 ? 15 : 0);
  const int rem = lc - start;
  const bool esc = rem >= 0, esc13 = rem >= 4096;
  const bool p14 = sl == 0 && lc >= 14;
  v = esc ? (esc13 ? (1 << 13) | (rem - 4096) : (1 << 12) | rem)
          : p14 ? (1 << 4) | (lc - 14) : (1 << sl) | (lc & ((1 << sl) - 1));
  n = esc ? (esc13 ? 30 : 28) : p14 ? 19 : (lc >> sl) + 1 + sl;
}

// coeff_token's table of nC (`cavlc.nc_context`; 4: chroma DC, nC -1)
__device__ __forceinline__ int nc_ctx(int nc) {
  return nc < 0 ? 4 : nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
}

template <bool kBaseMode>
__global__ void __launch_bounds__(kWarpsC * 32, 12)
sym_codes_kernel(const Args a) {
  __shared__ int4 lev4[kWarpsC][kLevInts / 4 + 1];     // and a zero word
  __shared__ int4 stage4[kWarpsC][2][2][kPairSlots / 4];  // values, lengths
  __shared__ uint32_t recs[kWarpsC][3 * kRecBytes / 4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nmb = a.mbw * a.mbh;
  const int m = blockIdx.y * kWarpsC + warp;   // MB m of slice blockIdx.x
  if (m >= nmb) return;
  const long long n_i = blockIdx.x, g = n_i * nmb + m;
  const int r = m / a.mbw, c = m - r * a.mbw;
  const bool has_left = c > 0, has_top = r > 0;

  const int sel = kBaseMode ? K6_SEL_INTER : a.sel[g];
  const bool is_inter = sel == K6_SEL_INTER, is_i16 = sel == K6_SEL_I16;
  const bool is_i4 = sel == K6_SEL_I4;
  // the MB's levels to shared memory in 16-byte pieces: its luma
  // (lev_inter's if it is inter, else ac_lev's), chroma AC, luma DC (zero
  // in a base-mode slice) and chroma DC, then a zero word
  {
    const int4* luma = reinterpret_cast<const int4*>(
        (is_inter ? a.inter : a.ac) + g * 256);
    const int4* cac = reinterpret_cast<const int4*>(a.cac + g * 128);
    const int4 q0 = luma[lane], q1 = luma[lane + 32], q2 = cac[lane];
    int4 q3 = make_int4(0, 0, 0, 0);
    if (lane < 4) {
      if (!kBaseMode) q3 = reinterpret_cast<const int4*>(a.dc + g * 16)[lane];
    } else if (lane < 6) {
      q3 = reinterpret_cast<const int4*>(a.cdc + g * 8)[lane - 4];
    }
    lev4[warp][lane] = q0;
    lev4[warp][lane + 32] = q1;
    lev4[warp][kCacAt / 4 + lane] = q2;
    if (lane < 7) lev4[warp][kDcAt / 4 + lane] = q3;
  }
  // the records of the MB, its left and its upper neighbour
  if (lane < 24) {
    const int w = lane & 7, which = lane >> 3;
    const bool there = which == 0 || (which == 1 ? has_left : has_top);
    const long long src = which == 0 ? g : which == 1 ? g - 1 : g - a.mbw;
    recs[warp][lane] = there ? reinterpret_cast<const uint32_t*>(
        a.rec + src * kRecBytes)[w] : 0u;
  }
  const int cbp = a.cbp[g], cbpc = a.cbpc[g];
  const bool coded = kBaseMode || !a.skip[g];
  const bool cbpl_i16 = (cbp & 15) != 0;   // of MBs neither inter nor I4
  __syncwarp();
  const uint8_t* own = reinterpret_cast<const uint8_t*>(recs[warp]);
  const int* levs = reinterpret_cast<const int*>(lev4[warp]);
  // the pair buffers: buffer b's values at stage + 2 b kPairSlots, its
  // lengths kPairSlots after them
  int* const stage = reinterpret_cast<int*>(stage4[warp]);
  const uint32_t* vlc = reinterpret_cast<const uint32_t*>(&kVlc);

  // lane u's descriptor of unit u: the luma DC (1), the 16 luma blocks in
  // BLOCK_SCAN_4x4 order (2-17), chroma DC (18-19), chroma AC (20-27);
  // lane 0's is not read. Where its levels start in the MB's shared
  // levels (9 bits), its view of them (2: 0 zig-zag, 1 AC, zig-zag
  // 1..15, 2 chroma DC raster), its coeff_token table (3), whether its
  // lengths stand (1) and max_coeff (5). nC (`_block_nc`) from the
  // counts of the MB's record and its neighbours' (n x n blocks at o).
  uint32_t desc;
  {
    const uint32_t ut = kUnitTable.w[lane];
    const int kind = ut >> 20;
    const bool u_cdc = kind == 2, u_cac = kind == 3;
    const int at = ut & 511, by = (ut >> 9) & 3, bx = (ut >> 11) & 3;
    const int o = (ut >> 13) & 31, grp = (ut >> 18) & 3, n = u_cac ? 2 : 4;
    const bool la = bx > 0 || has_left, ta = by > 0 || has_top;
    const int na = own[o + (bx > 0 ? by * n + bx - 1 : kRecBytes + by * n
                                                        + n - 1)];
    const int nb = own[o + (by > 0 ? (by - 1) * n + bx
                                   : 2 * kRecBytes + (n - 1) * n + bx)];
    const int nc = la && ta ? (na + nb + 1) >> 1 : la ? na : ta ? nb : 0;
    // by kind: whether the lengths stand, the view, max_coeff
    const bool keep_luma = is_i16 ? cbpl_i16
        : coded && (is_inter || is_i4) && ((cbp >> grp) & 1);
    const uint32_t keeps = (uint32_t)is_i16 | (uint32_t)keep_luma << 1
                           | (uint32_t)(cbpc >= 1 && coded) << 2
                           | (uint32_t)(cbpc == 2 && coded) << 3;
    const uint32_t views = (uint32_t)is_i16 << 2 | 2u << 4 | 1u << 6;
    const uint32_t max_coeffs = 16u | (is_i16 ? 15u : 16u) << 5 | 4u << 10
                                | 15u << 15;
    desc = (uint32_t)at | ((views >> 2 * kind) & 3) << 9
           | (uint32_t)(u_cdc ? 4 : nc_ctx(nc)) << 11
           | ((keeps >> kind) & 1) << 14
           | ((max_coeffs >> 5 * kind) & 31) << 15;
  }

  // the header (unit 0) with the whole warp, a slot a lane, and slots 32
  // and 33 on lanes 0 and 1: mb_skip_run, base_mode_flag, mb_type,
  // sub_mb_type, the partitions' MV differences (x, y), the Intra 4x4
  // symbols, chroma mode, coded_block_pattern, mb_qp_delta; in a
  // base-mode slice base_mode_flag 1, coded_block_pattern (the inter
  // column) and mb_qp_delta se(0) in slots 0-2, the others empty
  int bits = 0;
  if (kBaseMode) {
    const int s = lane;
    const int code = kCbpCode[min(max(cbp, 0), 47) * 2 + 1];
    const int n = s == 0 ? 1 : s == 1 ? ue_len(code) : s == 2 ? cbp != 0
                                                               : 0;
    stage[s] = s == 1 ? ue_val(code) : s == 0 || s == 2 ? 1 : 0;
    stage[kPairSlots + s] = n;
    bits += n;
    if (s < 2) stage[32 + s] = stage[kPairSlots + 32 + s] = 0;
  } else {
    const int s = lane, shape = a.shape[g];
    const int run = a.scan[2 * g], dqp_delta = a.scan[2 * g + 1];
    const int i16code = 1 + a.mode16[g] + 4 * cbpc + 12 * cbpl_i16;
    const int mb_type = a.has_inter
        ? (is_inter ? shape : is_i4 ? 5 : 5 + i16code)
        : (is_i4 ? 0 : i16code);
    const int cmode = a.cmode[g];
    const int code = kCbpCode[min(max(cbp, 0), 47) * 2 + (is_i4 ? 0 : 1)];
    const bool dqp = coded && (is_i16 || cbp != 0);
    const int n_parts = K6_N_PARTS(min(max(shape, 0), 3));
    const bool s_i4 = s >= 15 && s < 31;
    // every lane loads (the other lanes' indices stay in the MB's rows)
    const int p = min(max((s - 7) >> 1, 0), 3), k4 = min(max(s - 15, 0), 15);
    const int mvd = (s & 1) ? a.mvd_px[g * 4 + p] : a.mvd_py[g * 4 + p];
    const int i4v = a.i4v[g * 16 + k4], i4l = a.i4l[g * 16 + k4];
    // which slots are ue(v) codes, and which lengths stand, a bit a slot
    const uint32_t ues = (uint32_t)a.has_inter | 1u << 2 | 0xffu << 7
                         | 1u << 31;
    const uint32_t keeps =
        (coded ? (uint32_t)a.has_inter | (uint32_t)a.base_mode_bit << 1
                     | 1u << 2 | (is_inter && shape == 3 ? 0xfu << 3 : 0u)
                     | (is_inter ? ((1u << 2 * n_parts) - 1) << 7 : 0u)
                     | (is_inter ? 0u : 1u << 31)
               : 0u)
        | (is_i4 ? 0xffffu << 15 : 0u);
    const bool ue = (ues >> s) & 1, keep = (keeps >> s) & 1;
    // the ue(v) argument, where the slot is one
    const int x = s == 0 ? run : s == 2 ? mb_type : s == 31 ? cmode
                : se_map(mvd);
    const int v = ue ? ue_val(x) : s_i4 ? i4v : s >= 3 ? 1 : 0;
    const int n = ue ? ue_len(x) : s_i4 ? i4l : s >= 1 ? 1 : 0;
    stage[s] = v;
    stage[kPairSlots + s] = keep ? n : 0;
    bits += keep ? n : 0;
    // coded_block_pattern (lane 0) and mb_qp_delta (lane 1)
    const int dq = se_map(dqp_delta);
    const int v2 = s == 0 ? ue_val(code) : a.has_plan ? ue_val(dq) : 1;
    const int n2 = s == 0 ? ue_len(code) : a.has_plan ? ue_len(dq) : 1;
    const bool keep2 = s == 0 ? coded && (is_inter || is_i4) : dqp;
    if (s < 2) {
      stage[32 + s] = v2;
      stage[kPairSlots + 32 + s] = keep2 ? n2 : 0;
      bits += keep2 ? n2 : 0;
    }
  }

  // the residual units, two a step: half-warp h codes unit 2t + h (unit 0,
  // the header, is done), lane i at scan position i of the unit's view
  const int h = lane >> 4, i = lane & 15, sh = 16 * h;
  // where lane i's level lies in each view (zig-zag, AC, chroma DC
  // raster), and in which views it has one
  const int offs = nib(kZigzag, i) | nib(kZigzag, min(i + 1, 15)) << 8
                   | i << 16;
  const int views = 1 | (i < 15) << 1 | (i < 4) << 2;
  const uint32_t below = (1u << i) - 1;
  int* const uv0 = stage + h * kSlots;
  int4* ov = reinterpret_cast<int4*>(a.vals) + g * (kMbSlots / 4) + lane;
  int4* ol = reinterpret_cast<int4*>(a.lens) + g * (kMbSlots / 4) + lane;
#pragma unroll 1
  for (int t = 0; t < kSteps; ++t) {
    const int u = 2 * t + h;
    const uint32_t d = __shfl_sync(kFull, desc, u);
    const int at = d & 511, view = (d >> 9) & 3, ctx = (d >> 11) & 7;
    const int keep_mask = (d >> 14) & 1 ? -1 : 0;
    const int max_coeff = (int)(d >> 15);
    const int l = levs[(views >> view) & 1 ? at + ((offs >> 8 * view) & 255)
                                           : kLevInts];
    const uint32_t b_nz = __ballot_sync(kFull, l != 0);
    int* const uv = uv0 + (t & 1) * 2 * kPairSlots;   // the unit's values
    int* const ul = uv + kPairSlots;                    // and lengths
    if (b_nz == 0) {
      // both blocks empty: coeff_token of TotalCoeff 0, every other slot 0
      const uint32_t ct = vlc[ctx * 17 * 4];
      const int n = i == 0 ? (int)(ct >> 16) & keep_mask : 0;
      if (u > 0) {
        // a base-mode slice's luma-DC unit is empty, values too
        uv[i] = i == 0 && !(kBaseMode && u == 1) ? (int)(ct & 0xffffu) : 0;
        ul[i] = n;
        uv[16 + i] = ul[16 + i] = 0;
        if (i < 2) uv[32 + i] = ul[32 + i] = 0;
        bits += n;
      }
    } else {
      const uint32_t nz = (b_nz >> sh) & 0xffffu;
      const uint32_t big = (__ballot_sync(kFull, l > 1 || l < -1) >> sh)
                           & 0xffffu;
      // TotalCoeff, this coefficient's rank in reverse scan order, and
      // TrailingOnes: the +-1 above the highest other nonzero, at most 3;
      // their signs, the first highest, gathered from their lanes
      const int total = __popc(nz);
      const int rank = __popc(nz >> (i + 1));
      const int t1 = min(__popc(nz >> (32 - __clz(big))), 3);
      const bool coef = l != 0, lvl = coef && rank >= t1;
      const int sign_bit = coef && rank < t1 ? (l < 0) << (t1 - 1 - rank)
                                             : 0;
      const int signs = (int)(__reduce_or_sync(kFull, sign_bit << (4 * h))
                              >> (4 * h)) & 7;
      // the level, past the trailing ones, at the suffixLength that the
      // levels before it (above it in scan order) leave: the exclusive
      // scan of their transfer maps over the half-warp from position 15
      // down, when a half has two levels
      const int al = abs(l);
      const int lc = max(2 * (al - 1) + (l < 0)
                         - (rank == t1 && t1 < 3 ? 2 : 0), 0);
      const int s0 = total > 10 && t1 < 3;
      int sl = s0;
      if (__any_sync(kFull, total - t1 > 1)) {
        const uint32_t own_map = level_map(al);
        uint32_t x = lvl ? own_map : kMapIdentity, lo, hi;
        map_bytes(x, lo, hi);
#pragma unroll
        for (int dd = 1; dd < 16; dd <<= 1) {
          const uint32_t y = __shfl_down_sync(kFull, x, dd, 16);
          x = compose(lo, hi, i + dd < 16 ? y : kMapIdentity);
        }
        const uint32_t e = __shfl_down_sync(kFull, x, 1, 16);
        sl = (int)(((i < 15 ? e : kMapIdentity) >> (4 * s0)) & 15);
      }
      int lv_v, lv_n;
      level_code(lc, sl, lv_v, lv_n);
      // run_before of every coefficient but the last: the zeros down to
      // the next nonzero, where zerosLeft is not 0
      const int zl = i - (total - 1 - rank);
      const int next = 31 - __clz(nz & below);
      const bool has_run = coef && rank < total - 1;
      const uint32_t rb_e = vlc[kRbAt + min(max(zl, 0), 7) * 15
                                + min(max(i - next - 1, 0), 14)];
      const uint32_t rb = has_run && zl > 0 ? rb_e : 0u;
      // coeff_token on lane 0, total_zeros on lane 2 (where 0 < TotalCoeff
      // < max_coeff; the other lanes' index stays inside the tables)
      const bool cdc = ctx == 4;
      const int tz = 32 - __clz(nz) - total;
      const int ct_at = (ctx * 17 + total) * 4 + t1;
      const int tz_at = (cdc ? kCdcTzAt : kTzAt) + total * (cdc ? 4 : 16)
                        + tz;
      const uint32_t tab_e = vlc[i == 0 ? ct_at : tz_at];
      const uint32_t tab = i == 0 || (i == 2 && total > 0
                                      && total < max_coeff) ? tab_e : 0u;
      if (u > 0) {
        // every slot of the unit once: each lane one of the 16 level slots
        // (a coefficient its rank's, the zero lanes the slots past
        // TotalCoeff in turn) and one of the 15 run_before slots (the
        // coefficients but the last their rank's, the other lanes the
        // rest in turn, the last of them none); lanes 0-2 coeff_token,
        // the trailing ones' signs and total_zeros
        const int ln = lvl ? lv_n & keep_mask : 0;
        const int rn = (int)(rb >> 16) & keep_mask;
        const int tn = (i == 1 ? t1 : (int)(tab >> 16)) & keep_mask;
        const int lslot = 2 + (coef ? rank : total + 15 - i - rank);
        const int rslot = has_run ? 19 + rank
                        : 19 + max(total - 1, 0) + 15 - i
                          - min(rank, max(total - 1, 0));
        uv[lslot] = lvl ? lv_v : 0;
        ul[lslot] = ln;
        if (rslot < 19 + 15) {
          uv[rslot] = (int)(rb & 0xffffu);
          ul[rslot] = rn;
        }
        if (i < 3) {
          const int mslot = i == 2 ? 18 : i;
          uv[mslot] = i == 1 ? signs : (int)(tab & 0xffffu);
          ul[mslot] = tn;
        }
        bits += ln + rn + tn;
      }
    }
    // the pair's 68 slots out, values and lengths, in 16-byte pieces
    __syncwarp();
    if (lane < kPairSlots / 4) {
      const int4* sp =
          reinterpret_cast<const int4*>(stage + (t & 1) * 2 * kPairSlots);
      *ov = sp[lane];
      *ol = sp[kPairSlots / 4 + lane];
    }
    ov += kPairSlots / 4;
    ol += kPairSlots / 4;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    bits += __shfl_xor_sync(kFull, bits, off);
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
    int base_mode_bit, int base_mode, void* stream) {
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  const long long mbs = n * mbw * mbh;
  if (mbs * kMbSlots >= (1ll << 40) || n >= (1ll << 31)
      || (long long)mbw * mbh > 65535ll * kWarpsC)
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
  const unsigned blocks_a = (unsigned)((mbs + kWarpsA - 1) / kWarpsA);
  const dim3 blocks_c((unsigned)n, (unsigned)((mbw * mbh + kWarpsC - 1)
                                              / kWarpsC));
  if (base_mode) {
    // a base-mode slice: no skip runs, no row plan, so no slice scans
    if (has_inter || base_mode_bit || qp_rows != nullptr)
      return (int)cudaErrorInvalidValue;
    sym_records_kernel<true><<<blocks_a, kWarpsA * 32, 0, s>>>(a);
    sym_codes_kernel<true><<<blocks_c, kWarpsC * 32, 0, s>>>(a);
  } else {
    sym_records_kernel<false><<<blocks_a, kWarpsA * 32, 0, s>>>(a);
    sym_scan_kernel<<<(unsigned)n, kScanThreads, 0, s>>>(a);
    sym_codes_kernel<false><<<blocks_c, kWarpsC * 32, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
