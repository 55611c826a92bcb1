// K3 of h264lab_tpu_torch: the slope-2 intra wavefront, the mode selection
// and intra transform of a batch of frames or slice bands (Intra_16x16,
// Intra_4x4 and chroma, with an optional inter candidate), in one kernel
// written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces h264lab_tpu/models/mbscan.py:541 `_wavefront_scan` (the
// `lax.scan` over slope-2 MB diagonals at :689) together with
// h264lab_tpu/ops/intra4.py:175 `encode_i4x4_mb` (its `lax.scan` over the
// 16 blocks at :295), which the JAX package left to XLA (no Pallas
// kernel). It takes what the port's plain version `_select_wavefront_plain`
// (models/mbscan.py) takes - the MB source tiles, per-frame QPs, the
// mode-decision lambda and intra-in-P penalty, the MB availability, and
// on P frames the inter candidate's cost and reconstruction - and writes
// its 13 outputs, equal array for array (integer arithmetic throughout).
//
// Bound. Each input is read once and each output written once: 384 B of
// source per MB (and 388 B of inter candidate on P frames) in; 384 B of
// reconstruction, 1024 B of `ac_lev`, 512 B of `cac_lev` and 300 B of the
// rest out: about 2.6 KB per MB, 0.10 ms for 16 frames of 1080p at 3.35
// TB/s. That bound is far away: what sets the time is latency along a
// chain. MB (r, c) needs the reconstruction of its left, top, top-left
// and top-right neighbours, so row r finishes MB c only after row r - 1
// has finished MB c + 1, and a frame is a chain of mbw + 2 (mbh - 1) MB
// steps (254 at 1080p) whatever the number of frames. An MB step is a
// chain too: the 16 Intra_4x4 blocks of an MB depend on each other, and
// each block is a chain of shared-memory loads, shuffles and integer
// steps that one warp runs in a few hundred to two thousand cycles. So
// the design shortens the chains and keeps everything else off them:
//   - Intra_4x4 in 10 dependency waves: block (bi, bj) needs its left,
//     top and top-left blocks, and its top-right one outside NO_TOPRIGHT
//     (raster 5, 7, 11, 13, 15), so it can run at wave 2 bi + bj. One warp
//     runs the waves, a half-warp per block (a lane per pixel), two blocks
//     in waves 2-7: 16 dependent block steps become 10. Each half reads
//     its 13 neighbours from the MB's canvas, which earlier waves wrote,
//     and the modes of earlier waves; a __syncwarp() ends a wave. A wave
//     has no branch: every prediction but DC is (U[a] + U[b] + U[c] +
//     U[d] + 2) >> 2 of four neighbours within three (a tap table per
//     pixel, built on the host), one byte permute and one 4-byte dot
//     product; the argmin is a min over (cost << 4 | mode) keys (the first
//     minimum wins, as in the plain version); the transforms shuffle
//     within a half's 16 lanes;
//   - Intra_16x16 and chroma in one warp beside it (together they take
//     less than the 10 waves): their SADs packed two to a word, then the
//     16 luma blocks on lanes 0-15 and the 8 chroma blocks on lanes 16-23
//     through the same transform and quantisation code, then the luma and
//     chroma DC Hadamards as butterflies across the lanes. So a row is a
//     block of 64 threads, and eight blocks fit on an SM at up to 128
//     registers a thread: every row of 16 frames of 1080p that the
//     wavefront keeps busy is resident. Which warp takes which role
//     follows its warp slot, so that the Intra_4x4 warps of an SM's blocks
//     spread over its four schedulers;
//   - the next MBs' inputs by TMA: after the MB's selection, one thread
//     issues 1-D bulk copies (cp.async.bulk, completed on an mbarrier) of
//     MB c + 2's source tiles, and on P frames its inter reconstruction,
//     into the third of three shared slots; the inter cost and the
//     availability flags come a step ahead in registers. No load of the
//     MB's own inputs is left on the chain;
//   - the row handoff off the chain: an MB's record for the row below (the
//     bottom lines of its Y, U and V reconstruction and its bottom
//     Intra_4x4 modes) is 9 units of 8 bytes, 4 bytes and a tag each. They
//     are written with single-copy atomic 64-bit relaxed stores as soon as
//     the selection is known, before the MB's outputs, and read with
//     64-bit relaxed loads (never a stale L1 line), loaded again until the
//     tag is set: a unit that shows its tag shows its data, with no fence
//     on the writer's side and no acquire load and second read on the
//     reader's. The records of the MB above and above left are final once
//     the row has its MB c - 1 (row r - 1 had to finish MB c to give it
//     its top right), so they are loaded one MB ahead. Only the top-right
//     record (row r - 1's MB c + 1) can be late, and only Intra_4x4 block
//     3, at wave 3, reads it: Intra_16x16, chroma and waves 0-2 run while
//     it arrives;
//   - the rows of a thread-block cluster (`cluster` consecutive MB rows of
//     one frame, a block each) hand their records over in distributed
//     shared memory: a row keeps its units in its own shared memory, and
//     the row below, the next block of the cluster, polls them there; a
//     cluster's first row reads the units of the cluster above from
//     global memory (a buffer the wrapper zeroes), which only a cluster's
//     last row writes. The blocks meet at a cluster barrier after they
//     have zeroed their units and before any exits (a row's units stay
//     readable until the row below has finished); rows past mbh only
//     meet there. The wrapper takes clusters of 8 rows where all of the
//     launch's clusters are resident at once (one frame or band), else of
//     2, where a finished row holds its place only until the other row of
//     its cluster is done (16 frames of 1080p);
//   - one barrier per MB step, a named barrier of the two warps when both
//     candidates are ready. What a warp reads of the other's after it (the
//     costs, the Intra_16x16 and chroma reconstruction, the Intra_4x4
//     right column) sits in one of two slots that alternate by MB, so a
//     warp can start the next MB while the other still reads; each warp
//     writes its own outputs and keeps its own copy of the left MB's edge;
//   - neighbours that are unavailable (outside the frame, or not
//     available by `avail_top` / `avail_left`) are never read: their
//     samples are zeros, which feed only modes that are invalid there, as
//     the clamped records of the plain version do. Row 0 and column 0 are
//     unavailable whatever the availability flags say;
//   - clusters are drawn from a global ticket in launch order (as K1 and
//     K2 draw their blocks' work), not from blockIdx: ticket t is rows
//     cluster * (t / n) + k of frame t % n, so every frame's row group
//     starts before any frame's next group, and a cluster waits only on
//     ticket t - n (the cluster above, same frame), which a resident (or
//     finished) cluster drew earlier, and on rows of its own, which run
//     beside it: no launch order can deadlock.
// What is left on the chain per MB step: the 10 waves, one barrier, the
// selection and the record stores; per row, what of the top-right
// record's trip waves 0-2 do not hide: through shared memory inside a
// cluster, through L2 once per cluster. An Intra_4x4 wave is a
// latency-bound chain of about 450 instructions on one warp (neighbours,
// predictions and SADs, the decision, four rounds of shuffles for the
// transforms), about 1,500 cycles, and an MB step about 7 us on one frame
// on an NVIDIA H100 80GB HBM3 at 700.00 W; at 16 frames two Intra_4x4
// warps share each scheduler and a slow row holds up the rows below.
//
// Integer semantics of ops/transform.py, ops/intra.py and ops/intra4.py:
// `>>` of negative ints is arithmetic; `* (1 << s)` where they write
// `<< s` (a left shift of a negative int is undefined in C++17); the
// deadzone f = dz << (qbits - 8); level = sign(W) * mag; the exact
// rounding of the luma DC dequantisation below QP 12. QUANT_MF, DEQUANT_V,
// POS_CLASS and BLOCK_SCAN_4x4 of ops/tables.py and the tap tables of
// ops/wavefront.py `i4_tap_tables` come as one device array.
//
// Plain C interface, loaded with ctypes; the entry point launches on the
// given stream in clusters of `cluster` (1 to 8) blocks, allocates nothing
// (the caller zeroes the ticket, 4 bytes, and the global record units, 72
// bytes per MB) and returns the launch's error.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 64;              // warps: Intra_4x4; I16 + chroma
constexpr int kMinBlocks = 8;             // resident rows per SM
constexpr int kInvalid = 1 << 30;         // ops/intra.py INVALID_COST
constexpr int kUnits = 9;                 // record units of an MB
constexpr unsigned long long kTag = 1ull << 32;   // a record unit written
constexpr int kSlots = 3;                 // the MB's inputs and the next two
constexpr int kCanW = 21;                 // Intra_4x4 canvas row: left
                                          // column, 16 pixels, 4 top-right
constexpr int kTapModes = 8;              // Intra_4x4 modes but DC
constexpr int kTables = 18 + 18 + 16 + 16 + 16 * kTapModes + 16;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const uint8_t* src_y;     // (N, nmb, 16, 16)
  const uint8_t* src_u;     // (N, nmb, 8, 8)
  const uint8_t* src_v;
  const int32_t* qp;        // (N,)
  const int32_t* qpc;
  const int32_t* lam;       // (N,) lambda_me(qp)
  const int32_t* pen;       // (N,) the intra-in-P penalty (0 on I frames)
  const uint8_t* avail_top;   // (nmb,)
  const uint8_t* avail_left;
  const int32_t* inter_cost;  // (N, nmb), or null without inter candidate
  const uint8_t* rec_y_inter;  // (N, nmb, 16, 16)
  const uint8_t* rec_u_inter;  // (N, nmb, 8, 8)
  const uint8_t* rec_v_inter;
  const int32_t* tables;    // QUANT_MF (6x3), DEQUANT_V (6x3), POS_CLASS,
                            // BLOCK_SCAN_4x4, the Intra_4x4 tap tables
  int32_t* sel;             // (N, nmb)
  int32_t* mode16;
  int32_t* cmode;
  int32_t* dc_lev;          // (N, nmb, 4, 4)
  int32_t* ac_lev;          // (N, nmb, 4, 4, 4, 4)
  int32_t* cdc_lev;         // (N, nmb, 2, 2, 2)
  int32_t* cac_lev;         // (N, nmb, 2, 2, 2, 4, 4)
  uint8_t* recon_y;         // (N, nmb, 16, 16)
  uint8_t* recon_u;         // (N, nmb, 8, 8)
  uint8_t* recon_v;
  int32_t* i4modes;         // (N, nmb, 16) raster
  int32_t* i4sym_v;         // (N, nmb, 16) coded order
  int32_t* i4sym_l;
  unsigned long long* records;  // (N, nmb, 9) tagged units
  int* sync;                // [0] the ticket
  int n, mbw, mbh, deadzone, i4_penalty;
};

// An MB's inputs, filled by bulk copies.
struct alignas(16) Slot {
  uint8_t src_y[256], src_u[64], src_v[64];
  uint8_t inter_y[256], inter_u[64], inter_v[64];
};

// What one warp hands the other at the MB's barrier (two, by MB parity).
struct alignas(16) Result {
  uint8_t rec16[256];       // Intra_16x16 reconstruction
  uint8_t rec_c[128];       // chroma reconstruction, U then V
  uint8_t i4col[16];        // Intra_4x4 reconstruction, right column
  int cost4, cost16;
};

struct alignas(16) Smem {
  Slot slot[kSlots];
  Result res[2];
  unsigned long long bar[kSlots];   // the slots' mbarriers
  int icost[kSlots];        // the inter cost of the slot's MB
  int mf[18], dv[18], pos[16], scan[16];
  // the Intra_4x4 tap tables (wavefront.i4_tap_tables): per pixel and mode
  // but DC a byte-permute selector of the 4 taps in an 8-byte window of
  // the neighbours (U[0..7] or U[5..12]), and per pixel the modes' windows,
  // a bit each
  unsigned i4sel[16][kTapModes], i4win[16];
  // the Intra_4x4 warp. Canvas row 0 the top edge (column 0 the top-left
  // pixel, 17-20 the top-right 4), column 0 of rows 1-16 the left MB's
  // right column
  int can[17 * kCanW];
  alignas(16) uint8_t nb[2][16];  // each half's block's neighbours U:
                                  // l3..l0, tl, t0..t7
  alignas(16) int lev4[256];
  int modes[16], symv[16], syml[16];
  int em_r[4];              // the left MB's right-column modes
  // where the record units of the row above are read and this row's
  // written (wavefront_row), read from here where they are used
  const unsigned long long* rec_above;
  unsigned long long* rec_out;
  int topm[4];              // the MB above's bottom modes
  // the Intra_16x16 and chroma warp
  alignas(16) uint8_t top[32];   // the record above: Y 16, U 8, V 8
  uint8_t left_y[16], left_u[8], left_v[8];  // the left MB's right columns
  alignas(16) int acl[24 * 16];  // AC levels: 16 luma blocks, then 8 chroma
  int dcl[24];              // DC levels: luma, then chroma
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 64-bit strong (relaxed, gpu-scope) load and store at a generic address,
// in global memory or in the shared memory of a block of the cluster:
// single-copy atomic, and never served by a stale L1 line.
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// Named barrier `id` of `n` threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

// The mbarrier's one arrival, expecting `bytes` of copies.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the mbarrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// A 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A pointer held in shared memory, loaded where it is used: it then takes
// no registers across the MB loop, where the Intra_4x4 warp has none to
// spare at 128.
template <typename T>
__device__ __forceinline__ T* smem_ptr(T* const& p) {
  return *const_cast<T* const volatile*>(&p);
}

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return min(max(x, lo), hi);
}

// Output k of the forward 1-D core transform (transform._bf).
__device__ __forceinline__ int bf(int x0, int x1, int x2, int x3, int k) {
  const int t0 = x0 + x3, t1 = x0 - x3, t2 = x1 + x2, t3 = x1 - x2;
  return k == 0 ? t0 + t2 : k == 1 ? 2 * t1 + t3 : k == 2 ? t0 - t2
                                                          : t1 - 2 * t3;
}

// Coefficient j of output k of the forward 1-D core transform: bf(x, k)
// is the sum over j of fcoef(k, j) x[j].
__device__ __forceinline__ int fcoef(int k, int j) {
  return k == 0 ? 1 : k == 2 ? (j == 0 || j == 3 ? 1 : -1)
         : k == 1 ? (j == 0 ? 2 : j == 1 ? 1 : j == 2 ? -1 : -2)
                  : (j == 0 ? 1 : j == 1 ? -2 : j == 2 ? 2 : -1);
}

// Output k of the inverse 1-D core transform (transform._ibf).
__device__ __forceinline__ int ibf(int d0, int d1, int d2, int d3, int k) {
  const int e0 = d0 + d2, e1 = d0 - d2;
  const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  return k == 0 ? e0 + e3 : k == 1 ? e1 + e2 : k == 2 ? e1 - e2 : e0 - e3;
}

// Forward 4x4 core transform of a block in registers, in place
// (transform.fdct4x4: columns, then rows).
__device__ __forceinline__ void fdct(int* x) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int a = x[j], b = x[4 + j], c = x[8 + j], d = x[12 + j];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[4 * k + j] = bf(a, b, c, d, k);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = x[4 * i], b = x[4 * i + 1], c = x[4 * i + 2],
              d = x[4 * i + 3];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[4 * i + k] = bf(a, b, c, d, k);
  }
}

// Inverse 4x4 core transform with the final (x + 32) >> 6, in place
// (transform.idct4x4: rows, then columns).
__device__ __forceinline__ void idct(int* x) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = x[4 * i], b = x[4 * i + 1], c = x[4 * i + 2],
              d = x[4 * i + 3];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[4 * i + k] = ibf(a, b, c, d, k);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int a = x[j], b = x[4 + j], c = x[8 + j], d = x[12 + j];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[4 * k + j] = (ibf(a, b, c, d, k) + 32) >> 6;
  }
}

__device__ __forceinline__ int sgn_mag(int f, int mag) {
  return f > 0 ? mag : f < 0 ? -mag : 0;
}

// The sum of v over groups of `width` lanes (a power of 2).
__device__ __forceinline__ unsigned warp_sum(unsigned v, int width) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    if (o < width) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The low 32 bits of a record unit, once its tag is set; 0 where the lane
// does not want one. `u` holds the unit as last loaded. Every lane of the
// warp calls it.
__device__ __forceinline__ uint32_t await_unit(
    unsigned long long& u, const unsigned long long* p, bool want) {
  while (!__all_sync(kFull, !want || u >= kTag))
    if (want && u < kTag) u = ld_relaxed(p);
  return want ? (uint32_t)u : 0u;
}

// prmt.b32: byte k of the result is byte (sel >> 4k) & 7 of (hi:lo) (the
// selectors K3 passes have bit 3 clear, so __byte_perm's masking is not
// needed).
__device__ __forceinline__ unsigned prmt(unsigned lo, unsigned hi,
                                         unsigned sel) {
  unsigned v;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(v) : "r"(lo), "r"(hi), "r"(sel));
  return v;
}

// Four canvas pixels as the bytes of a word.
__device__ __forceinline__ uint32_t pack4(const int* v) {
  return (uint32_t)v[0] | ((uint32_t)v[1] << 8) | ((uint32_t)v[2] << 16)
         | ((uint32_t)v[3] << 24);
}

// ---------------------------------------------------------------------------
// the Intra_4x4 warp (intra4.encode_i4x4_mb) in 10 waves
// ---------------------------------------------------------------------------

// The top-right record unit: lane 5 waits for it before wave 3 (where
// `want`) and writes its 4 pixels into the canvas.
struct TopRight {
  unsigned long long* u;
  const unsigned long long* p;
  bool want;
};

__device__ void intra4_warp(Smem& s, Result& res, const Slot& in, int lane,
                            bool a_top, bool a_left, bool a_tl, bool a_tr,
                            int qp, int lam, int dz, int i4_penalty,
                            TopRight tr) {
  const int h = lane >> 4, pix = lane & 15, py = pix >> 2, px = pix & 3;
  const int cls = s.pos[pix];
  // this lane's quantiser (transform.quant4x4 and dequant4x4)
  const int qbits = 15 + qp / 6;
  const int mf = s.mf[(qp % 6) * 3 + cls], fq = dz << (qbits - 8);
  const int dq = s.dv[(qp % 6) * 3 + cls] * (1 << (qp / 6));
  // this lane's rows of the forward transform: its column pass gives row
  // py, its row pass column px
  int cy[4], cx[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cy[j] = fcoef(py, j);
    cx[j] = fcoef(px, j);
  }
  int cost = 0;
#pragma unroll 1
  for (int t = 0; t < 10; ++t) {
    if (t == 3) {
      const uint32_t v = await_unit(*tr.u, tr.p, tr.want && lane == 5);
      if (lane == 5 && tr.want) {
#pragma unroll
        for (int k = 0; k < 4; ++k) s.can[17 + k] = (v >> (8 * k)) & 0xff;
      }
      __syncwarp();
    }
    // half 1 takes block (t / 2, t % 2), half 0 block (t / 2 - 1,
    // t % 2 + 2); a half without a block (waves 0, 1, 8, 9) works on a
    // clamped one and writes nothing
    const int bi_w = h ? (t >> 1) : (t >> 1) - 1;
    const bool live = bi_w >= 0 && bi_w <= 3;
    const int bi = clip3(0, 3, bi_w), bj = h ? (t & 1) : (t & 1) + 2;
    const int b = bi * 4 + bj, y0 = 4 * bi, x0 = 4 * bj;
    const bool at = bi > 0 || a_top, al = bj > 0 || a_left;
    const bool atl = (bi > 0 && bj > 0) ? true
                     : (bi == 0 && bj == 0) ? a_tl : (bi == 0 ? a_top
                                                               : a_left);
    // the neighbours U = [l3, l2, l1, l0, tl, t0..t3, t4..t7] as bytes;
    // t4..t7 replicate t3 where the top-right is not available
    // (NO_TOPRIGHT: raster blocks 5, 7, 11, 13, 15)
    // (lanes 13-15 copy U[12] into bytes no tap reads)
    {
      const bool tr_ok = !((0xa8a0 >> b) & 1)
                         && (bi > 0 || (bj == 3 ? a_tr : a_top));
      const int n = min(pix, 12);
      const int off = n < 4 ? (4 - n) * kCanW : n < 9 || tr_ok ? n - 4 : 4;
      s.nb[h][pix] = (uint8_t)s.can[y0 * kCanW + x0 + off];
    }
    __syncwarp();
    const uint4 u = *reinterpret_cast<const uint4*>(s.nb[h]);
    const unsigned u5 = __byte_perm(u.y, u.z, 0x4321);   // U[5..8]
    const unsigned u9 = __byte_perm(u.z, u.w, 0x4321);   // U[9..12]
    // the predictions: DC from the edge sums, the other modes each
    // (U[a] + U[b] + U[c] + U[d] + 2) >> 2, its 4 taps permuted out of an
    // 8-byte window of U and summed by one dot product
    int pred[9];
    {
      const int st = __dp4a(u5, 0x01010101u, 0u);
      const int sl = __dp4a(u.x, 0x01010101u, 0u);
      pred[2] = (at && al) ? (st + sl + 4) >> 3
                : at ? (st + 2) >> 2 : al ? (sl + 2) >> 2 : 128;
    }
    const unsigned win = s.i4win[pix];
#pragma unroll
    for (int k = 0; k < kTapModes; ++k) {
      const bool w = (win & (1u << k)) != 0;
      const unsigned lo = w ? u5 : u.x, hi = w ? u9 : u.y;
      pred[k < 2 ? k : k + 1] =
          (int)(__dp4a(prmt(lo, hi, s.i4sel[pix][k]), 0x01010101u, 2u)
                >> 2);
    }
    const int src = in.src_y[(y0 + py) * 16 + x0 + px];
    // SADs of the half's 16 pixels, two modes per word (each at most 4080)
    int sad[9];
#pragma unroll
    for (int m = 0; m < 9; m += 2) {
      unsigned v = abs(src - pred[m]);
      if (m + 1 < 9) v |= abs(src - pred[m + 1]) << 16;
      v = warp_sum(v, 16);
      sad[m] = v & 0xffff;
      if (m + 1 < 9) sad[m + 1] = v >> 16;
    }
    // the predicted mode (spec 8.3.1.1)
    const int ma = bj == 0 ? s.em_r[bi] : s.modes[b - 1];
    const int mb = bi == 0 ? s.topm[bj] : s.modes[b - 4];
    const int pm = (at && al) ? min(ma, mb) : 2;
    const bool diag = at && al && atl;
    const bool valid[9] = {at, al, true, at, diag, diag, diag, at, al};
    // the first minimum of the costs: the least (cost << 4 | mode)
    int key[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      key[k] = valid[k] ? ((sad[k] + lam * (k == pm ? 1 : 4)) << 4) | k
                        : 0x7fffffff;
    const int kmin = min(min(min(key[0], key[1]), min(key[2], key[3])),
                         min(min(key[4], key[5]),
                             min(min(key[6], key[7]), key[8])));
    const int m = kmin & 15;
    if (live) cost += kmin >> 4;
    const int p01 = (m & 1) ? pred[1] : pred[0];
    const int p23 = (m & 1) ? pred[3] : pred[2];
    const int p45 = (m & 1) ? pred[5] : pred[4];
    const int p67 = (m & 1) ? pred[7] : pred[6];
    const int p03 = (m & 2) ? p23 : p01, p47 = (m & 2) ? p67 : p45;
    const int p = (m & 8) ? pred[8] : (m & 4) ? p47 : p03;
    // transform, quantise, reconstruct: a lane per coefficient, rows and
    // columns gathered by shuffles within the half's 16 lanes
    const int res0 = src - p;
    int x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = __shfl_sync(kFull, res0, 4 * j + px, 16);
    const int tt = (cy[0] * x[0] + cy[1] * x[1])
                   + (cy[2] * x[2] + cy[3] * x[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[j] = __shfl_sync(kFull, tt, py * 4 + j, 16);
    const int w = (cx[0] * x[0] + cx[1] * x[1])
                  + (cx[2] * x[2] + cx[3] * x[3]);
    const int mag = (abs(w) * mf + fq) >> qbits;
    const int lev = w > 0 ? mag : w < 0 ? -mag : 0;
    const int d = lev * dq;
    const int ti = ibf(__shfl_sync(kFull, d, py * 4, 16),
             __shfl_sync(kFull, d, py * 4 + 1, 16),
             __shfl_sync(kFull, d, py * 4 + 2, 16),
             __shfl_sync(kFull, d, py * 4 + 3, 16), px);
    const int r = (ibf(__shfl_sync(kFull, ti, px, 16),
                       __shfl_sync(kFull, ti, 4 + px, 16),
                       __shfl_sync(kFull, ti, 8 + px, 16),
                       __shfl_sync(kFull, ti, 12 + px, 16), py) + 32)
                  >> 6;
    if (live) {
      const int rec = clip3(0, 255, r + p);
      s.can[(y0 + 1 + py) * kCanW + x0 + 1 + px] = rec;
      s.lev4[b * 16 + pix] = lev;
      if (bj == 3 && px == 3) res.i4col[y0 + py] = (uint8_t)rec;
      if (pix == 0) {
        const bool eq = m == pm;
        s.modes[b] = m;
        s.symv[b] = eq ? 1 : (m < pm ? m : m - 1);
        s.syml[b] = eq ? 1 : 4;
      }
    }
    __syncwarp();
  }
  cost = __shfl_sync(kFull, cost, 0) + __shfl_sync(kFull, cost, 16);
  if (lane == 0) res.cost4 = cost + lam * i4_penalty;
}

// ---------------------------------------------------------------------------
// the other warp: Intra_16x16 (intra.predict_16x16, intra.select_mode,
// mbscan._encode_luma_i16) and chroma (intra.predict_chroma with the
// per-quadrant DC, the summed SAD argmin, mbscan._encode_chroma)
// ---------------------------------------------------------------------------

// The DC prediction of quadrant q (raster) of a chroma plane: quadrants 0
// and 3 from the top and left sums, 1 preferring the top, 2 the left.
__device__ __forceinline__ int chroma_dc(const Smem& s, int plane, int q,
                                         bool a_top, bool a_left) {
  const uint8_t* left = plane ? s.left_v : s.left_u;
  const uint8_t* top = s.top + 16 + 8 * plane;
  int st = 0, sl = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    st += top[(q & 1) * 4 + k];
    sl += left[(q >> 1) * 4 + k];
  }
  const int both = (st + sl + 4) >> 3, t_only = (st + 2) >> 2,
            l_only = (sl + 2) >> 2;
  if (q == 0 || q == 3)
    return (a_top && a_left) ? both : a_top ? t_only : a_left ? l_only : 128;
  if (q == 1) return a_top ? t_only : a_left ? l_only : 128;
  return a_left ? l_only : a_top ? t_only : 128;
}

__device__ void intra16_chroma_warp(Smem& s, Result& res, const Slot& in,
                                    int lane, bool a_top, bool a_left,
                                    int qp, int qpc, int dz, int& mode16,
                                    int& cmode) {
  int st = 0, sl = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    st += s.top[k];
    sl += s.left_y[k];
  }
  const int dc16 = (a_top && a_left) ? (st + sl + 16) >> 5
                   : a_top ? (st + 8) >> 4 : a_left ? (sl + 8) >> 4 : 128;
  // the SADs: a lane per half row of luma (V, H, DC) and per half row of
  // a chroma plane (DC, H, V; U and V summed), two per word (at most 65280
  // each)
  {
    const int y = lane >> 1, xb = (lane & 1) * 8;
    unsigned sv = 0, sh = 0, sd = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int x = xb + k, v = in.src_y[y * 16 + x];
      sv += abs(v - s.top[x]);
      sh += abs(v - s.left_y[y]);
      sd += abs(v - dc16);
    }
    const int p = lane >> 4, cy = (lane & 15) >> 1, cxb = (lane & 1) * 4;
    const uint8_t* src = p ? in.src_v : in.src_u;
    const uint8_t* left = p ? s.left_v : s.left_u;
    const uint8_t* top = s.top + 16 + 8 * p;
    const int dc = chroma_dc(s, p, (cy >> 2) * 2 + (lane & 1), a_top, a_left);
    unsigned cd = 0, ch = 0, cv = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = cxb + k, v = src[cy * 8 + x];
      cd += abs(v - dc);
      ch += abs(v - left[cy]);
      cv += abs(v - top[x]);
    }
    const unsigned w0 = warp_sum(sv | (sh << 16), 32);
    const unsigned w1 = warp_sum(sd | (cd << 16), 32);
    const unsigned w2 = warp_sum(ch | (cv << 16), 32);
    const int c16[3] = {a_top ? (int)(w0 & 0xffff) : kInvalid,
                        a_left ? (int)(w0 >> 16) : kInvalid,
                        (int)(w1 & 0xffff)};
    mode16 = 0;
    int cost = c16[0];
    if (c16[1] < cost) { mode16 = 1; cost = c16[1]; }
    if (c16[2] < cost) { mode16 = 2; cost = c16[2]; }
    if (lane == 0) res.cost16 = cost;
    const int cc[3] = {(int)(w1 >> 16), a_left ? (int)(w2 & 0xffff) : kInvalid,
                       a_top ? (int)(w2 >> 16) : kInvalid};
    cmode = 0;
    int ccost = cc[0];
    if (cc[1] < ccost) { cmode = 1; ccost = cc[1]; }
    if (cc[2] < ccost) cmode = 2;
  }
  // a lane per 4x4 block: luma blocks on lanes 0-15, U on 16-19, V on
  // 20-23 (lanes 24-31 repeat V's last and write nothing)
  const bool luma = lane < 16, live = lane < 24;
  const int cb = luma ? 0 : min(lane - 16, 7), p = cb >> 2, blk = cb & 3;
  const int bi = luma ? lane >> 2 : blk >> 1, bj = luma ? lane & 3 : blk & 1;
  const int q = luma ? qp : qpc;
  const int stride = luma ? 16 : 8;
  const uint8_t* src = (luma ? in.src_y : p ? in.src_v : in.src_u)
                       + 4 * bi * stride + 4 * bj;
  // the prediction: kind 0 vertical, 1 horizontal, 2 DC (chroma's modes
  // are DC, H, V)
  const int kind = luma ? mode16 : 2 - cmode;
  const uint8_t* top = luma ? s.top + 4 * bj : s.top + 16 + 8 * p + 4 * bj;
  const uint8_t* left = (luma ? s.left_y : p ? s.left_v : s.left_u) + 4 * bi;
  const int dc = luma ? dc16 : chroma_dc(s, p, blk, a_top, a_left);
  // the block's rows of source, its top row and left column, as words
  uint32_t srow[4];
#pragma unroll
  for (int y = 0; y < 4; ++y)
    srow[y] = *reinterpret_cast<const uint32_t*>(src + y * stride);
  const uint32_t tw = *reinterpret_cast<const uint32_t*>(top);
  const uint32_t lw = *reinterpret_cast<const uint32_t*>(left);
  auto pred = [&](int k) {
    return kind == 0 ? (int)((tw >> (8 * (k & 3))) & 0xff)
           : kind == 1 ? (int)((lw >> (8 * (k >> 2))) & 0xff) : dc;
  };
  int x[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    x[k] = (int)((srow[k >> 2] >> (8 * (k & 3))) & 0xff) - pred(k);
  fdct(x);
  // this lane's quantiser (transform.quant4x4, dequant4x4)
  const int q6 = q % 6, d6 = q / 6, qbits = 15 + d6;
  const int fq = dz << (qbits - 8);
  const int slot = luma ? lane : 16 + cb;
  int dcv = x[0];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int i = q6 * 3 + s.pos[k];
    const int mag = (abs(x[k]) * s.mf[i] + fq) >> qbits;
    const int lev = x[k] > 0 ? mag : x[k] < 0 ? -mag : 0;
    if (live) s.acl[slot * 16 + k] = k == 0 ? 0 : lev;
    x[k] = lev * s.dv[i] * (1 << d6);
  }
  // the DC transforms (transform.quant_luma_dc, quant_chroma_dc and their
  // dequantisation) a lane per coefficient: Walsh-Hadamard butterflies
  // over the lanes' bits 0-1 (a chroma plane's 4 blocks, or a row of
  // luma blocks) and, for luma, 2-3 (the rows). They give the natural
  // (Walsh) order, which is transform.hadamard2x2's; hadamard4x4's row i
  // ((1, 1, 1, 1), (1, 1, -1, -1), (1, -1, -1, 1), (1, -1, 1, -1)) is the
  // natural row (0x1320 >> 4 i) & 15.
  auto wht = [&](int v) {
#pragma unroll
    for (int bit = 1; bit < 16; bit <<= 1) {
      const int o = __shfl_xor_sync(kFull, v, bit);
      if (luma || bit < 4) v = (lane & bit) ? o - v : v + o;
    }
    const int src_lane = ((0x1320 >> (4 * (lane >> 2))) & 15) * 4
                         + ((0x1320 >> (4 * (lane & 3))) & 15);
    const int w = __shfl_sync(kFull, v, luma ? src_lane : lane);
    return luma ? w : v;
  };
  {
    const int f = wht(dcv);
    const int qb = (luma ? 17 : 16) + d6;
    dcv = sgn_mag(f, (abs(f) * s.mf[q6 * 3] + (1 << (qb - 1))) >> qb);
    if (live) s.dcl[slot] = dcv;
  }
  {
    const int f = wht(dcv) * s.dv[q6 * 3];
    x[0] = luma ? (d6 >= 2 ? f * (1 << (d6 - 2))      // dequant_luma_dc
                           : (f + (1 << (1 - d6))) >> (2 - d6))
                : (f * (1 << d6)) >> 1;                // dequant_chroma_dc
  }
  idct(x);
  if (live) {
    uint8_t* rec = luma ? res.rec16 + 4 * bi * 16 + 4 * bj
                        : res.rec_c + 64 * p + 4 * bi * 8 + 4 * bj;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      uint32_t row = 0;
#pragma unroll
      for (int xx = 0; xx < 4; ++xx)
        row |= (uint32_t)clip3(0, 255, x[4 * y + xx] + pred(4 * y + xx))
               << (8 * xx);
      *reinterpret_cast<uint32_t*>(rec + y * stride) = row;
    }
  }
}

// MB row r of frame f on the block's two warps (`role` 0 Intra_4x4, 1
// Intra_16x16 and chroma). The row above's record units come from
// `s.rec_above` (its MB m's at m * kUnits; unused on row 0), this row's go
// to `s.rec_out` (null without a row below); either lies in global memory
// or in the shared memory of a block of the cluster.
__device__ __forceinline__ void wavefront_row(Smem& s, const Args& a,
                                              int lane, int role, int r,
                                              int f) {
  const int nmb = a.mbw * a.mbh;
  const int qp = clip3(0, 51, a.qp[f]), qpc = clip3(0, 51, a.qpc[f]);
  const int lam = a.lam[f], pen = a.pen[f];
  const bool has_inter = a.inter_cost != nullptr;
  const long long g0 = (long long)f * nmb + (long long)r * a.mbw;
  const bool prefetcher = role == 1 && lane == 0;
  // MB c's inputs into slot c % 3 (by the prefetcher)
  auto prefetch = [&](int c) {
    Slot& d = s.slot[c % kSlots];
    unsigned long long* bar = &s.bar[c % kSlots];
    const long long g = g0 + c;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect(bar, has_inter ? 768 : 384);
    bulk_copy(d.src_y, a.src_y + g * 256, 256, bar);
    bulk_copy(d.src_u, a.src_u + g * 64, 64, bar);
    bulk_copy(d.src_v, a.src_v + g * 64, 64, bar);
    if (has_inter) {
      bulk_copy(d.inter_y, a.rec_y_inter + g * 256, 256, bar);
      bulk_copy(d.inter_u, a.rec_u_inter + g * 64, 64, bar);
      bulk_copy(d.inter_v, a.rec_v_inter + g * 64, 64, bar);
    }
  };
  int icost_next = kInvalid;       // the prefetcher's: MB c + 1's inter cost
  if (prefetcher) {
    prefetch(0);
    if (a.mbw > 1) prefetch(1);
    if (has_inter) {
      s.icost[0] = a.inter_cost[g0];
      if (a.mbw > 1) icost_next = a.inter_cost[g0 + 1];
    }
  }
  // MB 0 has no left MB: zeros, read by invalid modes only
  if (role == 0) {
    if (lane < 16) s.can[(lane + 1) * kCanW] = 0;
    if (lane < 4) s.em_r[lane] = 2;
  } else {
    if (lane < 16) s.left_y[lane] = 0;
    else if (lane < 24) s.left_u[lane - 16] = 0;
    else s.left_v[lane - 24] = 0;
  }
  // The record unit this lane polls for MB c: the Intra_4x4 warp's lanes
  // 0-3 the top Y, 4 the top-left's last Y unit, 5 the top-right's first
  // (at wave 3), 6 the top modes; the other warp's lanes 0-7 the top Y, U
  // and V. Each is loaded one MB ahead, once MB c - 1's top-right record
  // (MB c's top) has been seen: after the Intra_4x4 waves, and after the
  // barrier for the other warp.
  auto unit_of = [&](int c) -> const unsigned long long* {
    const long long m = role == 0 && lane == 4 ? c - 1
                        : role == 0 && lane == 5 ? c + 1 : c;
    const int k = role == 1 ? lane : lane < 4 ? lane : lane == 4 ? 3
                  : lane == 5 ? 0 : 8;
    return smem_ptr(s.rec_above) + m * kUnits + k;
  };
  auto wants = [&](int c, bool at, bool al) {
    return role == 1 ? at && lane < 8
           : lane < 4 || lane == 6 ? at
           : lane == 4 ? at && al
           : lane == 5 && at && c < a.mbw - 1;
  };
  const bool is_tr = role == 0 && lane == 5;
  int i = r * a.mbw;                      // the MB's index in its frame
  bool a_top = r > 0 && a.avail_top[i], a_left = false;
  bool want = wants(0, a_top, false);
  unsigned long long unit = want ? ld_relaxed(unit_of(0)) : 0ull;
  // MB c + 1's availability as loaded (tested a step later, so that the
  // loads are not waited for)
  int nx_top = a.mbw > 1 ? a.avail_top[i + 1] : 0;
  int nx_left = a.mbw > 1 ? a.avail_left[i + 1] : 0;

  for (int c = 0; c < a.mbw; ++c, ++i) {
    const long long g = g0 + c;
    const int sl = c % kSlots;
    Slot& in = s.slot[sl];
    Result& res = s.res[c & 1];
    const bool a_tl = a_top && a_left, a_tr = a_top && c < a.mbw - 1;
    // the records above but the top-right one
    const uint32_t v = await_unit(unit, unit_of(c), want && !is_tr);
    if (role == 0) {
      if (lane < 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          s.can[1 + 4 * lane + k] = (v >> (8 * k)) & 0xff;
      } else if (lane == 4) {
        s.can[0] = v >> 24;                 // pixel 15 of its bottom row
      } else if (lane == 6) {
#pragma unroll
        for (int k = 0; k < 4; ++k) s.topm[k] = (v >> (8 * k)) & 0xff;
      }
    } else if (lane < 8) {
      reinterpret_cast<uint32_t*>(s.top)[lane] = v;
    }
    // MB c + 1's flags; MB c + 2's in flight
    const bool n_top = r > 0 && c + 1 < a.mbw && nx_top != 0;
    const bool n_left = c + 1 < a.mbw && nx_left != 0;
    const bool n_want = c + 1 < a.mbw && wants(c + 1, n_top, n_left);
    if (c + 2 < a.mbw) {
      nx_top = a.avail_top[i + 2];
      nx_left = a.avail_left[i + 2];
    }
    // this MB's inputs
    mbar_wait(&s.bar[sl], (unsigned)(c / kSlots) & 1u);
    __syncwarp();
    int mode16 = 0, cmode = 0;
    if (role == 0) {
      intra4_warp(s, res, in, lane, a_top, a_left, a_tl, a_tr, qp, lam,
                  a.deadzone, a.i4_penalty,
                  TopRight{&unit, unit_of(c), a_tr});
      if (n_want) unit = ld_relaxed(unit_of(c + 1));
    } else {
      intra16_chroma_warp(s, res, in, lane, a_top, a_left, qp, qpc,
                          a.deadzone, mode16, cmode);
    }
    bar_sync(1, kThreads);
    if (role == 1 && n_want) unit = ld_relaxed(unit_of(c + 1));
    // the selection over (inter, I16, I4): the first minimum wins
    const int ci = has_inter ? s.icost[sl] : kInvalid;
    const int c16 = res.cost16 + pen, c4 = res.cost4 + pen;
    int sel = 0, best = ci;
    if (c16 < best) { sel = 1; best = c16; }
    if (c4 < best) sel = 2;
    const uint8_t* rec_y = sel == 1 ? res.rec16 : in.inter_y;  // sel < 2
    if (role == 0) {
      // first the record for the row below: the bottom lines and the
      // bottom Intra_4x4 modes
      unsigned long long* const rec_out = smem_ptr(s.rec_out);
      if (lane < kUnits && rec_out != nullptr) {
        uint32_t w;
        if (lane < 4) {
          w = sel == 2 ? pack4(s.can + 16 * kCanW + 1 + 4 * lane)
                       : reinterpret_cast<const uint32_t*>(rec_y)[60 + lane];
        } else if (lane < 8) {
          const int p = (lane - 4) >> 1, k = lane & 1;
          w = reinterpret_cast<const uint32_t*>(
              sel == 0 ? (p ? in.inter_v : in.inter_u)
                       : res.rec_c + 64 * p)[14 + k];
        } else {
          w = sel == 2 ? pack4(s.modes + 12) : 0x02020202u;
        }
        st_relaxed(rec_out + c * kUnits + lane, kTag | w);
      }
      // then Intra_4x4's outputs
      if (lane == 0) a.sel[g] = sel;
      if (lane < 16) {
        a.i4modes[g * 16 + lane] = s.modes[lane];
        a.i4sym_v[g * 16 + lane] = s.symv[s.scan[lane]];
        a.i4sym_l[g * 16 + lane] = s.syml[s.scan[lane]];
      }
      if (sel == 2) {
        int4* out = reinterpret_cast<int4*>(a.ac_lev + g * 256);
        out[lane] = reinterpret_cast<const int4*>(s.lev4)[lane];
        out[lane + 32] = reinterpret_cast<const int4*>(s.lev4)[lane + 32];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int wd = lane + 32 * k;
          reinterpret_cast<uint32_t*>(a.recon_y + g * 256)[wd] =
              pack4(s.can + ((wd >> 2) + 1) * kCanW + 1 + (wd & 3) * 4);
        }
      }
      // the next MB's left edge: the right column and modes
      __syncwarp();
      if (lane < 16) {
        s.can[(lane + 1) * kCanW] = sel == 2
            ? s.can[(lane + 1) * kCanW + 16] : rec_y[lane * 16 + 15];
      } else if (lane < 20) {
        s.em_r[lane - 16] = sel == 2 ? s.modes[(lane - 16) * 4 + 3] : 2;
      }
      __syncwarp();
    } else {
      if (prefetcher) {              // MB c + 2's inputs, MB c + 1's cost
        if (c + 2 < a.mbw) prefetch(c + 2);
        if (has_inter && c + 1 < a.mbw) {
          s.icost[(c + 1) % kSlots] = icost_next;
          if (c + 2 < a.mbw) icost_next = a.inter_cost[g + 2];
        }
      }
      // Intra_16x16's and chroma's outputs
      if (lane == 0) {
        a.mode16[g] = mode16;
        a.cmode[g] = cmode;
      }
      if (lane < 16) a.dc_lev[g * 16 + lane] = s.dcl[lane];
      else if (lane < 24) a.cdc_lev[g * 8 + lane - 16] = s.dcl[lane];
      if (sel != 2) {
        int4* out = reinterpret_cast<int4*>(a.ac_lev + g * 256);
        out[lane] = reinterpret_cast<const int4*>(s.acl)[lane];
        out[lane + 32] = reinterpret_cast<const int4*>(s.acl)[lane + 32];
      }
      reinterpret_cast<int4*>(a.cac_lev + g * 128)[lane] =
          reinterpret_cast<const int4*>(s.acl + 256)[lane];
      if (lane < 16) {
        if (sel != 2)
          reinterpret_cast<uint4*>(a.recon_y + g * 256)[lane] =
              reinterpret_cast<const uint4*>(rec_y)[lane];
      } else if (lane < 24) {
        const int p = (lane - 16) >> 2, k = lane & 3;
        reinterpret_cast<uint4*>((p ? a.recon_v : a.recon_u) + g * 64)[k] =
            reinterpret_cast<const uint4*>(
                sel == 0 ? (p ? in.inter_v : in.inter_u)
                         : res.rec_c + 64 * p)[k];
      }
      // the next MB's left edges
      __syncwarp();
      if (lane < 16) {
        s.left_y[lane] = sel == 2 ? res.i4col[lane] : rec_y[lane * 16 + 15];
      } else if (lane < 24) {
        const int y = lane - 16;
        s.left_u[y] = sel == 0 ? in.inter_u[y * 8 + 7] : res.rec_c[y * 8 + 7];
      } else {
        const int y = lane - 24;
        s.left_v[y] = sel == 0 ? in.inter_v[y * 8 + 7]
                               : res.rec_c[64 + y * 8 + 7];
      }
      __syncwarp();
    }
    a_top = n_top;
    a_left = n_left;
    want = n_want;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
wavefront_kernel(const Args a) {
  __shared__ Smem s;
  __shared__ int ticket_s, i4_warp_s;
  // this row's record units (mbw x kUnits), read by the next block of the
  // cluster
  extern __shared__ unsigned long long own_rec[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31;
  for (int k = tid; k < kTables; k += kThreads) {
    const int v = a.tables[k];
    if (k < 18) s.mf[k] = v;
    else if (k < 36) s.dv[k - 18] = v;
    else if (k < 52) s.pos[k - 36] = v;
    else if (k < 68) s.scan[k - 52] = v;
    else if (k < 68 + 16 * kTapModes) (&s.i4sel[0][0])[k - 68] = v;
    else s.i4win[k - 68 - 16 * kTapModes] = v;
  }
  for (int k = tid; k < a.mbw * kUnits; k += kThreads) own_rec[k] = 0ull;
  if (tid == 0) {
    // warp w of an SM issues on its scheduler w % 4, and a block's two
    // warps take slots 2k and 2k + 1: Intra_4x4 on warp (k / 2) % 2 puts
    // the Intra_4x4 warps of consecutive blocks on schedulers 0, 2, 1, 3,
    // not all on two of them (only the balance depends on this)
    unsigned slot;
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
    i4_warp_s = (slot >> 2) & 1;
    if (rank == 0) ticket_s = atomicAdd(a.sync, 1);
    for (int k = 0; k < kSlots; ++k) mbar_init(&s.bar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the ticket, the zeroed record units and the mbarriers are visible to
  // the whole cluster
  cluster.sync();
  // the cluster's ticket t takes rows csize * (t / n) + rank of frame t % n
  const int ticket = *cluster.map_shared_rank(&ticket_s, 0);
  const int r = ticket / a.n * csize + rank, f = ticket % a.n;
  if (r < a.mbh) {
    const long long g0 = ((long long)f * a.mbh + r) * a.mbw;
    // the row above: the cluster's previous block's shared memory, or
    // for a cluster's first row the global units of the last row of the
    // cluster above (ticket t - n); the row below likewise
    if (tid == 0) {
      s.rec_above = rank > 0 ? cluster.map_shared_rank(own_rec, rank - 1)
                             : a.records + (g0 - a.mbw) * kUnits;
      s.rec_out = r + 1 == a.mbh ? nullptr
                  : rank + 1 < csize ? own_rec : a.records + g0 * kUnits;
    }
    __syncthreads();
    wavefront_row(s, a, lane, (tid >> 5) ^ i4_warp_s, r, f);
  }
  // the next block of the cluster may still read this one's record units
  cluster.sync();
}

// The launch of `blocks` blocks in clusters of `cluster`, with the shared
// memory of a row's record units at mbw MBs.
cudaLaunchConfig_t launch_config(unsigned blocks, int cluster, int mbw,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)mbw * kUnits * sizeof(unsigned long long);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allow the record units' shared memory at mbw MBs.
cudaError_t allow_smem(int mbw) {
  return cudaFuncSetAttribute(wavefront_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              mbw * kUnits * (int)sizeof(unsigned long long));
}

}  // namespace

extern "C" int h264lab_wavefront(
    const void* src_y, const void* src_u, const void* src_v, const void* qp,
    const void* qpc, const void* lam, const void* pen, const void* avail_top,
    const void* avail_left, const void* inter_cost, const void* rec_y_inter,
    const void* rec_u_inter, const void* rec_v_inter, const void* tables,
    void* sel, void* mode16, void* cmode, void* dc_lev, void* ac_lev,
    void* cdc_lev, void* cac_lev, void* recon_y, void* recon_u,
    void* recon_v, void* i4modes, void* i4sym_v, void* i4sym_l,
    void* records, void* sync, long long n, int mbw, int mbh, int deadzone,
    int i4_penalty, int cluster, void* stream) {
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  if (cluster < 1 || cluster > 8) return (int)cudaErrorInvalidValue;
  const long long groups = (mbh + cluster - 1) / cluster;
  if (n * groups * cluster >= (1ll << 31) || n * mbw * mbh >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint8_t*)src_y, (const uint8_t*)src_u,
               (const uint8_t*)src_v, (const int32_t*)qp,
               (const int32_t*)qpc, (const int32_t*)lam, (const int32_t*)pen,
               (const uint8_t*)avail_top, (const uint8_t*)avail_left,
               (const int32_t*)inter_cost, (const uint8_t*)rec_y_inter,
               (const uint8_t*)rec_u_inter, (const uint8_t*)rec_v_inter,
               (const int32_t*)tables, (int32_t*)sel, (int32_t*)mode16,
               (int32_t*)cmode, (int32_t*)dc_lev, (int32_t*)ac_lev,
               (int32_t*)cdc_lev, (int32_t*)cac_lev, (uint8_t*)recon_y,
               (uint8_t*)recon_u, (uint8_t*)recon_v, (int32_t*)i4modes,
               (int32_t*)i4sym_v, (int32_t*)i4sym_l,
               (unsigned long long*)records, (int*)sync, (int)n, mbw, mbh,
               deadzone, i4_penalty};
  cudaError_t e = allow_smem(mbw);
  if (e != cudaSuccess) return (int)e;
  // a cluster of `cluster` blocks per `cluster` MB rows of each frame
  // (rows past mbh idle); each cluster draws its rows from the ticket
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      (unsigned)(n * groups * cluster), cluster, mbw, (cudaStream_t)stream,
      &attr);
  e = cudaLaunchKernelEx(&cfg, wavefront_kernel, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// K3's resident blocks per SM and clusters on the card at mbw MBs a row
// (out[0], out[1]).
extern "C" int h264lab_wavefront_occupancy(int mbw, int cluster, int* out) {
  cudaError_t e = allow_smem(mbw);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], wavefront_kernel, kThreads,
        (size_t)mbw * kUnits * sizeof(unsigned long long));
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config((unsigned)cluster, cluster, mbw, nullptr, &attr);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&out[1], wavefront_kernel, &cfg);
  return (int)e;
}
