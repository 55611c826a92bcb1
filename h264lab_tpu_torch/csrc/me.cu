// K4 and K5 of h264lab_tpu_torch: the motion search of the P path, written
// by hand for NVIDIA Hopper (sm_90a).
//
// K4 replaces h264lab_tpu/ops/me.py:385 `motion_search_dense` (the coarse
// 4x search `coarse_search_4x` :83, the spatial predictor :182, the
// candidate centres, the full-pel sweep `_sweep_fullpel` :326, the 6-tap
// half-pel planes :204, the phase planes :269 and the quarter-pel sweep
// `_sweep_qpel` :352), which the JAX package left to XLA's fori_loops (no
// Pallas kernel). K5 replaces h264lab_tpu/ops/me.py:575 `partition_search`
// with `_search_geometry` :523 (the 16x8, 8x16 and 8x8 partitions of speed
// 0). Each is equal array for array to the port's plain version,
// `motion_search_dense` and `partition_search` of ops/me.py, which stay
// beside them as the reference and the CPU path.
//
// K4 is one launch: a block of 8 warps per tile of 2 x 8 MBs of a frame
// or band, with no dependency between blocks.
//   - The coarse field in the block. An MB's predictor reads the coarse
//     winners of its left, top and top-right (top-left on the last
//     column) neighbours, so the block searches its own MBs and the halo
//     they read: the column to the left, the row above from one column
//     left to one right, and the column to the right of the rows but the
//     last; nothing above the band's first row, where the predictor takes
//     the left neighbour alone. The halo repeats 13 of a full tile's 16
//     MBs of coarse work, about 3% of K4's operations. The coarse +-8
//     search runs a half warp per MB on a 4x strip in shared memory (the
//     band window of each dy at its clamped row, as the plain version
//     clamps it): lane j takes column j of the 17 x 17 positions, the
//     column's 20 rows of 4 bytes in registers, 4 packed SADs a position.
//     The MB that a block owns is written by that block only.
//   - A reference strip per tile in shared memory: every window an MB
//     reads lies within +-kGuard = 64 pixels of it, so (16 x 2 + 128) rows
//     of (16 x 8 + 128) bytes of the lane's padded plane hold every
//     centre, window and sweep of the tile. The block's warps copy it,
//     one bulk copy (cp.async.bulk) per row on an mbarrier, while the
//     block runs the coarse search (and each warp's first MB's inputs
//     load). Its origin is clamped as `qpel.windows` clamps a window start
//     (`search_kernel` says why that makes every window lie inside it).
//   - Row-split sweeps with the reference words in registers. A warp
//     takes an MB; lane (i, h) owns row i and half h of it (2 words of
//     the current block in registers). Full-pel: per dy the lane's 14
//     reference bytes (4 words, aligned by funnel shifts), the 7 dx by
//     funnel shifts of those registers, partial SADs of all 49 positions.
//     Quarter-pel: the lane's rows of F, B, H and J (3 words a row) in
//     registers, every phase word by funnel shifts and `__vavgu4` of two
//     of them. Then a reduce-scatter (`reduce_scatter`: the 49 partial
//     sums packed two to a word, five rounds of shuffles) leaves each lane
//     with the totals of two positions, and one `warp_min` of the signed
//     (cost, raster index) keys takes the winner.
//   - The 6-tap planes spread over the warp: lane (c, h) takes columns
//     2 c and 2 c + 1 of the 27 x 27 window as the two 16-bit halves of a
//     word, and half of its rows: their vertical sums (kept unclamped, with
//     a bias that keeps the halves apart, for J) with F and H; lane y takes
//     row y of B (two byte dot products a sample) and of J (from the
//     vertical sums). They go to device memory only when K5 will read them
//     (uint8, (n * nmb, 4, 22, 22)).
//   - 3 blocks an SM (at most 80 registers a thread, 72,840 bytes of
//     shared memory a block): 24 warps hide the shared loads' latency.
// K5 is one launch: a warp per MB, blocks of kWarps5 warps, no dependency
//   between warps. Lane (i, h) owns row i and half h of the MB, as in K4's
//   sweeps, with its rows of the planes in registers.
//   - One full-pel pass for all three geometries: the 25 positions +-2
//     around the 16x16 winner on F. A block of 16x8 or 8x16 at a full-pel
//     position is two 8x8 quadrants there, so a segmented reduce-scatter
//     (3 rounds) gives the quadrants' SADs and one shuffle across h or
//     across i >> 3 the halves'; 25 x 256 SAD terms an MB where the three
//     geometries' sweeps took 3 x 25 x 256.
//   - A quarter-pel pass per geometry, every block at once: each lane
//     sweeps the 49 positions +-3 around its own block's full-pel winner
//     (its plane rows aligned once by a funnel shift of the winner's
//     column, then K4's compile-time phase code), 32 lanes busy; a
//     segmented reduce-scatter (3 or 4 rounds) and a segmented keyed
//     minimum over the block's lanes.
//   - Bound: 244,992 operations an MB, the function's scalar work with one
//     full-pel pass (chip_smoke.py `K5_OPS_NEEDED_PER_MB`), 0.030 ms a
//     1080p frame at 67 T/s; VABSDIFF4 does four SAD terms at once, so
//     the count is a loose bound.
//
// Every sweep is a minimum over (cost, raster index) keys, signed 64-bit
// (the quarter-pel skip bias can make a cost negative), which is the plain
// loops' rule of a strict `<` in raster order: the first position of the
// least cost wins, whatever lane sums or keys it. SADs are packed byte
// instructions, one VABSDIFF4 with its accumulator on sm_90a (`sad4`); the
// phase averages `__vavgu4`, which rounds as (a + b + 1) >> 1 and takes
// four instructions there (no packed average is native).
//
// Bound. At 16 frames of 1080p (130,560 MBs) the search reads about 114
// MB (tiles 33 MB, the lanes' padded luma 40 MB, the 4x planes 2.5 MB) and
// writes about 38 MB (more with K5's planes): 0.05 ms at 3.35 TB/s. Its
// integer work, counted on the plain algorithm, is about 151,000
// operations per MB with the sub-pel stage (chip_smoke.py
// `K4_OPS_SUBPEL`): 0.29 ms at 67 T/s. So the work bounds it, and the
// packed byte instructions (four pixels an instruction) are what the
// design leans on; the halo's repeated coarse search is not counted.
//
// Integer semantics of ops/me.py: `>>` of negative ints is arithmetic;
// window starts are clamped into the plane as `qpel.windows` clamps them;
// mv bits are 2 (32 - clz(code)) - 1 of the Exp-Golomb code.
//
// Plain C interface, loaded with ctypes; each entry point launches on the
// given stream, allocates nothing and returns the launch's error.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGuard = 64;               // ops/qpel.py GUARD
constexpr int kG4 = kGuard / 4;
constexpr int kR4 = 8;                   // COARSE_R4
constexpr int kSide4 = 2 * kR4 + 1;      // 17
constexpr int kWinM = 9;                 // WIN_M
constexpr int kWinS = 16 + 2 * kWinM;    // 34
constexpr int kMaxCand = kGuard - kWinM - 3;   // MAX_CAND_FP, 52
constexpr int kSub = 22;                 // plane side
constexpr int kPlStride = 24;
constexpr int kPlane = kSub * kPlStride;
constexpr int kPlaneOut = kSub * kSub;   // 484 bytes a plane in memory
constexpr int kAln = 27;                 // ALN_S, the planes' window side
constexpr int kHrStride = 28;            // 16-bit vertical sums a row
constexpr uint32_t kHrBias = 4096;       // added to each vertical sum
constexpr int kJBias = kHrBias * 32 / 1024;   // J's share of it: 128
// K5's warps a block. At its 80 registers (no spills) an SM holds 24 of its
// warps as 3 blocks of 8 or 6 of 4; in turns on the card blocks of 8 took
// 0.90x the time of blocks of 4 at 16 frames of 1080p (1, 2 and 4 were
// alike, and 64 registers with 8 blocks of 4 spilled and gained nothing)
constexpr int kWarps5 = 8;
constexpr int kChunks5 = 4 * kPlaneOut / 16;   // an MB's planes: 121 chunks
// K4's tile, its strip and its coarse grid
constexpr int kTileR = 2;                // MB rows of a tile
constexpr int kTileC = 8;                // MB columns of a tile
constexpr int kWarps4 = 8;               // K4's warps a block
constexpr int kThreads4 = 32 * kWarps4;
constexpr int kStripH = 16 * kTileR + 2 * kGuard;   // 160
// a strip row: 16 * kTileC + 2 * kGuard bytes as the 16-byte chunks that
// hold it, at most one chunk more
constexpr int kStripStride = 16 * kTileC + 2 * kGuard + 16;   // 272
constexpr int kGridH = kTileR + 1, kGridW = kTileC + 2;
constexpr int kSlots = kGridH * kGridW;  // the coarse grid's MBs
constexpr int kS4H = 4 * kGridH + 2 * kR4;          // 28 4x rows
constexpr int kS4Stride = 4 * kGridW + 2 * kR4 + 4;  // 60 bytes a 4x row
// B's taps as signed bytes: (1, -5, 20, 20) and (-5, 1, 0, 0)
constexpr uint32_t kTapsLo = 0x1414FB01u;
constexpr uint32_t kTapsHi = 0x000001FBu;

// the phase table: for (fy, fx) at index 4 fy + fx, a byte of the first
// plane (bits 0-1: F 0, B 1, H 2, J 3), its row and column shift (bits 2
// and 3), the second plane and its shifts (bits 4-7); a phase sample is
// the rounded average of the two (a plane alone is averaged with itself)
constexpr uint64_t phase_entry(int pa, int eya, int exa, int pb, int eyb,
                               int exb) {
  return (uint64_t)(pa | eya << 2 | exa << 3 | pb << 4 | eyb << 6 |
                    exb << 7);
}
constexpr uint64_t kPhaseLo =
    phase_entry(0, 0, 0, 0, 0, 0) | phase_entry(0, 0, 0, 1, 0, 0) << 8 |
    phase_entry(1, 0, 0, 1, 0, 0) << 16 | phase_entry(1, 0, 0, 0, 0, 1) << 24 |
    phase_entry(0, 0, 0, 2, 0, 0) << 32 | phase_entry(1, 0, 0, 2, 0, 0) << 40 |
    phase_entry(1, 0, 0, 3, 0, 0) << 48 | phase_entry(1, 0, 0, 2, 0, 1) << 56;
constexpr uint64_t kPhaseHi =
    phase_entry(2, 0, 0, 2, 0, 0) | phase_entry(2, 0, 0, 3, 0, 0) << 8 |
    phase_entry(3, 0, 0, 3, 0, 0) << 16 | phase_entry(3, 0, 0, 2, 0, 1) << 24 |
    phase_entry(2, 0, 0, 0, 1, 0) << 32 | phase_entry(2, 0, 0, 1, 1, 0) << 40 |
    phase_entry(3, 0, 0, 1, 1, 0) << 48 | phase_entry(2, 0, 1, 1, 1, 0) << 56;

// the phase table's byte of (fy, fx), i = 4 fy + fx
__host__ __device__ constexpr uint32_t phase_byte(int i) {
  return (uint32_t)((i < 8 ? kPhaseLo >> (8 * i) : kPhaseHi >> (8 * (i - 8))) &
                    0xFF);
}

struct Phase {
  int pa, ya, xa, pb, yb, xb;
};

__device__ __forceinline__ Phase phase_of(int fy, int fx) {
  const unsigned e = phase_byte(4 * fy + fx);
  return Phase{(int)(e & 3), (int)(e >> 2 & 1), (int)(e >> 3 & 1),
               (int)(e >> 4 & 3), (int)(e >> 6 & 1), (int)(e >> 7 & 1)};
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Exp-Golomb bits of se(v): 2 bitlen(code) - 1, code = 2|v| (- 1 if v > 0)
// + 1 (ops/me.py `mv_bits`)
__device__ __forceinline__ int mv_bits(int v) {
  const unsigned code = (v > 0 ? 2u * (unsigned)v - 1u : (unsigned)(-2 * v)) +
                        1u;
  return 2 * (32 - __clz(code)) - 1;
}

// a (cost, raster index) key: the least key is the least cost, then the
// first position
__device__ __forceinline__ long long key_of(int cost, int idx) {
  return (long long)cost * 4294967296ll + idx;
}

__device__ __forceinline__ int key_idx(long long key) {
  return (int)((unsigned long long)key & 0xFFFFFFFFull);
}

__device__ __forceinline__ int key_cost(long long key) {
  return (int)((key - key_idx(key)) / 4294967296ll);
}

__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const long long w = __shfl_xor_sync(0xFFFFFFFFu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

// bytes x .. x + 3 of a shared row that starts on a 4-byte boundary
__device__ __forceinline__ uint32_t ld4(const uint8_t* row, int x) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (x & ~3));
  return __funnelshift_r(w[0], w[1], (x & 3) * 8);
}

// four phase samples of a quarter-pel position: the planes (4 x kPlane
// bytes), the phase, the position's top-left in plane coordinates
__device__ __forceinline__ uint32_t phase4(const uint8_t* pl, const Phase& p,
                                           int y, int x) {
  const uint32_t a = ld4(pl + p.pa * kPlane + (y + p.ya) * kPlStride, x + p.xa);
  const uint32_t b = ld4(pl + p.pb * kPlane + (y + p.yb) * kPlStride, x + p.xb);
  return __vavgu4(a, b);
}

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

struct MeArgs {
  const uint8_t* y_pad;      // (L, hp, wp)
  const uint8_t* y4_pad;     // (L, h4p, w4p)
  const uint8_t* cur;        // (n, nmb, 16, 16)
  const int32_t* lane;       // (n,)
  const int32_t* row_off;    // (n,)
  const int32_t* qp;         // (n,)
  const int32_t* lam;        // (52,) the ME lambda of each QP
  const int32_t* prev_my;    // (n, nmb) or null
  const int32_t* prev_mx;
  int32_t* cy4;              // (n, nmb) each
  int32_t* cx4;
  int32_t* mvp_y;
  int32_t* mvp_x;
  int32_t* full_my;
  int32_t* full_mx;
  int32_t* mv_y;
  int32_t* mv_x;
  int32_t* cost;
  uint8_t* pred;             // (n, nmb, 16, 16)
  uint8_t* planes;           // (n * nmb, 4, 22, 22) or null
  int nmb, mbw, mbh, hp, wp, h4p, w4p, subpel, tiles_x, tiles;
  int skip_base, skip_qp, skip_bias;
};

// a warp's planes: the vertical 6-tap sums (unclamped, biased by kHrBias,
// 16 bits) and F, B, H, J
struct WarpSmem {
  uint16_t hr[kSub * kHrStride];
  uint8_t pl[4 * kPlane];
};

struct SearchSmem {
  uint8_t strip[kStripH * kStripStride];   // the tile's reference strip
  WarpSmem w[kWarps4];
  uint8_t strip4[kS4H * kS4Stride];        // the coarse grid's 4x strip
  uint32_t cur4[kSlots][4];                // a grid MB's 4x4 block, 4 rows
  int q4[2][kGridH][kGridW];               // the grid's coarse winners
  uint8_t off[kStripH];                    // a strip row's first byte
  unsigned long long bar;                  // the strip's mbarrier
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(arrivals) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// An arrival on the mbarrier, expecting `bytes` of copies more.
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

// c plus the SAD of the 4 bytes of a and b (one VABSDIFF4 with its
// accumulator; `__vsadu4(a, b) + c` takes an add more)
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the 4 unsigned bytes of `a` times the 4 signed bytes of `b`, plus c
__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// bytes o .. o + 3 of the words u[0], u[1], ... (o known at compile time)
template <int O, int N>
__device__ __forceinline__ uint32_t bytes_at(const uint32_t (&u)[N]) {
  static_assert(O / 4 < N && (O % 4 == 0 || O / 4 + 1 < N), "word range");
  if constexpr (O % 4 == 0)
    return u[O / 4];
  else
    return __funnelshift_r(u[O / 4], u[O / 4 + 1], 8 * (O % 4));
}

__device__ __forceinline__ int median3(int x, int y, int z) {
  return max(min(max(x, y), z), min(x, y));
}

// One round of the reduce-scatter: lanes with bit O keep the upper half
// of slots 0 .. 2 O, the others the lower, each adding its partner's copy.
// The halves are chosen by masks, never by an index (an index into v would
// put it in local memory).
template <int O>
__device__ __forceinline__ void scatter_round(uint32_t (&v)[32], int ln) {
  const uint32_t up = (ln & O) ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const uint32_t x = v[j] ^ v[j + O];
    const uint32_t send = v[j + O] ^ (x & up);
    v[j] = (send ^ x) + __shfl_xor_sync(0xFFFFFFFFu, send, O);
  }
}

// The row-split sweep's reduce-scatter. Lane (i, h) holds the SADs of its
// 8 pixels at each of the 49 positions (at most 2040 each, so a total of
// the 32 lanes fits 16 bits); packed two positions to a word (slot s:
// positions 2 s and 2 s + 1), five rounds of shuffles halve the slots a
// lane keeps. Lane l ends with slot l: the totals of positions 2 l (low
// half) and 2 l + 1 (high half).
__device__ __forceinline__ uint32_t reduce_scatter(const uint32_t (&acc)[49],
                                                   int ln) {
  uint32_t v[32];
#pragma unroll
  for (int s = 0; s < 32; ++s)
    v[s] = s < 24 ? acc[2 * s] | acc[2 * s + 1] << 16
                  : (s == 24 ? acc[48] : 0u);
  scatter_round<16>(v, ln);
  scatter_round<8>(v, ln);
  scatter_round<4>(v, ln);
  scatter_round<2>(v, ln);
  scatter_round<1>(v, ln);
  return v[0];
}

// The winner of a 49-position sweep from `reduce_scatter`'s slot: each
// lane keys its two positions by cost (`cost_of(sad, position)`), then the
// least key of the warp
template <typename CostOf>
__device__ __forceinline__ long long sweep_min(uint32_t slot, int ln,
                                               CostOf cost_of) {
  long long best = LLONG_MAX;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 2 * ln + h;
    if (p < 49) {
      const int sad = (int)(h ? slot >> 16 : slot & 0xFFFFu);
      const long long key = key_of(cost_of(sad, p), p);
      best = key < best ? key : best;
    }
  }
  return warp_min(best);
}

// K4: one block per tile of kTileR x kTileC MBs of a frame or band, in
// four steps.
// 1. The warps start the tile's reference strip (bulk copies, one per
//    row) and stage the coarse grid's 4x strip and 4x4 blocks.
// 2. The coarse +-8 search of every grid MB, a half warp each: lane j
//    takes column j of the 17 x 17 positions (its rows of 4 bytes kept in
//    registers) and position (j, 16) (lane 0 also (16, 16)), 4 packed
//    SADs a position; the least key of the half warp.
// 3. Per own MB (a warp each, in turn): the predictor from the grid, the
//    candidate centres, the full-pel sweep (row-split), then the planes
//    and the quarter-pel sweep (row-split), all from the strip.
// 4. The outputs.
__global__ void __launch_bounds__(kThreads4, 3)
    search_kernel(const MeArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  SearchSmem& s = *reinterpret_cast<SearchSmem*>(smem_raw);
  const int tid = threadIdx.x, w = tid >> 5, ln = tid & 31;
  const int f = blockIdx.x / a.tiles, t = blockIdx.x % a.tiles;
  const int r0 = t / a.tiles_x * kTileR, c0 = t % a.tiles_x * kTileC;
  const int R = min(kTileR, a.mbh - r0), C = min(kTileC, a.mbw - c0);
  const int ro = a.row_off[f], lam = a.lam[clampi(a.qp[f], 0, 51)];
  const size_t lane = (size_t)a.lane[f];
  const long long k0 = (long long)f * a.nmb;
  const int i = ln >> 1, hh = ln & 1;       // lane (i, h) of an MB
  // own MB m of the tile (a warp takes m = w, w + 8, ...): m / C for m <
  // 16 as a multiply and a shift
  const int c_inv = 65536 / C + 1;
  auto own_k = [&](int m) {
    const int mr = (m * c_inv) >> 16;
    return k0 + (r0 + mr) * a.mbw + c0 + m - mr * C;
  };
  // a warp's next MB's current words (lane (i, h): row i, pixels 8 h ..
  // 8 h + 7) and previous MV, loaded ahead: the first before the block's
  // setup, whose latency hides them
  uint2 cur_next = make_uint2(0u, 0u);
  int prev_next[2] = {0, 0};
  auto load_next = [&](int m) {
    if (m >= R * C) return;
    const long long k = own_k(m);
    cur_next = __ldg(reinterpret_cast<const uint2*>(a.cur + k * 256 +
                                                    16 * i + 8 * hh));
    if (a.prev_my != nullptr) {
      prev_next[0] = __ldg(a.prev_my + k);
      prev_next[1] = __ldg(a.prev_mx + k);
    }
  };
  load_next(w);

  // 1. The strip: rows sy .. sy + sh and columns sx .. sx + sw of the
  // lane's padded plane. Every window of an MB of the tile starts within
  // +-(kMaxCand + kWinM) = 61 pixels of its MB and ends within 77, all
  // inside the MB +-kGuard. The strip's origin is clamped into the plane
  // as `qpel.windows` clamps a window start, and a strip larger than the
  // plane is the plane: so the strip lies in the plane and holds every
  // window, clamped or not (a window starts at or after the strip's
  // origin, since both are clamped alike and the window's unclamped
  // start is the later; it ends at or before the strip's end, the MB +
  // 80 or the plane's end). No copy reads outside the plane's rows, and
  // no read depends on bytes the copies did not write.
  const int sh = min(16 * R + 2 * kGuard, a.hp);
  const int sw = min(16 * C + 2 * kGuard, a.wp);
  const int sy = clampi(16 * (r0 + ro), 0, a.hp - sh);
  const int sx = clampi(16 * c0, 0, a.wp - sw);
  // A row is copied as the 16-byte aligned chunks that hold it (a chunk
  // of a mapped byte is mapped), its first byte at off[y] in its slot.
  // Lane l of warp w copies row w + 8 l; each warp's arrival on the
  // mbarrier announces its bytes before its copies.
  static_assert(kStripH <= 32 * kWarps4, "a row a lane");
  if (tid == 0) mbar_init(&s.bar, kWarps4);
  __syncthreads();
  {
    const int y = w + kWarps4 * ln;
    uintptr_t lo = 0;
    unsigned bytes = 0;
    if (y < sh) {
      const uintptr_t p = (uintptr_t)(a.y_pad + lane * a.hp * a.wp +
                                      (size_t)(sy + y) * a.wp + sx);
      lo = p & ~(uintptr_t)15;
      bytes = (unsigned)(((p + sw + 15) & ~(uintptr_t)15) - lo);
      s.off[y] = (uint8_t)(p - lo);
    }
    const unsigned total = __reduce_add_sync(0xFFFFFFFFu, bytes);
    if (ln == 0) mbar_expect(&s.bar, total);
    __syncwarp();
    if (bytes) bulk_copy(s.strip + y * kStripStride, (const void*)lo, bytes,
                         &s.bar);
  }

  // the coarse grid: MB rows r0 - 1 .. r0 + R - 1 and columns c0 - 1 ..
  // c0 + C (slot (gr, gc) is MB (r0 - 1 + gr, c0 - 1 + gc)), the MBs of
  // the band (none above its first row, none outside its columns) but the
  // bottom right one, which no predictor of the tile reads
  auto grid_mb = [&](int slot, int& r, int& c) {
    const int gr = slot / kGridW, gc = slot % kGridW;
    r = r0 - 1 + gr;
    c = c0 - 1 + gc;
    return gr <= R && gc <= C + 1 && r >= 0 && c >= 0 && c < a.mbw &&
           !(gr == R && gc == C + 1);
  };
  // the 4x strip: the band window of each dy starts at a clamped row,
  // Y(d) = clamp(y0 + d, 0, h4p - h4), as `qpel.windows` clamps the plain
  // version's band windows; its columns start at x0 + 4 c
  const int h4 = 4 * a.mbh;
  const int x0 = clampi(kG4 - kR4, 0, a.w4p - (4 * a.mbw + 2 * kR4));
  const int y0 = kG4 + 4 * ro - kR4;
  const int ylo = clampi(y0, 0, a.h4p - h4);
  const int rmin = max(r0 - 1, 0), cmin = max(c0 - 1, 0);
  const int cmax = min(c0 + C, a.mbw - 1);
  {
    const int n4 = clampi(y0 + 2 * kR4, 0, a.h4p - h4) - ylo +
                   4 * (r0 + R - rmin);
    const int m4 = 4 * (cmax - cmin + 1) + 2 * kR4;
    const uint8_t* ref4 = a.y4_pad + lane * a.h4p * a.w4p +
                          (size_t)(ylo + 4 * rmin) * a.w4p + x0 + 4 * cmin;
    // all loads first, then the stores
    constexpr int kLoads4 = (kS4H * (kS4Stride - 4) + kThreads4 - 1) /
                            kThreads4;
    uint8_t v4[kLoads4];
#pragma unroll
    for (int q = 0; q < kLoads4; ++q) {
      const int e = tid + q * kThreads4;
      v4[q] = e < n4 * m4 ? __ldg(ref4 + (size_t)(e / m4) * a.w4p + e % m4)
                          : (uint8_t)0;
    }
#pragma unroll
    for (int q = 0; q < kLoads4; ++q) {
      const int e = tid + q * kThreads4;
      if (e < n4 * m4) s.strip4[e / m4 * kS4Stride + e % m4] = v4[q];
    }
    // a grid MB's 4x box downsample, (sum + 8) >> 4
    constexpr int kItems = (kSlots * 16 + kThreads4 - 1) / kThreads4;
    uint32_t rows[kItems][4];
    bool used[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int e = tid + q * kThreads4, j = e & 15;
      int r = 0, c = 0;
      used[q] = e < kSlots * 16 && grid_mb(e >> 4, r, c);
      const uint32_t* tile = reinterpret_cast<const uint32_t*>(
          a.cur + (k0 + r * a.mbw + c) * 256 + (j >> 2) * 64 + (j & 3) * 4);
#pragma unroll
      for (int y = 0; y < 4; ++y)
        rows[q][y] = used[q] ? __ldg(tile + 4 * y) : 0u;
    }
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int e = tid + q * kThreads4;
      unsigned sum = 0;
#pragma unroll
      for (int y = 0; y < 4; ++y) sum += __vsadu4(rows[q][y], 0u);
      if (used[q])
        reinterpret_cast<uint8_t*>(s.cur4[e >> 4])[e & 15] =
            (uint8_t)((sum + 8) >> 4);
    }
  }
  __syncthreads();

  // 2. the coarse search of the grid's MBs, a half warp each. Its costs
  // are below 2^17 (16 x 4080 + 83 x 34), so a 32-bit (cost << 9 |
  // raster index) key orders as the signed 64-bit one
  {
    const int hw = tid >> 4, j = tid & 15;
    const unsigned hmask = 0xFFFFu << (tid & 16);
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(s.strip4);
    // the band windows of all dy unclamped (the plane's guard holds them,
    // as on every encode path): Y(d) = Y(0) + d
    const bool unclamped = y0 >= 0 && y0 + 2 * kR4 <= a.h4p - h4;
    for (int slot = hw; slot < kSlots; slot += kThreads4 / 16) {
      int r, c;
      if (!grid_mb(slot, r, c)) continue;
      const uint4 cw = *reinterpret_cast<const uint4*>(s.cur4[slot]);
      // bytes xb .. xb + 3 of 4x strip row y
      const int xb = 4 * (c - cmin) + j, yb = 4 * (r - rmin);
      auto row = [&](int y) {
        const uint32_t* p = s4 + y * (kS4Stride / 4) + (xb >> 2);
        return __funnelshift_r(p[0], p[1], 8 * (xb & 3));
      };
      const int be = mv_bits(16 * (j - kR4));
      uint32_t best = 0xFFFFFFFFu;
      auto position = [&](int d, uint32_t w0, uint32_t w1, uint32_t w2,
                          uint32_t w3) {
        const uint32_t sad =
            sad4(w3, cw.w, sad4(w2, cw.z, sad4(w1, cw.y, sad4(w0, cw.x, 0u))));
        const uint32_t key =
            (16 * sad + lam * (mv_bits(16 * (d - kR4)) + be)) << 9 |
            (d * kSide4 + j);
        best = min(best, key);
      };
      if (unclamped) {         // the column's 20 rows in registers
        uint32_t rw[kSide4 + 3];
#pragma unroll
        for (int y = 0; y < kSide4 + 3; ++y) rw[y] = row(yb + y);
#pragma unroll
        for (int d = 0; d < kSide4; ++d)
          position(d, rw[d], rw[d + 1], rw[d + 2], rw[d + 3]);
      } else {
        for (int d = 0; d < kSide4; ++d) {
          const int y = yb + clampi(y0 + d, 0, a.h4p - h4) - ylo;
          position(d, row(y), row(y + 1), row(y + 2), row(y + 3));
        }
      }
      // column 16 (its rows start word-aligned): position (j, 16), and
      // (16, 16) on lane 0
      for (int d = j; d < kSide4; d += 16) {
        const int y = clampi(y0 + d, 0, a.h4p - h4) - ylo + yb;
        const uint32_t* p = s4 + y * (kS4Stride / 4) + c - cmin + 4;
        const uint32_t sad =
            sad4(p[3 * (kS4Stride / 4)], cw.w,
                 sad4(p[2 * (kS4Stride / 4)], cw.z,
                      sad4(p[kS4Stride / 4], cw.y, sad4(p[0], cw.x, 0u))));
        const uint32_t key =
            (16 * sad + lam * (mv_bits(16 * (d - kR4)) + mv_bits(16 * kR4)))
                << 9 |
            (d * kSide4 + 2 * kR4);
        best = min(best, key);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        best = min(best, __shfl_xor_sync(hmask, best, o));
      if (j == 0) {
        const int p = (int)(best & 511), gr = slot / kGridW,
                  gc = slot % kGridW;
        s.q4[0][gr][gc] = p / kSide4 - kR4;
        s.q4[1][gr][gc] = p % kSide4 - kR4;
        if (gr >= 1 && gc >= 1 && gc <= C) {   // the block's own MB
          a.cy4[k0 + r * a.mbw + c] = p / kSide4 - kR4;
          a.cx4[k0 + r * a.mbw + c] = p % kSide4 - kR4;
        }
      }
    }
  }
  __syncthreads();
  mbar_wait(&s.bar, 0);

  // 3. the own MBs, a warp each in turn; lane (i, h) takes row i and
  // half h (pixels 8 h .. 8 h + 7) of the MB
  const uint32_t* strip32 = reinterpret_cast<const uint32_t*>(s.strip);
  // the byte of strip pixel (y, x) (strip coordinates), and 4 bytes there
  auto sidx = [&](int y, int x) { return y * kStripStride + s.off[y] + x; };
  auto word = [&](int n) {
    return __funnelshift_r(strip32[n >> 2], strip32[(n >> 2) + 1],
                           8 * (n & 3));
  };
  WarpSmem& ws = s.w[w];
  for (int m = w; m < R * C; m += kWarps4) {
    const int mr = (m * c_inv) >> 16, mc = m - mr * C;
    const int gr = 1 + mr, gc = 1 + mc;
    const int r = r0 + mr, c = c0 + mc;
    const long long k = own_k(m);
    const uint2 cur = cur_next;
    const int prev_y = prev_next[0], prev_x = prev_next[1];
    load_next(m + kWarps4);
    // the quarter-pel predictor of each component (ops/me.py
    // `spatial_predictor`): the median of left, top and top right (top
    // left on the last column); row 0 takes the left neighbour alone
    int pv[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int left = c > 0 ? 16 * s.q4[q][gr][gc - 1] : 0;
      if (r == 0) {
        pv[q] = left;
        continue;
      }
      const int top = 16 * s.q4[q][gr - 1][gc];
      const int tr = c == a.mbw - 1
                         ? (c > 0 ? 16 * s.q4[q][gr - 1][gc - 1] : 0)
                         : 16 * s.q4[q][gr - 1][gc + 1];
      pv[q] = median3(left, top, tr);
    }
    const int pvy = pv[0], pvx = pv[1];
    const int by = kGuard + 16 * (r + ro), bx = kGuard + 16 * c;

    // candidate centres: zero, the coarse winner, the previous MV; each
    // replaces the best only on a strictly lower cost
    int cand_y[3] = {0, 4 * s.q4[0][gr][gc], 0};
    int cand_x[3] = {0, 4 * s.q4[1][gr][gc], 0};
    int n_cand = 2;
    if (a.prev_my != nullptr) {
      cand_y[2] = clampi(prev_y, -kMaxCand, kMaxCand);
      cand_x[2] = clampi(prev_x, -kMaxCand, kMaxCand);
      n_cand = 3;
    }
    int cm_y = 0, cm_x = 0, best_c = 0, wy = 0, wx = 0;
    for (int q = 0; q < n_cand; ++q) {
      const int oy = clampi(by + cand_y[q] - kWinM, 0, a.hp - kWinS) - sy;
      const int ox = clampi(bx + cand_x[q] - kWinM, 0, a.wp - kWinS) - sx;
      const int n = sidx(oy + kWinM + i, ox + kWinM + 8 * hh);
      const int sad = (int)__reduce_add_sync(
          0xFFFFFFFFu, sad4(word(n + 4), cur.y, sad4(word(n), cur.x, 0u)));
      const int cost = sad + lam * (mv_bits(cand_y[q] * 4 - pvy) +
                                    mv_bits(cand_x[q] * 4 - pvx));
      if (q == 0 || cost < best_c) {
        best_c = cost;
        cm_y = cand_y[q];
        cm_x = cand_x[q];
        wy = oy;
        wx = ox;
      }
    }

    // the +-3 full-pel sweep of the winner's window (window origin wy,
    // wx in strip coordinates): per dy, the lane's 14 reference bytes in
    // 4 registers, the 7 dx by funnel shifts
    uint32_t acc[49];
#pragma unroll
    for (int dy = 0; dy < 7; ++dy) {
      const int n = sidx(wy + kWinM - 3 + dy + i, wx + kWinM - 3 + 8 * hh);
      const uint32_t* p = strip32 + (n >> 2);
      uint32_t u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        u[q] = __funnelshift_r(p[q], p[q + 1], 8 * (n & 3));
#define K4_FULLPEL_DX(T)                                          \
  acc[dy * 7 + T] = sad4(bytes_at<T + 4>(u), cur.y,               \
                         sad4(bytes_at<T>(u), cur.x, 0u));
      K4_FULLPEL_DX(0) K4_FULLPEL_DX(1) K4_FULLPEL_DX(2) K4_FULLPEL_DX(3)
      K4_FULLPEL_DX(4) K4_FULLPEL_DX(5) K4_FULLPEL_DX(6)
#undef K4_FULLPEL_DX
    }
    long long best = sweep_min(reduce_scatter(acc, ln), ln, [&](int sad,
                                                                int p) {
      return sad + lam * (mv_bits((cm_y + p / 7 - 3) * 4 - pvy) +
                          mv_bits((cm_x + p % 7 - 3) * 4 - pvx));
    });
    const int bdy = key_idx(best) / 7 - 3, bdx = key_idx(best) % 7 - 3;
    const int fmy = cm_y + bdy, fmx = cm_x + bdx;
    uint2* pred = reinterpret_cast<uint2*>(a.pred + k * 256) + ln;
    if (!a.subpel) {
      const int n = sidx(wy + kWinM + bdy + i, wx + kWinM + bdx + 8 * hh);
      *pred = make_uint2(word(n), word(n + 4));
      if (ln == 0) {
        a.mvp_y[k] = pvy;
        a.mvp_x[k] = pvx;
        a.full_my[k] = fmy;
        a.full_mx[k] = fmx;
        a.mv_y[k] = 4 * fmy;
        a.mv_x[k] = 4 * fmx;
        a.cost[k] = key_cost(best);
      }
      continue;
    }

    // the planes from the aligned 27 x 27 window A(p, q) = window(4 + bdy
    // + p, 4 + bdx + q) (the full-pel winner at 5), in plane coordinates
    // (the winner at 3). Lane (c, h) < 28 takes columns 2 c and 2 c + 1,
    // as the two 16-bit halves of a word (column 27, past the window, is
    // summed and never read), and vertical-sum rows 11 h .. 11 h + 10
    // (A's rows 11 h .. 11 h + 15): a sum lies in [-2550, 10710],
    // so with kHrBias in each half no half borrows from the other, and
    // both columns' sums take one multiply-add a tap. The sums are kept
    // biased (J takes the bias off), with F and H there
    const int ay = wy + 4 + bdy, ax = wx + 4 + bdx;
    __syncwarp();                      // the warp's previous MB is done
    constexpr int kRows = kSub / 2;    // vertical-sum rows a lane
    if (ln < kAln + 1) {
      const int q0 = 2 * (ln >> 1), r0h = kRows * (ln & 1);
      uint32_t x[kRows + 5];           // A(r0h + y, q0) | A(., q0 + 1) << 16
#pragma unroll
      for (int y = 0; y < kRows + 5; ++y)
        x[y] = __byte_perm(word(sidx(ay + r0h + y, ax + q0)), 0u, 0x4140);
      uint32_t h[kRows];
#pragma unroll
      for (int y = 0; y < kRows; ++y) {
        h[y] = kHrBias * 0x10001u + x[y] - 5 * x[y + 1] + 20 * x[y + 2] +
               20 * x[y + 3] - 5 * x[y + 4] + x[y + 5];
        *reinterpret_cast<uint32_t*>(ws.hr + (r0h + y) * kHrStride + q0) =
            h[y];
      }
      if (q0 >= 2 && q0 < kSub + 2) {       // plane columns q0 - 2, q0 - 1
#pragma unroll
        for (int y = 0; y < kRows; ++y) {
          // H = clamp((sum + 16) >> 5) per half: (biased + 16) >> 5 lies
          // in [48, 463], the bias adds 128
          uint32_t v = ((h[y] + 0x00100010u) >> 5) & 0x07FF07FFu;
          v = __vminu2(__vmaxu2(v, 0x00800080u), 0x017F017Fu) - 0x00800080u;
          const int at = (r0h + y) * kPlStride + q0 - 2;
          *reinterpret_cast<uint16_t*>(ws.pl + 2 * kPlane + at) =
              (uint16_t)__byte_perm(v, 0u, 0x0020);
          *reinterpret_cast<uint16_t*>(ws.pl + at) =
              (uint16_t)__byte_perm(x[y + 2], 0u, 0x0020);
        }
      }
    }
    __syncwarp();
    // lane y < 22 takes row y of B (two 4-byte dot products a sample on
    // A's row y + 2) and of J (the 6-tap of the biased vertical sums:
    // kHrBias times the taps' sum 32, 128 after the shift by 10)
    if (ln < kSub) {
      const int n = sidx(ay + ln + 2, ax);
      const uint32_t* p = strip32 + (n >> 2);
      uint32_t u[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        u[q] = __funnelshift_r(p[q], p[q + 1], 8 * (n & 3));
      uint32_t bw[6] = {0, 0, 0, 0, 0, 0}, jw[6] = {0, 0, 0, 0, 0, 0};
      int hv[kAln + 1];
      const uint32_t* hrow =
          reinterpret_cast<const uint32_t*>(ws.hr + ln * kHrStride);
#pragma unroll
      for (int q = 0; q < kHrStride / 2; ++q) {
        const uint32_t x = hrow[q];
        hv[2 * q] = (int)(x & 0xFFFFu);
        hv[2 * q + 1] = (int)(x >> 16);
      }
#define K4_BJ(J)                                                           \
  {                                                                        \
    const int b = dp4a_us(bytes_at<J>(u), kTapsLo,                         \
                          dp4a_us(bytes_at<J + 4>(u), kTapsHi, 16)) >> 5;  \
    bw[J / 4] |= (uint32_t)clampi(b, 0, 255) << (8 * (J % 4));             \
    const int jv = (tap6(hv[J], hv[J + 1], hv[J + 2], hv[J + 3],          \
                         hv[J + 4], hv[J + 5]) + 512) >> 10;               \
    jw[J / 4] |= (uint32_t)clampi(jv - kJBias, 0, 255) << (8 * (J % 4));   \
  }
      K4_BJ(0) K4_BJ(1) K4_BJ(2) K4_BJ(3) K4_BJ(4) K4_BJ(5) K4_BJ(6)
      K4_BJ(7) K4_BJ(8) K4_BJ(9) K4_BJ(10) K4_BJ(11) K4_BJ(12) K4_BJ(13)
      K4_BJ(14) K4_BJ(15) K4_BJ(16) K4_BJ(17) K4_BJ(18) K4_BJ(19)
      K4_BJ(20) K4_BJ(21)
#undef K4_BJ
      uint32_t* brow =
          reinterpret_cast<uint32_t*>(ws.pl + 1 * kPlane + ln * kPlStride);
      uint32_t* jrow =
          reinterpret_cast<uint32_t*>(ws.pl + 3 * kPlane + ln * kPlStride);
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        brow[q] = bw[q];
        jrow[q] = jw[q];
      }
    }
    __syncwarp();
    if (a.planes != nullptr) {         // (4, 22, 22) uint8 a MB
      uint32_t* out = reinterpret_cast<uint32_t*>(a.planes + k * 4 * kPlaneOut);
      for (int e = ln; e < kPlaneOut; e += 32) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int g = 4 * e + b, pl = g / kPlaneOut, rem = g % kPlaneOut;
          v |= (uint32_t)ws.pl[pl * kPlane + rem / kSub * kPlStride +
                               rem % kSub] << (8 * b);
        }
        out[e] = v;
      }
    }

    // the +-3 quarter-pel sweep around the winner (plane coordinate 3),
    // row-split: the lane's rows 2 + i .. 4 + i of F and B and 2 + i ..
    // 3 + i of H and J, 3 words from byte 8 h, in registers; every phase
    // word by funnel shifts and `__vavgu4` of two of them
    uint32_t P[4][3][3];
#pragma unroll
    for (int pl = 0; pl < 4; ++pl)
#pragma unroll
      for (int y = 0; y < 3; ++y)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          P[pl][y][q] = (pl < 2 || y < 2)
                            ? reinterpret_cast<const uint32_t*>(
                                  ws.pl + pl * kPlane +
                                  (2 + i + y) * kPlStride + 8 * hh)[q]
                            : 0u;
#define K4_QPEL(DY, DX)                                                    \
  {                                                                        \
    constexpr int fy = (DY - 3) & 3, fx = (DX - 3) & 3;                    \
    constexpr int ry = 1 + ((DY - 3) >> 2), cx = 3 + ((DX - 3) >> 2);      \
    constexpr uint32_t e = phase_byte(4 * fy + fx);                        \
    constexpr int pa = e & 3, ya = e >> 2 & 1, xa = e >> 3 & 1;            \
    constexpr int pb = e >> 4 & 3, yb = e >> 6 & 1, xb = e >> 7 & 1;       \
    uint32_t s0, s1;                                                       \
    if constexpr (pa == pb && ya == yb && xa == xb) {                      \
      s0 = bytes_at<cx + xa>(P[pa][ry + ya]);                              \
      s1 = bytes_at<cx + xa + 4>(P[pa][ry + ya]);                          \
    } else if constexpr (xa == xb) {                                       \
      /* the mean of the aligned words, then the shift: the two         */ \
      /* positions of a phase in a row share the means                 */ \
      const uint32_t m3[3] = {__vavgu4(P[pa][ry + ya][0], P[pb][ry + yb][0]), \
                              __vavgu4(P[pa][ry + ya][1], P[pb][ry + yb][1]), \
                              __vavgu4(P[pa][ry + ya][2], P[pb][ry + yb][2])}; \
      s0 = bytes_at<cx + xa>(m3);                                          \
      s1 = bytes_at<cx + xa + 4>(m3);                                      \
    } else {                                                               \
      s0 = __vavgu4(bytes_at<cx + xa>(P[pa][ry + ya]),                     \
                    bytes_at<cx + xb>(P[pb][ry + yb]));                    \
      s1 = __vavgu4(bytes_at<cx + xa + 4>(P[pa][ry + ya]),                 \
                    bytes_at<cx + xb + 4>(P[pb][ry + yb]));                \
    }                                                                      \
    acc[DY * 7 + DX] = sad4(s1, cur.y, sad4(s0, cur.x, 0u));               \
  }
#define K4_QPEL_ROW(DY)                                                   \
  K4_QPEL(DY, 0) K4_QPEL(DY, 1) K4_QPEL(DY, 2) K4_QPEL(DY, 3)             \
  K4_QPEL(DY, 4) K4_QPEL(DY, 5) K4_QPEL(DY, 6)
    K4_QPEL_ROW(0) K4_QPEL_ROW(1) K4_QPEL_ROW(2) K4_QPEL_ROW(3)
    K4_QPEL_ROW(4) K4_QPEL_ROW(5) K4_QPEL_ROW(6)
#undef K4_QPEL_ROW
#undef K4_QPEL
    // the early-skip bias at the predictor
    const int skip_thr = a.skip_base + a.qp[f] * a.skip_qp;
    best = sweep_min(reduce_scatter(acc, ln), ln, [&](int sad, int p) {
      const int mvy = 4 * fmy + p / 7 - 3, mvx = 4 * fmx + p % 7 - 3;
      int cost = sad + lam * (mv_bits(mvy - pvy) + mv_bits(mvx - pvx));
      if (mvy == pvy && mvx == pvx && sad < skip_thr)
        cost -= lam * a.skip_bias;
      return cost;
    });
    const int dyq = key_idx(best) / 7 - 3, dxq = key_idx(best) % 7 - 3;
    const Phase ph = phase_of(dyq & 3, dxq & 3);
    const int y = 3 + (dyq >> 2) + i, x = 3 + (dxq >> 2) + 8 * hh;
    *pred = make_uint2(phase4(ws.pl, ph, y, x), phase4(ws.pl, ph, y, x + 4));
    if (ln == 0) {
      a.mvp_y[k] = pvy;
      a.mvp_x[k] = pvx;
      a.full_my[k] = fmy;
      a.full_mx[k] = fmx;
      a.mv_y[k] = 4 * fmy + dyq;
      a.mv_x[k] = 4 * fmx + dxq;
      a.cost[k] = key_cost(best);
    }
  }
}

struct PartArgs {
  const uint8_t* cur;        // (k, 16, 16)
  const uint8_t* planes;     // (k, 4, 22, 22), 16-byte aligned
  const int32_t* full_my;    // (k,) each
  const int32_t* full_mx;
  const int32_t* mvp_y;
  const int32_t* mvp_x;
  const int32_t* lam;
  int32_t* mv[3];            // (k, 2, 2), (k, 2, 2), (k, 4, 2)
  long long* cost[3];        // (k,)
  int32_t* pred[3];          // (k, 16, 16), 16-byte aligned
  long long n_mb;
};

// a warp's MB: its planes as they lie in memory (a chunk more, zeroed,
// which the last row's word reads reach), then at kPlStride bytes a row,
// whose bytes 22 and 23 no SAD or prediction reads
struct PartSmem {
  uint4 raw[kChunks5 + 1];
  uint8_t pl[4 * kPlane];
};

// the SAD of a lane's 8 pixels (cur: its two words) at one dx of a +-2
// full-pel row: u holds the plane row's bytes from the lane's column base
// 8 h, where its pixel 0 at dx lies at byte O = 3 + dx
template <int O>
__device__ __forceinline__ uint32_t sad8_at(const uint32_t (&u)[4],
                                            uint2 cur) {
  return sad4(bytes_at<O + 4>(u), cur.y, sad4(bytes_at<O>(u), cur.x, 0u));
}

// The SAD of a lane's 8 pixels at quarter-pel position (DY, DX) of a +-3
// sweep (dyq = DY - 3, dxq = DX - 3), K4's phase code: P[plane][row][word]
// holds the lane's rows of F, B (3 rows) and H, J (2 rows) from one row
// above the winner, each as 3 words from a column base where the lane's
// pixel 0 at the winner lies at byte C.
template <int DY, int DX, int C>
__device__ __forceinline__ uint32_t qpel_sad(const uint32_t (&P)[4][3][3],
                                             uint2 cur) {
  constexpr int fy = (DY - 3) & 3, fx = (DX - 3) & 3;
  constexpr int ry = 1 + ((DY - 3) >> 2), cx = C + ((DX - 3) >> 2);
  constexpr uint32_t e = phase_byte(4 * fy + fx);
  constexpr int pa = e & 3, ya = e >> 2 & 1, xa = e >> 3 & 1;
  constexpr int pb = e >> 4 & 3, yb = e >> 6 & 1, xb = e >> 7 & 1;
  uint32_t s0, s1;
  if constexpr (pa == pb && ya == yb && xa == xb) {
    s0 = bytes_at<cx + xa>(P[pa][ry + ya]);
    s1 = bytes_at<cx + xa + 4>(P[pa][ry + ya]);
  } else if constexpr (xa == xb) {
    // the mean of the aligned words, then the shift
    const uint32_t m3[3] = {__vavgu4(P[pa][ry + ya][0], P[pb][ry + yb][0]),
                            __vavgu4(P[pa][ry + ya][1], P[pb][ry + yb][1]),
                            __vavgu4(P[pa][ry + ya][2], P[pb][ry + yb][2])};
    s0 = bytes_at<cx + xa>(m3);
    s1 = bytes_at<cx + xa + 4>(m3);
  } else {
    s0 = __vavgu4(bytes_at<cx + xa>(P[pa][ry + ya]),
                  bytes_at<cx + xb>(P[pb][ry + yb]));
    s1 = __vavgu4(bytes_at<cx + xa + 4>(P[pa][ry + ya]),
                  bytes_at<cx + xb + 4>(P[pb][ry + yb]));
  }
  return sad4(s1, cur.y, sad4(s0, cur.x, 0u));
}

template <int C, int Q = 0>
__device__ __forceinline__ void qpel_sweep(const uint32_t (&P)[4][3][3],
                                           uint2 cur, uint32_t (&acc)[49]) {
  acc[Q] = qpel_sad<Q / 7, Q % 7, C>(P, cur);
  if constexpr (Q + 1 < 49) qpel_sweep<C, Q + 1>(P, cur, acc);
}

// the least key over the lanes whose bits of mask M differ (a segment)
template <int M>
__device__ __forceinline__ long long segment_min(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (M & o) {
      const long long w = __shfl_xor_sync(0xFFFFFFFFu, v, o);
      v = w < v ? w : v;
    }
  return v;
}

// the lane's key over the positions it holds after a reduce-scatter:
// word j of `slots` holds positions P0[j] (low half) and P0[j] + 1 (high)
template <int N, typename CostOf>
__device__ __forceinline__ long long lane_min(const uint32_t (&slots)[N],
                                              const int (&p0)[N], int n_pos,
                                              CostOf cost_of) {
  long long best = LLONG_MAX;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0[j] + h;
      if (p < n_pos) {
        const int sad = (int)(h ? slots[j] >> 16 : slots[j] & 0xFFFFu);
        const long long key = key_of(cost_of(sad, p), p);
        best = key < best ? key : best;
      }
    }
  return best;
}

// One geometry's quarter-pel pass (G: 0 16x8, 1 8x16, 2 8x8): every lane
// sweeps its own block's +-3 quarter-pel positions around the block's
// full-pel winner (raster index w of the +-2 sweep), then the reduce-
// scatter and the keyed minimum within the block's lanes; the lanes write
// their prediction samples, a lane per block its MV, lane 0 the sum of the
// blocks' costs.
//   16x8: the block of lane (i, h) is i >> 3, its lanes differ in bits 0-3
//     (h and i & 7); 8x16: h, bits 1-4 (i); 8x8: 2 (i >> 3) + h, bits 1-3.
// The 25 packed slots of the 49 positions are reduced as one 32-slot set
// (8x16: four rounds leave lane (i, h) slots 2 i and 2 i + 1) or as two of
// 16 (slots 0-15 and 16-31; 16x8: four rounds leave slot 2 (i & 7) + h of
// each; 8x8: three rounds leave slots 2 (i & 7) and 2 (i & 7) + 1 of each).
template <int G>
__device__ __forceinline__ void part_qpel(const PartSmem& s,
                                          const PartArgs& a, long long k,
                                          int ln, uint2 cur, int w, int fmy,
                                          int fmx, int mvpy, int mvpx,
                                          int lam) {
  const int i = ln >> 1, hh = ln & 1, g = i & 7;
  const int bdy = w / 5 - 2, bdx = w % 5 - 2;
  const int bmy = fmy + bdy, bmx = fmx + bdx;
  // the lane's rows 2 + i + bdy .. of the planes, 3 words each from column
  // 8 h + bdx + 2 (its pixel 0 at the block's winner lies at byte 1): four
  // aligned words and a funnel shift by the column's byte in its word
  const int c0 = 8 * hh + bdx + 2, sh = 8 * (c0 & 3);
  uint32_t P[4][3][3];
#pragma unroll
  for (int pl = 0; pl < 4; ++pl)
#pragma unroll
    for (int y = 0; y < 3; ++y) {
      if (pl >= 2 && y == 2) {
#pragma unroll
        for (int q = 0; q < 3; ++q) P[pl][y][q] = 0u;
        continue;
      }
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          s.pl + pl * kPlane + (2 + i + bdy + y) * kPlStride + (c0 & ~3));
      uint32_t u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = src[q];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        P[pl][y][q] = __funnelshift_r(u[q], u[q + 1], sh);
    }
  uint32_t acc[49];
  qpel_sweep<1>(P, cur, acc);
  // the reduce-scatter of the packed partial sums (each at most 2040; a
  // block's total at most 32,640)
  uint32_t v[32], vb[32];
#pragma unroll
  for (int q = 0; q < 32; ++q)
    v[q] = q < 24 ? acc[2 * q] | acc[2 * q + 1] << 16
                  : (q == 24 ? acc[48] : 0u);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    vb[q] = v[16 + q];
    vb[16 + q] = 0u;
  }
  auto cost_of = [&](int sad, int p) {
    return sad + lam * (mv_bits(4 * bmy + p / 7 - 3 - mvpy) +
                        mv_bits(4 * bmx + p % 7 - 3 - mvpx));
  };
  long long best;
  int b, nb;
  if constexpr (G == 0) {
    scatter_round<8>(v, ln); scatter_round<8>(vb, ln);
    scatter_round<4>(v, ln); scatter_round<4>(vb, ln);
    scatter_round<2>(v, ln); scatter_round<2>(vb, ln);
    scatter_round<1>(v, ln); scatter_round<1>(vb, ln);
    const uint32_t slots[2] = {v[0], vb[0]};
    const int p0[2] = {4 * g + 2 * hh, 32 + 4 * g + 2 * hh};
    best = segment_min<0xF>(lane_min(slots, p0, 49, cost_of));
    b = i >> 3;
    nb = 2;
  } else if constexpr (G == 1) {
    scatter_round<16>(v, ln);
    scatter_round<8>(v, ln);
    scatter_round<4>(v, ln);
    scatter_round<2>(v, ln);
    const uint32_t slots[2] = {v[0], v[1]};
    const int p0[2] = {4 * i, 4 * i + 2};
    best = segment_min<0x1E>(lane_min(slots, p0, 49, cost_of));
    b = hh;
    nb = 2;
  } else {
    scatter_round<8>(v, ln); scatter_round<8>(vb, ln);
    scatter_round<4>(v, ln); scatter_round<4>(vb, ln);
    scatter_round<2>(v, ln); scatter_round<2>(vb, ln);
    const uint32_t slots[4] = {v[0], v[1], vb[0], vb[1]};
    const int p0[4] = {4 * g, 4 * g + 2, 32 + 4 * g, 34 + 4 * g};
    best = segment_min<0xE>(lane_min(slots, p0, 49, cost_of));
    b = 2 * (i >> 3) + hh;
    nb = 4;
  }
  const int p = key_idx(best), dyq = p / 7 - 3, dxq = p % 7 - 3;
  // the lane's 8 samples of the winning phase, two 16-byte stores
  const Phase ph = phase_of(dyq & 3, dxq & 3);
  const int y = 3 + i + bdy + (dyq >> 2), x = 3 + 8 * hh + bdx + (dxq >> 2);
  const uint32_t w0 = phase4(s.pl, ph, y, x), w1 = phase4(s.pl, ph, y, x + 4);
  int4* pred = reinterpret_cast<int4*>(a.pred[G] + k * 256 + 16 * i + 8 * hh);
  pred[0] = make_int4(w0 & 0xFF, w0 >> 8 & 0xFF, w0 >> 16 & 0xFF, w0 >> 24);
  pred[1] = make_int4(w1 & 0xFF, w1 >> 8 & 0xFF, w1 >> 16 & 0xFF, w1 >> 24);
  // a block's first lane (g = 0, and h = 0 or i = 0 where the block spans
  // both) writes its MV
  const bool first = G == 0 ? (g == 0 && hh == 0)
                            : (G == 1 ? i == 0 : g == 0);
  if (first) {
    a.mv[G][(k * nb + b) * 2] = 4 * bmy + dyq;
    a.mv[G][(k * nb + b) * 2 + 1] = 4 * bmx + dxq;
  }
  // the sum of the blocks' costs (the partners across the other block
  // bits: 16 for 16x8, 1 for 8x16, both for 8x8)
  int sum = key_cost(best);
  if constexpr (G != 0) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
  if constexpr (G != 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 16);
  if (ln == 0) a.cost[G][k] = sum;
}

// K5: a warp per MB, lane (i, h) owns row i and half h (pixels 8 h ..
// 8 h + 7) of it, as in K4's sweeps.
// 1. The MB's planes (1,936 contiguous bytes, 16-byte aligned) staged by
//    16-byte loads, then re-laid to kPlStride bytes a row (a row a lane).
// 2. One full-pel pass for the three geometries: each lane's SADs at the
//    25 positions +-2 around the 16x16 winner on F (the lane's plane rows
//    as aligned words, the 5 dx by funnel shifts), packed two to a word; a
//    reduce-scatter over the lane bits of i & 7 (3 rounds) leaves lane (i,
//    h) the 8x8 SADs of quadrant (i >> 3, h) at positions 4 (i & 7) .. +3;
//    the partner across h (lane bit 0) adds the quadrant beside it (the
//    16x8 half), the partner across i >> 3 (bit 4) the one below or above
//    (the 8x16 half). Each geometry's block winner is the least key of the
//    lane's 8 lanes.
// 3. A quarter-pel pass per geometry, all blocks at once (`part_qpel`).
// Every block's cost at every position equals the plain sweep's, and
// every minimum is over signed (cost, raster index) keys of the block's
// own positions, so the plain loops' first-of-the-least wins.
__global__ void __launch_bounds__(32 * kWarps5)
    partition_kernel(const PartArgs a) {
  __shared__ PartSmem smem[kWarps5];
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kWarps5 + w;
  if (k >= a.n_mb) return;
  PartSmem& s = smem[w];
  const int i = ln >> 1, hh = ln & 1;
  // 1. the planes, then the rows r = ln, ln + 32, ln + 64 of the 88
  {
    const uint4* src = reinterpret_cast<const uint4*>(a.planes +
                                                      k * 4 * kPlaneOut);
    constexpr int kLoads = (kChunks5 + 31) / 32;
    uint4 ch[kLoads];
#pragma unroll
    for (int q = 0; q < kLoads; ++q)
      if (ln + 32 * q < kChunks5) ch[q] = __ldg(src + ln + 32 * q);
#pragma unroll
    for (int q = 0; q < kLoads; ++q)
      if (ln + 32 * q < kChunks5) s.raw[ln + 32 * q] = ch[q];
    if (ln == 0) s.raw[kChunks5] = make_uint4(0, 0, 0, 0);
  }
  const uint2 cur = __ldg(reinterpret_cast<const uint2*>(a.cur + k * 256) +
                          ln);
  const int fmy = __ldg(a.full_my + k), fmx = __ldg(a.full_mx + k);
  const int mvpy = __ldg(a.mvp_y + k), mvpx = __ldg(a.mvp_x + k);
  const int lam = __ldg(a.lam + k);
  __syncwarp();
  {
    const uint32_t* raw = reinterpret_cast<const uint32_t*>(s.raw);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int r = ln + 32 * q, at = kSub * r;
      if (r < 4 * kSub) {
        uint32_t u[7];
#pragma unroll
        for (int j = 0; j < 7; ++j) u[j] = raw[(at >> 2) + j];
        uint2* dst = reinterpret_cast<uint2*>(s.pl + kPlStride * r);
        const int sh = 8 * (at & 3);
#pragma unroll
        for (int j = 0; j < 3; ++j)
          dst[j] = make_uint2(__funnelshift_r(u[2 * j], u[2 * j + 1], sh),
                              __funnelshift_r(u[2 * j + 1], u[2 * j + 2], sh));
      }
    }
  }
  __syncwarp();

  // 2. the full-pel pass: row 1 + i + dy of F (dy = 0 .. 4 for -2 .. 2),
  // 16 bytes from column 8 h
  uint32_t acc[25];
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
    const uint2* row = reinterpret_cast<const uint2*>(
        s.pl + (1 + i + dy) * kPlStride + 8 * hh);
    const uint2 lo = row[0], hi = row[1];
    const uint32_t u[4] = {lo.x, lo.y, hi.x, hi.y};
    acc[5 * dy] = sad8_at<1>(u, cur);
    acc[5 * dy + 1] = sad8_at<2>(u, cur);
    acc[5 * dy + 2] = sad8_at<3>(u, cur);
    acc[5 * dy + 3] = sad8_at<4>(u, cur);
    acc[5 * dy + 4] = sad8_at<5>(u, cur);
  }
  uint32_t v[32];
#pragma unroll
  for (int q = 0; q < 32; ++q)
    v[q] = q < 12 ? acc[2 * q] | acc[2 * q + 1] << 16
                  : (q == 12 ? acc[24] : 0u);
  scatter_round<8>(v, ln);
  scatter_round<4>(v, ln);
  scatter_round<2>(v, ln);
  // quadrant (i >> 3, h) at positions 4 g .. 4 g + 3; the 16x8 half with
  // the quadrant across h, the 8x16 half with the one across i >> 3
  const int g = i & 7;
  const uint32_t q8[2] = {v[0], v[1]};
  const uint32_t q16x8[2] = {q8[0] + __shfl_xor_sync(0xFFFFFFFFu, q8[0], 1),
                             q8[1] + __shfl_xor_sync(0xFFFFFFFFu, q8[1], 1)};
  const uint32_t q8x16[2] = {q8[0] + __shfl_xor_sync(0xFFFFFFFFu, q8[0], 16),
                             q8[1] + __shfl_xor_sync(0xFFFFFFFFu, q8[1], 16)};
  const int p0[2] = {4 * g, 4 * g + 2};
  auto cost_of = [&](int sad, int p) {
    return sad + lam * (mv_bits(4 * (fmy + p / 5 - 2) - mvpy) +
                        mv_bits(4 * (fmx + p % 5 - 2) - mvpx));
  };
  const int w16x8 = key_idx(segment_min<0xE>(lane_min(q16x8, p0, 25, cost_of)));
  const int w8x16 = key_idx(segment_min<0xE>(lane_min(q8x16, p0, 25, cost_of)));
  const int w8x8 = key_idx(segment_min<0xE>(lane_min(q8, p0, 25, cost_of)));

  // 3. the quarter-pel passes
  part_qpel<0>(s, a, k, ln, cur, w16x8, fmy, fmx, mvpy, mvpx, lam);
  part_qpel<1>(s, a, k, ln, cur, w8x16, fmy, fmx, mvpy, mvpx, lam);
  part_qpel<2>(s, a, k, ln, cur, w8x8, fmy, fmx, mvpy, mvpx, lam);
}

// K4's shared memory limit (above 48 KB), set once on each device
cudaError_t allow_smem() {
  static bool set[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !set[dev])) {
    e = cudaFuncSetAttribute(search_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(SearchSmem));
    if (e == cudaSuccess && dev < 64) set[dev] = true;
  }
  return e;
}

unsigned blocks_of(long long n_mb, int warps) {
  return (unsigned)((n_mb + warps - 1) / warps);
}

}  // namespace

// K4: one launch on `stream`. lam: the (52,) ME lambda table by QP;
// prev_my / prev_mx null: two candidate centres; planes null: the planes
// stay in shared memory
extern "C" int h264lab_me(
    const void* y_pad, const void* y4_pad, const void* cur, const void* lane,
    const void* row_off, const void* qp, const void* lam, const void* prev_my,
    const void* prev_mx, void* cy4, void* cx4, void* mvp_y, void* mvp_x,
    void* full_my, void* full_mx, void* mv_y, void* mv_x, void* cost,
    void* pred, void* planes, long long n, int mbw, int mbh, int hp, int wp,
    int h4p, int w4p, int subpel, int skip_base, int skip_qp, int skip_bias,
    void* stream) {
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  const long long tiles_x = (mbw + kTileC - 1) / kTileC;
  const long long tiles = tiles_x * ((mbh + kTileR - 1) / kTileR);
  if (n * mbw * mbh >= (1ll << 32) || n * tiles >= (1ll << 31) ||
      hp < kWinS || wp < kWinS || h4p < 4 * mbh || w4p < 4 * mbw + 2 * kR4)
    return (int)cudaErrorInvalidValue;
  const MeArgs a{(const uint8_t*)y_pad, (const uint8_t*)y4_pad,
                 (const uint8_t*)cur, (const int32_t*)lane,
                 (const int32_t*)row_off, (const int32_t*)qp,
                 (const int32_t*)lam, (const int32_t*)prev_my,
                 (const int32_t*)prev_mx, (int32_t*)cy4, (int32_t*)cx4,
                 (int32_t*)mvp_y, (int32_t*)mvp_x, (int32_t*)full_my,
                 (int32_t*)full_mx, (int32_t*)mv_y, (int32_t*)mv_x,
                 (int32_t*)cost, (uint8_t*)pred, (uint8_t*)planes, mbw * mbh,
                 mbw, mbh, hp, wp, h4p, w4p, subpel, (int)tiles_x, (int)tiles,
                 skip_base, skip_qp, skip_bias};
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  search_kernel<<<(unsigned)(n * tiles), kThreads4, sizeof(SearchSmem),
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K4's launch shape on the current device: out[0] its threads a block,
// out[1] its shared memory bytes a block, out[2] its resident blocks an
// SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] and out[4]
// its tile's MB rows and columns
extern "C" int h264lab_me_occupancy(int* out) {
  out[0] = kThreads4;
  out[1] = (int)sizeof(SearchSmem);
  out[3] = kTileR;
  out[4] = kTileC;
  cudaError_t e = allow_smem();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], search_kernel, kThreads4, sizeof(SearchSmem));
  return (int)e;
}

// K5 on `stream`: the partition search of n_mb MBs from K4's planes
extern "C" int h264lab_partition(
    const void* cur, const void* planes, const void* full_my,
    const void* full_mx, const void* mvp_y, const void* mvp_x, const void* lam,
    void* mv16x8, void* mv8x16, void* mv8x8, void* cost16x8, void* cost8x16,
    void* cost8x8, void* pred16x8, void* pred8x16, void* pred8x8,
    long long n_mb, void* stream) {
  if (n_mb <= 0) return 0;
  const PartArgs a{(const uint8_t*)cur,
                   (const uint8_t*)planes,
                   (const int32_t*)full_my,
                   (const int32_t*)full_mx,
                   (const int32_t*)mvp_y,
                   (const int32_t*)mvp_x,
                   (const int32_t*)lam,
                   {(int32_t*)mv16x8, (int32_t*)mv8x16, (int32_t*)mv8x8},
                   {(long long*)cost16x8, (long long*)cost8x16,
                    (long long*)cost8x8},
                   {(int32_t*)pred16x8, (int32_t*)pred8x16, (int32_t*)pred8x8},
                   n_mb};
  partition_kernel<<<blocks_of(n_mb, kWarps5), 32 * kWarps5, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K5's launch shape on the current device: out[0] its threads a block,
// out[1] its (static) shared memory bytes a block, out[2] its resident
// blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[3] its
// warps a block (an MB each)
extern "C" int h264lab_partition_occupancy(int* out) {
  out[0] = 32 * kWarps5;
  out[1] = (int)(kWarps5 * sizeof(PartSmem));
  out[3] = kWarps5;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], partition_kernel, 32 * kWarps5, 0);
}
