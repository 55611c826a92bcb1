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
// K4 is two launches, since an MB's predictor needs its neighbours'
// coarse winners:
//   A (coarse): a warp per MB. The MB's 4x4 box-downsampled block, the 17
//     x 17 positions of the +-8 search on the lane's 4x plane (17 rows of
//     4 x 20 bytes in shared memory, each row start clamped into the
//     plane as the plain version clamps its band window), a position per
//     lane and round, cost 16 SAD + lam (mv bits of 16 dy and 16 dx);
//   B (refine): a warp per MB. The predictor from the coarse field; the
//     three candidate centres (zero, coarse x 4, the previous MV clipped
//     to +-52) by the 16x16 SAD of their window, each replacing the best
//     only on a strictly lower cost; the winner's 34 x 34 window in
//     shared memory; the 49 positions of the +-3 full-pel sweep; then,
//     with the sub-pel stage, the 6-tap F, B, H and J planes (22 x 22
//     each, the unclamped vertical taps kept as int32 for J) and the 49
//     positions of the +-3 quarter-pel sweep, each phase sample the
//     rounded average of two plane samples (a per-phase table of two
//     planes and their one-pixel shifts), with the early-skip bias. The
//     planes go to device memory only when K5 will read them (uint8).
// K5: a warp per MB; the MB's four planes in shared memory; per block of
//   the three geometries the 25 positions of the +-2 full-pel sweep on F,
//   then the 49 of the +-3 quarter-pel sweep around the block's winner.
//
// Every sweep is a minimum over (cost, raster index) keys, signed 64-bit
// (the quarter-pel skip bias can make a cost negative): a lane keeps the
// least key of its positions, then a butterfly of shuffles gives the
// warp's. That is the plain loops' rule of a strict `<` in raster order:
// the first position of the least cost wins. Rows of 16 or 8 pixels are
// read as 4-byte words (a funnel shift of two aligned words when the
// start is not aligned); SADs are `__vsadu4` and the phase averages
// `__vavgu4`, which rounds as (a + b + 1) >> 1.
//
// Bound. At 16 frames of 1080p (130,560 MBs) the search reads about 114
// MB (tiles 33 MB, the lanes' padded luma 40 MB, the 4x planes 2.5 MB) and
// writes about 38 MB (more with K5's planes): 0.05 ms at 3.35 TB/s. Its
// integer work, counted on the plain algorithm, is about 60,000 operations
// per MB: 289 coarse positions x 16 pixels, 3 centres and 49 full-pel
// positions x 256 pixels, the planes, 49 quarter-pel positions x 256
// pixels and their averages (about 8 G operations, 0.12 ms at 67 T/s).
// So the work bounds it, and the packed byte instructions (four pixels an
// instruction) are what the design leans on. What it does not do yet:
// several MBs share no loads (a window is read once per MB from L2), a
// lane sums a position alone (no split of a SAD across lanes), and K5
// reloads the planes K4 had in shared memory; fusing K5 into K4's launch
// B and sharing windows between neighbouring MBs are a later step.
//
// Integer semantics of ops/me.py: `>>` of negative ints is arithmetic;
// window starts are clamped into the plane as `qpel.windows` clamps them;
// mv bits are 2 (32 - clz(code)) - 1 of the Exp-Golomb code.
//
// Plain C interface, loaded with ctypes; each entry point launches on the
// given stream, allocates nothing and returns the launches' error.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGuard = 64;               // ops/qpel.py GUARD
constexpr int kG4 = kGuard / 4;
constexpr int kR4 = 8;                   // COARSE_R4
constexpr int kSide4 = 2 * kR4 + 1;      // 17
constexpr int kWin4W = 4 + 2 * kR4;      // 20 bytes of a coarse row
constexpr int kWin4 = kSide4 * 4 * kWin4W;
constexpr int kWinM = 9;                 // WIN_M
constexpr int kWinS = 16 + 2 * kWinM;    // 34
constexpr int kWinStride = 36;
constexpr int kMaxCand = kGuard - kWinM - 3;   // MAX_CAND_FP, 52
constexpr int kSub = 22;                 // plane side
constexpr int kPlStride = 24;
constexpr int kPlane = kSub * kPlStride;
constexpr int kPlaneOut = kSub * kSub;   // 484 bytes a plane in memory
constexpr int kHr = 27;                  // h_raw columns
constexpr int kCoarseWarps = 8;
constexpr int kWarps = 4;

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

struct Phase {
  int pa, ya, xa, pb, yb, xb;
};

__device__ __forceinline__ Phase phase_of(int fy, int fx) {
  const int i = 4 * fy + fx;
  const unsigned e =
      (unsigned)((i < 8 ? kPhaseLo >> (8 * i) : kPhaseHi >> (8 * (i - 8))) &
                 0xFF);
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

// SAD of a ROWS x 4 WORDS block of a shared plane at (y, x) against the
// current MB's words (16 pixels, 4 words a row) at (cy, 4 cw)
template <int ROWS, int WORDS>
__device__ __forceinline__ int sad_at(const uint8_t* pl, int stride, int y,
                                      int x, const uint32_t* cur, int cy,
                                      int cw) {
  unsigned s = 0;
#pragma unroll 4
  for (int i = 0; i < ROWS; ++i) {
    const uint8_t* row = pl + (y + i) * stride;
    const uint32_t* c = cur + (cy + i) * 4 + cw;
#pragma unroll
    for (int q = 0; q < WORDS; ++q) s = __vsadu4(ld4(row, x + 4 * q), c[q]) + s;
  }
  return (int)s;
}

// four phase samples of a quarter-pel position: the planes (4 x kPlane
// bytes), the phase, the position's top-left in plane coordinates
__device__ __forceinline__ uint32_t phase4(const uint8_t* pl, const Phase& p,
                                           int y, int x) {
  const uint32_t a = ld4(pl + p.pa * kPlane + (y + p.ya) * kPlStride, x + p.xa);
  const uint32_t b = ld4(pl + p.pb * kPlane + (y + p.yb) * kPlStride, x + p.xb);
  return __vavgu4(a, b);
}

template <int ROWS, int WORDS>
__device__ __forceinline__ int sad_phase(const uint8_t* pl, const Phase& p,
                                         int y, int x, const uint32_t* cur,
                                         int cy, int cw) {
  unsigned s = 0;
#pragma unroll 4
  for (int i = 0; i < ROWS; ++i) {
    const uint32_t* c = cur + (cy + i) * 4 + cw;
#pragma unroll
    for (int q = 0; q < WORDS; ++q)
      s = __vsadu4(phase4(pl, p, y + i, x + 4 * q), c[q]) + s;
  }
  return (int)s;
}

__device__ __forceinline__ int phase_px(const uint8_t* pl, const Phase& p,
                                        int y, int x) {
  const int a = pl[p.pa * kPlane + (y + p.ya) * kPlStride + x + p.xa];
  const int b = pl[p.pb * kPlane + (y + p.yb) * kPlStride + x + p.xb];
  return (a + b + 1) >> 1;
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
  const int32_t* lam;        // (n,)
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
  long long n_mb;
  int nmb, mbw, mbh, hp, wp, h4p, w4p, subpel;
  int skip_base, skip_qp, skip_bias;
};

// launch A: the coarse +-8 search on the 4x plane, a warp per MB
__global__ void __launch_bounds__(32 * kCoarseWarps)
    coarse_kernel(const MeArgs a) {
  __shared__ uint8_t s_win[kCoarseWarps][kWin4];
  __shared__ int s_cur4[kCoarseWarps][16];
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kCoarseWarps + w;
  if (k >= a.n_mb) return;
  const int f = (int)(k / a.nmb), m = (int)(k % a.nmb);
  const int r = m / a.mbw, c = m % a.mbw;
  if (ln < 16) {           // the 4x box downsample, (sum + 8) >> 4
    const uint8_t* t = a.cur + k * 256 + (ln >> 2) * 64 + (ln & 3) * 4;
    int s = 0;
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int x = 0; x < 4; ++x) s += t[y * 16 + x];
    s_cur4[w][ln] = (s + 8) >> 4;
  }
  // the band window of each dy starts at a clamped row, as
  // `qpel.windows` clamps the plain version's band windows
  const uint8_t* ref = a.y4_pad + (size_t)a.lane[f] * a.h4p * a.w4p;
  const int h4 = 4 * a.mbh, w4 = 4 * a.mbw;
  const int x0 = clampi(kG4 - kR4, 0, a.w4p - (w4 + 2 * kR4)) + 4 * c;
  const int y0 = kG4 + 4 * a.row_off[f] - kR4;
  for (int e = ln; e < kWin4; e += 32) {
    const int d = e / (4 * kWin4W), i = e / kWin4W % 4, x = e % kWin4W;
    const int y = clampi(y0 + d, 0, a.h4p - h4) + 4 * r + i;
    s_win[w][e] = ref[(size_t)y * a.w4p + x0 + x];
  }
  __syncwarp();
  const int lam = a.lam[f];
  long long best = LLONG_MAX;
  for (int p = ln; p < kSide4 * kSide4; p += 32) {
    const int d = p / kSide4, e = p % kSide4;
    const uint8_t* win = s_win[w] + d * 4 * kWin4W + e;
    int sad = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sad += abs(s_cur4[w][4 * i + j] - (int)win[i * kWin4W + j]);
    const int cost = 16 * sad + lam * (mv_bits(16 * (d - kR4)) +
                                       mv_bits(16 * (e - kR4)));
    const long long key = key_of(cost, p);
    best = key < best ? key : best;
  }
  best = warp_min(best);
  if (ln == 0) {
    const int p = key_idx(best);
    a.cy4[k] = p / kSide4 - kR4;
    a.cx4[k] = p % kSide4 - kR4;
  }
}

__device__ __forceinline__ int median3(int x, int y, int z) {
  return max(min(max(x, y), z), min(x, y));
}

// the quarter-pel predictor of one component from the band's coarse field
// (ops/me.py `spatial_predictor`): the median of left, top and top right
// (top left on the last column); row 0 takes the left neighbour alone
__device__ __forceinline__ int predictor(const int32_t* q4, int r, int c,
                                         int mbw) {
  const int left = c > 0 ? 16 * q4[r * mbw + c - 1] : 0;
  if (r == 0) return left;
  const int top = 16 * q4[(r - 1) * mbw + c];
  int tr;
  if (c == mbw - 1)
    tr = c > 0 ? 16 * q4[(r - 1) * mbw + c - 1] : 0;
  else
    tr = 16 * q4[(r - 1) * mbw + c + 1];
  return median3(left, top, tr);
}

struct RefineSmem {
  uint32_t cur[64];                      // the MB's 16 x 16 pixels
  uint8_t win[kWinS * kWinStride];       // the winner's 34 x 34 window
  int hr[kSub * kHr];                    // vertical 6-tap sums, unclamped
  uint8_t pl[4 * kPlane];                // F, B, H, J
};

// launch B: candidate centres, full-pel and quarter-pel sweeps, a warp per
// MB
__global__ void __launch_bounds__(32 * kWarps) refine_kernel(const MeArgs a) {
  __shared__ RefineSmem smem[kWarps];
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kWarps + w;
  if (k >= a.n_mb) return;
  RefineSmem& s = smem[w];
  const int f = (int)(k / a.nmb), m = (int)(k % a.nmb);
  const int r = m / a.mbw, c = m % a.mbw;
  const uint32_t* tile = reinterpret_cast<const uint32_t*>(a.cur + k * 256);
  s.cur[ln] = tile[ln];
  s.cur[ln + 32] = tile[ln + 32];
  const int32_t* cy4 = a.cy4 + (long long)f * a.nmb;
  const int32_t* cx4 = a.cx4 + (long long)f * a.nmb;
  const int pvy = predictor(cy4, r, c, a.mbw);
  const int pvx = predictor(cx4, r, c, a.mbw);
  const int lam = a.lam[f];
  const uint8_t* ref = a.y_pad + (size_t)a.lane[f] * a.hp * a.wp;
  const int by = kGuard + 16 * (r + a.row_off[f]), bx = kGuard + 16 * c;
  __syncwarp();

  // candidate centres: zero, the coarse winner, the previous MV; a lane
  // sums 8 pixels of the centre block (row ln / 2, half ln % 2)
  int cand_y[3] = {0, 4 * cy4[m], 0}, cand_x[3] = {0, 4 * cx4[m], 0};
  int n_cand = 2;
  if (a.prev_my != nullptr) {
    cand_y[2] = clampi(a.prev_my[k], -kMaxCand, kMaxCand);
    cand_x[2] = clampi(a.prev_mx[k], -kMaxCand, kMaxCand);
    n_cand = 3;
  }
  int cm_y = 0, cm_x = 0, best_c = 0, oy_w = 0, ox_w = 0;
  const uint8_t* cur_b = reinterpret_cast<const uint8_t*>(s.cur);
  for (int i = 0; i < n_cand; ++i) {
    const int oy = clampi(by + cand_y[i] - kWinM, 0, a.hp - kWinS);
    const int ox = clampi(bx + cand_x[i] - kWinM, 0, a.wp - kWinS);
    const uint8_t* src = ref + (size_t)(oy + kWinM + (ln >> 1)) * a.wp + ox +
                         kWinM + 8 * (ln & 1);
    const uint8_t* cb = cur_b + (ln >> 1) * 16 + 8 * (ln & 1);
    int sad = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) sad += abs((int)cb[j] - (int)__ldg(src + j));
    sad = __reduce_add_sync(0xFFFFFFFFu, sad);
    const int cost = sad + lam * (mv_bits(cand_y[i] * 4 - pvy) +
                                  mv_bits(cand_x[i] * 4 - pvx));
    if (i == 0 || cost < best_c) {
      best_c = cost;
      cm_y = cand_y[i];
      cm_x = cand_x[i];
      oy_w = oy;
      ox_w = ox;
    }
  }
  for (int e = ln; e < kWinS * kWinS; e += 32) {
    const int y = e / kWinS, x = e % kWinS;
    s.win[y * kWinStride + x] = ref[(size_t)(oy_w + y) * a.wp + ox_w + x];
  }
  __syncwarp();

  // the +-3 full-pel sweep of the winner's window
  long long best = LLONG_MAX;
  for (int p = ln; p < 49; p += 32) {
    const int dy = p / 7 - 3, dx = p % 7 - 3;
    const int sad = sad_at<16, 4>(s.win, kWinStride, kWinM + dy, kWinM + dx,
                                  s.cur, 0, 0);
    const int cost = sad + lam * (mv_bits((cm_y + dy) * 4 - pvy) +
                                  mv_bits((cm_x + dx) * 4 - pvx));
    const long long key = key_of(cost, p);
    best = key < best ? key : best;
  }
  best = warp_min(best);
  const int bdy = key_idx(best) / 7 - 3, bdx = key_idx(best) % 7 - 3;
  const int fmy = cm_y + bdy, fmx = cm_x + bdx;
  if (ln == 0) {
    a.mvp_y[k] = pvy;
    a.mvp_x[k] = pvx;
    a.full_my[k] = fmy;
    a.full_mx[k] = fmx;
  }
  uint2* pred = reinterpret_cast<uint2*>(a.pred + k * 256) + ln;
  if (!a.subpel) {
    // the window at the full-pel winner
    const uint8_t* row = s.win + (kWinM + bdy + (ln >> 1)) * kWinStride;
    const int x = kWinM + bdx + 8 * (ln & 1);
    *pred = make_uint2(ld4(row, x), ld4(row, x + 4));
    if (ln == 0) {
      a.mv_y[k] = 4 * fmy;
      a.mv_x[k] = 4 * fmx;
      a.cost[k] = key_cost(best);
    }
    return;
  }

  // the aligned 27 x 27 window A(p, q) = win[4 + bdy + p][4 + bdx + q]
  // (the full-pel winner at 5), its vertical 6-tap sums, then the planes
  // in plane coordinates (the winner at 3)
  const uint8_t* A = s.win + (4 + bdy) * kWinStride + 4 + bdx;
  for (int e = ln; e < kSub * kHr; e += 32) {
    const int i = e / kHr, q = e % kHr;
    const uint8_t* col = A + i * kWinStride + q;
    s.hr[e] = tap6(col[0], col[kWinStride], col[2 * kWinStride],
                   col[3 * kWinStride], col[4 * kWinStride],
                   col[5 * kWinStride]);
  }
  __syncwarp();
  uint8_t* planes_out =
      a.planes != nullptr ? a.planes + k * 4 * kPlaneOut : nullptr;
  for (int e = ln; e < kSub * kSub; e += 32) {
    const int i = e / kSub, j = e % kSub;
    const uint8_t* row = A + (i + 2) * kWinStride + j;
    const int* h = s.hr + i * kHr + j;
    const uint8_t v[4] = {
        row[2],
        (uint8_t)clampi((tap6(row[0], row[1], row[2], row[3], row[4], row[5]) +
                         16) >> 5, 0, 255),
        (uint8_t)clampi((h[2] + 16) >> 5, 0, 255),
        (uint8_t)clampi((tap6(h[0], h[1], h[2], h[3], h[4], h[5]) + 512) >> 10,
                        0, 255)};
#pragma unroll
    for (int pl = 0; pl < 4; ++pl) {
      s.pl[pl * kPlane + i * kPlStride + j] = v[pl];
      if (planes_out != nullptr) planes_out[pl * kPlaneOut + e] = v[pl];
    }
  }
  __syncwarp();

  // the +-3 quarter-pel sweep around the winner (plane coordinate 3),
  // with the early-skip bias at the predictor
  const int skip_thr = a.skip_base + a.qp[f] * a.skip_qp;
  best = LLONG_MAX;
  for (int p = ln; p < 49; p += 32) {
    const int dyq = p / 7 - 3, dxq = p % 7 - 3;
    const Phase ph = phase_of(dyq & 3, dxq & 3);
    const int sad = sad_phase<16, 4>(s.pl, ph, 3 + (dyq >> 2), 3 + (dxq >> 2),
                                     s.cur, 0, 0);
    const int mvy = 4 * fmy + dyq, mvx = 4 * fmx + dxq;
    int cost = sad + lam * (mv_bits(mvy - pvy) + mv_bits(mvx - pvx));
    if (mvy == pvy && mvx == pvx && sad < skip_thr)
      cost -= lam * a.skip_bias;
    const long long key = key_of(cost, p);
    best = key < best ? key : best;
  }
  best = warp_min(best);
  const int dyq = key_idx(best) / 7 - 3, dxq = key_idx(best) % 7 - 3;
  const Phase ph = phase_of(dyq & 3, dxq & 3);
  const int y = 3 + (dyq >> 2) + (ln >> 1), x = 3 + (dxq >> 2) + 8 * (ln & 1);
  *pred = make_uint2(phase4(s.pl, ph, y, x), phase4(s.pl, ph, y, x + 4));
  if (ln == 0) {
    a.mv_y[k] = 4 * fmy + dyq;
    a.mv_x[k] = 4 * fmx + dxq;
    a.cost[k] = key_cost(best);
  }
}

struct PartArgs {
  const uint8_t* cur;        // (k, 16, 16)
  const uint8_t* planes;     // (k, 4, 22, 22)
  const int32_t* full_my;    // (k,) each
  const int32_t* full_mx;
  const int32_t* mvp_y;
  const int32_t* mvp_x;
  const int32_t* lam;
  int32_t* mv[3];            // (k, 2, 2), (k, 2, 2), (k, 4, 2)
  long long* cost[3];        // (k,)
  int32_t* pred[3];          // (k, 16, 16)
  long long n_mb;
};

struct PartSmem {
  uint32_t cur[64];
  uint8_t pl[4 * kPlane];
};

// one block of a geometry: the +-2 full-pel sweep on F around the 16x16
// winner (F coordinate 3 + the block's offset), then the +-3 quarter-pel
// sweep around the block's winner; writes its MV and prediction, returns
// its cost
template <int BH, int BW>
__device__ int part_block(const PartSmem& s, int ln, int oy0, int ox0,
                          int fmy, int fmx, int mvpy, int mvpx, int lam,
                          int32_t* mv, int32_t* pred) {
  long long best = LLONG_MAX;
  if (ln < 25) {
    const int dy = ln / 5 - 2, dx = ln % 5 - 2;
    const int sad = sad_at<BH, BW / 4>(s.pl, kPlStride, 3 + oy0 + dy,
                                       3 + ox0 + dx, s.cur, oy0, ox0 / 4);
    const int cost = sad + lam * (mv_bits((fmy + dy) * 4 - mvpy) +
                                  mv_bits((fmx + dx) * 4 - mvpx));
    best = key_of(cost, ln);
  }
  best = warp_min(best);
  const int bmy = fmy + key_idx(best) / 5 - 2;
  const int bmx = fmx + key_idx(best) % 5 - 2;
  // the block's (BH + 2, BW + 2) sub-planes start at plane coordinate
  // (2 + oy0 + bdy, 2 + ox0 + bdx); the block's winner sits at 1 there
  const int y0 = 2 + oy0 + bmy - fmy, x0 = 2 + ox0 + bmx - fmx;
  best = LLONG_MAX;
  for (int p = ln; p < 49; p += 32) {
    const int dyq = p / 7 - 3, dxq = p % 7 - 3;
    const Phase ph = phase_of(dyq & 3, dxq & 3);
    const int sad = sad_phase<BH, BW / 4>(s.pl, ph, y0 + 1 + (dyq >> 2),
                                          x0 + 1 + (dxq >> 2), s.cur, oy0,
                                          ox0 / 4);
    const int cost = sad + lam * (mv_bits(bmy * 4 + dyq - mvpy) +
                                  mv_bits(bmx * 4 + dxq - mvpx));
    const long long key = key_of(cost, p);
    best = key < best ? key : best;
  }
  best = warp_min(best);
  const int dyq = key_idx(best) / 7 - 3, dxq = key_idx(best) % 7 - 3;
  const Phase ph = phase_of(dyq & 3, dxq & 3);
  const int py = y0 + 1 + (dyq >> 2), px = x0 + 1 + (dxq >> 2);
  for (int e = ln; e < BH * BW; e += 32) {
    const int i = e / BW, j = e % BW;
    pred[(oy0 + i) * 16 + ox0 + j] = phase_px(s.pl, ph, py + i, px + j);
  }
  if (ln == 0) {
    mv[0] = bmy * 4 + dyq;
    mv[1] = bmx * 4 + dxq;
  }
  return key_cost(best);
}

__global__ void __launch_bounds__(32 * kWarps)
    partition_kernel(const PartArgs a) {
  __shared__ PartSmem smem[kWarps];
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kWarps + w;
  if (k >= a.n_mb) return;
  PartSmem& s = smem[w];
  const uint32_t* tile = reinterpret_cast<const uint32_t*>(a.cur + k * 256);
  s.cur[ln] = tile[ln];
  s.cur[ln + 32] = tile[ln + 32];
  const uint8_t* src = a.planes + k * 4 * kPlaneOut;
  for (int e = ln; e < 4 * kPlaneOut; e += 32) {
    const int pl = e / kPlaneOut, i = e / kSub % kSub, j = e % kSub;
    s.pl[pl * kPlane + i * kPlStride + j] = src[e];
  }
  __syncwarp();
  const int fmy = a.full_my[k], fmx = a.full_mx[k];
  const int mvpy = a.mvp_y[k], mvpx = a.mvp_x[k], lam = a.lam[k];
  long long sum;
  // 16x8: top, bottom
  sum = 0;
  for (int b = 0; b < 2; ++b)
    sum += part_block<8, 16>(s, ln, 8 * b, 0, fmy, fmx, mvpy, mvpx, lam,
                             a.mv[0] + k * 4 + 2 * b, a.pred[0] + k * 256);
  if (ln == 0) a.cost[0][k] = sum;
  // 8x16: left, right
  sum = 0;
  for (int b = 0; b < 2; ++b)
    sum += part_block<16, 8>(s, ln, 0, 8 * b, fmy, fmx, mvpy, mvpx, lam,
                             a.mv[1] + k * 4 + 2 * b, a.pred[1] + k * 256);
  if (ln == 0) a.cost[1][k] = sum;
  // 8x8: the raster quadrants
  sum = 0;
  for (int b = 0; b < 4; ++b)
    sum += part_block<8, 8>(s, ln, 8 * (b >> 1), 8 * (b & 1), fmy, fmx, mvpy,
                            mvpx, lam, a.mv[2] + k * 8 + 2 * b,
                            a.pred[2] + k * 256);
  if (ln == 0) a.cost[2][k] = sum;
}

unsigned blocks_of(long long n_mb, int warps) {
  return (unsigned)((n_mb + warps - 1) / warps);
}

}  // namespace

// K4: both launches on `stream`. prev_my / prev_mx null: two candidate
// centres; planes null: the planes stay in shared memory
extern "C" int h264lab_me(
    const void* y_pad, const void* y4_pad, const void* cur, const void* lane,
    const void* row_off, const void* qp, const void* lam, const void* prev_my,
    const void* prev_mx, void* cy4, void* cx4, void* mvp_y, void* mvp_x,
    void* full_my, void* full_mx, void* mv_y, void* mv_x, void* cost,
    void* pred, void* planes, long long n, int mbw, int mbh, int hp, int wp,
    int h4p, int w4p, int subpel, int skip_base, int skip_qp, int skip_bias,
    void* stream) {
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  const long long n_mb = n * mbw * mbh;
  if (n_mb >= (1ll << 32) || hp < kWinS || wp < kWinS || h4p < 4 * mbh ||
      w4p < 4 * mbw + 2 * kR4)
    return (int)cudaErrorInvalidValue;
  const MeArgs a{(const uint8_t*)y_pad, (const uint8_t*)y4_pad,
                 (const uint8_t*)cur, (const int32_t*)lane,
                 (const int32_t*)row_off, (const int32_t*)qp,
                 (const int32_t*)lam, (const int32_t*)prev_my,
                 (const int32_t*)prev_mx, (int32_t*)cy4, (int32_t*)cx4,
                 (int32_t*)mvp_y, (int32_t*)mvp_x, (int32_t*)full_my,
                 (int32_t*)full_mx, (int32_t*)mv_y, (int32_t*)mv_x,
                 (int32_t*)cost, (uint8_t*)pred, (uint8_t*)planes, n_mb,
                 mbw * mbh, mbw, mbh, hp, wp, h4p, w4p, subpel, skip_base,
                 skip_qp, skip_bias};
  const cudaStream_t s = (cudaStream_t)stream;
  coarse_kernel<<<blocks_of(n_mb, kCoarseWarps), 32 * kCoarseWarps, 0, s>>>(
      a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  refine_kernel<<<blocks_of(n_mb, kWarps), 32 * kWarps, 0, s>>>(a);
  return (int)cudaGetLastError();
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
  partition_kernel<<<blocks_of(n_mb, kWarps), 32 * kWarps, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
