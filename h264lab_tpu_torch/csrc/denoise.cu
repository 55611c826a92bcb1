// K13 of h264lab_tpu_torch: the temporal denoise pre-filter of one frame,
// in one kernel written by hand for NVIDIA Hopper (sm_90a), one launch for
// its three planes.
//
// Replaces h264lab_tpu/ops/denoise.py:23-41 `denoise_plane` (jitted at
// :43, called per plane at h264lab_tpu/models/encoder.py:276-287), which
// XLA ran (no Pallas kernel). Per pixel of an (H, W) uint8 plane, with the
// previous denoised plane:
//   d = cur - prev (int32), ad = |d|;
//   act = (the sum of the 4-neighbour ad values, the plane's edges
//         replicated, + 2) >> 2;
//   idx = min(max(ad, act), 31);
//   out = clamp(cur - ((d gain[idx]) >> 8), 0, 255),
// `>>` an arithmetic shift (a negative product floors, as in torch and
// jnp). The 32 gains are the port's `denoise.GAIN_Q8`, which the wrapper
// passes in the kernel's parameters; the kernel holds no table of its own.
//
// Bound. A byte-bound stencil: cur and prev read once, out written once;
// a 1920x1088 frame moves 9.4 MB, 2.8 us at 3.35 TB/s. At that size a
// launch is over in a few microseconds, so the design issues the whole
// frame's loads at once and spends few instructions a pixel.
//
// Design: a register march.
// - One 1-D grid over the live tiles of the three planes: a warp a tile of
//   kRows rows x 512 columns (a lane a strip of 16 columns), kWarps warps
//   a block. The parameters hold each plane's tile columns and its first
//   tile (a prefix sum), so every block holds a live tile; only the last
//   block's spare warps return.
// - Each lane loads its strip of cur and prev for the tile's rows and a
//   one-row halo above and below (rows inside the plane only), every load
//   issued before any arithmetic: a strip whose every row is 16-byte
//   aligned (the width a multiple of 16, cur and prev aligned) in one
//   16-byte load a row; others row by row, 16 bytes where the row allows,
//   else byte by byte (columns past the row's end repeat its last, in
//   registers). Lane 0 also loads the byte left of the tile, lane 31 the
//   one right of it, where the plane has them. No byte is loaded twice
//   but the halo rows and those two columns.
// - The edges replicated: a missing row above or below takes the |d| of
//   the nearest row, where the march needs it (a warp-uniform branch), so
//   that a row's arithmetic waits for no other row's loads; a missing
//   column the strip's own end.
// - The march, in 16-bit pairs: |d| of the row above, the row and the row
//   below as words of two pixels (4k, 4k + 2 and 4k + 1, 4k + 3), so that
//   one add sums two pixels' neighbours and `__vmaxu2` / `__vminu2` give
//   two indices; the strip's horizontal neighbours come from the next
//   lanes by `__shfl_up_sync` / `__shfl_down_sync`. Each lane holds one
//   gain as the pair (256 - g, g) (read once from the `__grid_constant__`
//   parameters); `__shfl_sync` fetches a pixel's pair, and one `dp2a`
//   over the bytes (cur, prev) gives 256 cur - d g + 255, whose byte 1 is
//   the output: cur - floor(d g / 256) = ceil(((256 - g) cur + g prev) /
//   256) lies between cur and prev for 0 <= g <= 256 (the entry point
//   refuses other gains), so no clamp is needed. 16 pixels leave in one
//   16-byte store (bytes where the address or the row's end does not
//   allow it). cur is not read again.
//
// Chosen by measurement (tools/torch_ref_bench.py --variants, on an
// NVIDIA H100 80GB HBM3 at 700 W, the 1080p denoise path's frame): tiles
// of 4 rows and blocks of 4 warps (4.8-4.9 us of device time; 8 rows
// 5.2-5.3, 16 rows 7.1-7.2, 2 rows 4.6 for twice the halo reads; 1 to 8
// warps a block within 0.3 us). ptxas: 96 registers, no shared memory, no
// stack, no spills. Tried and slower: the gain pairs in shared memory
// (+0.2-0.3 us), each tile's rows bulk-copied into shared memory on one
// mbarrier (+1.3 us) and the rows by cp.async with a wait a row
// (+0.8 us). ptxas puts every load of a thread on one scoreboard, so a
// warp's arithmetic starts once all its rows have come; short tiles give
// each SM more warps to overlap with.
//
// Plain C interface, loaded with ctypes; the entry point takes its
// arguments as one array of 64-bit words (in the order
// `denoise.denoise_k13` writes them), launches on the given stream,
// allocates nothing and returns the launch's error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4, kWarps = 4;   // a tile's rows; warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kStrip = 16;             // a lane's columns: one 16-byte word
constexpr int kTileW = 32 * kStrip;    // a tile's columns
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  const uint8_t* cur[3];
  const uint8_t* prev[3];
  uint8_t* out[3];
  int h[3], w[3];
  int cols[3];                         // each plane's tile columns
  int first[4];                        // plane p's tiles: first[p] .. first[p + 1] - 1
  uint32_t gain[32];                   // (256 - g, g) of GAIN_Q8[i], 16 bits each
};

// Word k of a 16-byte word.
__device__ __forceinline__ uint32_t word_of(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The 16 bytes of a strip at p, n of them inside the row (1 .. 16): one
// 16-byte load where p is 16-byte aligned and n is 16, else byte by byte,
// the bytes past the row's end repeating its last.
__device__ __forceinline__ uint4 load_strip(const uint8_t* __restrict__ p,
                                            int n) {
  if (n == kStrip && ((uintptr_t)p & 15) == 0)
    return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0, 0, 0, 0}, b = 0;
#pragma unroll
  for (int k = 0; k < kStrip; ++k) {
    if (k < n) b = __ldg(p + k);
    w[k >> 2] |= b << (8 * (k & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The strip's n bytes to p: one 16-byte store where the address allows,
// else a loop of byte stores (kept out of the 16-byte path's way).
__device__ __forceinline__ void store_strip(uint8_t* p, const uint4& v,
                                            int n) {
  if (n == kStrip && ((uintptr_t)p & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
#pragma unroll 1
  for (int k = 0; k < n; ++k)
    p[k] = (uint8_t)__byte_perm(word_of(v, k >> 2), 0, 0x4440 | (k & 3));
}

// |cur - prev| of a strip's 16 pixels as 16-bit pairs: lo[k] holds pixels
// 4k and 4k + 2, hi[k] pixels 4k + 1 and 4k + 3.
__device__ __forceinline__ void abs_pairs(const uint4& c, const uint4& q,
                                          uint32_t* lo, uint32_t* hi) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t w = __vabsdiffu4(word_of(c, k), word_of(q, k));
    lo[k] = __byte_perm(w, 0, 0x4240);
    hi[k] = __byte_perm(w, 0, 0x4341);
  }
}

// 256 cur - d g + 255 of the pixel whose bytes (cur, prev) are bytes 0, 1
// (lo) or 2, 3 (hi) of b, from its gain pair (256 - g, g).
__device__ __forceinline__ uint32_t blend_lo(uint32_t gp, uint32_t b) {
  uint32_t t;
  asm("dp2a.lo.s32.u32 %0, %1, %2, %3;" : "=r"(t) : "r"(gp), "r"(b), "r"(255));
  return t;
}
__device__ __forceinline__ uint32_t blend_hi(uint32_t gp, uint32_t b) {
  uint32_t t;
  asm("dp2a.hi.s32.u32 %0, %1, %2, %3;" : "=r"(t) : "r"(gp), "r"(b), "r"(255));
  return t;
}

__global__ void __launch_bounds__(kThreads)
denoise_kernel(const __grid_constant__ Args a) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= a.first[3]) return;         // the last block's spare warps
  const int p = t < a.first[1] ? 0 : t < a.first[2] ? 1 : 2;
  const int H = a.h[p], W = a.w[p], cols = a.cols[p];
  const int tile = t - a.first[p];
  const int ty = tile / cols;
  const int x0 = (tile - ty * cols) * kTileW + kStrip * lane;
  const int y0 = ty * kRows;
  const int n = min(kStrip, W - x0);   // the strip's columns in the plane
  const uint32_t gain = a.gain[lane];  // the pair of gain[i] is lane i's
  // the column an edge lane loads beside the tile, where the plane has it
  const int ex = lane == 0 ? x0 - 1 : x0 + kStrip;
  const bool edge = (lane == 0 || lane == 31) && ex >= 0 && ex < W;
  const uint8_t* __restrict__ cur = a.cur[p];
  const uint8_t* __restrict__ prev = a.prev[p];
  uint8_t* __restrict__ out = a.out[p];
  const bool wide = n == kStrip && (W & 15) == 0 &&
      (((uintptr_t)(cur + x0) | (uintptr_t)(prev + x0)) & 15) == 0;
  const bool wide_out = n == kStrip && (W & 15) == 0 &&
      ((uintptr_t)(out + x0) & 15) == 0;

  // every load first: rows y0 - 1 .. y0 + kRows, those inside the plane;
  // a wide strip takes a loop of 16-byte loads alone, others choose row by
  // row
  uint4 c[kRows + 2], q[kRows + 2];
  int ec[kRows + 2], eq[kRows + 2];
  if (wide) {
#pragma unroll
    for (int i = 0; i < kRows + 2; ++i) {
      const int y = y0 - 1 + i;
      if (y < 0 || y >= H) continue;
      const long long o = (long long)y * W + x0;
      c[i] = __ldg(reinterpret_cast<const uint4*>(cur + o));
      q[i] = __ldg(reinterpret_cast<const uint4*>(prev + o));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRows + 2; ++i) {
      c[i] = q[i] = make_uint4(0, 0, 0, 0);
      const int y = y0 - 1 + i;
      if (y < 0 || y >= H || n <= 0) continue;
      const long long o = (long long)y * W + x0;
      c[i] = load_strip(cur + o, n);
      q[i] = load_strip(prev + o, n);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows + 2; ++i) {
    const int y = y0 - 1 + i;
    ec[i] = eq[i] = 0;
    if (edge && y >= 0 && y < H) {
      ec[i] = __ldg(cur + (long long)y * W + ex);
      eq[i] = __ldg(prev + (long long)y * W + ex);
    }
  }

  // the march down the tile's rows: |d| of the rows above (u), at (m) and
  // below (d) as pairs; the plane's edges replicated where they are used
  // (the row above row 0 is row 0, the row below the last is the last),
  // so that each row's arithmetic waits for its own rows' loads alone
  uint32_t ulo[4], uhi[4], mlo[4], mhi[4], dlo[4], dhi[4];
  abs_pairs(c[1], q[1], mlo, mhi);
  if (y0 == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ulo[k] = mlo[k];
      uhi[k] = mhi[k];
    }
  } else {
    abs_pairs(c[0], q[0], ulo, uhi);
  }
#pragma unroll
  for (int i = 1; i <= kRows; ++i) {
    const int y = y0 - 1 + i;
    if (y >= H) break;                 // warp-uniform
    if (y + 1 < H) {
      abs_pairs(c[i + 1], q[i + 1], dlo, dhi);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dlo[k] = mlo[k];
        dhi[k] = mhi[k];
      }
    }
    // |d| left of the strip's first column (the high half) and right of
    // its last (the low half)
    uint32_t left = __shfl_up_sync(kAll, mhi[3], 1);
    uint32_t right = __shfl_down_sync(kAll, mlo[0], 1);
    const uint32_t e = abs(ec[i] - eq[i]);
    if (lane == 0) left = (edge ? e : mlo[0] & 0xffff) << 16;
    if (lane == 31) right = e;
    if (x0 + kStrip >= W) right = mhi[3] >> 16;
    uint32_t wd[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // the neighbours left of pixels 4k, 4k + 2 and right of 4k + 1,
      // 4k + 3; the others are the pair beside
      const uint32_t lft = __byte_perm(k ? mhi[k - 1] : left, mhi[k], 0x5432);
      const uint32_t rgt = __byte_perm(mlo[k], k < 3 ? mlo[k + 1] : right,
                                       0x5432);
      const uint32_t act_lo =
          ((ulo[k] + dlo[k] + lft + mhi[k] + 0x00020002u) >> 2) & 0x3fff3fffu;
      const uint32_t act_hi =
          ((uhi[k] + dhi[k] + mlo[k] + rgt + 0x00020002u) >> 2) & 0x3fff3fffu;
      const uint32_t i_lo = __vminu2(__vmaxu2(mlo[k], act_lo), 0x001f001fu);
      const uint32_t i_hi = __vminu2(__vmaxu2(mhi[k], act_hi), 0x001f001fu);
      // the shuffle reads its lane from the low 5 bits
      const uint32_t g0 = __shfl_sync(kAll, gain, i_lo);
      const uint32_t g1 = __shfl_sync(kAll, gain, i_hi);
      const uint32_t g2 = __shfl_sync(kAll, gain, i_lo >> 16);
      const uint32_t g3 = __shfl_sync(kAll, gain, i_hi >> 16);
      // (cur, prev) of pixels 4k, 4k + 1 and of 4k + 2, 4k + 3
      const uint32_t cw = word_of(c[i], k), qw = word_of(q[i], k);
      const uint32_t b01 = __byte_perm(cw, qw, 0x5140);
      const uint32_t b23 = __byte_perm(cw, qw, 0x7362);
      const uint32_t t01 = __byte_perm(blend_lo(g0, b01), blend_hi(g1, b01),
                                       0x0051);
      const uint32_t t23 = __byte_perm(blend_lo(g2, b23), blend_hi(g3, b23),
                                       0x5100);
      wd[k] = __byte_perm(t01, t23, 0x7610);
    }
    const uint4 v = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    const long long o = (long long)y * W + x0;
    if (wide_out)
      *reinterpret_cast<uint4*>(out + o) = v;
    else if (n > 0)
      store_strip(out + o, v, n);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ulo[k] = mlo[k];
      uhi[k] = mhi[k];
      mlo[k] = dlo[k];
      mhi[k] = dhi[k];
    }
  }
}

}  // namespace

// w: cur Y, U, V, prev Y, U, V, out Y, U, V (9 addresses), per plane its
// (h, w) (6 words), the 32 gains (each 0 .. 256), the stream. Planes
// contiguous.
extern "C" int h264lab_denoise(const long long* w) {
  Args a;
  long long tiles = 0;
  a.first[0] = 0;
  for (int p = 0; p < 3; ++p) {
    a.cur[p] = (const uint8_t*)w[p];
    a.prev[p] = (const uint8_t*)w[3 + p];
    a.out[p] = (uint8_t*)w[6 + p];
    const long long h = w[9 + 2 * p], wd = w[10 + 2 * p];
    if (h < 0 || wd < 0 || h * wd >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
    a.h[p] = (int)h;
    a.w[p] = (int)wd;
    const long long cols = (wd + kTileW - 1) / kTileW;
    a.cols[p] = cols > 0 ? (int)cols : 1;
    if (h > 0 && wd > 0) tiles += cols * ((h + kRows - 1) / kRows);
    a.first[p + 1] = (int)tiles;
  }
  for (int i = 0; i < 32; ++i) {
    const long long g = w[15 + i];
    if (g < 0 || g > 256) return (int)cudaErrorInvalidValue;
    a.gain[i] = (uint32_t)(256 - g) | (uint32_t)g << 16;
  }
  if (tiles == 0) return 0;
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  denoise_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)w[47]>>>(a);
  return (int)cudaGetLastError();
}
