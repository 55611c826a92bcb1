// K9 and K10 of h264lab_tpu_torch: the SVC 2x resampling, in two kernels
// written by hand for NVIDIA Hopper (sm_90a), one launch each.
//
// K9, `downsample_kernel`, replaces h264lab_tpu/ops/resample.py:26
// `downsample2x`, which the JAX package runs on the three input planes of
// every two-layer frame (h264lab_tpu/models/svc.py:255-257): each output
// pixel is the 2x2 box (a + b + c + d + 2) >> 2; an odd last row or column
// of the input is dropped. All three planes in one launch.
//
// K10, `upsample_kernel`, replaces h264lab_tpu/ops/resample.py:56
// `upsample2x_luma` and :64 `upsample2x_chroma` with the tiling of their
// output (h264lab_tpu/models/svc.py:316-330: `wavefront.pad_plane` to the
// enhancement's padded size, `mb_tiles`) and the guard-padded chroma
// planes that the base-mode frame's chroma prediction reads
// (`qpel.pad_guard` by GUARD // 2 of the tiled planes). One launch writes
// the five outputs of the port's plain version
// (`ops/resample.upsample_tiles_plain`) from the base layer's deblocked
// tiles:
//   - the upsampled plane of a cropped base plane of h x w pixels is 2h x
//     2w; pixel (2i + a, 2j + b) is
//       clip((sum_l f_b[l] V_a(i, c(j - 1 + l)) + r) >> s, 0, 255),
//       V_a(i, col) = sum_k f_a[k] x[c(i - 1 + k)][col],
//     with c() clamping into the cropped plane (its edges replicated), f
//     the luma phases 4 and 12 of FILTER16_LUMA, (-3, 28, 8, -1) and (-1,
//     8, 28, -3), r = 512, s = 10 (an arithmetic shift), or for chroma the
//     bilinear taps (1, 3, 0) and (0, 3, 1), r = 8, s = 4. The JAX package
//     filters the rows, then the columns, and neither rounds nor clips
//     between the passes: the vertical sums V are exact integers (luma in
//     [-1020, 9180], chroma in [0, 1020]: int16 holds them) and the
//     horizontal pass over them gives its values;
//   - an enhancement pixel (Y, X) of the padded plane reads the upsampled
//     pixel (min(Y, 2h - 1), min(X, 2w - 1)) (`pad_to`'s edge
//     replication); the crop is the base picture's (the configured size),
//     not its padded MB grid;
//   - u_pad and v_pad pixel (P, Q) is enhancement chroma pixel
//     (clamp(P - G), clamp(Q - G)), G = 32, clamped into the padded plane
//     first, then as above.
//
// Bound. Both are byte-bound integer stencils: K9 reads each input byte
// once and writes a quarter as many (3.1 MB in, 0.8 MB out at 1080p, about
// 1.2 us at 3.35 TB/s); K10 reads the 0.8 MB cropped base picture once and
// writes 3.1 MB of tiles and 1.2 MB of padded chroma (5.16 MB, about 1.5
// us).
//
// K9's design: threads in two dimensions, an output row and 16 output
// bytes of it, the plane on the grid's third axis (no division). Where a
// plane's input width is a multiple of 32 and both its addresses are
// 16-byte aligned (the 1080p planes and the 960x544 ones), a thread reads
// two 32-byte runs of two input rows as four 16-byte loads, sums the
// boxes two to a 32-bit word (16-bit lanes) and writes one 16-byte store;
// any other plane takes a byte-wise path in the same kernel, with the same
// results, so planes of any alignment are taken as they are.
//
// K10's design: a block of kUpThreads threads per chunk of kUpChunk
// enhancement MBs of one enhancement MB row (1,020 blocks at 1080p, all
// resident at once):
//   - one thread bulk-copies the base tiles the chunk reads into shared
//     memory on an mbarrier (csrc/tq.h): of each plane, in each of the at
//     most two base MB rows its taps reach, one contiguous run of at most
//     kUpChunk / 2 + 2 tiles of the (bnmb, t, t) layout, the halo included
//     (16-byte aligned: the wrapper checks), so no thread loads a base
//     byte from device memory;
//   - the vertical pass: each row of the chunk at each base column that
//     its horizontal taps reach (clamped into the crop), its vertical sum
//     into shared memory as 16 bits, once; an item takes 4 columns of a
//     pair of rows from one 4-byte read of each tap row, two columns a
//     word in 16-bit lanes (the luma biased by 1020, so that no lane goes
//     negative), both phases of the pair from the same base pixels;
//   - the horizontal pass in registers: a thread takes a luma tile row (16
//     bytes, one 16-byte store) or a chroma tile row (8 bytes, one 8-byte
//     store and a copy into shared tiles), its vertical sums in three (two)
//     16-byte shared reads, taken as pairs of 16-bit lanes into dp2a, the
//     luma clamped two lanes at a time by DPX; a row that runs past the
//     crop repeats its last pixel byte by byte;
//   - the chunk's columns of the guard-padded chroma rows of its MB row,
//     the guard bands on the first and last MB row's blocks and the ring
//     on the first and last chunk, from the shared chroma tiles by
//     csrc/planes.h's writers (K11's), U by half the threads and V by the
//     other half, in 16-byte stores where the pitch allows (else 8); the
//     blocks of the first and last MB row come first in the grid;
//   - index arithmetic in 32 bits, division only by constants; the thread
//     maps are bit fields of the item index, chosen so that the shared
//     reads and writes are free of bank conflicts; no parameter array is
//     indexed at run time (that would copy them to local memory).
// Where its time goes: the grid's launch and the copies' latency are
// about half of it, the passes' instructions the rest, issue-bound
// (`tools/torch_ref_bench.py --phases`, PERF.md).
//
// Plain C interface, loaded with ctypes; each entry point takes its
// arguments as one array of 64-bit words (in the order
// `resample.downsample_k9` and `upsample_k10` write them), launches on
// the given stream, allocates nothing and returns the launch's error.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "planes.h"
#include "tq.h"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Element i of a kernel parameter's array with i known only at run time:
// a select, so that the parameters stay in the constant bank (indexed
// directly they are copied to the stack).
template <typename T>
__device__ __forceinline__ T pick(const T (&v)[3], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : v[2];
}

struct DownArgs {
  const uint8_t* in[3];
  uint8_t* out[3];
  int h[3], w[3];        // the output planes' sizes
  int in_w[3];           // the input planes' row widths
  int vec[3];            // 1: the 16-byte path (see the entry point)
};

// K9's block: 32 columns of 16 output bytes by 8 output rows
constexpr int kDownX = 32, kDownY = 8;

// The 2x2 boxes of one input word of two rows (a above b): the outputs
// of bytes 0-1 and 2-3 at bits 0-7 and 16-23 (two 16-bit lanes, each sum
// at most 1022, so no carry crosses them).
__device__ __forceinline__ uint32_t down_pair(uint32_t a, uint32_t b) {
  constexpr uint32_t kLo = 0x00ff00ffu;
  const uint32_t s = (a & kLo) + ((a >> 8) & kLo) + (b & kLo) +
                     ((b >> 8) & kLo) + 0x00020002u;
  return (s >> 2) & kLo;
}

// 4 output bytes from input words x0 x1 (row 2r) and y0 y1 (row 2r + 1)
__device__ __forceinline__ uint32_t down_word(uint32_t x0, uint32_t x1,
                                              uint32_t y0, uint32_t y1) {
  return __byte_perm(down_pair(x0, y0), down_pair(x1, y1), 0x6420);
}

// A thread per 16 output bytes of one row: (blockIdx.z the plane, row,
// 16-byte column). On the 16-byte path two 32-byte runs of two input
// rows as four 16-byte loads and one 16-byte store; else byte by byte.
__global__ void __launch_bounds__(kDownX * kDownY)
downsample_kernel(const DownArgs a) {
  const int p = blockIdx.z;
  const int r = blockIdx.y * kDownY + threadIdx.y;
  const int c = 16 * (blockIdx.x * kDownX + threadIdx.x);
  const int ow = pick(a.w, p);
  if (r >= pick(a.h, p) || c >= ow) return;
  const int iw = pick(a.in_w, p);
  const uint8_t* __restrict__ s = pick(a.in, p) + (long long)(2 * r) * iw +
                                  2 * c;
  uint8_t* __restrict__ out = pick(a.out, p) + (long long)r * ow + c;
  if (pick(a.vec, p)) {
    const uint4 x0 = *reinterpret_cast<const uint4*>(s);
    const uint4 x1 = *reinterpret_cast<const uint4*>(s + 16);
    const uint4 y0 = *reinterpret_cast<const uint4*>(s + iw);
    const uint4 y1 = *reinterpret_cast<const uint4*>(s + iw + 16);
    *reinterpret_cast<uint4*>(out) = make_uint4(
        down_word(x0.x, x0.y, y0.x, y0.y), down_word(x0.z, x0.w, y0.z, y0.w),
        down_word(x1.x, x1.y, y1.x, y1.y), down_word(x1.z, x1.w, y1.z, y1.w));
  } else {
    const int m = min(16, ow - c);
    for (int k = 0; k < m; ++k) {
      const uint8_t* b = s + 2 * k;
      out[k] = (uint8_t)((b[0] + b[1] + b[iw] + b[iw + 1] + 2) >> 2);
    }
  }
}

constexpr int kUpChunk = 8;        // enhancement MBs a block: 4, 8 or 16
constexpr int kUpThreads = 128;
constexpr int kUpLogChunk = log2i(kUpChunk);
static_assert(kUpChunk == 1 << kUpLogChunk && kUpChunk >= 4 &&
              kUpChunk <= 16, "kUpChunk");
constexpr int kUpTiles = kUpChunk / 2 + 2;  // base tiles a row, halo included
constexpr int kVy = 8 * kUpChunk + 16;      // vertical sums a luma row
constexpr int kVc = 4 * kUpChunk + 16;      // and a chroma row
// the rows' pitch, 16 bytes over a multiple of 32: the 8-byte writes of
// rows 2 apart fall in distinct banks
constexpr int kVyPitch = kVy + 8, kVcPitch = kVc + 8;
// the luma sums are kept biased by 1020 (4 x 255, the most the negative
// taps take), so that no 16-bit lane goes negative
constexpr uint32_t kBias2 = 0x03fc03fcu;
// signed byte taps for dp2a: luma phases 0 (-3, 28, 8, -1) and 1 (-1, 8,
// 28, -3); chroma (1, 3) and (3, 1)
constexpr int kTapsY0 = (int)0xff081cfdu, kTapsY1 = (int)0xfd1c08ffu;
constexpr int kTapsC0 = 0x0301, kTapsC1 = 0x0103;

struct UpArgs {
  const uint8_t* base[3];   // (bnmb, t, t) deblocked base tiles
  uint8_t* pred[3];         // (nmb, t, t) enhancement tiles
  uint8_t* pad[2];          // (8 (mbh + 8), 8 (mbw + 8)) guard-padded U, V
  int bmbw;                 // the base layer's MBs a row
  int crop_h[3], crop_w[3]; // the cropped base planes
  int mbw, mbh;             // the enhancement's MBs
  int wc;                   // the store bytes of u_pad and v_pad: 16 or 8
};

struct __align__(16) UpSmem {
  uint8_t y[2][kUpTiles * 256];     // base luma tiles of two base MB rows
  // U and V, the same, V 32 bytes past U in the banks
  uint8_t c[2][2 * kUpTiles * 64 + 32];
  uint16_t vy[16][kVyPitch];        // the vertical sums of the luma rows
  uint16_t vc[2][8][kVcPitch];      // and of the U and V rows
  uint8_t out[2][kUpChunk * 64];    // the chunk's U and V tiles
  unsigned long long bar;
};

// One plane's window of a block (t = 16 luma, 8 chroma): the vertical
// sums at element e of a row are those of base column clamp(vb + e, 0, w -
// 1); shared memory holds base tile columns t0 .. t1 of MB rows s0 .. s1.
// An enhancement MB column k > kmax has no pixel inside 2w: it repeats
// pixel 2w - 1, which MB column kmax computes.
struct Win {
  int h, w, kmax, c0e, vb, t0, t1, s0, s1;
};

// Of the chunk of MBs c0 .. of enhancement MB row r: luma rows 16 r + y
// have their taps on base rows clamp(8 r - 1 .. 8 r + 9) and their MB
// columns k on base columns clamp(8 k - 1 .. 8 k + 9); chroma rows 8 r + y
// on base rows clamp(4 r - 1 .. 4 r + 4), MB columns on clamp(4 k - 1 .. 4
// k + 4). vb is at most 8 below the first one, a multiple of 8.
template <int kT>
__device__ __forceinline__ Win window(int h, int w, int c0, int r) {
  Win g;
  g.h = h;
  g.w = w;
  g.kmax = (2 * w - 1) >> log2i(kT);
  g.c0e = min(c0, g.kmax);
  if constexpr (kT == 16) {
    g.vb = 8 * g.c0e - 8;
    g.t1 = min(g.vb + kVy - 1, w - 1) >> 4;
    g.s0 = max(min(8 * r, h - 1) - 1, 0) >> 4;
    g.s1 = min(8 * r + 9, h - 1) >> 4;
  } else {
    g.vb = (4 * g.c0e - 4) & ~7;
    g.t1 = min(g.vb + kVc - 1, w - 1) >> 3;
    g.s0 = max(min(4 * r, h - 1) - 1, 0) >> 3;
    g.s1 = min(4 * r + 4, h - 1) >> 3;
  }
  g.t0 = max(g.vb, 0) >> log2i(kT);
  return g;
}

// The window's bytes in shared memory.
template <int kT>
__device__ __forceinline__ unsigned window_bytes(const Win& g) {
  return (unsigned)((g.s1 - g.s0 + 1) * (g.t1 - g.t0 + 1) * kT * kT);
}

// The window's tiles into shared memory, a bulk copy a base MB row, slot
// s - s0 at dst + (s - s0) * kUpTiles t t (one thread).
template <int kT>
__device__ __forceinline__ void load_window(const uint8_t* base, int bmbw,
                                            const Win& g, uint8_t* dst,
                                            unsigned long long* bar) {
  const unsigned bytes = (g.t1 - g.t0 + 1) * kT * kT;
  for (int s = g.s0; s <= g.s1; ++s)
    tq_load(dst + (s - g.s0) * (kUpTiles * kT * kT),
            base + ((long long)s * bmbw + g.t0) * (kT * kT), bytes, bar);
}

// Base columns col0 .. col0 + 3 (col0 a multiple of 4) clamped into the
// crop [0, w - 1]: the column of the word that holds them (a multiple of
// 4) and the `__byte_perm` selectors that put its bytes of columns col0,
// col0 + 2 (lo) and col0 + 1, col0 + 3 (hi) into a word's two 16-bit
// lanes, zero-extended.
struct Quad {
  int cb;
  unsigned lo, hi;
};

__device__ __forceinline__ Quad quad(int col0, int w) {
  const int cb = clampi(col0, 0, (w - 1) & ~3);
  int b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = clampi(col0 + j, 0, w - 1) - cb;
  return Quad{cb, 0x4040u | b[0] | b[2] << 8, 0x4040u | b[1] | b[3] << 8};
}

// Four sums, lanes (col 0, col 2) and (col 1, col 3), in column order: one
// 8-byte store.
__device__ __forceinline__ void put_sums(uint16_t* dst, uint32_t lo,
                                         uint32_t hi) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(__byte_perm(lo, hi, 0x5410), __byte_perm(lo, hi, 0x7632));
}

// Luma item q of the vertical pass: a word of 4 elements (base columns
// vb + 4 word ..) of a pair of rows 2 pair, 2 pair + 1 (the two phases of
// base row i, or both the last phase past the crop), from one 4-byte read
// of each tap row, two columns a word in 16-bit lanes. Lanes: bits 0-1
// the word's low bits, 2-4 the pair: a warp reads 4 words of each of 8
// consecutive base rows, 32 banks.
__device__ __forceinline__ void luma_vertical(UpSmem& s, const Win& g,
                                              int r, int q) {
  const int pair = (q >> 2) & 7, word = ((q >> 5) << 2) | (q & 3);
  const Quad c = quad(g.vb + 4 * word, g.w);
  const uint8_t* src = s.y[0] + ((c.cb >> 4) - g.t0) * 256 + (c.cb & 15);
  const int i = min(8 * r + pair, g.h - 1);
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int row = clampi(i - 1 + k, 0, g.h - 1);
    const uint32_t x = *reinterpret_cast<const uint32_t*>(
        src + ((row >> 4) - g.s0) * (kUpTiles * 256) + (row & 15) * 16);
    lo[k] = __byte_perm(x, 0, c.lo);
    hi[k] = __byte_perm(x, 0, c.hi);
  }
  const uint32_t l0 = kBias2 + 28 * lo[1] + 8 * lo[2] - 3 * lo[0] - lo[3];
  const uint32_t h0 = kBias2 + 28 * hi[1] + 8 * hi[2] - 3 * hi[0] - hi[3];
  const uint32_t l1 = kBias2 + 8 * lo[1] + 28 * lo[2] - lo[0] - 3 * lo[3];
  const uint32_t h1 = kBias2 + 8 * hi[1] + 28 * hi[2] - hi[0] - 3 * hi[3];
  const bool ph0 = 8 * r + pair < g.h;
  put_sums(&s.vy[2 * pair][4 * word], ph0 ? l0 : l1, ph0 ? h0 : h1);
  put_sums(&s.vy[2 * pair + 1][4 * word], l1, h1);
}

// The same for chroma item q of U and V: taps (1, 3, 0) and (0, 3, 1), no
// bias. Lanes: bit 0 the word's low bit, 1-2 the pair, 3 the word's next
// bit, 4 the plane: a warp reads 2 words of each of 4 consecutive base
// rows of 2 tiles of both planes, 32 banks.
__device__ __forceinline__ void chroma_vertical(UpSmem& s, const Win& gu,
                                                const Win& gv, int r,
                                                int q) {
  const int p = (q >> 4) & 1, pair = (q >> 1) & 3;
  const int word = ((q >> 5) << 2) | ((q >> 2) & 2) | (q & 1);
  const int h = p ? gv.h : gu.h, t0 = p ? gv.t0 : gu.t0;
  const int s0 = p ? gv.s0 : gu.s0;
  const Quad c = quad((p ? gv.vb : gu.vb) + 4 * word, p ? gv.w : gu.w);
  const uint8_t* src = s.c[p] + ((c.cb >> 3) - t0) * 64 + (c.cb & 7);
  const int i = min(4 * r + pair, h - 1);
  uint32_t lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int row = clampi(i - 1 + k, 0, h - 1);
    const uint32_t x = *reinterpret_cast<const uint32_t*>(
        src + ((row >> 3) - s0) * (kUpTiles * 64) + (row & 7) * 8);
    lo[k] = __byte_perm(x, 0, c.lo);
    hi[k] = __byte_perm(x, 0, c.hi);
  }
  const uint32_t l1 = 3 * lo[1] + lo[2], h1 = 3 * hi[1] + hi[2];
  const bool ph0 = 4 * r + pair < h;
  put_sums(&s.vc[p][2 * pair][4 * word], ph0 ? lo[0] + 3 * lo[1] : l1,
           ph0 ? hi[0] + 3 * hi[1] : h1);
  put_sums(&s.vc[p][2 * pair + 1][4 * word], l1, h1);
}

// The vertical pass: the 2 kVy luma items, then the 2 kVc chroma items
// (multiples of 32: a warp takes one kind), every thread two items at
// kUpChunk 8.
__device__ __forceinline__ void vertical(UpSmem& s, const Win& gy,
                                         const Win& gu, const Win& gv,
                                         int r) {
  for (int q = threadIdx.x; q < 2 * (kVy + kVc); q += kUpThreads) {
    if (q < 2 * kVy)
      luma_vertical(s, gy, r, q);
    else
      chroma_vertical(s, gu, gv, r, q - 2 * kVy);
  }
}

// Four ints as the bytes of a word, each clamped to [0, 255] (two 16-bit
// lanes a DPX min-and-ReLU).
__device__ __forceinline__ uint32_t clamped_bytes(const int* v) {
  const uint32_t a = __vimin_s16x2_relu(__byte_perm(v[0], v[1], 0x5410),
                                        0x00ff00ffu);
  const uint32_t b = __vimin_s16x2_relu(__byte_perm(v[2], v[3], 0x5410),
                                        0x00ff00ffu);
  return __byte_perm(a, b, 0x6420);
}

// Four ints in [0, 255] as the bytes of a word.
__device__ __forceinline__ uint32_t bytes(const int* v) {
  return __byte_perm(__byte_perm(v[0], v[1], 0x0040),
                     __byte_perm(v[2], v[3], 0x0040), 0x5410);
}

// Bytes from byte e on of `n` words replaced by byte `cap` (e, cap below
// 4 n): a row's pixels past the crop repeat its last one.
template <int n>
__device__ __forceinline__ void repeat_last(uint32_t* word, int e, int cap) {
  // word cap >> 2 by selects on constant indices (no local memory)
  uint32_t w = cap & 4 ? word[1] : word[0];
  if constexpr (n == 4) w = cap & 8 ? (cap & 4 ? word[3] : word[2]) : w;
  const uint32_t last = __byte_perm(w, 0, (cap & 3) * 0x1111);
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const int keep = clampi(e - 4 * j, 0, 4);
    const uint32_t mask = keep == 4 ? 0xffffffffu : (1u << (8 * keep)) - 1;
    word[j] = (word[j] & mask) | (last & ~mask);
  }
}

// The chunk's luma tile rows: a thread per (row, MB), its 16 bytes from
// the sums win[t] of base columns 8 k - 1 + t (three 16-byte shared
// reads), taken as pairs (win[t], win[t + 1]) of 16-bit lanes into dp2a,
// one 16-byte store. Lanes: the MB, then the row: a quarter-warp reads 8
// MBs of one row, 16 bytes apart.
__device__ __forceinline__ void luma_rows(const UpArgs& a, const UpSmem& s,
                                          const Win& g, int r, int c0,
                                          int n) {
  constexpr int kRound = 512 - 32 * 1020;   // the rounding, less the bias
  for (int q = threadIdx.x; q < 16 * kUpChunk; q += kUpThreads) {
    const int m = q & (kUpChunk - 1), row = q >> kUpLogChunk;
    if (m >= n) continue;
    const int k = min(c0 + m, g.kmax);
    // win[t] is element 7 + t of the 24 sums read
    const uint4* v = reinterpret_cast<const uint4*>(
        &s.vy[row][8 * (k - g.c0e)]);
    const uint4 x = v[0], y = v[1], z = v[2];
    const uint32_t wd[6] = {x.w, y.x, y.y, y.z, y.w, z.x};
    uint32_t pr[10];
#pragma unroll
    for (int t = 0; t < 10; ++t)
      pr[t] = t & 1 ? wd[(t + 1) >> 1]
                    : __byte_perm(wd[t >> 1], wd[(t >> 1) + 1], 0x5432);
    uint32_t word[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int px[4];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int p = 2 * j + b;
        px[2 * b] = __dp2a_lo((int)pr[p], kTapsY0,
                              __dp2a_hi((int)pr[p + 2], kTapsY0, kRound)) >>
                    10;
        px[2 * b + 1] = __dp2a_lo((int)pr[p], kTapsY1,
                                  __dp2a_hi((int)pr[p + 2], kTapsY1,
                                            kRound)) >>
                        10;
      }
      word[j] = clamped_bytes(px);
    }
    const int cap = 2 * g.w - 1 - 16 * k;
    const int e = c0 + m > g.kmax ? 0 : cap + 1;
    if (e < 16) repeat_last<4>(word, e, cap);
    *reinterpret_cast<uint4*>(a.pred[0] + (r * a.mbw + c0 + m) * 256 +
                              row * 16) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// The chunk's U and V tile rows: a thread per (plane, row, MB), its 8
// bytes from the sums of base columns 4 k - 1 .. 4 k + 4 (two 16-byte
// shared reads; the window starts at element 3 or 7 of them) as pairs
// into dp2a, one 8-byte store, and into the shared tiles. Lanes: bits 0-1
// the row's bits 1-2, bit 2 the MB's low bit, bit 3 the row's bit 0, then
// the MB, then the plane: a quarter-warp reads rows 0, 2, 4, 6 (224 bytes
// apart) of at most 2 chunks, a half-warp writes 8 rows of 2 MBs:
// distinct banks.
__device__ __forceinline__ void chroma_rows_up(const UpArgs& a, UpSmem& s,
                                               const Win& gu, const Win& gv,
                                               int r, int c0, int n) {
  for (int q = threadIdx.x; q < 16 * kUpChunk; q += kUpThreads) {
    const int row = ((q & 3) << 1) | ((q >> 3) & 1);
    const int m = ((q >> 2) & 1) | (((q >> 4) & (kUpChunk / 2 - 1)) << 1);
    const int p = q >> (3 + kUpLogChunk);
    if (m >= n) continue;
    const int kmax = p ? gv.kmax : gu.kmax, w = p ? gv.w : gu.w;
    const int k = min(c0 + m, kmax);
    const int st = 4 * k - 1 - (p ? gv.vb : gu.vb);
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
    uint32_t word[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int px[4];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int t = 2 * j + b;
        px[2 * b] = __dp2a_lo((int)pr[t], kTapsC0, 8) >> 4;
        px[2 * b + 1] = __dp2a_lo((int)pr[t + 1], kTapsC1, 8) >> 4;
      }
      word[j] = bytes(px);
    }
    const int cap = 2 * w - 1 - 8 * k;
    const int e = c0 + m > kmax ? 0 : cap + 1;
    if (e < 8) repeat_last<2>(word, e, cap);
    const uint2 out = make_uint2(word[0], word[1]);
    *reinterpret_cast<uint2*>(pick(a.pred, 1 + p) +
                              (r * a.mbw + c0 + m) * 64 + row * 8) = out;
    *reinterpret_cast<uint2*>(s.out[p] + m * 64 + row * 8) = out;
  }
}

// grid (chunks of a row, mbh): blockIdx.y 0 the first MB row, 1 the last,
// then the rows between (the blocks with guard bands first)
__global__ void __launch_bounds__(kUpThreads)
upsample_kernel(const UpArgs a) {
  __shared__ UpSmem s;
  const int z = blockIdx.y;
  const int r = z == 0 ? 0 : z == 1 ? a.mbh - 1 : z - 1;
  const int c0 = blockIdx.x * kUpChunk, n = min(kUpChunk, a.mbw - c0);
  const Win gy = window<16>(a.crop_h[0], a.crop_w[0], c0, r);
  const Win gu = window<8>(a.crop_h[1], a.crop_w[1], c0, r);
  const Win gv = window<8>(a.crop_h[2], a.crop_w[2], c0, r);
  if (threadIdx.x == 0) {
    tq_mbar_init(&s.bar);
    tq_mbar_expect(&s.bar, window_bytes<16>(gy) + window_bytes<8>(gu) +
                               window_bytes<8>(gv));
    load_window<16>(a.base[0], a.bmbw, gy, s.y[0], &s.bar);
    load_window<8>(a.base[1], a.bmbw, gu, s.c[0], &s.bar);
    load_window<8>(a.base[2], a.bmbw, gv, s.c[1], &s.bar);
  }
  __syncthreads();                  // the mbarrier's init before its waits
  tq_mbar_wait(&s.bar);
  vertical(s, gy, gu, gv, r);
  __syncthreads();                  // the vertical sums written
  luma_rows(a, s, gy, r, c0, n);
  chroma_rows_up(a, s, gu, gv, r, c0, n);
  __syncthreads();                  // the shared chroma tiles written
  // U by the first half of the threads, V by the second
  constexpr unsigned kHalf = kUpThreads / 2;
  const Bands bd = bands_of(r, a.mbh);
  const bool first = c0 == 0, last = c0 + n == a.mbw;
  const int pitch = 8 * (a.mbw + 8), p = threadIdx.x >= kHalf;
  const unsigned tid = threadIdx.x - p * kHalf;
  // a select, not a.pad[p]: indexed at run time, the kernel's parameters
  // would be copied to local memory
  uint8_t* pad = p ? a.pad[1] : a.pad[0];
  if (a.wc == 16)
    chroma_plane<16, kUpChunk, kHalf>(pad, pitch, bd, s.out[p], n, c0, first,
                                      last, a.mbw, tid);
  else
    chroma_plane<8, kUpChunk, kHalf>(pad, pitch, bd, s.out[p], n, c0, first,
                                     last, a.mbw, tid);
}

}  // namespace

// w: in_y, in_u, in_v, out_y, out_u, out_v, then per plane its input's
// height and width (6 words), then the stream. A plane takes the 16-byte
// path where its input's width is a multiple of 32 (so its output's is
// one of 16) and both its addresses are 16-byte aligned.
extern "C" int h264lab_resample_down(const long long* w) {
  DownArgs a;
  int rows = 0, groups = 0;
  for (int p = 0; p < 3; ++p) {
    a.in[p] = (const uint8_t*)w[p];
    a.out[p] = (uint8_t*)w[3 + p];
    const long long ih = w[6 + 2 * p], iw = w[7 + 2 * p];
    if (ih < 0 || iw < 0 || ih * iw >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
    a.h[p] = (int)(ih / 2);
    a.w[p] = (int)(iw / 2);
    a.in_w[p] = (int)iw;
    a.vec[p] = iw % 32 == 0 && ((w[p] | w[3 + p]) & 15) == 0;
    if (a.h[p] > 0 && a.w[p] > 0) {
      rows = std::max(rows, a.h[p]);
      groups = std::max(groups, (a.w[p] + 15) / 16);
    }
  }
  if (rows == 0) return 0;
  const dim3 grid((groups + kDownX - 1) / kDownX,
                  (rows + kDownY - 1) / kDownY, 3);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  downsample_kernel<<<grid, dim3(kDownX, kDownY), 0,
                      (cudaStream_t)w[12]>>>(a);
  return (int)cudaGetLastError();
}

// w: base_y, base_u, base_v, pred_y, pred_u, pred_v, u_pad, v_pad, bmbw,
// the crops (h, w) of Y, U and V (6 words), mbw, mbh, guard, the stream.
// The tiles and planes 16-byte aligned (the tiles are bulk-copied), the
// crops within the base planes (the wrapper checks both).
extern "C" int h264lab_resample_up(const long long* w) {
  UpArgs a;
  long long addr = w[6] | w[7];
  for (int p = 0; p < 3; ++p) {
    a.base[p] = (const uint8_t*)w[p];
    a.pred[p] = (uint8_t*)w[3 + p];
    addr |= w[p] | w[3 + p];
    a.crop_h[p] = (int)w[9 + 2 * p];
    a.crop_w[p] = (int)w[10 + 2 * p];
    if (a.crop_h[p] <= 0 || a.crop_w[p] <= 0)
      return (int)cudaErrorInvalidValue;
  }
  a.pad[0] = (uint8_t*)w[6];
  a.pad[1] = (uint8_t*)w[7];
  a.bmbw = (int)w[8];
  a.mbw = (int)w[15];
  a.mbh = (int)w[16];
  // the band structure needs the ring at 4 MB rows: GUARD / 2 = 32
  if (a.bmbw <= 0 || a.mbw <= 0 || a.mbh <= 0 || w[17] != 32 ||
      (addr & 15) || a.mbh > 65535 ||
      (long long)a.mbw * a.mbh * 256 >= (1ll << 31) ||
      (long long)(8 * a.mbh + 64) * (8 * a.mbw + 64) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  a.wc = store_bytes(8ll * (a.mbw + 8));
  const dim3 grid((a.mbw + kUpChunk - 1) / kUpChunk, a.mbh);
  upsample_kernel<<<grid, kUpThreads, 0, (cudaStream_t)w[18]>>>(a);
  return (int)cudaGetLastError();
}
