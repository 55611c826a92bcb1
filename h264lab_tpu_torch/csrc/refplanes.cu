// K11 of h264lab_tpu_torch: the reference planes of L pictures from their
// deblocked MB tiles, in one kernel written by hand for NVIDIA Hopper
// (sm_90a), one launch for all L.
//
// Replaces h264lab_tpu/models/refstate.py:28-47 `prepare_reference` (and
// the `ref` stage that calls it, h264lab_tpu/parallel/gop.py:144-151),
// which the JAX package left to XLA (no Pallas kernel). It writes what the
// port's plain version `refstate.prepare_reference_plain` returns, array
// for array:
//   - y_pad (L, H + 2 G, W + 2 G), G = qpel.GUARD = 64: the luma plane
//     with a replicated guard ring, pixel (P, Q) = y[clamp(P - G)][clamp(Q
//     - G)];
//   - u_pad and v_pad (L, H/2 + G, W/2 + G), a ring of G / 2;
//   - y4_pad (L, H/4 + G/2, W/4 + G/2): the 4x pyramid y4[r][c] = (the sum
//     of the 4x4 box at (4r, 4c) + 8) >> 4, with a ring of G / 4.
// With no luma tiles (chroma only, `refstate.reference_chroma`) it writes
// u_pad and v_pad alone.
//
// The four planes share one structure: a plane of t bytes an MB row and
// column (t = 16 luma, 8 chroma, 4 the pyramid) has a ring of 4 t, a row
// pitch of t (mbw + 8) and (mbh + 8) bands of t rows, the outer 4 bands
// above and below the ring's copies of the edge row.
//
// Bound. Pure layout and a box sum, byte-bound: each tile byte read once
// (384 B an MB) and each plane byte written once; 16 lanes of 1080p move
// 50.1 MB in and 62.2 MB out, 34 us at 3.35 TB/s. Design:
//   - a block takes a chunk of kChunk MBs of one MB row of one picture;
//     one thread bulk-copies the chunk's luma and chroma tiles (contiguous
//     in device memory: 256 and 64 bytes an MB) into shared memory on an
//     mbarrier (csrc/tq.h), so every tile byte is read from device memory
//     once, and shared memory does not grow with the frame;
//   - every row of every plane is written from shared memory, in stores
//     as wide as the plane's pitch allows (y_pad always 16 bytes; u_pad,
//     v_pad and y4_pad 16, 8 or 4: the widest that divides their pitch,
//     so no store crosses a row); the thread map is bit fields of the
//     item index (no division by a run-time value), chosen so that a warp
//     writes whole 32-byte sectors of 8 rows and its shared reads are free
//     of bank conflicts;
//   - the pyramid is summed from the shared luma into a row-major shared
//     copy, then written like the other planes;
//   - the ring columns are splats of the edge pixel, written by the first
//     and last chunk of a row; the 4 guard bands above (below) are written
//     by the blocks of the first (last) MB row from the same shared copy,
//     and those blocks come first in the grid, so the heavier blocks do
//     not form the tail.
// The chroma planes' writers and the ring (`chroma_plane`, `ring`) are
// csrc/planes.h's, which K10 shares.
//
// Plain C interface, loaded with ctypes; the entry point takes its
// arguments as one array of 64-bit words (in the order
// `refplanes.planes_k11` writes them), launches on the given stream,
// allocates nothing and returns the launch's error.

#include <cstdint>
#include <cuda_runtime.h>

#include "planes.h"
#include "tq.h"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;      // MBs a block: a power of 2, at least 4
constexpr int kLogChunk = log2i(kChunk);
static_assert(kChunk == 1 << kLogChunk && kChunk >= 4, "kChunk");

struct Args {
  const uint8_t* tiles[3];      // (L, nmb, t, t); tiles[0] null: chroma only
  uint8_t* out[4];              // y_pad, u_pad, v_pad, y4_pad
  int mbw, mbh;
  int wc, w4;                   // the store bytes of u/v_pad and y4_pad
};

struct __align__(16) Smem {
  uint8_t y[kChunk * 256];      // the chunk's tiles, as in device memory
  uint8_t c[2][kChunk * 64];
  uint8_t y4[4 * 4 * kChunk];   // the chunk's 4 pyramid rows, row-major
  unsigned long long bar;
};

// The chunk's columns of the block's luma rows: 16-byte stores, a warp
// 8 rows x 4 MBs (lanes: bits 0-2 the row, 3-4 the MB; then the row's
// bit 3, then the MB's upper bits), each quarter-warp's shared reads 8
// rows of one tile.
__device__ __forceinline__ void luma_rows(uint8_t* plane, int pitch,
                                          const Bands& bd, const uint8_t* sy,
                                          int n, int col0) {
  constexpr int kLogBand = 4 + kLogChunk;
  const unsigned items = (unsigned)bd.nb << kLogBand;
  for (unsigned q = threadIdx.x; q < items; q += kThreads) {
    const int bi = q >> kLogBand, qq = q & ((1 << kLogBand) - 1);
    const int row = (qq & 7) | ((qq >> 2) & 8);
    const int j = ((qq >> 3) & 3) | ((qq >> 6) << 2);
    if (j >= n) continue;
    const uint4 v = get<16>(sy + 256 * j + 16 * bd.src(bi, row, 16));
    put<16>(plane + (long long)(16 * (bd.b0 + bi) + row) * pitch + col0 +
                16 * j,
            v);
  }
}

// The chunk's columns of the block's pyramid rows from the shared
// row-major pyramid (4 kChunk bytes a row), W-byte stores.
template <int W>
__device__ __forceinline__ void pyramid_rows(uint8_t* plane, int pitch,
                                             const Bands& bd,
                                             const uint8_t* s4, int n,
                                             int col0) {
  constexpr int kLogU = log2i(4 * kChunk / W);     // units a row
  constexpr int kLogBand = 2 + kLogU;
  const unsigned items = (unsigned)bd.nb << kLogBand;
  for (unsigned q = threadIdx.x; q < items; q += kThreads) {
    const int bi = q >> kLogBand, qq = q & ((1 << kLogBand) - 1);
    const int j = qq & ((1 << kLogU) - 1), row = qq >> kLogU;
    if (W * j >= 4 * n) continue;
    put<W>(plane + (long long)(4 * (bd.b0 + bi) + row) * pitch + col0 +
               W * j,
           get<W>(s4 + 4 * kChunk * bd.src(bi, row, 4) + W * j));
  }
}

// The pyramid rows of the chunk into the shared row-major copy: a thread
// per (pyramid row k, MB m), the 4 box rows of its 4 pixels as 16-byte
// shared reads. Lanes: bit 0 k's bit 0, bits 1-2 m's bits 0-1, bit 3 k's
// bit 1, then m; each thread starts at box row m & 3, so a quarter-warp's
// reads hit 8 distinct 16-byte bank groups.
__device__ __forceinline__ void pyramid(Smem& s, int n) {
  for (unsigned q = threadIdx.x; q < 4 * kChunk; q += kThreads) {
    const int k = (q & 1) | ((q >> 2) & 2);
    const int m = ((q >> 1) & 3) | ((q >> 4) << 2);
    if (m >= n) continue;
    const uint8_t* box = s.y + 256 * m + 64 * k;
    uint32_t sum[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 v = get<16>(box + 16 * ((i + m) & 3));
      sum[0] = __vsadu4(v.x, 0u) + sum[0];
      sum[1] = __vsadu4(v.y, 0u) + sum[1];
      sum[2] = __vsadu4(v.z, 0u) + sum[2];
      sum[3] = __vsadu4(v.w, 0u) + sum[3];
    }
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) word |= ((sum[c] + 8) >> 4) << (8 * c);
    *reinterpret_cast<uint32_t*>(s.y4 + 4 * kChunk * k + 4 * m) = word;
  }
}

template <int W>
__device__ __forceinline__ void pyramid_plane(uint8_t* plane, int pitch,
                                              const Bands& bd,
                                              const uint8_t* s4, int n,
                                              int c0, bool first, bool last,
                                              int mbw) {
  pyramid_rows<W>(plane, pitch, bd, s4, n, 16 + 4 * c0);
  if (first || last)
    ring<4, W, kThreads>(plane, pitch, bd, s4, s4 + 4 * n - 1, 4 * kChunk,
                         first, last, mbw, threadIdx.x);
}

// One block's work: chunk `chunk` (MBs c0 .. c0 + n - 1) of MB row r of
// picture pic.
struct Chunk {
  int c0, n, pic;
  long long mb0;                // its first MB among all L pictures'
  bool first, last;             // the first, the last chunk of its row
  Bands bd;
};

__device__ __forceinline__ Chunk chunk_of(const Args& a, int chunk, int pic,
                                          int r) {
  const int c0 = chunk * kChunk, n = min(kChunk, a.mbw - c0);
  return Chunk{c0, n, pic,
               (long long)pic * a.mbw * a.mbh + (long long)r * a.mbw + c0,
               chunk == 0, c0 + n == a.mbw, bands_of(r, a.mbh)};
}

// The chunk's tiles into s by bulk copies on s.bar, their bytes expected
// there (one thread).
__device__ __forceinline__ void load_chunk(const Args& a, Smem& s,
                                           const Chunk& c) {
  const bool luma = a.tiles[0] != nullptr;
  tq_mbar_expect(&s.bar, (luma ? 384 : 128) * c.n);
  if (luma) tq_load(s.y, a.tiles[0] + 256 * c.mb0, 256 * c.n, &s.bar);
  tq_load(s.c[0], a.tiles[1] + 64 * c.mb0, 64 * c.n, &s.bar);
  tq_load(s.c[1], a.tiles[2] + 64 * c.mb0, 64 * c.n, &s.bar);
}

// Every plane's rows of the chunk from its tiles in s (the whole block).
__device__ __forceinline__ void write_chunk(const Args& a, Smem& s,
                                            const Chunk& c) {
  const Bands& bd = c.bd;
  const long long hc = 8ll * (a.mbh + 8), pc = 8 * (a.mbw + 8);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint8_t* plane = a.out[1 + p] + c.pic * hc * pc;
    if (a.wc == 16)
      chroma_plane<16, kChunk, kThreads>(plane, (int)pc, bd, s.c[p], c.n,
                                         c.c0, c.first, c.last, a.mbw,
                                         threadIdx.x);
    else
      chroma_plane<8, kChunk, kThreads>(plane, (int)pc, bd, s.c[p], c.n,
                                        c.c0, c.first, c.last, a.mbw,
                                        threadIdx.x);
  }
  if (a.tiles[0] == nullptr) return;
  const long long py = 16ll * (a.mbw + 8);
  uint8_t* y = a.out[0] + c.pic * (16ll * (a.mbh + 8)) * py;
  luma_rows(y, (int)py, bd, s.y, c.n, 64 + 16 * c.c0);
  if (c.first || c.last)
    ring<16, 16, kThreads>(y, (int)py, bd, s.y, s.y + 256 * (c.n - 1) + 15,
                           16, c.first, c.last, a.mbw, threadIdx.x);
  pyramid(s, c.n);
  __syncthreads();                  // the shared pyramid rows written
  const long long p4 = 4 * (a.mbw + 8);
  uint8_t* y4 = a.out[3] + c.pic * (4ll * (a.mbh + 8)) * p4;
  if (a.w4 == 16)
    pyramid_plane<16>(y4, (int)p4, bd, s.y4, c.n, c.c0, c.first, c.last,
                      a.mbw);
  else if (a.w4 == 8)
    pyramid_plane<8>(y4, (int)p4, bd, s.y4, c.n, c.c0, c.first, c.last,
                     a.mbw);
  else
    pyramid_plane<4>(y4, (int)p4, bd, s.y4, c.n, c.c0, c.first, c.last,
                     a.mbw);
}

// grid (chunks of a row, L, mbh): blockIdx.z 0 the first MB row, 1 the
// last, then the rows between (the heavier blocks first)
__global__ void __launch_bounds__(kThreads)
reference_planes_kernel(const Args a) {
  __shared__ Smem s;
  const int z = blockIdx.z;
  const Chunk c = chunk_of(a, blockIdx.x, blockIdx.y,
                           z == 0 ? 0 : z == 1 ? a.mbh - 1 : z - 1);
  if (threadIdx.x == 0) {
    tq_mbar_init(&s.bar);
    load_chunk(a, s, c);
  }
  __syncthreads();                  // the mbarrier's init before its waits
  tq_mbar_wait(&s.bar);
  write_chunk(a, s, c);
}

}  // namespace

// w: tiles_y (0 for chroma only), tiles_u, tiles_v, y_pad, u_pad, v_pad,
// y4_pad, L, mbw, mbh, guard, the stream. Tiles and planes 16-byte
// aligned.
extern "C" int h264lab_reference_planes(const long long* w) {
  Args a;
  for (int p = 0; p < 3; ++p) a.tiles[p] = (const uint8_t*)w[p];
  for (int p = 0; p < 4; ++p) a.out[p] = (uint8_t*)w[3 + p];
  const long long n = w[7];
  a.mbw = (int)w[8];
  a.mbh = (int)w[9];
  if (n <= 0) return 0;
  const bool luma = a.tiles[0] != nullptr;
  long long addr = 0;
  for (int p = luma ? 0 : 1; p < 3; ++p) addr |= w[p] | w[3 + p];
  if (luma) addr |= w[6];
  // the band structure needs the rings at 4 MB rows: G = 64
  if (a.mbw <= 0 || a.mbh <= 0 || w[10] != 64 || (addr & 15) ||
      n > 65535 || a.mbh > 65535 ||
      (long long)(16 * a.mbh + 128) * (16 * a.mbw + 128) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  a.wc = store_bytes(8ll * (a.mbw + 8));
  a.w4 = store_bytes(4ll * (a.mbw + 8));
  const dim3 grid((a.mbw + kChunk - 1) / kChunk, (unsigned)n, a.mbh);
  reference_planes_kernel<<<grid, kThreads, 0, (cudaStream_t)w[11]>>>(a);
  return (int)cudaGetLastError();
}
