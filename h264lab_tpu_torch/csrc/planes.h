// The writers of the guard-padded chroma planes that K10 (csrc/resample.cu)
// and K11 (csrc/refplanes.cu) share. Both write u_pad and v_pad, a plane
// of t = 8 bytes an MB row and column with a ring of 4 t = GUARD / 2: a
// row pitch of t (mbw + 8) and (mbh + 8) bands of t rows, the outer 4
// bands above and below the ring's copies of the edge row. A block writes
// the bands of one chunk of kChunk MBs of one MB row from that chunk's
// 8 x 8 tiles in shared memory, in stores as wide as the pitch allows (16
// bytes where it divides by 16, else 8), from a thread map of bit fields
// of the item index (no division by a run-time value) whose shared reads
// are free of bank conflicts; the ring columns are splats of the edge
// pixels, written by the first and last chunk of a row.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x >> 1);
}

template <int W> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };

template <int W>
__device__ __forceinline__ typename Vec<W>::T splat(uint32_t byte) {
  const uint32_t w = 0x01010101u * byte;
  if constexpr (W == 16) {
    return make_uint4(w, w, w, w);
  } else if constexpr (W == 8) {
    return make_uint2(w, w);
  } else {
    return w;
  }
}

template <int W>
__device__ __forceinline__ void put(uint8_t* dst, typename Vec<W>::T v) {
  *reinterpret_cast<typename Vec<W>::T*>(dst) = v;
}

template <int W>
__device__ __forceinline__ typename Vec<W>::T get(const uint8_t* src) {
  return *reinterpret_cast<const typename Vec<W>::T*>(src);
}

// What a block writes: band b0 + bi of each plane for bi in [0, nb), band
// b0 + ib the chunk's MB row; the bands before it copy its first row, the
// bands after it its last.
struct Bands {
  int b0, nb, ib;
  __device__ __forceinline__ int src(int bi, int row, int t) const {
    return bi < ib ? 0 : bi == ib ? row : t - 1;
  }
};

// The bands of the chunk of MB row r of a plane of mbh MB rows: its own,
// and the 4 guard bands above on the first row and below on the last.
__device__ __forceinline__ Bands bands_of(int r, int mbh) {
  const bool top = r == 0, bottom = r == mbh - 1;
  return Bands{top ? 0 : r + 4, 1 + (top ? 4 : 0) + (bottom ? 4 : 0),
               top ? 4 : 0};
}

// The ring columns of the block's rows of a plane of t bytes an MB (ring
// 4 t), W-byte splats of the edge pixels: source row s's left pixel at
// left[s * sp], its right one at right[s * sp]. Written by kThreads
// threads, this one thread `tid` of them (as in every writer here).
template <int kT, int W, int kThreads>
__device__ __forceinline__ void ring(uint8_t* plane, int pitch,
                                     const Bands& bd, const uint8_t* left,
                                     const uint8_t* right, int sp, bool first,
                                     bool last, int mbw, unsigned tid) {
  constexpr int kRU = 4 * kT / W;           // units a side
  constexpr int kLog = log2i(2 * kRU);
  const unsigned items = (unsigned)bd.nb * kT * 2 * kRU;
  for (unsigned q = tid; q < items; q += kThreads) {
    const int u = q & (2 * kRU - 1), row = q >> kLog;
    const bool is_left = u < kRU;
    if (is_left ? !first : !last) continue;
    const int bi = row >> log2i(kT), s = bd.src(bi, row & (kT - 1), kT);
    const uint32_t px = is_left ? left[s * sp] : right[s * sp];
    put<W>(plane + (long long)(kT * bd.b0 + row) * pitch +
               (is_left ? u * W : 4 * kT + kT * mbw + (u - kRU) * W),
           splat<W>(px));
  }
}

// The chunk's columns of the block's rows of one chroma plane from its n
// 8 x 8 tiles at sc. W = 16: a store is one row of two MBs (lanes: bits
// 0-2 the row, then the MB pair), the lanes of odd pairs reading their
// second MB first so that a half-warp's 8-byte shared reads hit 16
// distinct bank pairs; W = 8: a store is one row of one MB.
template <int W, int kChunk, int kThreads>
__device__ __forceinline__ void chroma_rows(uint8_t* plane, int pitch,
                                            const Bands& bd,
                                            const uint8_t* sc, int n,
                                            int col0, unsigned tid) {
  constexpr int kMbs = W / 8;                     // MBs a store
  constexpr int kLogBand = 3 + log2i(kChunk) - log2i(kMbs);
  const unsigned items = (unsigned)bd.nb << kLogBand;
  for (unsigned q = tid; q < items; q += kThreads) {
    const int bi = q >> kLogBand, qq = q & ((1 << kLogBand) - 1);
    const int row = qq & 7, j = qq >> 3;
    if (kMbs * j >= n) continue;
    const uint8_t* src = sc + 8 * bd.src(bi, row, 8);
    uint8_t* dst = plane + (long long)(8 * (bd.b0 + bi) + row) * pitch +
                   col0 + W * j;
    if constexpr (W == 16) {
      const int e = j & 1;
      const uint2 x = get<8>(src + 64 * (2 * j + e));
      const uint2 y = get<8>(src + 64 * (2 * j + 1 - e));
      const uint2 lo = e ? y : x, hi = e ? x : y;
      put<16>(dst, make_uint4(lo.x, lo.y, hi.x, hi.y));
    } else {
      put<8>(dst, get<8>(src + 64 * j));
    }
  }
}

// A chroma plane's bands of the chunk of MBs c0 .. c0 + n - 1 (the first
// or the last chunk of its row also writes the ring) from its tiles at sc.
template <int W, int kChunk, int kThreads>
__device__ __forceinline__ void chroma_plane(uint8_t* plane, int pitch,
                                             const Bands& bd,
                                             const uint8_t* sc, int n,
                                             int c0, bool first, bool last,
                                             int mbw, unsigned tid) {
  chroma_rows<W, kChunk, kThreads>(plane, pitch, bd, sc, n, 32 + 8 * c0,
                                   tid);
  if (first || last)
    ring<8, W, kThreads>(plane, pitch, bd, sc, sc + 64 * (n - 1) + 7, 8,
                         first, last, mbw, tid);
}

// The widest store, 16, 8 or 4 bytes, that divides a row pitch.
inline int store_bytes(long long pitch) {
  return pitch % 16 == 0 ? 16 : pitch % 8 == 0 ? 8 : 4;
}

}  // namespace
