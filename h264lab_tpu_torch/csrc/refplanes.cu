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
// Plane pixel (y, x) lies in MB (y / t) * mb_width + x / t at offset
// (y % t) * t + x % t of its tile (t = 16, or 8 for chroma); a 4x4 box
// never crosses an MB (16 % 4 == 0). With no luma tiles (chroma only,
// `refstate.reference_chroma`) it writes u_pad and v_pad alone.
//
// Bound. Pure layout and a box sum, byte-bound: each tile byte read once
// (384 B an MB) and each plane byte written once; 16 lanes of 1080p move
// 50.1 MB in and 62.2 MB out, 34 us at 3.35 TB/s. Design: the padded
// planes share one band structure, (mb_height + 8) bands of 16 luma, 8
// chroma and 4 pyramid rows, the outer 4 bands the guard ring; a block
// takes one band of one picture and writes all four planes' rows of it,
// so the tiles of one MB row are read from device memory once and its
// pyramid rows and guard bands read them again from L1 and L2. A thread
// writes 4 bytes at a time (4-byte stores; every row width divides by 4,
// the ring widths too): inside the plane one 4-byte load of a tile row
// (the 4 pixels never cross a tile), on the ring each byte clamped; a
// pyramid word is 16 4-byte loads summed with __vsadu4.
//
// Plain C interface, loaded with ctypes; the entry point takes its
// arguments as one array of 64-bit words (in the order
// `refplanes.planes_k11` writes them), launches on the given stream,
// allocates nothing and returns the launch's error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBands = 8;      // the guard rings' bands, 4 above, 4 below

struct Args {
  const uint8_t* tiles[3];     // (L, nmb, t, t); tiles[0] null: chroma only
  uint8_t* out[4];             // y_pad, u_pad, v_pad, y4_pad
  int mbw, mbh;
  int guard;                   // G
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Rows [kT * b, kT * (b + 1)) of one picture's padded plane of tile size
// kT (guard g = 4 kT: the band structure), from its tiles.
template <int kT>
__device__ __forceinline__ void pad_band(const uint8_t* __restrict__ tiles,
                                         uint8_t* __restrict__ out, int b,
                                         int mbw, int mbh) {
  constexpr int kG = 4 * kT;
  const int ph = mbh * kT, pw = mbw * kT;
  const int words = (pw + 2 * kG) / 4;
  for (int item = threadIdx.x; item < kT * words; item += kThreads) {
    const int r = item / words, q = item - r * words;
    const int pr = kT * b + r;
    const int y = clampi(pr - kG, 0, ph - 1);
    const int row = (y / kT) * mbw * kT * kT + (y % kT) * kT;
    const int x = 4 * q - kG;
    uint32_t word;
    if (x >= 0 && x < pw) {     // 4 pixels of one tile row
      word = *reinterpret_cast<const uint32_t*>(
          tiles + row + (x / kT) * kT * kT + x % kT);
    } else {                    // the ring: one clamped column
      const int c = clampi(x, 0, pw - 1);
      word = 0x01010101u * tiles[row + (c / kT) * kT * kT + c % kT];
    }
    *reinterpret_cast<uint32_t*>(out + (long long)pr * (pw + 2 * kG) +
                                 4 * q) = word;
  }
}

__global__ void __launch_bounds__(kThreads)
reference_planes_kernel(const Args a) {
  const int bands = a.mbh + kBands;
  const int pic = blockIdx.x / bands, b = blockIdx.x - pic * bands;
  const long long nmb = (long long)a.mbw * a.mbh;
  const int H = 16 * a.mbh, W = 16 * a.mbw;
  const int g = a.guard;
  if (a.tiles[0] != nullptr) {
    const uint8_t* y = a.tiles[0] + pic * nmb * 256;
    pad_band<16>(y, a.out[0] + pic * (long long)(H + 2 * g) * (W + 2 * g),
                 b, a.mbw, a.mbh);
    // the pyramid's rows [4 b, 4 b + 4), ring G / 4 = 16
    const int h4 = H / 4, w4 = W / 4, g4 = g / 4;
    const int words = (w4 + 2 * g4) / 4;
    uint8_t* y4 = a.out[3] + pic * (long long)(h4 + 2 * g4) * (w4 + 2 * g4);
    for (int item = threadIdx.x; item < 4 * words; item += kThreads) {
      const int r = item / words, q = item - r * words;
      const int pr = 4 * b + r;
      const int r4 = clampi(pr - g4, 0, h4 - 1);
      // the 4 box rows 4 r4 .. 4 r4 + 3 lie in MB row r4 / 4
      const uint8_t* rows = y + (long long)(r4 >> 2) * a.mbw * 256 +
                            (4 * (r4 & 3)) * 16;
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c4 = clampi(4 * q + k - g4, 0, w4 - 1);
        const uint8_t* box = rows + (c4 >> 2) * 256 + 4 * (c4 & 3);
        unsigned s = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s += __vsadu4(*reinterpret_cast<const uint32_t*>(box + 16 * i), 0u);
        word |= ((s + 8) >> 4) << (8 * k);
      }
      *reinterpret_cast<uint32_t*>(y4 + (long long)pr * (w4 + 2 * g4) +
                                   4 * q) = word;
    }
  }
  const long long cplane = (long long)(H / 2 + g) * (W / 2 + g);
#pragma unroll
  for (int p = 1; p < 3; ++p)
    pad_band<8>(a.tiles[p] + pic * nmb * 64, a.out[p] + pic * cplane, b,
                a.mbw, a.mbh);
}

}  // namespace

// w: tiles_y (0 for chroma only), tiles_u, tiles_v, y_pad, u_pad, v_pad,
// y4_pad, L, mbw, mbh, guard, the stream.
extern "C" int h264lab_reference_planes(const long long* w) {
  Args a;
  for (int p = 0; p < 3; ++p) a.tiles[p] = (const uint8_t*)w[p];
  for (int p = 0; p < 4; ++p) a.out[p] = (uint8_t*)w[3 + p];
  const long long n = w[7];
  a.mbw = (int)w[8];
  a.mbh = (int)w[9];
  a.guard = (int)w[10];
  if (n <= 0) return 0;
  // the band structure needs the rings at 4 MB rows: G = 64
  if (a.mbw <= 0 || a.mbh <= 0 || a.guard != 64 ||
      n * (a.mbh + kBands) >= (1ll << 31) ||
      (long long)(16 * a.mbh + 128) * (16 * a.mbw + 128) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  reference_planes_kernel<<<(unsigned)(n * (a.mbh + kBands)), kThreads, 0,
                            (cudaStream_t)w[11]>>>(a);
  return (int)cudaGetLastError();
}
