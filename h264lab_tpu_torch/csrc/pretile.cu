// K12 of h264lab_tpu_torch: the source planes of G lanes edge-replicated
// to the padded picture and cut into MB tiles, in one kernel written by
// hand for NVIDIA Hopper (sm_90a), one launch for the three planes of all
// lanes.
//
// Replaces the `pre` stage of the JAX package: the host's edge
// replication h264lab_tpu/models/wavefront.py:70-75 `pad_plane` (called at
// h264lab_tpu/parallel/gop.py:418-422) and the device tiling `pre_fn`
// (h264lab_tpu/parallel/gop.py:94-106), which XLA ran (no Pallas kernel).
// It writes what the port's plain version `stages.source_tiles_plain`
// returns: for plane p of lane g, an (h0, w0) uint8 plane at any address
// with any row pitch, the (mbh mbw, t, t) tiles (t = 16 luma, 8 chroma)
// of the (mbh t, mbw t) padded plane, pixel (Y, X) = src[min(Y, h0 -
// 1)][min(X, w0 - 1)] (a plane larger than the padded one is cropped);
// tile (r, c) of lane g at ((g mbh + r) mbw + c) t t, so that the G B
// bands of a step are (G B, nmb_band, t, t) with each band's MB rows
// contiguous.
//
// Bound. Pure layout, byte-bound: each source byte read once, each tile
// byte written once; 16 lanes of 1920x1088 move 50.1 MB in and 50.1 MB
// out, 30 us at 3.35 TB/s.
//
// Design: a block of 256 threads per 16 MBs of one MB row of one lane;
// blockIdx.z 0 the luma (a thread a tile row: 16 rows x 16 MBs), 1 the
// chroma (U by the first 128 threads, V by the rest: 8 rows x 16 MBs
// each). A warp reads 2 luma rows of 256 contiguous source bytes (4 of
// 64 chroma) and writes whole 32-byte sectors of its 16 (8) tiles: 2
// (4) consecutive tile rows each. Each tile row is one 16-byte (8-byte)
// store; it is loaded as 16, 8 or 4-byte words where its source address
// allows and it lies inside the plane's width, else byte by byte with
// each column clamped (an odd pitch, a width that is no multiple of 16,
// the replicated columns). The lanes' addresses and pitches are a table
// in the kernel's parameters (a __grid_constant__ struct, read where it
// lies), kMaxLanes lanes a launch; the entry point launches once per
// kMaxLanes lanes (once on every path of the port).
//
// Plain C interface, loaded with ctypes; the entry point takes its
// arguments as one array of 64-bit words (in the order
// `pretile.tiles_k12` writes them), launches on the given stream,
// allocates nothing and returns the launch's error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMbs = 16;          // MBs of one MB row a block
constexpr int kMaxLanes = 64;     // lanes a launch

struct Args {
  const uint8_t* src[kMaxLanes][3];   // each lane's Y, U and V planes
  int pitch[kMaxLanes][3];            // their row pitches in bytes
  uint8_t* out[3];                    // the lanes' tiles, (G, nmb, t, t)
  int h0[3], w0[3];                   // the source planes' sizes
  int mbw, mbh;
};

// 4 bytes of a source row from column x, each column clamped to last
__device__ __forceinline__ uint32_t clamped4(const uint8_t* row, int x,
                                             int last) {
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w |= (uint32_t)row[min(x + k, last)] << (8 * k);
  return w;
}

// T bytes of a source row from column x0 (a tile row) as T / 4 words:
// the widest loads its address allows where the row lies inside the
// plane's width w0, else byte by byte, each column clamped.
template <int T>
__device__ __forceinline__ void tile_row(const uint8_t* row, int x0, int w0,
                                         uint32_t (&w)[T / 4]) {
  const uint8_t* p = row + x0;
  const unsigned a = (unsigned)(uintptr_t)p;
  if (x0 + T <= w0) {
    if (T == 16 && (a & 15) == 0) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
      return;
    }
    if ((a & 7) == 0) {
#pragma unroll
      for (int k = 0; k < T / 8; ++k) {
        const uint2 v = reinterpret_cast<const uint2*>(p)[k];
        w[2 * k] = v.x;
        w[2 * k + 1] = v.y;
      }
      return;
    }
    if ((a & 3) == 0) {
#pragma unroll
      for (int k = 0; k < T / 4; ++k)
        w[k] = reinterpret_cast<const uint32_t*>(p)[k];
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < T / 4; ++k) w[k] = clamped4(row, x0 + 4 * k, w0 - 1);
}

// grid (MB columns / kMbs, lanes x mbh, 2): blockIdx.y the lane's MB row,
// blockIdx.z 0 luma, 1 chroma
__global__ void __launch_bounds__(kThreads)
pad_tiles_kernel(const __grid_constant__ Args a) {
  const int lane = blockIdx.y / a.mbh;
  const int r = blockIdx.y - lane * a.mbh;
  const int tid = threadIdx.x;
  if (blockIdx.z == 0) {
    // a warp: rows y, y + 1 (lane bit 4) of 16 MBs (lane bits 0-3)
    const int c = blockIdx.x * kMbs + (tid & 15), y = tid >> 4;
    if (c >= a.mbw) return;
    const int sy = min(16 * r + y, a.h0[0] - 1);
    uint32_t w[4];
    tile_row<16>(a.src[lane][0] + (long long)sy * a.pitch[lane][0], 16 * c,
                 a.w0[0], w);
    *reinterpret_cast<uint4*>(
        a.out[0] + (((long long)blockIdx.y * a.mbw + c) << 8) + 16 * y) =
        make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  // a warp: rows 4 k .. 4 k + 3 (lane bits 3-4) of 8 MBs (lane bits 0-2)
  const int p = 1 + (tid >> 7), q = tid & 127;
  const int c = blockIdx.x * kMbs + ((q & 7) | ((q >> 2) & 8));
  const int y = ((q >> 3) & 3) | ((q >> 4) & 4);
  if (c >= a.mbw) return;
  const int sy = min(8 * r + y, a.h0[p] - 1);
  uint32_t w[2];
  tile_row<8>(a.src[lane][p] + (long long)sy * a.pitch[lane][p], 8 * c,
              a.w0[p], w);
  *reinterpret_cast<uint2*>(
      a.out[p] + (((long long)blockIdx.y * a.mbw + c) << 6) + 8 * y) =
      make_uint2(w[0], w[1]);
}

}  // namespace

// w: G, mbw, mbh, the source planes' (h0, w0) of Y, U and V (6 words),
// the tiles' addresses of Y, U and V (16-byte aligned), the stream, then
// per lane its Y, U and V planes' (address, pitch) (6 words).
extern "C" int h264lab_pad_tiles(const long long* w) {
  const long long n = w[0];
  Args a;
  a.mbw = (int)w[1];
  a.mbh = (int)w[2];
  long long addr = 0;
  for (int p = 0; p < 3; ++p) {
    a.h0[p] = (int)w[3 + 2 * p];
    a.w0[p] = (int)w[4 + 2 * p];
    if (w[3 + 2 * p] <= 0 || w[4 + 2 * p] <= 0 ||
        w[3 + 2 * p] >= (1 << 30) || w[4 + 2 * p] >= (1 << 30))
      return (int)cudaErrorInvalidValue;
    addr |= w[9 + p];
  }
  if (n < 0 || a.mbw <= 0 || a.mbh <= 0 || (addr & 15) ||
      (long long)a.mbw * a.mbh * 256 >= (1ll << 31) ||
      (long long)kMaxLanes * a.mbh > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)w[12];
  const long long* table = w + 13;
  for (long long g0 = 0; g0 < n; g0 += kMaxLanes) {
    const int lanes = (int)(n - g0 < kMaxLanes ? n - g0 : kMaxLanes);
    for (int g = 0; g < lanes; ++g) {
      for (int p = 0; p < 3; ++p) {
        const long long* e = table + 6 * (g0 + g) + 2 * p;
        if (e[0] == 0 || e[1] < (a.h0[p] > 1 ? a.w0[p] : 0) ||
            e[1] >= (1ll << 31))
          return (int)cudaErrorInvalidValue;
        a.src[g][p] = (const uint8_t*)e[0];
        a.pitch[g][p] = (int)e[1];
      }
    }
    for (int p = 0; p < 3; ++p) {
      const int t = p ? 8 : 16;
      a.out[p] = (uint8_t*)w[9 + p] + g0 * a.mbh * a.mbw * t * t;
    }
    const dim3 grid((a.mbw + kMbs - 1) / kMbs, lanes * a.mbh, 2);
    pad_tiles_kernel<<<grid, kThreads, 0, stream>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
