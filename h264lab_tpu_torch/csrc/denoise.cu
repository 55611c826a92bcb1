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
// a 1920x1088 frame moves 9.4 MB, 2.8 us at 3.35 TB/s.
//
// Design: a block of 256 threads per tile of kTh x kTw pixels of one
// plane, the plane on the grid's z. The block writes d of its tile and a
// ring of one pixel (clamped into the plane: the replicated edges) into
// shared memory as 16 bits, a thread an element with consecutive threads
// on consecutive columns; then a thread takes 4 consecutive pixels of a
// row, their neighbours' |d| from shared memory, and writes them in one
// 4-byte store where the row's address allows (else byte by byte).
//
// Plain C interface, loaded with ctypes; the entry point takes its
// arguments as one array of 64-bit words (in the order
// `denoise.denoise_k13` writes them), launches on the given stream,
// allocates nothing and returns the launch's error.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTh = 8, kTw = 128;      // a block's tile: 8 rows x 128 columns
static_assert(kTh * kTw == 4 * kThreads, "4 pixels a thread");

struct Args {
  const uint8_t* cur[3];
  const uint8_t* prev[3];
  uint8_t* out[3];
  int h[3], w[3];
  int gain[32];                        // Q8, indexed by min(max(ad, act), 31)
};

__global__ void __launch_bounds__(kThreads)
denoise_kernel(const __grid_constant__ Args a) {
  __shared__ int16_t sd[kTh + 2][kTw + 2];
  __shared__ int gain[32];
  const int p = blockIdx.z;
  const int H = a.h[p], W = a.w[p];
  const int y0 = blockIdx.y * kTh, x0 = blockIdx.x * kTw;
  if (y0 >= H || x0 >= W) return;     // the whole block: a smaller plane
  const uint8_t* __restrict__ cur = a.cur[p];
  const uint8_t* __restrict__ prev = a.prev[p];
  const int tid = threadIdx.x;
  if (tid < 32) gain[tid] = a.gain[tid];
  for (int i = tid; i < (kTh + 2) * (kTw + 2); i += kThreads) {
    const int r = i / (kTw + 2), c = i - r * (kTw + 2);
    const int gy = min(max(y0 - 1 + r, 0), H - 1);
    const int gx = min(max(x0 - 1 + c, 0), W - 1);
    const long long o = (long long)gy * W + gx;
    sd[r][c] = (int16_t)((int)cur[o] - (int)prev[o]);
  }
  __syncthreads();
  const int ty = tid >> 5, tx = 4 * (tid & 31);
  const int y = y0 + ty, x = x0 + tx;
  if (y >= H || x >= W) return;
  const long long o = (long long)y * W + x;
  const int n = min(4, W - x);
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k >= n) break;
    const int r = ty + 1, c = tx + k + 1;
    const int d = sd[r][c];
    const int ad = abs(d);
    const int act = (abs(sd[r - 1][c]) + abs(sd[r + 1][c]) +
                     abs(sd[r][c - 1]) + abs(sd[r][c + 1]) + 2) >> 2;
    const int g = gain[min(max(ad, act), 31)];
    const int v = min(max((int)cur[o + k] - ((d * g) >> 8), 0), 255);
    word |= (uint32_t)v << (8 * k);
  }
  uint8_t* out = a.out[p] + o;
  if (n == 4 && ((uintptr_t)out & 3) == 0) {
    *reinterpret_cast<uint32_t*>(out) = word;
  } else {
    for (int k = 0; k < n; ++k) out[k] = (uint8_t)(word >> (8 * k));
  }
}

}  // namespace

// w: cur Y, U, V, prev Y, U, V, out Y, U, V (9 addresses), per plane its
// (h, w) (6 words), the 32 gains, the stream. Planes contiguous.
extern "C" int h264lab_denoise(const long long* w) {
  Args a;
  int rows = 0, cols = 0;
  for (int p = 0; p < 3; ++p) {
    a.cur[p] = (const uint8_t*)w[p];
    a.prev[p] = (const uint8_t*)w[3 + p];
    a.out[p] = (uint8_t*)w[6 + p];
    const long long h = w[9 + 2 * p], wd = w[10 + 2 * p];
    if (h < 0 || wd < 0 || h * wd >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
    a.h[p] = (int)h;
    a.w[p] = (int)wd;
    if (h > 0 && wd > 0) {
      rows = rows > a.h[p] ? rows : a.h[p];
      cols = cols > a.w[p] ? cols : a.w[p];
    }
  }
  for (int i = 0; i < 32; ++i) a.gain[i] = (int)w[15 + i];
  if (rows == 0) return 0;
  const dim3 grid((cols + kTw - 1) / kTw, (rows + kTh - 1) / kTh, 3);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  denoise_kernel<<<grid, kThreads, 0, (cudaStream_t)w[47]>>>(a);
  return (int)cudaGetLastError();
}
