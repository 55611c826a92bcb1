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
//       clip((sum_k sum_l f_a[k] f_b[l] x[c(i - 1 + k)][c(j - 1 + l)]
//             + r) >> s, 0, 255)
//     with c() clamping into the cropped plane (its edges replicated), f
//     the luma phases 4 and 12 of FILTER16_LUMA, (-3, 28, 8, -1) and (-1,
//     8, 28, -3), r = 512, s = 10 (an arithmetic shift), or for chroma the
//     bilinear taps (1, 3, 0) and (0, 3, 1), r = 8, s = 4. The JAX package
//     filters the rows, then the columns, and neither rounds nor clips
//     between the passes, so one 2-D integer sum gives the same value
//     (|sum| <= 40 x 40 x 255 fits an int);
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
// 1.2 us at 3.35 TB/s); K10 reads the 0.8 MB base picture and writes 3.1
// MB of tiles and 1.2 MB of padded chroma (about 1.5 us).
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
// K10's design: a thread per 4 consecutive output bytes, one 4-byte
// store, a grid row per output (3 tile sets, 2 planes). A K10 thread's 4
// pixels share their row and span at most 3 base columns, so it sums the
// 4 filter rows over a window of 6 base columns once (24 byte loads
// through L1) and takes each pixel's horizontal taps from there. Simple
// first: no shared memory, no bulk copies.
//
// Plain C interface, loaded with ctypes; each entry point takes its
// arguments as one array of 64-bit words (in the order
// `resample.downsample_k9` and `upsample_k10` write them), launches on
// the given stream, allocates nothing and returns the launch's error.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

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

struct UpArgs {
  const uint8_t* base[3];   // (bnmb, t, t) deblocked base tiles
  uint8_t* pred[3];         // (nmb, t, t) enhancement tiles
  uint8_t* pad[2];          // (hc + 2G, wc + 2G) guard-padded U and V
  int bmbw;                 // the base layer's MBs a row
  int crop_h[3], crop_w[3]; // the cropped base planes
  int mbw, mbh;             // the enhancement's MBs
  int guard;                // G, the chroma planes' guard ring
};

// Tap k (0 .. 3, over source samples i - 1 .. i + 2) of phase 0 or 1:
// luma (-3, 28, 8, -1) and (-1, 8, 28, -3), chroma (1, 3, 0, 0) and (0,
// 3, 1, 0). `k` is a constant wherever the loops are unrolled.
template <bool kLuma>
__device__ __forceinline__ int tap(int phase, int k) {
  if (kLuma) {
    return phase ? (k == 0 ? -1 : k == 1 ? 8 : k == 2 ? 28 : -3)
                 : (k == 0 ? -3 : k == 1 ? 28 : k == 2 ? 8 : -1);
  }
  return phase ? (k == 1 ? 3 : k == 2 ? 1 : 0) : (k == 0 ? 1 : k == 1 ? 3 : 0);
}

// The 4 output pixels of one thread: enhancement row `y` and columns
// x[0..3] (clamped into the padded enhancement plane already), each then
// clamped to the upsampled plane (2h x 2w) and filtered from the tiles.
template <bool kLuma>
__device__ __forceinline__ uint32_t up4(const uint8_t* __restrict__ base,
                                        int bmbw, int h, int w, int y,
                                        const int* x) {
  constexpr int kT = kLuma ? 16 : 8, kLs = kLuma ? 4 : 3;
  constexpr int kTaps = kLuma ? 4 : 3;   // chroma's fourth tap is 0
  constexpr int kRound = kLuma ? 512 : 8, kShift = kLuma ? 10 : 4;
  const int yu = min(y, 2 * h - 1);
  const int i = yu >> 1, a = yu & 1;
  int xu[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) xu[k] = min(x[k], 2 * w - 1);
  const int j0 = xu[0] >> 1;
  int rows[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    const int r = clampi(i - 1 + k, 0, h - 1);
    rows[k] = (r >> kLs) * bmbw * kT * kT + (r & (kT - 1)) * kT;
  }
  // the vertical sums on base columns j0 - 1 .. j0 + 4: the 4 pixels'
  // columns xu[k] >> 1 lie in j0 .. j0 + 2
  int v[6];
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    const int c = clampi(j0 - 1 + m, 0, w - 1);
    const int col = (c >> kLs) * kT * kT + (c & (kT - 1));
    int s = 0;
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      s += tap<kLuma>(a, k) * base[rows[k] + col];
    v[m] = s;
  }
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int d = (xu[k] >> 1) - j0, b = xu[k] & 1;
    int t[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      t[e] = 0;
#pragma unroll
      for (int l = 0; l < kTaps; ++l) t[e] += tap<kLuma>(b, l) * v[e + l];
    }
    const int s = d == 0 ? t[0] : d == 1 ? t[1] : t[2];
    word |= (uint32_t)clampi((s + kRound) >> kShift, 0, 255) << (8 * k);
  }
  return word;
}

__global__ void __launch_bounds__(kThreads)
upsample_kernel(const UpArgs a) {
  const int o = blockIdx.y;                     // output 0 .. 4
  const int p = o < 3 ? o : o - 2;              // its plane
  const uint8_t* base = pick(a.base, p);
  const int t = p == 0 ? 16 : 8;
  const int ph = a.mbh * t, pw = a.mbw * t;     // the padded plane
  const long long item = (long long)blockIdx.x * kThreads + threadIdx.x;
  int y, x[4];
  uint8_t* out;
  if (o < 3) {
    const int per_mb = t * t / 4;
    const long long nmb = (long long)a.mbw * a.mbh;
    if (item >= nmb * per_mb) return;
    const int mb = (int)(item / per_mb), rem = (int)(item % per_mb);
    const int row = rem / (t / 4), cq = rem % (t / 4);
    y = (mb / a.mbw) * t + row;
    const int x0 = (mb % a.mbw) * t + 4 * cq;
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = x0 + k;
    out = pick(a.pred, p) + (long long)mb * t * t + row * t + 4 * cq;
  } else {
    const int g = a.guard;
    const int words = (pw + 2 * g) / 4;
    if (item >= (long long)(ph + 2 * g) * words) return;
    const int r = (int)(item / words), q = (int)(item % words);
    y = clampi(r - g, 0, ph - 1);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = clampi(4 * q + k - g, 0, pw - 1);
    out = (o == 3 ? a.pad[0] : a.pad[1]) + (long long)r * (pw + 2 * g) +
          4 * q;
  }
  const uint32_t word =
      p == 0 ? up4<true>(base, a.bmbw, a.crop_h[0], a.crop_w[0], y, x)
             : up4<false>(base, a.bmbw, pick(a.crop_h, p), pick(a.crop_w, p),
                          y, x);
  *reinterpret_cast<uint32_t*>(out) = word;     // 4-aligned: see the wrapper
}

unsigned blocks(long long items) {
  return (unsigned)((items + kThreads - 1) / kThreads);
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
extern "C" int h264lab_resample_up(const long long* w) {
  UpArgs a;
  for (int p = 0; p < 3; ++p) {
    a.base[p] = (const uint8_t*)w[p];
    a.pred[p] = (uint8_t*)w[3 + p];
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
  a.guard = (int)w[17];
  if (a.bmbw <= 0 || a.mbw <= 0 || a.mbh <= 0 || a.guard < 0 ||
      a.guard % 4 || (long long)a.mbw * a.mbh * 256 >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const long long nmb = (long long)a.mbw * a.mbh;
  const long long pad = (long long)(a.mbh * 8 + 2 * a.guard) *
                        ((a.mbw * 8 + 2 * a.guard) / 4);
  const long long most = std::max(nmb * 64, pad);
  upsample_kernel<<<dim3(blocks(most), 5), kThreads, 0,
                    (cudaStream_t)w[18]>>>(a);
  return (int)cudaGetLastError();
}
