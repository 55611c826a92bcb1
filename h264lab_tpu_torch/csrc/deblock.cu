// K2 of h264lab_tpu_torch: the in-loop deblocking filter (spec 8.7) of a
// batch of frames or slice bands, one persistent kernel written by hand for
// NVIDIA Hopper (sm_90a).
//
// Replaces the XLA `lax.scan` over slope-1 MB diagonals of
// h264lab_tpu/models/mbscan.py:793 `deblock_frame`, not a Pallas kernel:
// the JAX package left this stage to XLA. It returns what the port's plain
// version `deblock_frame_plain` (models/mbscan.py) returns, the filtered
// uint8 tiles. bS comes from `_frame_bs` (parallel PyTorch), the QP of
// every MB edge from `ops/deblock.edge_qps`.
//
// Bound. Bytes would allow far less time than the filter takes. Each pixel
// is read once and written once (3,133,440 B each way per 1080p frame),
// plus bS (32 B per MB as uint8) and the edge QPs (48 B per MB as int32):
// about 6.9 MB per frame, 0.033 ms for 16 frames at 3.35 TB/s, 2 us for
// one. What sets the time is the serial chain of raster order: mbw + mbh -
// 1 diagonals (187 at 1080p, 153 in a 34-row band), each two dependent
// passes, so 374 block-wide barriers in a row, each behind a round of
// dependent loads and stores. It is flat in the number of frames, which run
// in parallel blocks.
//
// Design. One launch per batch, grid (N, 2): block (f, 0) filters frame
// f's luma, block (f, 1) its two chroma planes (the planes are independent;
// U and V share bS and QP). A block first copies its planes from the input
// tiles to the output tiles, then walks the diagonals d = 0 .. mbw + mbh - 2
// over the MBs (r, d - r), in the output, in place:
//   - V pass: one thread per (MB, row) — luma 16 rows, chroma 2 planes x 8
//     rows — loads the MB's row and the 4 (chroma 2) pixels left of it into
//     registers, filters the MB's 4 (chroma 2) vertical edges in order (the
//     taps p3..q3 span 8 pixels and the edges are 4 apart, so edge e + 1
//     reads what edge e wrote) and stores the row back; __syncthreads();
//   - H pass: the same per (MB, column) for the horizontal edges;
//     __syncthreads().
// Raster order holds because the whole diagonal's V pass ends before its H
// pass starts: MB (r, c)'s top-edge H filter reads pixels of MB (r - 1, c)
// that MB (r - 1, c + 1)'s V filter wrote on the same diagonal, and MB
// (r + 1, c - 1)'s H filter and MB (r, c)'s V filter both write the corner
// of MB (r, c - 1). Inside one pass the threads' rows or columns are
// disjoint. A diagonal holds up to min(mbw, mbh) MBs (68 at 1080p, 1088
// rows), so the threads stride over them.
// Pixels stay in the tile layout in device memory, where they are L1 and
// L2 resident: pixel (Y, X) of a band is tile[(Y >> 4) * mbw + (X >> 4)]
// [Y & 15][X & 15]. An edge whose bS is 0 is skipped without touching its
// taps, and nothing left of column 0 or above row 0 is read: a band whose
// top row has no upper neighbour reads nothing outside the band.
// Against the plain version (1463 launches per diagonal, 273,572 per 1080p
// frame) this is one launch per batch. Shared-memory windows, one frame
// spread over many SMs (per-row flags or a grid-wide barrier) and clusters
// are left for a later version.
//
// Integer semantics of ops/deblock.py: arithmetic >> of negative ints; * 4
// where the spec writes << 2 (a left shift of a negative int is undefined
// in C++17); p0' and q0' of the normal filters clipped to 0..255; tc0 from
// bS - 1 clamped to 0..2; luma tc = tc0 + ap + aq, chroma tc = tc0 + 1; QP
// indices clamped to 0..51; slice filter offsets 0. The alpha, beta and
// tc0 tables come from ops/tables.py as a __grid_constant__ kernel
// parameter, which the card keeps in its constant bank.
//
// Plain C interface, loaded with ctypes; the entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kQps = 52;
constexpr int kMaxThreads = 1024;

struct Tables {
  uint8_t alpha[kQps];
  uint8_t beta[kQps];
  uint8_t tc0[kQps * 3];
};

struct Args {
  const uint8_t* in_y;
  const uint8_t* in_u;
  const uint8_t* in_v;
  uint8_t* out_y;
  uint8_t* out_u;
  uint8_t* out_v;
  const uint8_t* bs_v;   // (N, nmb, 4 edges, 4 groups of 4 pixels)
  const uint8_t* bs_h;
  const int32_t* q_v;    // (N, nmb, 4) luma edge QPs
  const int32_t* q_h;
  const int32_t* qc_v;   // (N, nmb, 2) chroma edge QPs
  const int32_t* qc_h;
  int mbw;
  int mbh;
};

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return min(max(x, lo), hi);
}

// The luma edge between s[X - 1] and s[X] of a line (p3..q3 = s[X - 4 ..
// X + 3]), bS in 1..4.
template <int X>
__device__ __forceinline__ void luma_edge(int* s, int bs, int qp,
                                          const Tables& t) {
  const int i = clip3(0, kQps - 1, qp);
  const int alpha = t.alpha[i], beta = t.beta[i];
  const int p3 = s[X - 4], p2 = s[X - 3], p1 = s[X - 2], p0 = s[X - 1];
  const int q0 = s[X], q1 = s[X + 1], q2 = s[X + 2], q3 = s[X + 3];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta))
    return;
  const bool ap = abs(p2 - p0) < beta, aq = abs(q2 - q0) < beta;
  if (bs == 4) {
    const bool strong = abs(p0 - q0) < ((alpha >> 2) + 2);
    if (strong && ap) {
      s[X - 1] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      s[X - 2] = (p2 + p1 + p0 + q0 + 2) >> 2;
      s[X - 3] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      s[X - 1] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (strong && aq) {
      s[X] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
      s[X + 1] = (q2 + q1 + q0 + p0 + 2) >> 2;
      s[X + 2] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      s[X] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
    return;
  }
  const int tc0 = t.tc0[i * 3 + clip3(0, 2, bs - 1)];
  const int tc = tc0 + ap + aq;
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
  s[X - 1] = clip3(0, 255, p0 + delta);
  s[X] = clip3(0, 255, q0 - delta);
  const int avg = (p0 + q0 + 1) >> 1;
  if (ap) s[X - 2] = p1 + clip3(-tc0, tc0, (p2 + avg - 2 * p1) >> 1);
  if (aq) s[X + 1] = q1 + clip3(-tc0, tc0, (q2 + avg - 2 * q1) >> 1);
}

// The chroma edge between s[X - 1] and s[X] (p1..q1 = s[X - 2 .. X + 1]).
template <int X>
__device__ __forceinline__ void chroma_edge(int* s, int bs, int qp,
                                            const Tables& t) {
  const int i = clip3(0, kQps - 1, qp);
  const int alpha = t.alpha[i], beta = t.beta[i];
  const int p1 = s[X - 2], p0 = s[X - 1], q0 = s[X], q1 = s[X + 1];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta))
    return;
  if (bs == 4) {
    s[X - 1] = (2 * p1 + p0 + q1 + 2) >> 2;
    s[X] = (2 * q1 + q0 + p1 + 2) >> 2;
    return;
  }
  const int tc = t.tc0[i * 3 + clip3(0, 2, bs - 1)] + 1;
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
  s[X - 1] = clip3(0, 255, p0 + delta);
  s[X] = clip3(0, 255, q0 - delta);
}

// One line of an MB across its edges: `step` is 1 along a row (V pass) and
// the tile width along a column (H pass); `nb` the offset of the same line
// in the left or upper MB, `has_nb` whether that MB exists.
__device__ __forceinline__ void luma_line(uint8_t* cur, long long nb,
                                          int step, bool has_nb,
                                          const uint8_t* bs,
                                          const int32_t* q, const Tables& t) {
  int s[20];
  const bool mb_edge = has_nb && bs[0];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = mb_edge ? cur[nb + (12 + i) * step] : 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[4 + i] = cur[i * step];
  if (bs[0]) luma_edge<4>(s, bs[0], q[0], t);
  if (bs[4]) luma_edge<8>(s, bs[4], q[1], t);
  if (bs[8]) luma_edge<12>(s, bs[8], q[2], t);
  if (bs[12]) luma_edge<16>(s, bs[12], q[3], t);
  if (mb_edge) {
#pragma unroll
    for (int i = 1; i < 4; ++i) cur[nb + (12 + i) * step] = (uint8_t)s[i];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) cur[i * step] = (uint8_t)s[4 + i];
}

// Chroma: edges 0 and 1 take luma bS edge groups 0 and 2.
__device__ __forceinline__ void chroma_line(uint8_t* cur, long long nb,
                                            int step, bool has_nb,
                                            const uint8_t* bs,
                                            const int32_t* q,
                                            const Tables& t) {
  int s[10];
  const bool mb_edge = has_nb && bs[0];
#pragma unroll
  for (int i = 0; i < 2; ++i) s[i] = mb_edge ? cur[nb + (6 + i) * step] : 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s[2 + i] = cur[i * step];
  if (bs[0]) chroma_edge<2>(s, bs[0], q[0], t);
  if (bs[8]) chroma_edge<6>(s, bs[8], q[1], t);
  if (mb_edge) cur[nb + 7 * step] = (uint8_t)s[1];
#pragma unroll
  for (int i = 0; i < 8; ++i) cur[i * step] = (uint8_t)s[2 + i];
}

__device__ void copy_plane(uint8_t* dst, const uint8_t* src, size_t n) {
  if (((uintptr_t)dst | (uintptr_t)src | n) & 15) {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
    return;
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (size_t i = threadIdx.x; i < n / 16; i += blockDim.x) d[i] = s[i];
}

__global__ void __launch_bounds__(kMaxThreads)
deblock_kernel(const __grid_constant__ Tables t,
               const __grid_constant__ Args a) {
  const long long nmb = (long long)a.mbw * a.mbh;
  const long long mb0 = (long long)blockIdx.x * nmb;
  const bool luma = blockIdx.y == 0;
  if (luma) {
    copy_plane(a.out_y + mb0 * 256, a.in_y + mb0 * 256, nmb * 256);
  } else {
    copy_plane(a.out_u + mb0 * 64, a.in_u + mb0 * 64, nmb * 64);
    copy_plane(a.out_v + mb0 * 64, a.in_v + mb0 * 64, nmb * 64);
  }
  __syncthreads();
  for (int d = 0; d < a.mbw + a.mbh - 1; ++d) {
    const int r0 = max(0, d - a.mbw + 1);
    const int lines = (min(a.mbh - 1, d) - r0 + 1) * 16;
    for (int pass = 0; pass < 2; ++pass) {       // V, then H
      const bool vert = pass == 0;
      const uint8_t* bs_all = vert ? a.bs_v : a.bs_h;
      for (int w = threadIdx.x; w < lines; w += blockDim.x) {
        const int r = r0 + (w >> 4), c = d - r;
        const long long mb = mb0 + (long long)r * a.mbw + c;
        const bool has_nb = vert ? c > 0 : r > 0;
        if (luma) {
          const int line = w & 15;         // row (V) or column (H)
          uint8_t* cur = a.out_y + mb * 256 + (vert ? line * 16 : line);
          const long long nb = vert ? -256 : -256LL * a.mbw;
          luma_line(cur, nb, vert ? 1 : 16, has_nb,
                    bs_all + mb * 16 + (line >> 2), (vert ? a.q_v : a.q_h)
                    + mb * 4, t);
        } else {
          const int line = w & 7;
          uint8_t* plane = (w >> 3) & 1 ? a.out_v : a.out_u;
          uint8_t* cur = plane + mb * 64 + (vert ? line * 8 : line);
          const long long nb = vert ? -64 : -64LL * a.mbw;
          chroma_line(cur, nb, vert ? 1 : 8, has_nb,
                      bs_all + mb * 16 + (line >> 1), (vert ? a.qc_v : a.qc_h)
                      + mb * 2, t);
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int h264lab_deblock(const void* in_y, const void* in_u,
                               const void* in_v, void* out_y, void* out_u,
                               void* out_v, const void* bs_v,
                               const void* bs_h, const void* q_v,
                               const void* q_h, const void* qc_v,
                               const void* qc_h, const void* alpha,
                               const void* beta, const void* tc0,
                               long long n, int mbw, int mbh, void* stream) {
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  if (n >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  Tables t;
  std::memcpy(t.alpha, alpha, sizeof t.alpha);
  std::memcpy(t.beta, beta, sizeof t.beta);
  std::memcpy(t.tc0, tc0, sizeof t.tc0);
  const Args a{(const uint8_t*)in_y, (const uint8_t*)in_u,
               (const uint8_t*)in_v, (uint8_t*)out_y, (uint8_t*)out_u,
               (uint8_t*)out_v, (const uint8_t*)bs_v, (const uint8_t*)bs_h,
               (const int32_t*)q_v, (const int32_t*)q_h,
               (const int32_t*)qc_v, (const int32_t*)qc_h, mbw, mbh};
  // one thread per line of the longest diagonal, at most 1024
  const int lines = (mbw < mbh ? mbw : mbh) * 16;
  const int threads = lines < kMaxThreads ? (lines + 31) / 32 * 32
                                          : kMaxThreads;
  deblock_kernel<<<dim3((unsigned)n, 2), threads, 0, (cudaStream_t)stream>>>(
      t, a);
  return (int)cudaGetLastError();
}
