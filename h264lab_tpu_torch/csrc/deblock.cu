// K2 of h264lab_tpu_torch: the in-loop deblocking filter (spec 8.7) of a
// batch of frames or slice bands, the whole `deblock` stage in one kernel
// written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces h264lab_tpu/models/mbscan.py:793 `deblock_frame`, which the JAX
// package left to XLA (no Pallas kernel): its parallel bS derivation
// `_frame_bs` (:727, with ops/deblock.py:51 `mb_edge_bs`), the per-edge QPs
// and the `lax.scan` over slope-1 MB diagonals (:904). It takes what the
// port's plain version `deblock_frame_plain` (models/mbscan.py) takes - the
// MB tiles, `sel`, the coded-block counts, the MVs, per-frame or per-MB
// QPs, the MB availability - and returns what it returns, the filtered
// uint8 tiles, byte for byte.
//
// Bound. Each input is read once and each output written once: 384 B of
// pixels in and 384 B out per MB, `sel` 4 B, `nnz_blk` 64 B, both MVs
// 128 B, per-MB QPs 8 B and availability 2 B: about 970 B per MB, 7.9 MB
// per 1080p frame, 0.0024 ms at 3.35 TB/s (0.038 ms for 16 frames). What
// sets the time is the serial chain of raster order: MB (r, c)'s top-edge
// filter reads pixels that MB (r - 1, c + 1)'s left-edge filter wrote, so
// row r can take MB c only once row r - 1 has finished MB min(c + 1,
// mbw - 1). With one row starting two MB steps behind the row above, the
// chain is mbw + 2 (mbh - 1) MB steps (254 at 1080p); it is flat in the
// number of frames, which run side by side. So the design keeps each MB
// step short: no block-wide barrier, no divergence, every global load
// issued ahead of its use, no fence.
//
// Design. The luma and the chroma planes are independent (they share only
// bS and the QPs), so each is walked on its own: one warp takes one MB row
// of one plane group of one frame or band, and walks its MBs in order.
//   - rows are drawn from a global ticket in launch order (as K1 draws its
//     tiles), not from blockIdx: ticket t is row t % mbh of plane group
//     (t / mbh) % 2 of frame t / (2 mbh), and waits only on ticket t - 1's
//     mailbox (below), which a resident (or finished) warp fills, so no
//     launch order of the blocks can deadlock;
//   - a warp keeps a ring of 4 MBs in shared memory: MB c - 1 (the left
//     neighbour), MB c and MBs c + 1 and c + 2 in flight. Each MB's tiles
//     and side data (nnz, MVs, sel, QPs, row 3 of the MB above) arrive by
//     16-byte cp.async copies issued two steps before they are used, from
//     sources each lane works out once per row;
//   - V pass: lanes 0-15 take the 16 luma rows, or the 2 x 8 chroma rows
//     (U, V), of the MB. A lane loads its row (plus the left MB's last 4,
//     chroma 2, pixels when the left MB exists), computes the bS and QP of
//     its edges, filters the edges in order in registers (the taps span 8
//     pixels and the edges are 4 apart, so edge e + 1 reads what edge e
//     wrote; the filters are branch-free, so lanes never diverge) and
//     stores the row back;
//   - the left MB is now final for this row: the warp writes it to the
//     output once (16-byte stores) and, when the MB below takes its top
//     edge, puts its bottom 4 (chroma 2) lines into the row's mailbox
//     instead: 16 (chroma 8) units of 8 bytes, each 4 pixels and a tag,
//     stored with single-copy-atomic 64-bit strong stores into a buffer
//     the wrapper zeroes;
//   - H pass, when the MB has an upper neighbour: the warp reads that
//     neighbour's bottom lines from the row above's mailbox with 64-bit
//     strong loads (served by L2, never a stale L1 line), loaded one step
//     ahead and loaded again until every unit's tag is set, filters the
//     columns (lanes as in the V pass) and writes the 4 (chroma 2) lines to
//     the output.
// The mailbox is the progress signal: a unit is single-copy atomic, so a
// reader that sees its tag sees its pixels, with no fence on the writer's
// side and no acquire on the reader's (a progress count would cost the
// writer a fence before its release store, and the reader an acquire load
// and a dependent read, two L2 round trips, in every MB step). Every
// output byte has one writer: the bottom lines of an MB with a neighbour
// below are written by that neighbour's row. A row waits on the row above
// one L2 round trip, mostly hidden by the load one step ahead, and one H
// pass per MB step. bS follows `_frame_bs`: intra on either side 4 on an
// MB edge, 3 inside; coded coefficients on either side 2; an MV component
// differing by 4 or more 1; else 0; an MB edge without its neighbour
// (column or row 0, or not available) 0. Chroma edges 0 and 1 take luma
// edge groups 0 and 2. An MB edge filters at the rounded average of the
// two MBs' QPs, an inner edge at the MB's own (spec 8.7.2.1). Edges whose
// bS is 0 leave their lines as they are, and nothing left of column 0 or
// above row 0 (or of an unavailable neighbour) is read.
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
// given stream, allocates nothing (the caller zeroes the ticket and mailbox
// buffer: 16 bytes, then 128 bytes per MB of every row and plane group)
// and returns cudaGetLastError().

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kQps = 52;
constexpr int kWarps = 4;                 // row warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 4;                  // MBs in a warp's shared ring
constexpr int kSelInter = 0;              // mbscan.SEL_INTER

struct Tables {
  uint8_t alpha[kQps];
  uint8_t beta[kQps];
  uint8_t tc0[kQps * 3];
};

struct Args {
  const uint8_t* in_y;      // (N, nmb, 16, 16)
  const uint8_t* in_u;      // (N, nmb, 8, 8)
  const uint8_t* in_v;
  uint8_t* out_y;
  uint8_t* out_u;
  uint8_t* out_v;
  const int32_t* sel;       // (N, nmb)
  const int32_t* nnz;       // (N, nmb, 4, 4): [block row][block column]
  const int32_t* mvy;
  const int32_t* mvx;
  const int32_t* qp;        // (N,) or (N, nmb)
  const int32_t* qpc;
  const uint8_t* avail_top;   // (nmb,)
  const uint8_t* avail_left;
  int* sync;                // [0] the ticket; from byte 16 the mailbox
  int mbw;
  int mbh;
  int qp_per_mb;
  int rows;                 // N * 2 * mbh: the rows of both plane groups
};

// One MB in shared memory: 39 chunks of 16 bytes, then 6 scalars.
struct alignas(16) Mb {
  uint8_t y[256];           // chunks 0-15
  uint8_t u[64];            // 16-19
  uint8_t v[64];            // 20-23
  int32_t nnz[16];          // 24-27
  int32_t mvy[16];          // 28-31
  int32_t mvx[16];          // 32-35
  int32_t top_nnz[4];       // 36-38: row 3 of the MB above
  int32_t top_mvy[4];
  int32_t top_mvx[4];
  int32_t sel, qp, qpc, top_sel, top_qp, top_qpc;
  int32_t pad[2];
};
static_assert(sizeof(Mb) == 39 * 16 + 8 * 4, "Mb layout");

struct alignas(16) WarpSmem {
  Mb mb[kRing];             // MB c in mb[c % kRing]
  uint8_t strip[64];        // the bottom lines of the MB above: luma rows
                            // 12-15, or chroma rows 6-7 of U then V
};

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return min(max(x, lo), hi);
}

// 64-bit strong (relaxed, gpu-scope) load and store: single-copy atomic,
// and served by L2, so a reader never sees a stale L1 line.
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

// The luma edge between s[X - 1] and s[X] of a line (p3..q3 = s[X - 4 ..
// X + 3]) at bS `bs` (0 leaves the line as it is). Branch-free: both
// filters are computed and the result selected, so lanes whose edges
// differ in bS or in the filter decision run the same instructions.
template <int X>
__device__ __forceinline__ void luma_edge(int* s, int bs, int qp,
                                          const Tables& t) {
  const int i = clip3(0, kQps - 1, qp);
  const int alpha = t.alpha[i], beta = t.beta[i];
  const int tc0 = t.tc0[i * 3 + clip3(0, 2, bs - 1)];
  const int p3 = s[X - 4], p2 = s[X - 3], p1 = s[X - 2], p0 = s[X - 1];
  const int q0 = s[X], q1 = s[X + 1], q2 = s[X + 2], q3 = s[X + 3];
  const bool filt = bs > 0 && abs(p0 - q0) < alpha && abs(p1 - p0) < beta
                    && abs(q1 - q0) < beta;
  const bool ap = abs(p2 - p0) < beta, aq = abs(q2 - q0) < beta;
  // bS 1..3
  const int tc = tc0 + ap + aq;
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
  const int avg = (p0 + q0 + 1) >> 1;
  const int np0 = clip3(0, 255, p0 + delta), nq0 = clip3(0, 255, q0 - delta);
  const int np1 = ap ? p1 + clip3(-tc0, tc0, (p2 + avg - 2 * p1) >> 1) : p1;
  const int nq1 = aq ? q1 + clip3(-tc0, tc0, (q2 + avg - 2 * q1) >> 1) : q1;
  // bS 4
  const bool strong = abs(p0 - q0) < ((alpha >> 2) + 2);
  const bool sp = strong && ap, sq = strong && aq;
  const int sp0 = sp ? (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
                     : (2 * p1 + p0 + q1 + 2) >> 2;
  const int sp1 = sp ? (p2 + p1 + p0 + q0 + 2) >> 2 : p1;
  const int sp2 = sp ? (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3 : p2;
  const int sq0 = sq ? (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
                     : (2 * q1 + q0 + p1 + 2) >> 2;
  const int sq1 = sq ? (q2 + q1 + q0 + p0 + 2) >> 2 : q1;
  const int sq2 = sq ? (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3 : q2;
  const bool f4 = filt && bs == 4, fn = filt && bs != 4;
  s[X - 3] = f4 ? sp2 : p2;
  s[X - 2] = f4 ? sp1 : fn ? np1 : p1;
  s[X - 1] = f4 ? sp0 : fn ? np0 : p0;
  s[X] = f4 ? sq0 : fn ? nq0 : q0;
  s[X + 1] = f4 ? sq1 : fn ? nq1 : q1;
  s[X + 2] = f4 ? sq2 : q2;
}

// The chroma edge between s[X - 1] and s[X] (p1..q1 = s[X - 2 .. X + 1]),
// branch-free like the luma edge.
template <int X>
__device__ __forceinline__ void chroma_edge(int* s, int bs, int qp,
                                            const Tables& t) {
  const int i = clip3(0, kQps - 1, qp);
  const int alpha = t.alpha[i], beta = t.beta[i];
  const int tc = t.tc0[i * 3 + clip3(0, 2, bs - 1)] + 1;
  const int p1 = s[X - 2], p0 = s[X - 1], q0 = s[X], q1 = s[X + 1];
  const bool filt = bs > 0 && abs(p0 - q0) < alpha && abs(p1 - p0) < beta
                    && abs(q1 - q0) < beta;
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
  const bool f4 = filt && bs == 4, fn = filt && bs != 4;
  s[X - 1] = f4 ? (2 * p1 + p0 + q1 + 2) >> 2
             : fn ? clip3(0, 255, p0 + delta) : p0;
  s[X] = f4 ? (2 * q1 + q0 + p1 + 2) >> 2
         : fn ? clip3(0, 255, q0 - delta) : q0;
}

// bS of one 4-pixel edge group (`mb_edge_bs`): p and q are the 4x4 blocks
// on either side, `intra` whether either MB is intra.
__device__ __forceinline__ int edge_bs(bool intra, bool mb_edge, int nnz_p,
                                       int nnz_q, int mvy_p, int mvx_p,
                                       int mvy_q, int mvx_q) {
  const bool coded = nnz_p > 0 || nnz_q > 0;
  const bool moved = abs(mvy_p - mvy_q) >= 4 || abs(mvx_p - mvx_q) >= 4;
  return intra ? (mb_edge ? 4 : 3) : coded ? 2 : moved;
}

// bS of edge e at group g of an MB: vertical edges (`vert`) pair blocks
// (g, e - 1) and (g, e), horizontal ones (e - 1, g) and (e, g); edge 0
// pairs the neighbour's last block column or row with the MB's first.
__device__ __forceinline__ int mb_bs(const Mb& m, const Mb& left, bool vert,
                                     bool has_nb, int e, int g) {
  const int q = vert ? g * 4 + e : e * 4 + g;
  const bool intra = m.sel != kSelInter;
  if (e > 0) {
    const int p = vert ? q - 1 : q - 4;
    return edge_bs(intra, false, m.nnz[p], m.nnz[q], m.mvy[p], m.mvx[p],
                   m.mvy[q], m.mvx[q]);
  }
  if (!has_nb) return 0;
  if (vert)
    return edge_bs(intra || left.sel != kSelInter, true, left.nnz[q + 3],
                   m.nnz[q], left.mvy[q + 3], left.mvx[q + 3], m.mvy[q],
                   m.mvx[q]);
  return edge_bs(intra || m.top_sel != kSelInter, true, m.top_nnz[g],
                 m.nnz[q], m.top_mvy[g], m.top_mvx[g], m.mvy[q], m.mvx[q]);
}

template <int N>
__device__ __forceinline__ void unpack(const uint32_t* w, int* s) {
#pragma unroll
  for (int k = 0; k < N; ++k) s[k] = (w[k >> 2] >> (8 * (k & 3))) & 255;
}

template <int N>
__device__ __forceinline__ void pack(const int* s, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    w[k] = (uint32_t)s[4 * k] | ((uint32_t)s[4 * k + 1] << 8)
           | ((uint32_t)s[4 * k + 2] << 16) | ((uint32_t)s[4 * k + 3] << 24);
}

// Luma row i of MB `m` across its vertical edges. Every line filters all 4
// edges (bS 0 leaves a line as it is); the left MB's pixels are read and
// written back when it exists.
__device__ __forceinline__ void luma_v(Mb& m, Mb& left, bool has_left, int i,
                                       const Tables& t) {
  const int g = i >> 2;
  int bs[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) bs[e] = mb_bs(m, left, true, has_left, e, g);
  if (!(bs[0] | bs[1] | bs[2] | bs[3])) return;
  int s[20] = {};
  uint4* row = reinterpret_cast<uint4*>(m.y + i * 16);
  const uint4 v = *row;
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
  unpack<16>(w, s + 4);
  uint32_t* lw = reinterpret_cast<uint32_t*>(left.y + i * 16 + 12);
  if (has_left) unpack<4>(lw, s);
  luma_edge<4>(s, bs[0], (m.qp + left.qp + 1) >> 1, t);
  luma_edge<8>(s, bs[1], m.qp, t);
  luma_edge<12>(s, bs[2], m.qp, t);
  luma_edge<16>(s, bs[3], m.qp, t);
  pack<16>(s + 4, w);
  *row = make_uint4(w[0], w[1], w[2], w[3]);
  if (has_left) pack<4>(s, lw);
}

// Chroma row l of plane p (0 U, 1 V) across its vertical edges, which take
// luma edges 0 and 2 of group l / 2.
__device__ __forceinline__ void chroma_v(Mb& m, Mb& left, bool has_left,
                                         int p, int l, const Tables& t) {
  const int g = l >> 1;
  const int b0 = mb_bs(m, left, true, has_left, 0, g);
  const int b1 = mb_bs(m, left, true, has_left, 2, g);
  if (!(b0 | b1)) return;
  int s[10] = {};
  uint2* row = reinterpret_cast<uint2*>((p ? m.v : m.u) + l * 8);
  const uint2 v = *row;
  uint32_t w[2] = {v.x, v.y};
  unpack<8>(w, s + 2);
  uint8_t* lp = (p ? left.v : left.u) + l * 8 + 6;
  if (has_left) {
    s[0] = lp[0];
    s[1] = lp[1];
  }
  chroma_edge<2>(s, b0, (m.qpc + left.qpc + 1) >> 1, t);
  chroma_edge<6>(s, b1, m.qpc, t);
  pack<8>(s + 2, w);
  *row = make_uint2(w[0], w[1]);
  if (has_left) lp[1] = (uint8_t)s[1];
}

// The bS of a lane's horizontal edges (luma column j: edges 0-3; chroma
// column l: luma edges 0 and 2 of group l / 2 in bs[0] and bs[1]).
__device__ __forceinline__ void h_bs(const Mb& m, bool has_top, bool luma,
                                     int lane, int* bs) {
  if (luma) {
#pragma unroll
    for (int e = 0; e < 4; ++e) bs[e] = mb_bs(m, m, false, has_top, e,
                                              lane >> 2);
  } else {
    bs[0] = mb_bs(m, m, false, has_top, 0, (lane & 7) >> 1);
    bs[1] = mb_bs(m, m, false, has_top, 2, (lane & 7) >> 1);
  }
}

// Luma column j of MB `m` across its horizontal edges; `strip` holds rows
// 12-15 of the MB above, read and written back when it exists.
__device__ __forceinline__ void luma_h(Mb& m, uint8_t* strip, bool has_top,
                                       const int* bs, int j,
                                       const Tables& t) {
  if (!(bs[0] | bs[1] | bs[2] | bs[3])) return;
  int s[20] = {};
#pragma unroll
  for (int k = 0; k < 16; ++k) s[4 + k] = m.y[k * 16 + j];
  if (has_top) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = strip[k * 16 + j];
  }
  luma_edge<4>(s, bs[0], (m.qp + m.top_qp + 1) >> 1, t);
  luma_edge<8>(s, bs[1], m.qp, t);
  luma_edge<12>(s, bs[2], m.qp, t);
  luma_edge<16>(s, bs[3], m.qp, t);
#pragma unroll
  for (int k = 0; k < 16; ++k) m.y[k * 16 + j] = (uint8_t)s[4 + k];
  if (has_top) {
#pragma unroll
    for (int k = 1; k < 4; ++k) strip[k * 16 + j] = (uint8_t)s[k];
  }
}

// Chroma column l of plane p across its horizontal edges; `strip` holds
// rows 6-7 of the plane's MB above.
__device__ __forceinline__ void chroma_h(Mb& m, uint8_t* strip, bool has_top,
                                         const int* bs, int p, int l,
                                         const Tables& t) {
  if (!(bs[0] | bs[1])) return;
  uint8_t* tile = p ? m.v : m.u;
  int s[10] = {};
#pragma unroll
  for (int k = 0; k < 8; ++k) s[2 + k] = tile[k * 8 + l];
  if (has_top) {
    s[0] = strip[l];
    s[1] = strip[8 + l];
  }
  chroma_edge<2>(s, bs[0], (m.qpc + m.top_qpc + 1) >> 1, t);
  chroma_edge<6>(s, bs[1], m.qpc, t);
#pragma unroll
  for (int k = 0; k < 8; ++k) tile[k * 8 + l] = (uint8_t)s[2 + k];
  if (has_top) strip[8 + l] = (uint8_t)s[1];
}

// The 16-byte chunk k (0-23) of MB `gm` (global index f * nmb + mb) in the
// tile layout, in the input (or output) planes.
template <typename T>
__device__ __forceinline__ T* pixel_chunk(T* y, T* u, T* v, long long gm,
                                          int k) {
  if (k < 16) return y + gm * 256 + k * 16;
  if (k < 20) return u + gm * 64 + (k - 16) * 16;
  return v + gm * 64 + (k - 20) * 16;
}

// cp.async of `Bytes` from global to shared memory; with `valid` false the
// destination is zero-filled and nothing is read.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait for every cp.async group of this thread but the newest.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// What one lane copies of every MB of a row into its Mb: a 16-byte chunk
// (a luma warp needs chunks 0-15 and 24-38, a chroma warp 16-23 and 24-38,
// one a lane) and a scalar (sel, qp, qpc of the MB, then of the MB above:
// lanes 0-5), each as the source of MB 0, a stride per MB and an offset in
// Mb. Row 0 has no MB above: zeros.
struct RowCopies {
  const char* chunk;
  const char* scalar;
  long long chunk_stride, scalar_stride;
  int chunk_dst, scalar_dst;
  bool chunk_on, chunk_valid, scalar_on, scalar_valid;
};

__device__ __forceinline__ RowCopies row_copies(const Args& a, int lane,
                                                bool luma, int f, int r) {
  const long long g0 = (long long)f * a.mbw * a.mbh + (long long)r * a.mbw;
  const long long t0 = g0 - a.mbw;               // MB (r - 1, 0)
  const bool has_top = r > 0;
  RowCopies rc{};
  const int n_pix = luma ? 16 : 8;
  rc.chunk_on = lane < n_pix + 15;
  if (rc.chunk_on) {
    const int k = lane < n_pix ? lane + (luma ? 0 : 16) : 24 + lane - n_pix;
    rc.chunk_dst = k * 16;
    rc.chunk_valid = true;
    if (k < 24) {
      rc.chunk = (const char*)pixel_chunk(a.in_y, a.in_u, a.in_v, g0, k);
      rc.chunk_stride = k < 16 ? 256 : 64;
    } else if (k < 36) {
      rc.chunk = (const char*)((k < 28 ? a.nnz : k < 32 ? a.mvy : a.mvx)
                               + g0 * 16 + (k & 3) * 4);
      rc.chunk_stride = 64;
    } else {                                     // row 3 of the MB above
      rc.chunk_valid = has_top;
      rc.chunk = (const char*)((k == 36 ? a.nnz : k == 37 ? a.mvy : a.mvx)
                               + (has_top ? t0 * 16 + 12 : 0));
      rc.chunk_stride = has_top ? 64 : 0;
    }
  }
  rc.scalar_on = lane < 6;
  if (rc.scalar_on) {
    const bool above = lane >= 3;
    const long long g = above ? t0 : g0;
    rc.scalar_valid = !above || has_top;
    rc.scalar_dst = (int)offsetof(Mb, sel) + lane * 4;
    if (!rc.scalar_valid) {
      rc.scalar = (const char*)a.sel;
    } else if (lane % 3 == 0) {
      rc.scalar = (const char*)(a.sel + g);
      rc.scalar_stride = 4;
    } else {
      rc.scalar = (const char*)((lane % 3 == 1 ? a.qp : a.qpc)
                                + (a.qp_per_mb ? g : (long long)f));
      rc.scalar_stride = a.qp_per_mb ? 4 : 0;
    }
  }
  return rc;
}

// Start the copies of MB c of the row into `m`.
__device__ __forceinline__ void issue_mb(const RowCopies& rc, Mb& m, int c) {
  char* base = reinterpret_cast<char*>(&m);
  if (rc.chunk_on)
    cp_async<16>(base + rc.chunk_dst, rc.chunk + c * rc.chunk_stride,
                 rc.chunk_valid);
  if (rc.scalar_on)
    cp_async<4>(base + rc.scalar_dst, rc.scalar + c * rc.scalar_stride,
                rc.scalar_valid);
}

// MB (r, c)'s availability flags as loaded (the MB above, the MB to the
// left, and the MB below's view of this MB: whether MB (r + 1, c) exists
// and has its upper neighbour); all 0 outside the frame. Kept apart until
// used, so that the loads, issued one MB step ahead, never stall.
struct Avail {
  int top, left, below;
};

__device__ __forceinline__ Avail load_avail(const Args& a, int r, int c) {
  Avail v{0, 0, 0};
  if (r < a.mbh && c >= 0 && c < a.mbw) {
    const int local = r * a.mbw + c;
    v.top = __ldg(a.avail_top + local);
    v.left = __ldg(a.avail_left + local);
    if (r + 1 < a.mbh) v.below = __ldg(a.avail_top + local + a.mbw);
  }
  return v;
}

// The bottom lines of MB `gm` in the output, 16 bytes a lane: luma rows
// 12-15 (lanes 0-3), or chroma rows 6-7 of U (lane 0) and V (lane 1).
__device__ __forceinline__ uint8_t* strip_chunk(const Args& a, long long gm,
                                                int lane, bool luma) {
  if (luma) return a.out_y + gm * 256 + 192 + lane * 16;
  return (lane ? a.out_v : a.out_u) + gm * 64 + 48;
}

constexpr unsigned long long kTag = 1ull << 32;   // a mailbox unit written
constexpr int kUnits = 16;                        // units of a mailbox entry

// MB `m` (global index gm) is final for its row: lane `lane` writes its
// chunk to the output and, when the MB below takes the bottom lines
// (`below`), its mailbox unit in `entry`: luma rows 12-15 (units 0-15), or
// rows 6-7 of U (units 0-3) then V (4-7), 4 pixels each, in place of the
// output's chunk of those lines.
__device__ __forceinline__ void put_out(const Args& a, const Mb& m,
                                       long long gm, int lane, bool luma,
                                       bool below,
                                       unsigned long long* entry) {
  if (lane >= (luma ? 16 : 8)) return;
  if (below) {
    const uint8_t* p = luma ? m.y + 192 + lane * 4
                            : (lane < 4 ? m.u : m.v) + 48 + (lane & 3) * 4;
    st_relaxed(entry + lane, kTag | *reinterpret_cast<const uint32_t*>(p));
    if (luma ? lane >= 12 : (lane & 3) == 3) return;
  }
  const int k = luma ? lane : 16 + lane;
  *reinterpret_cast<uint4*>(pixel_chunk(a.out_y, a.out_u, a.out_v, gm, k)) =
      reinterpret_cast<const uint4*>(&m)[k];
}

__global__ void __launch_bounds__(kThreads)
deblock_kernel(const __grid_constant__ Tables t,
               const __grid_constant__ Args a) {
  __shared__ WarpSmem smem[kWarps];
  const int lane = threadIdx.x & 31;
  WarpSmem& w = smem[threadIdx.x >> 5];
  int ticket = 0;
  if (lane == 0) ticket = atomicAdd(a.sync, 1);
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  if (ticket >= a.rows) return;
  const int r = ticket % a.mbh, fg = ticket / a.mbh, f = fg >> 1;
  const bool luma = (fg & 1) == 0;
  const bool works = lane < 16;                 // a line of the MB
  const int cp = (lane >> 3) & 1, cl = lane & 7;  // chroma plane, line
  const int n_units = luma ? 16 : 8, n_strip = luma ? 4 : 2;
  // mailbox entries (ticket, MB c): the bottom lines of the row's MB c for
  // the row below
  unsigned long long* mail_out =
      reinterpret_cast<unsigned long long*>(a.sync + 4)
      + (long long)ticket * a.mbw * kUnits;
  const unsigned long long* mail_in = mail_out - (long long)a.mbw * kUnits;
  const bool reads_mail = r > 0 && lane < n_units;
  const long long row0 = (long long)f * a.mbw * a.mbh + (long long)r * a.mbw;
  const RowCopies copies = row_copies(a, lane, luma, f, r);

  issue_mb(copies, w.mb[0], 0);
  cp_async_commit();
  if (a.mbw > 1) issue_mb(copies, w.mb[1], 1);
  cp_async_commit();
  Avail av_prev{0, 0, 0}, av = load_avail(a, r, 0), av1 = load_avail(a, r, 1);
  unsigned long long unit = reads_mail ? ld_relaxed(mail_in + lane) : 0;
  for (int c = 0; c < a.mbw; ++c) {
    cp_async_wait_all_but_one();              // MB c has landed
    __syncwarp();
    if (c + 2 < a.mbw) issue_mb(copies, w.mb[(c + 2) % kRing], c + 2);
    cp_async_commit();
    if (c > 0) {
      av_prev = av;
      av = av1;
      av1 = load_avail(a, r, c + 1);
    }
    Mb& m = w.mb[c % kRing];
    Mb& left = w.mb[(c + kRing - 1) % kRing];
    const bool has_left = c > 0 && av.left;
    const bool has_top = r > 0 && av.top;
    // V pass, then the left MB is final for this row
    if (works) {
      if (luma) luma_v(m, left, has_left, lane, t);
      else chroma_v(m, left, has_left, cp, cl, t);
    }
    __syncwarp();
    if (c > 0)
      put_out(a, left, row0 + c - 1, lane, luma, av_prev.below,
              mail_out + (long long)(c - 1) * kUnits);
    // H pass, with the bottom lines of the MB above from the mailbox
    int bh[4];
    if (works) h_bs(m, has_top, luma, lane, bh);
    if (has_top) {
      const unsigned long long* src = mail_in + (long long)c * kUnits + lane;
      while (!__all_sync(0xffffffffu, !reads_mail || unit >= kTag))
        if (reads_mail && unit < kTag) unit = ld_relaxed(src);
      if (reads_mail)
        *reinterpret_cast<uint32_t*>(w.strip + lane * 4) = (uint32_t)unit;
      __syncwarp();
    }
    if (reads_mail && c + 1 < a.mbw)          // the next MB's, in flight
      unit = ld_relaxed(mail_in + (long long)(c + 1) * kUnits + lane);
    if (works) {
      if (luma) luma_h(m, w.strip, has_top, bh, lane, t);
      else chroma_h(m, w.strip + 16 * cp, has_top, bh, cp, cl, t);
    }
    __syncwarp();
    if (has_top && lane < n_strip)
      *reinterpret_cast<uint4*>(strip_chunk(a, row0 - a.mbw + c, lane,
                                            luma)) =
          *reinterpret_cast<const uint4*>(w.strip + 16 * lane);
  }
  put_out(a, w.mb[(a.mbw - 1) % kRing], row0 + a.mbw - 1, lane, luma,
          av.below, mail_out + (long long)(a.mbw - 1) * kUnits);
}

}  // namespace

extern "C" int h264lab_deblock(
    const void* in_y, const void* in_u, const void* in_v, void* out_y,
    void* out_u, void* out_v, const void* sel, const void* nnz,
    const void* mvy, const void* mvx, const void* qp, const void* qpc,
    const void* avail_top, const void* avail_left, void* sync,
    const void* alpha, const void* beta, const void* tc0, long long n,
    int mbw, int mbh, int qp_per_mb, void* stream) {
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  if (n * 2 * mbh >= (1ll << 31) || n * mbw * mbh >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  Tables t;
  std::memcpy(t.alpha, alpha, sizeof t.alpha);
  std::memcpy(t.beta, beta, sizeof t.beta);
  std::memcpy(t.tc0, tc0, sizeof t.tc0);
  const int rows = (int)(n * 2 * mbh);
  const Args a{(const uint8_t*)in_y, (const uint8_t*)in_u,
               (const uint8_t*)in_v, (uint8_t*)out_y, (uint8_t*)out_u,
               (uint8_t*)out_v, (const int32_t*)sel, (const int32_t*)nnz,
               (const int32_t*)mvy, (const int32_t*)mvx,
               (const int32_t*)qp, (const int32_t*)qpc,
               (const uint8_t*)avail_top, (const uint8_t*)avail_left,
               (int*)sync, mbw, mbh, qp_per_mb, rows};
  // one warp per MB row and plane group; each warp draws its row from the
  // ticket
  deblock_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                   (cudaStream_t)stream>>>(t, a);
  return (int)cudaGetLastError();
}
