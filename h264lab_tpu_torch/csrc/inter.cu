// K7 of h264lab_tpu_torch: the inter residual of a batch of P frames or
// slice bands, everything of the `inter` stage after the motion searches,
// in one kernel written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces h264lab_tpu/models/mbscan.py:221-293, which the JAX package
// left to XLA (no Pallas kernel): the partition shape and MV grids
// (:221-262), the chroma motion compensation (:264-276, ops/qpel.py:169
// `mc_chroma_uniform` or :236 `mc_chroma_grid`), the inter luma TQ with
// its zero-block kills (`_encode_inter_luma`, :135) and the chroma TQ
// (`_encode_chroma`, :117). In the port those were about 340 eager
// operations a P step, each a launch and a few microseconds of host issue:
// the stage was bound by host issue (PERF.md §5), which one launch ends.
// It takes what the port's plain version `inter_residual_plain`
// (models/mbscan.py) takes, in the form `mbscan.inter_residual_args`
// packs, and writes what it returns, array for array (integer arithmetic
// throughout): mv4_y, mv4_x, shape, inter_cost, lev_inter and the
// reconstruction and levels of Y, U and V.
//
// Bound. Each input is read once and each output written once: of an MB
// 384 B of source, 256 B of luma prediction (1,024 B of int32 from K5 at
// speed 0, the chosen shape's), its MVs and costs, and about 2 x 81 B of
// chroma reference window in; 1,024 B of luma levels, 544 B of chroma
// levels, 384 B of reconstruction and 136 B of MVs, shape and cost out:
// about 2.9 KB an MB, 0.11 ms for 16 frames of 1080p at 3.35 TB/s
// (chip_smoke.k7_bytes counts them). The arithmetic, about 24 block
// transforms and quantisations an MB, is a few thousand integer
// operations, far under the bytes' time.
//
// Design, simple first: a warp per MB, 4 MBs a block, nothing carried
// between MBs, every output written once.
//   - lane 0's choice of shape (speed 0: the least of the 16x16 cost and
//     K5's three plus their lambda-weighted side-info penalties, the first
//     on ties) is made by every lane, from the same loads;
//   - chroma MC: lane l predicts 4 pixels of one row of one plane (U on
//     lanes 0-15, V on 16-31), each from its 4x4 luma block's MV, with the
//     eighth-pel bilinear, into shared memory. Without partitions every MV
//     of the MB is the same and the rows and columns follow
//     `mc_chroma_uniform`: its 10 x 10 window at the full-pel winner,
//     clamped into the plane as `lax.dynamic_slice` clamps it, and the
//     final MV's offset of 0 or 1 inside it;
//   - the TQ: lanes 0-15 each transform, quantise and reconstruct one 4x4
//     luma block in registers, lanes 16-23 one chroma block (U 16-19, V
//     20-23); the 8x8 quarters' kill decision and the 2x2 chroma DC
//     Hadamards are shuffles across the lanes of the blocks involved
//     (lane ^ 1, lane ^ 4 for a quarter; lane ^ 1, lane ^ 2 for a plane);
//   - levels go out in 16-byte stores, reconstruction rows in 4-byte ones.
//
// Plain C interface, loaded with ctypes; the entry point launches on the
// given stream, allocates nothing and returns the launch's error.

#include <cstdint>
#include <cuda_runtime.h>

#include "tq.h"

namespace {

constexpr int kWarps = 4;                 // MBs a block

struct Args {
  const uint8_t* src_y;     // (N, nmb, 16, 16)
  const uint8_t* src_u;     // (N, nmb, 8, 8)
  const uint8_t* src_v;
  const uint8_t* u_pad;     // (L, hc, wc) guard-padded chroma planes
  const uint8_t* v_pad;
  const int32_t* lane;      // (N,) each frame's reference lane
  const int32_t* row0;      // (N,) its first MB row in the lane's frame
  const int32_t* qp;        // (N,) or (N, mbh) with qp_rows
  const int32_t* qpc;
  const int32_t* mv_y;      // (N, nmb) the 16x16 search's final MV
  const int32_t* mv_x;
  const int32_t* full_my;   // (N, nmb) its full-pel winner
  const int32_t* full_mx;
  const int32_t* cost16;    // (N, nmb)
  const uint8_t* pred16;    // (N, nmb, 16, 16)
  // K5's outputs at speed 0, else null
  const int32_t* mv16x8;    // (K, 2, 2) (part, y/x)
  const int32_t* mv8x16;
  const int32_t* mv8x8;     // (K, 4, 2)
  const long long* cost16x8;  // (K,)
  const long long* cost8x16;
  const long long* cost8x8;
  const int32_t* pred16x8;  // (K, 16, 16)
  const int32_t* pred8x16;
  const int32_t* pred8x8;
  int32_t* mv4_y;           // (N, nmb, 4, 4)
  int32_t* mv4_x;
  int32_t* shape;           // (N, nmb)
  int32_t* inter_cost;
  int32_t* lev;             // (N, nmb, 4, 4, 4, 4) (bi, bj, y, x)
  uint8_t* rec_y;           // (N, nmb, 16, 16)
  uint8_t* rec_u;           // (N, nmb, 8, 8)
  uint8_t* rec_v;
  int32_t* cdc;             // (N, nmb, 2, 2, 2) (plane, bi, bj)
  int32_t* cac;             // (N, nmb, 2, 2, 2, 4, 4)
  long long mbs;
  int nmb, mbw, mbh, qp_rows, hc, wc, guard_c;
  int dz, kill, thr1_q8, thr2_q8, pen16x8, pen8x8;
};

__global__ void __launch_bounds__(kWarps * 32)
inter_residual_kernel(const Args a) {
  __shared__ alignas(16) uint8_t pred_c[kWarps][2][64];
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kWarps + warp;
  if (k >= a.mbs) return;                   // the whole warp
  const int n = (int)(k / a.nmb), m = (int)(k - (long long)n * a.nmb);
  const int r = m / a.mbw, c = m - r * a.mbw;
  const int qrow = a.qp_rows ? n * a.mbh + r : n;
  const int qp = a.qp[qrow], qpc = a.qpc[qrow];

  // the shape: the least of the four costs, the first on ties
  int shape = 0;
  long long cost = a.cost16[k];
  const bool parts = a.pred16x8 != nullptr;
  if (parts) {
    const long long lam = kTqLambda[a.qp[a.qp_rows ? n * a.mbh : n]];
    const long long c1 = a.cost16x8[k] + lam * a.pen16x8;
    const long long c2 = a.cost8x16[k] + lam * a.pen16x8;
    const long long c3 = a.cost8x8[k] + lam * a.pen8x8;
    if (c1 < cost) { cost = c1; shape = 1; }
    if (c2 < cost) { cost = c2; shape = 2; }
    if (c3 < cost) { cost = c3; shape = 3; }
  }
  const int mvy16 = a.mv_y[k], mvx16 = a.mv_x[k];
  // the MV of luma block (bi, bj) under the shape
  auto block_mv = [&](int bi, int bj, int& my, int& mx) {
    const int32_t* p = shape == 1 ? a.mv16x8 + 4 * k + 2 * (bi >> 1)
                     : shape == 2 ? a.mv8x16 + 4 * k + 2 * (bj >> 1)
                     : shape == 3 ? a.mv8x8 + 8 * k
                                    + 2 * (2 * (bi >> 1) + (bj >> 1))
                                  : nullptr;
    my = p ? p[0] : mvy16;
    mx = p ? p[1] : mvx16;
  };

  // chroma MC: lane l, plane l >> 4, row y, pixels x0..x0 + 3
  {
    const int p = l >> 4, y = (l & 15) >> 1, x0 = (l & 1) * 4;
    const uint8_t* plane = (p ? a.v_pad : a.u_pad)
                           + (long long)a.lane[n] * a.hc * a.wc;
    const int cb_y = a.guard_c + 8 * (r + a.row0[n]);
    const int cb_x = a.guard_c + 8 * c;
    // mc_chroma_uniform's window origin, clamped, and the final MV's
    // offset in it (what the plain `windows` and `shift_window` read)
    const int wy = (a.full_my[k] >> 1) - 1, wx = (a.full_mx[k] >> 1) - 1;
    const int oy = tq_clip3(0, a.hc - 10, cb_y + wy) - wy;
    const int ox = tq_clip3(0, a.wc - 10, cb_x + wx) - wx;
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int x = x0 + j;
      int my, mx;
      block_mv(y >> 1, x >> 1, my, mx);
      int iy = (parts ? cb_y : oy) + (my >> 3) + y;
      int ix = (parts ? cb_x : ox) + (mx >> 3) + x;
      // no index of the P path leaves the plane (qpel.mc_chroma); kept
      // inside it whatever the inputs
      iy = tq_clip3(0, a.hc - 2, iy);
      ix = tq_clip3(0, a.wc - 2, ix);
      const uint8_t* q = plane + (long long)iy * a.wc + ix;
      const int fy = my & 7, fx = mx & 7;
      const int v = ((8 - fx) * (8 - fy) * q[0] + fx * (8 - fy) * q[1]
                     + (8 - fx) * fy * q[a.wc] + fx * fy * q[a.wc + 1]
                     + 32) >> 6;
      word |= (uint32_t)v << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(&pred_c[warp][p][8 * y + x0]) = word;
  }
  __syncwarp();

  // the TQ: luma block l on lanes 0-15, chroma block l - 16 on 16-23
  const bool luma = l < 16;
  const int cb = (l - 16) & 7, cp = cb >> 2;
  const int bi = luma ? l >> 2 : (cb >> 1) & 1;
  const int bj = luma ? l & 3 : cb & 1;
  int x[16], rec[16];
  uint32_t prow[4];
  if (luma) {
    const uint8_t* src = a.src_y + 256 * k + 64 * bi + 4 * bj;
    const int32_t* pp = shape == 1 ? a.pred16x8 : shape == 2 ? a.pred8x16
                      : shape == 3 ? a.pred8x8 : nullptr;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      if (pp) {
        const int4 v = *reinterpret_cast<const int4*>(
            pp + 256 * k + 16 * (4 * bi + y) + 4 * bj);
        prow[y] = (uint32_t)(v.x & 0xff) | (uint32_t)(v.y & 0xff) << 8
                  | (uint32_t)(v.z & 0xff) << 16
                  | (uint32_t)(v.w & 0xff) << 24;
      } else {
        prow[y] = *reinterpret_cast<const uint32_t*>(
            a.pred16 + 256 * k + 64 * bi + 16 * y + 4 * bj);
      }
      tq_residual_row(x, y, *reinterpret_cast<const uint32_t*>(src + 16 * y),
                      prow[y]);
    }
  } else {
    const uint8_t* src = (cp ? a.src_v : a.src_u) + 64 * k + 32 * bi + 4 * bj;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      prow[y] = *reinterpret_cast<const uint32_t*>(
          &pred_c[warp][cp][8 * (4 * bi + y) + 4 * bj]);
      tq_residual_row(x, y, *reinterpret_cast<const uint32_t*>(src + 8 * y),
                      prow[y]);
    }
  }

  // transform and quantise: luma at qp with the kills, chroma at qpc with
  // its DC through the 2x2 Hadamard; every lane runs the shuffles
  const TqQuant q = tq_quant(luma ? qp : qpc);
  tq_fdct(x);
  int dc_deq;
  const int dc_lev = tq_chroma_dc(x[0], q, bi, bj, dc_deq);
  int lev[16];
  tq_quant_block(x, lev, rec, q, a.dz);
  // a luma block under the first threshold, or an 8x8 quarter whose four
  // blocks are all under the second (lane ^ 1: bj, lane ^ 4: bi)
  int z2 = a.kill && tq_under(x, q, a.thr2_q8);
  z2 &= __shfl_xor_sync(kTqFull, z2, 1);
  z2 &= __shfl_xor_sync(kTqFull, z2, 4);
  if (luma && a.kill && (z2 || tq_under(x, q, a.thr1_q8))) {
#pragma unroll
    for (int i = 0; i < 16; ++i) lev[i] = rec[i] = 0;
  }
  if (!luma) {
    lev[0] = 0;
    rec[0] = dc_deq;
  }
  tq_idct(rec);

  if (luma) {
    tq_store16(a.lev + 256 * k + 16 * l, lev);
    uint8_t* out = a.rec_y + 256 * k + 64 * bi + 4 * bj;
#pragma unroll
    for (int y = 0; y < 4; ++y)
      *reinterpret_cast<uint32_t*>(out + 16 * y) =
          tq_recon_row(rec, y, prow[y]);
    int my, mx;
    block_mv(bi, bj, my, mx);
    a.mv4_y[16 * k + l] = my;
    a.mv4_x[16 * k + l] = mx;
    if (l == 0) {
      a.shape[k] = shape;
      a.inter_cost[k] = (int)cost;
    }
  } else if (l < 24) {
    a.cdc[8 * k + cb] = dc_lev;
    tq_store16(a.cac + 16 * (8 * k + cb), lev);
    uint8_t* out = (cp ? a.rec_v : a.rec_u) + 64 * k + 32 * bi + 4 * bj;
#pragma unroll
    for (int y = 0; y < 4; ++y)
      *reinterpret_cast<uint32_t*>(out + 8 * y) =
          tq_recon_row(rec, y, prow[y]);
  }
}

}  // namespace

extern "C" int h264lab_inter_residual(
    const void* src_y, const void* src_u, const void* src_v,
    const void* u_pad, const void* v_pad, const void* lane, const void* row0,
    const void* qp, const void* qpc, const void* mv_y, const void* mv_x,
    const void* full_my, const void* full_mx, const void* cost16,
    const void* pred16, const void* mv16x8, const void* mv8x16,
    const void* mv8x8, const void* cost16x8, const void* cost8x16,
    const void* cost8x8, const void* pred16x8, const void* pred8x16,
    const void* pred8x8, void* mv4_y, void* mv4_x, void* shape,
    void* inter_cost, void* lev, void* rec_y, void* rec_u, void* rec_v,
    void* cdc, void* cac, long long n, int mbw, int mbh, int qp_rows, int hc,
    int wc, int guard_c, int dz, int kill, int thr1_q8, int thr2_q8,
    int pen16x8, int pen8x8, void* stream) {
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  const long long mbs = n * mbw * mbh;
  if (mbs >= (1ll << 31) * kWarps || hc < 10 || wc < 10)
    return (int)cudaErrorInvalidValue;
  Args a{(const uint8_t*)src_y, (const uint8_t*)src_u, (const uint8_t*)src_v,
         (const uint8_t*)u_pad, (const uint8_t*)v_pad, (const int32_t*)lane,
         (const int32_t*)row0, (const int32_t*)qp, (const int32_t*)qpc,
         (const int32_t*)mv_y, (const int32_t*)mv_x, (const int32_t*)full_my,
         (const int32_t*)full_mx, (const int32_t*)cost16,
         (const uint8_t*)pred16, (const int32_t*)mv16x8,
         (const int32_t*)mv8x16, (const int32_t*)mv8x8,
         (const long long*)cost16x8, (const long long*)cost8x16,
         (const long long*)cost8x8, (const int32_t*)pred16x8,
         (const int32_t*)pred8x16, (const int32_t*)pred8x8, (int32_t*)mv4_y,
         (int32_t*)mv4_x, (int32_t*)shape, (int32_t*)inter_cost,
         (int32_t*)lev, (uint8_t*)rec_y, (uint8_t*)rec_u, (uint8_t*)rec_v,
         (int32_t*)cdc, (int32_t*)cac, mbs, mbw * mbh, mbw, mbh, qp_rows, hc,
         wc, guard_c, dz, kill, thr1_q8, thr2_q8, pen16x8, pen8x8};
  inter_residual_kernel<<<(unsigned)((mbs + kWarps - 1) / kWarps),
                          kWarps * 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
