// K7 of h264lab_tpu_torch: the inter residual of a batch of P frames or
// slice bands, everything of the `inter` stage after the motion searches,
// in one kernel written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces h264lab_tpu/models/mbscan.py:221-293, which the JAX package
// left to XLA (no Pallas kernel): the partition shape and MV grids
// (:221-262), the chroma motion compensation (:264-276, ops/qpel.py:169
// `mc_chroma_uniform` or :236 `mc_chroma_grid`), the inter luma TQ with
// its zero-block kills (`_encode_inter_luma`, :135) and the chroma TQ
// (`_encode_chroma`, :117). It takes what the port's plain version
// `inter_residual_plain` (models/mbscan.py) takes, in the form
// `mbscan.inter_residual_args` packs, and writes what it returns, array
// for array (integer arithmetic throughout): mv4_y, mv4_x, shape,
// inter_cost, lev_inter and the reconstruction and levels of Y, U and V.
//
// Bound. Each input is read once and each output written once: of an MB
// 384 B of source, 256 B of luma prediction (1,024 B of int32 from K5 at
// speed 0, the chosen shape's), its MVs and costs, and about 2 x 81 B of
// chroma reference window in; 1,024 B of luma levels, 544 B of chroma
// levels, 384 B of reconstruction and 136 B of MVs, shape and cost out:
// about 2.9 KB an MB, 0.11 ms for 16 frames of 1080p at 3.35 TB/s
// (chip_smoke.k7_bytes counts them). PR 20's kernel (a warp per MB) took
// 2.6x that, held by issue: lanes 24-31 idle through the TQ, every lane
// in the chroma DC code, the chroma MC four single-byte loads a pixel
// through L1 (every lane of an MB in one 10 x 10 window), source and
// prediction 4-byte rows strided by 16.
//
// Design (PR 21): a block of 4 warps takes a tile of 16 consecutive MBs,
// a warp 4 of them, a group of 8 lanes one MB (lane g = lane & 7):
//   - the tile's source and 16x16 prediction (640 B an MB) come in by
//     bulk copies (cp.async.bulk on one mbarrier) issued by warp 0 before
//     any arithmetic, the luma ones a copy per MB into rows padded to
//     272 B, so that the four MBs of a warp read distinct banks;
//   - chroma MC with one MV an MB (speeds 1 and up): the group copies
//     the 9 x 9 bytes a plane that the bilinear reads, as 9 rows of three
//     aligned words, into shared memory by 4-byte asynchronous copies
//     (cp.async, in flight beside the bulk copies; `tools/
//     torch_k78_variants.py` times loads through registers) (the window
//     of
//     `mc_chroma_uniform`, clamped into the plane as its
//     `lax.dynamic_slice` clamps it, and the final MV's offset in it),
//     and each lane predicts its 4x4 block from there with funnel
//     shifts; with K5's partitions (speed 0), or where a pixel's index
//     would be clamped, the lane reads each pixel's four samples from
//     the plane itself, as PR 20's kernel did;
//   - the luma TQ gives each lane two blocks, (g >> 2, g & 3) and the one
//     two rows below, one after the other; an 8x8 quarter's kill is two
//     shuffles (lane ^ 1: bj, lane ^ 4: bi); the chroma TQ gives each
//     lane one block, plane g >> 2 (lanes 4 p + 2 bi + bj, tq_chroma_dc's
//     layout);
//   - each block's reconstruction goes over its source in shared memory
//     and out by bulk stores; the levels go out in 16-byte stores from
//     the lanes;
//   - at most 96 registers (5 blocks an SM; 24 B of spills;
//     `tools/torch_k78_variants.py` times 4 and 6).
//
// Plain C interface, loaded with ctypes; the entry point takes its
// arguments as one array of 64-bit words (in the order
// `residual.inter_tiles` writes them), launches on the given stream, allocates nothing and returns the
// launch's error.

#include <cstdint>
#include <cuda_runtime.h>

#include "tq.h"

namespace {

constexpr int kTile = 16;                 // MBs a block
constexpr int kThreads = 128;             // 4 warps, 8 lanes an MB
constexpr int kRow = 272;                 // a luma MB's padded bytes
constexpr unsigned kInBytes = 256 + 256 + 2 * 64;  // src_y, pred16, src_c

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

struct alignas(16) Smem {
  uint8_t src_y[kTile][kRow];       // source in, reconstruction out
  uint8_t pred[kTile][kRow];        // pred16
  uint8_t src_c[2][kTile][64];      // source in, reconstruction out
  uint32_t win[kTile][2][9][4];     // a plane's window: 9 rows, 3 words
  unsigned long long bar;
};

__global__ void __launch_bounds__(kThreads, 5)
inter_residual_kernel(const Args a) {
  __shared__ Smem s;
  const int lane = threadIdx.x & 31, g = lane & 7, t = threadIdx.x >> 3;
  const long long k0 = (long long)blockIdx.x * kTile;
  const int cnt = (int)min((long long)kTile, a.mbs - k0);

  // 1. the tile's source and prediction by bulk copies (warp 0)
  if (threadIdx.x < 32) {
    if (lane == 0) {
      tq_mbar_init(&s.bar);
      tq_mbar_expect(&s.bar, cnt * kInBytes);
    }
    __syncwarp();
    const int i = lane & 15;
    if (i < cnt) {
      if (lane < 16)
        tq_load(s.src_y[i], a.src_y + 256 * (k0 + i), 256, &s.bar);
      else
        tq_load(s.pred[i], a.pred16 + 256 * (k0 + i), 256, &s.bar);
    }
    if (lane == 0) tq_load(s.src_c[0], a.src_u + 64 * k0, 64 * cnt, &s.bar);
    if (lane == 1) tq_load(s.src_c[1], a.src_v + 64 * k0, 64 * cnt, &s.bar);
  }
  __syncthreads();                  // the mbarrier's init before its waits

  const long long kt = k0 + t;
  const bool valid = kt < a.mbs;
  const long long k = valid ? kt : a.mbs - 1;
  const int n = (int)(k / a.nmb), m = (int)(k - (long long)n * a.nmb);
  const int r = m / a.mbw, c = m - r * a.mbw;
  const int qrow = a.qp_rows ? n * a.mbh + r : n;
  const int qp = a.qp[qrow], qpc = a.qpc[qrow];

  // 2. the shape: the least of the four costs, the first on ties
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

  // 3. the chroma windows: mc_chroma_uniform's origin, clamped, and the
  // final MV's offset in it (what the plain `windows` and `shift_window`
  // read); pixel (y, x) reads rows y0 + y, y0 + y + 1 and columns x0 + x,
  // x0 + x + 1 of the lane's plane. The window takes every MB with one MV
  // whose 9 x 9 samples lie in the plane; the others read the plane per
  // pixel (step 5)
  const int cb_y = a.guard_c + 8 * (r + a.row0[n]);
  const int cb_x = a.guard_c + 8 * c;
  const int wy = (a.full_my[k] >> 1) - 1, wx = (a.full_mx[k] >> 1) - 1;
  const int oy = tq_clip3(0, a.hc - 10, cb_y + wy) - wy;
  const int ox = tq_clip3(0, a.wc - 10, cb_x + wx) - wx;
  const int y0 = oy + (mvy16 >> 3), x0 = ox + (mvx16 >> 3);
  const bool windowed = !parts && y0 >= 0 && y0 + 8 <= a.hc - 1
                        && x0 >= 0 && x0 + 8 <= a.wc - 1;
  const long long plane_at = (long long)a.lane[n] * a.hc * a.wc;
  if (windowed) {
    // 18 rows of three words, two planes, over the group's 8 lanes
    const int xa = x0 & ~3;
    for (int i = g; i < 18; i += 8) {
      const int p = i >= 9, row = i - 9 * p;
      const uint32_t* from = reinterpret_cast<const uint32_t*>(
          (p ? a.v_pad : a.u_pad) + plane_at + (long long)(y0 + row) * a.wc
          + xa);
      uint32_t* to = s.win[t][p][row];
#pragma unroll
      for (int j = 0; j < 3; ++j)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                     :: "r"(tq_smem(to + j)), "l"(from + j) : "memory");
    }
  }

  const int fy16 = mvy16 & 7, fx16 = mvx16 & 7;
  const bool kill = a.kill != 0;
  asm volatile("cp.async.wait_all;" ::: "memory");
  tq_mbar_wait(&s.bar);
  __syncwarp();                     // the group's windows

  // 4. luma: lane g blocks (bi, bj) and (bi + 2, bj), bi = g >> 2, bj =
  // g & 3, one after the other
  {
    const int bi0 = g >> 2, bj = g & 3;
    const int32_t* pp = shape == 1 ? a.pred16x8 : shape == 2 ? a.pred8x16
                      : shape == 3 ? a.pred8x8 : nullptr;
    const TqQuant q = tq_quant(qp);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bi = bi0 + 2 * h, blk = 4 * bi + bj;
      uint8_t* at = s.src_y[t] + 64 * bi + 4 * bj;
      int x[16], rec[16], lev[16];
      uint32_t prow[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        if (pp) {
          // K5's int32 prediction of the chosen shape, read as it is
          const int4 v = *reinterpret_cast<const int4*>(
              pp + 256 * k + 16 * (4 * bi + y) + 4 * bj);
          prow[y] = (uint32_t)(v.x & 0xff) | (uint32_t)(v.y & 0xff) << 8
                    | (uint32_t)(v.z & 0xff) << 16
                    | (uint32_t)(v.w & 0xff) << 24;
        } else {
          prow[y] = *reinterpret_cast<const uint32_t*>(
              s.pred[t] + 64 * bi + 16 * y + 4 * bj);
        }
        tq_residual_row(x, y, *reinterpret_cast<const uint32_t*>(
            at + 16 * y), prow[y]);
      }
      tq_fdct(x);
      // a block under the first threshold, or an 8x8 quarter whose four
      // blocks are all under the second (lane ^ 1: bj, lane ^ 4: bi)
      int z2 = kill && tq_under(x, q, a.thr2_q8);
      z2 &= __shfl_xor_sync(kTqFull, z2, 1);
      z2 &= __shfl_xor_sync(kTqFull, z2, 4);
      tq_quant_block(x, lev, rec, q, a.dz);
      if (kill && (z2 || tq_under(x, q, a.thr1_q8))) {
#pragma unroll
        for (int i = 0; i < 16; ++i) lev[i] = rec[i] = 0;
      }
      tq_idct(rec);
#pragma unroll
      for (int y = 0; y < 4; ++y)
        *reinterpret_cast<uint32_t*>(at + 16 * y) =
            tq_recon_row(rec, y, prow[y]);
      if (valid) {
        tq_store16(a.lev + 256 * k + 16 * blk, lev);
        int my, mx;
        block_mv(bi, bj, my, mx);
        a.mv4_y[16 * k + blk] = my;
        a.mv4_x[16 * k + blk] = mx;
      }
    }
  }

  // 5. chroma: lane g block (bi, bj) of plane p, g = 4 p + 2 bi + bj
  {
    const int p = g >> 2, bi = (g >> 1) & 1, bj = g & 1;
    uint32_t prow[4];
    if (windowed) {
      const int o = (x0 & 3) + 4 * bj, wi = o >> 2, sh = 8 * (o & 3);
      const int w11 = fx16 * fy16, w01 = fx16 * (8 - fy16);
      const int w10 = (8 - fx16) * fy16, w00 = (8 - fx16) * (8 - fy16);
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int y = -1; y < 4; ++y) {
        const uint32_t* row = s.win[t][p][4 * bi + y + 1];
        const uint32_t a0 = __funnelshift_r(row[wi], row[wi + 1], sh);
        const uint32_t a4 = (row[wi + 1] >> sh) & 0xff;
        if (y >= 0) {
          uint32_t word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p00 = (lo >> (8 * j)) & 0xff;
            const int p01 = j < 3 ? (lo >> (8 * j + 8)) & 0xff : (int)hi;
            const int p10 = (a0 >> (8 * j)) & 0xff;
            const int p11 = j < 3 ? (a0 >> (8 * j + 8)) & 0xff : (int)a4;
            const int v = (w00 * p00 + w01 * p01 + w10 * p10 + w11 * p11
                           + 32) >> 6;
            word |= (uint32_t)v << (8 * j);
          }
          prow[y] = word;
        }
        lo = a0;
        hi = a4;
      }
    } else {
      // each pixel from the plane, with its 4x4 block's MV; no index of
      // the P path leaves the plane (qpel.mc_chroma), kept inside it
      // whatever the inputs
      const uint8_t* plane = (p ? a.v_pad : a.u_pad) + plane_at;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int cy = 4 * bi + y;
        uint32_t word = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cx = 4 * bj + j;
          int my, mx;
          block_mv(cy >> 1, cx >> 1, my, mx);
          int iy = (parts ? cb_y : oy) + (my >> 3) + cy;
          int ix = (parts ? cb_x : ox) + (mx >> 3) + cx;
          iy = tq_clip3(0, a.hc - 2, iy);
          ix = tq_clip3(0, a.wc - 2, ix);
          const uint8_t* qq = plane + (long long)iy * a.wc + ix;
          const int fy = my & 7, fx = mx & 7;
          const int v = ((8 - fx) * (8 - fy) * qq[0] + fx * (8 - fy) * qq[1]
                         + (8 - fx) * fy * qq[a.wc] + fx * fy * qq[a.wc + 1]
                         + 32) >> 6;
          word |= (uint32_t)v << (8 * j);
        }
        prow[y] = word;
      }
    }
    uint8_t* at = s.src_c[p][t] + 32 * bi + 4 * bj;
    int x[16], rec[16], lev[16];
#pragma unroll
    for (int y = 0; y < 4; ++y)
      tq_residual_row(x, y, *reinterpret_cast<const uint32_t*>(at + 8 * y),
                      prow[y]);
    const TqQuant q = tq_quant(qpc);
    tq_fdct(x);
    int dc_deq;
    const int dc_lev = tq_chroma_dc(x[0], q, bi, bj, dc_deq);
    tq_quant_block(x, lev, rec, q, a.dz);
    lev[0] = 0;
    rec[0] = dc_deq;
    tq_idct(rec);
#pragma unroll
    for (int y = 0; y < 4; ++y)
      *reinterpret_cast<uint32_t*>(at + 8 * y) = tq_recon_row(rec, y,
                                                              prow[y]);
    if (valid) {
      a.cdc[8 * k + g] = dc_lev;
      tq_store16(a.cac + 16 * (8 * k + g), lev);
      if (g == 0) {
        a.shape[k] = shape;
        a.inter_cost[k] = (int)cost;
      }
    }
  }

  // 6. the tile's reconstruction out by bulk stores
  tq_fence_async();
  __syncthreads();
  if (threadIdx.x < 32) {
    const int i = lane & 15;
    if (lane < 16 && i < cnt)
      tq_store(a.rec_y + 256 * (k0 + i), s.src_y[i], 256);
    if (lane == 16) tq_store(a.rec_u + 64 * k0, s.src_c[0], 64 * cnt);
    if (lane == 17) tq_store(a.rec_v + 64 * k0, s.src_c[1], 64 * cnt);
    tq_store_wait();
  }
}

}  // namespace

// The arguments, as `residual.inter_tiles` writes them: the 24 inputs' addresses (K5's 9
// null without partitions) and the 10 outputs', then n, mbw, mbh,
// qp_rows, hc, wc, guard_c, dz, kill, thr1_q8, thr2_q8, pen16x8, pen8x8
// and the stream.
extern "C" int h264lab_inter_residual(const long long* w) {
  const long long n = w[34];
  const int mbw = (int)w[35], mbh = (int)w[36], hc = (int)w[38],
            wc = (int)w[39];
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  const long long mbs = n * mbw * mbh;
  if (mbs >= (1ll << 31) * kTile || hc < 10 || wc < 10 || wc % 4)
    return (int)cudaErrorInvalidValue;
  auto p = [&](int i) { return (void*)w[i]; };
  Args a{(const uint8_t*)p(0), (const uint8_t*)p(1), (const uint8_t*)p(2),
         (const uint8_t*)p(3), (const uint8_t*)p(4), (const int32_t*)p(5),
         (const int32_t*)p(6), (const int32_t*)p(7), (const int32_t*)p(8),
         (const int32_t*)p(9), (const int32_t*)p(10), (const int32_t*)p(11),
         (const int32_t*)p(12), (const int32_t*)p(13), (const uint8_t*)p(14),
         (const int32_t*)p(15), (const int32_t*)p(16), (const int32_t*)p(17),
         (const long long*)p(18), (const long long*)p(19),
         (const long long*)p(20), (const int32_t*)p(21),
         (const int32_t*)p(22), (const int32_t*)p(23), (int32_t*)p(24),
         (int32_t*)p(25), (int32_t*)p(26), (int32_t*)p(27), (int32_t*)p(28),
         (uint8_t*)p(29), (uint8_t*)p(30), (uint8_t*)p(31), (int32_t*)p(32),
         (int32_t*)p(33), mbs, mbw * mbh, mbw, mbh, (int)w[37], hc, wc,
         (int)w[40], (int)w[41], (int)w[42], (int)w[43], (int)w[44],
         (int)w[45], (int)w[46]};
  inter_residual_kernel<<<(unsigned)((mbs + kTile - 1) / kTile), kThreads,
                          0, (cudaStream_t)p(47)>>>(a);
  return (int)cudaGetLastError();
}
