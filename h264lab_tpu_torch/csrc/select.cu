// K8 of h264lab_tpu_torch: the fully parallel mode decision of P frames
// (encode speeds 2 and up, no Intra_4x4), the `select` stage of those
// frames, written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces h264lab_tpu/models/mbscan.py:338-405 (the parallel P branch of
// `select_stage_core`) with the merge of the inter fields at :415-428,
// which the JAX package left to XLA (no Pallas kernel). It takes what the
// port's plain version `select_parallel_plain` (models/mbscan.py) takes,
// in the form `mbscan.select_parallel_args` packs, and writes what it
// returns, array for array (integer arithmetic throughout): sel, mode16,
// cmode, the Intra_16x16 levels of every MB, the merged chroma levels and
// reconstruction, the Intra_4x4 fills and the MV fields with intra MBs
// zeroed (lev_inter is the inter stage's, passed through by the wrapper).
//
// An MB may be Intra_16x16 only if it "wants intra" (its Intra_16x16 SAD
// plus the intra-in-P penalty is under its inter cost) and neither its
// left nor its top neighbour, where available, wants intra: every intra
// prediction then reads the inter stage's reconstruction. So an MB's
// decision reads its neighbours' "wants intra". One launch: each tile
// recomputes it for its halo, the MBs above its own and the MB before it,
// from the same inputs (1-D tiles of 16 MBs: 17 halo MBs, a group's
// VABSDIFF4 SADs each, their source from L2, where the row above was read
// a few tiles earlier). PR 20 ran two launches with a byte per MB between
// them; started by programmatic dependent launch, that design still
// waits for its whole first launch, which costs more than the halo
// (`tools/torch_k78_variants.py`, PERF.md §6).
//
// Bound. Each input is read once and each output written once: of an MB
// 384 B of source, the inter reconstruction (384 B) and cost, the inter
// chroma levels (544 B) and MVs (136 B) in; the levels of Intra_16x16 and
// chroma (1,632 B), the reconstruction (384 B), the MV fields (136 B) and
// the Intra_4x4 fills (192 B) out: about 3.8 KB an MB, 0.15 ms for 16
// frames of 1080p at 3.35 TB/s (chip_smoke.k8_bytes counts them). PR 20's
// kernel (a warp per MB) took 2.6x that: it was held by issue (about
// 2,500 warp instructions an MB, lanes 24-31 idle through the TQ, every
// lane in both DC codes) and by too few bytes in flight (dependent 4-byte
// loads).
//
// Design (PR 21): a block of 4 warps takes a tile of 16 consecutive MBs,
// a warp 4 of them, a group of 8 lanes one MB (lane g = lane & 7):
//   - the tile's inputs (source, inter reconstruction, chroma levels and
//     MV grids, 1,440 B an MB) come in by bulk copies (cp.async.bulk on
//     one mbarrier) issued by warp 0 before any arithmetic; the luma ones
//     a copy per MB into rows padded to 272 B, so that the four MBs of a
//     warp read distinct banks;
//   - "wants intra" (`wants_intra`) is a group's VABSDIFF4 SADs, a lane
//     two rows of 16 pixels, summed over the group: the tile's MBs, the
//     MBs above them, and (warp 0) the MB before the tile; the chroma SADs
//     a lane two rows of a plane;
//   - the luma TQ gives each lane two blocks, (g >> 2, g & 3) and the one
//     two rows below; the blocks' DCs are sums of their residuals, so the
//     DC Hadamard, its quantiser and its inverse run first, over shuffles
//     (tq_hadamard4), and each block is then coded once; the inverse and
//     the reconstruction only for Intra_16x16 MBs;
//   - the chroma TQ (Intra_16x16 MBs only) gives each lane one block,
//     plane g >> 2 (lanes 4 p + 2 bi + bj, tq_chroma_dc's layout);
//   - what an MB copies from the inter stage (reconstruction, chroma
//     levels, MV grids) goes back out of the same shared memory by bulk
//     stores, an Intra_16x16 MB's own values written over it first; the
//     levels go out in 16-byte stores from the lanes;
//   - at most 80 registers (6 blocks an SM; `tools/torch_k78_variants.py`
//     times 4 and 5).
//
// Plain C interface, loaded with ctypes; the entry point takes its
// arguments as one array of 64-bit words (in the order
// `residual.select_tiles` writes them), launches on the given stream,
// allocates nothing and returns the launch's error.

#include <cstdint>
#include <cuda_runtime.h>

#include "tq.h"

namespace {

constexpr int kTile = 16;                 // MBs a block
constexpr int kThreads = 128;             // 4 warps, 8 lanes an MB
constexpr int kRow = 272;                 // a luma MB's padded bytes
constexpr int kInvalid = 1 << 30;         // ops/intra.py INVALID_COST
// The bulk-loaded bytes of an MB: src_y, rec_y_i, src_u, src_v, rec_u_i,
// rec_v_i, cac_i, cdc_i, mv4_y_i, mv4_x_i
constexpr unsigned kInBytes = 256 + 256 + 4 * 64 + 512 + 32 + 2 * 64;

struct Args {
  const uint8_t* src_y;     // (N, nmb, 16, 16)
  const uint8_t* src_u;     // (N, nmb, 8, 8)
  const uint8_t* src_v;
  const int32_t* qp;        // (N,) or (N, mbh) with qp_rows
  const int32_t* qpc;
  const uint8_t* avail;     // (2, nmb): top, then left
  const int32_t* inter_cost;  // (N, nmb)
  const uint8_t* rec_y_i;   // (N, nmb, 16, 16) the inter reconstruction
  const uint8_t* rec_u_i;   // (N, nmb, 8, 8)
  const uint8_t* rec_v_i;
  const int32_t* cdc_i;     // (N, nmb, 2, 2, 2)
  const int32_t* cac_i;     // (N, nmb, 2, 2, 2, 4, 4)
  const int32_t* mv_y_i;    // (N, nmb)
  const int32_t* mv_x_i;
  const int32_t* mv4_y_i;   // (N, nmb, 4, 4)
  const int32_t* mv4_x_i;
  const int32_t* shape_i;   // (N, nmb)
  int32_t* sel;             // (N, nmb)
  int32_t* mode16;
  int32_t* cmode;
  int32_t* dc_lev;          // (N, nmb, 4, 4)
  int32_t* ac_lev;          // (N, nmb, 4, 4, 4, 4)
  int32_t* cdc;             // (N, nmb, 2, 2, 2)
  int32_t* cac;             // (N, nmb, 2, 2, 2, 4, 4)
  uint8_t* rec_y;           // (N, nmb, 16, 16)
  uint8_t* rec_u;           // (N, nmb, 8, 8)
  uint8_t* rec_v;
  int32_t* i4modes;         // (N, nmb, 16)
  int32_t* i4sym_v;
  int32_t* i4sym_l;
  int32_t* mv_y;            // (N, nmb)
  int32_t* mv_x;
  int32_t* shape;
  int32_t* mv4_y;           // (N, nmb, 4, 4)
  int32_t* mv4_x;
  long long mbs;
  int nmb, mbw, mbh, qp_rows, dz, pen_bits;
};

// The MB's place: frame n, index m in the frame, row r.
struct Mb {
  int n, m, r;
  bool top, left;           // avail_top, avail_left
};

__device__ __forceinline__ Mb locate(const Args& a, long long k) {
  Mb b;
  b.n = (int)(k / a.nmb);
  b.m = (int)(k - (long long)b.n * a.nmb);
  b.r = b.m / a.mbw;
  b.top = a.avail[b.m] != 0;
  b.left = a.avail[a.nmb + b.m] != 0;
  return b;
}

// The Intra_16x16 DC prediction (intra.predict_16x16) from the sums of
// the top and left edges.
__device__ __forceinline__ int luma_dc(const Mb& b, int st, int sl) {
  return b.top && b.left ? (st + sl + 16) >> 5
         : b.top ? (st + 8) >> 4 : b.left ? (sl + 8) >> 4 : 128;
}

// intra.select_mode of the three Intra_16x16 SADs: the first valid least
// of V, H, DC.
__device__ __forceinline__ int luma_mode(const Mb& b, int v, int h, int dc,
                                         int& cost) {
  int mode = 0;
  cost = b.top ? v : kInvalid;
  if ((b.left ? h : kInvalid) < cost) {
    cost = h;
    mode = 1;
  }
  if (dc < cost) {
    cost = dc;
    mode = 2;
  }
  return mode;
}

// Whether MB k wants intra (intra.select_mode's first valid least
// Intra_16x16 SAD plus the intra-in-P penalty under its inter cost), and
// its mode16: a group of 8 lanes, lane g rows 2 g and 2 g + 1, the sums
// over the group; every lane of the warp calls it together. The edges are
// the inter reconstruction's bottom row of the MB above (0 on the frame's
// first row) and the right column of the MB before it in raster order (0
// for the frame's first MB), as the plain version's `above` and `left`
// build them; the lane's are handed back (`top`, rows `l0`, `l1`).
__device__ __forceinline__ bool wants_intra(const Args& a, long long k,
                                            int g, int& mode, uint4& top,
                                            int& l0, int& l1) {
  const Mb b = locate(a, k);
  top = make_uint4(0, 0, 0, 0);
  if (b.m >= a.mbw)
    top = *reinterpret_cast<const uint4*>(a.rec_y_i + 256 * (k - a.mbw)
                                          + 240);
  l0 = l1 = 0;
  if (b.m >= 1) {
    const uint8_t* c = a.rec_y_i + 256 * (k - 1) + 32 * g + 15;
    l0 = c[0];
    l1 = c[16];
  }
  const uint4* src = reinterpret_cast<const uint4*>(a.src_y + 256 * k
                                                    + 32 * g);
  const uint4 x = src[0], y = src[1];
  const int cost_i = a.inter_cost[k];
  const int qp0 = a.qp[a.qp_rows ? b.n * a.mbh : b.n];
  const int st = (int)tq_sad4(top.x, 0, tq_sad4(top.y, 0, tq_sad4(
      top.z, 0, tq_sad4(top.w, 0, 0))));
  const int sl = tq_sum8(l0 + l1);
  const uint32_t dc = tq_splat(luma_dc(b, st, sl));
  const uint32_t h0 = tq_splat(l0), h1 = tq_splat(l1);
  uint32_t sv = 0, sh = 0, sd = 0;
  sv = tq_sad4(x.x, top.x, tq_sad4(x.y, top.y, tq_sad4(x.z, top.z,
       tq_sad4(x.w, top.w, sv))));
  sv = tq_sad4(y.x, top.x, tq_sad4(y.y, top.y, tq_sad4(y.z, top.z,
       tq_sad4(y.w, top.w, sv))));
  sh = tq_sad4(x.x, h0, tq_sad4(x.y, h0, tq_sad4(x.z, h0,
       tq_sad4(x.w, h0, sh))));
  sh = tq_sad4(y.x, h1, tq_sad4(y.y, h1, tq_sad4(y.z, h1,
       tq_sad4(y.w, h1, sh))));
  sd = tq_sad4(x.x, dc, tq_sad4(x.y, dc, tq_sad4(x.z, dc,
       tq_sad4(x.w, dc, sd))));
  sd = tq_sad4(y.x, dc, tq_sad4(y.y, dc, tq_sad4(y.z, dc,
       tq_sad4(y.w, dc, sd))));
  int cost;
  mode = luma_mode(b, tq_sum8((int)sv), tq_sum8((int)sh), tq_sum8((int)sd),
                   cost);
  return cost + kTqLambda[qp0] * a.pen_bits < cost_i;
}

// The kernel's shared memory: the tile's inputs as the bulk copies leave them (the
// luma ones in padded rows), overwritten by an Intra_16x16 MB's own
// reconstruction, chroma levels and zero MVs before the bulk stores; the
// edges of each MB.
struct alignas(16) CodeSmem {
  uint8_t src_y[kTile][kRow];
  uint8_t rec_y[kTile][kRow];       // rec_y_i in, rec_y out
  uint8_t src_c[2][kTile][64];      // src_u, src_v
  uint8_t rec_c[2][kTile][64];      // rec_u_i, rec_v_i in; out
  int32_t cac[kTile][128];          // cac_i in, cac out
  int32_t cdc[kTile][8];
  int32_t mv4[2][kTile][16];        // mv4_y_i, mv4_x_i in; out
  uint8_t edge[kTile][32];          // luma: top 16, left 16
  uint8_t cedge[kTile][2][16];      // chroma: top 8, left 8 a plane
  bool want[2][kTile];              // wants intra: the MB, the MB above
  bool want_left;                   // the MB before the tile
  alignas(8) unsigned long long bar;
};

// The chroma DC prediction of quadrant (qy, qx) of a plane
// (intra.predict_chroma): `e` its edge samples, the top 8, then the left
// 8.
__device__ __forceinline__ int chroma_dc(const uint8_t* e, bool top,
                                         bool left, int qy, int qx) {
  const uint32_t wt = reinterpret_cast<const uint32_t*>(e)[qx];
  const uint32_t wl = reinterpret_cast<const uint32_t*>(e)[2 + qy];
  const int st = (int)tq_sad4(wt, 0, 0), sl = (int)tq_sad4(wl, 0, 0);
  const int t = (st + 2) >> 2, lf = (sl + 2) >> 2;
  if (qy == qx) return top && left ? (st + sl + 4) >> 3
                       : top ? t : left ? lf : 128;
  if (qy == 0) return top ? t : left ? lf : 128;    // top right: top first
  return left ? lf : top ? t : 128;                 // bottom left
}

// The DC of a block's forward transform, the sum of its residual, from
// its source and prediction rows (four bytes a word).
__device__ __forceinline__ int word_dc(const uint32_t* s, const uint32_t* p) {
  int d = 0;
#pragma unroll
  for (int y = 0; y < 4; ++y)
    d += (int)tq_sad4(s[y], 0, 0) - (int)tq_sad4(p[y], 0, 0);
  return d;
}

// A block's reconstruction rows from its levels (the DC replaced by
// `dc_deq`) and its prediction words, into `out` at a row stride.
__device__ __forceinline__ void recon_block(int* lev, int dc_deq,
                                            const TqQuant& q,
                                            const uint32_t* pred,
                                            uint8_t* out, int stride) {
  tq_dequant(lev, lev, q);
  lev[0] = dc_deq;
  tq_idct(lev);
#pragma unroll
  for (int y = 0; y < 4; ++y)
    *reinterpret_cast<uint32_t*>(out + stride * y) =
        tq_recon_row(lev, y, pred[y]);
}

__global__ void __launch_bounds__(kThreads, 6)
select_parallel_kernel(const Args a) {
  __shared__ CodeSmem s;
  const int lane = threadIdx.x & 31, g = lane & 7, t = threadIdx.x >> 3;
  const long long k0 = (long long)blockIdx.x * kTile;
  const int cnt = (int)min((long long)kTile, a.mbs - k0);

  // 1. the tile's inputs by bulk copies: warp 0, a lane per luma MB
  // array, lanes 0-7 one whole-tile array each after it
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
        tq_load(s.rec_y[i], a.rec_y_i + 256 * (k0 + i), 256, &s.bar);
    }
    const unsigned c64 = 64 * cnt;
    switch (lane) {
      case 0: tq_load(s.src_c[0], a.src_u + 64 * k0, c64, &s.bar); break;
      case 1: tq_load(s.src_c[1], a.src_v + 64 * k0, c64, &s.bar); break;
      case 2: tq_load(s.rec_c[0], a.rec_u_i + 64 * k0, c64, &s.bar); break;
      case 3: tq_load(s.rec_c[1], a.rec_v_i + 64 * k0, c64, &s.bar); break;
      case 4: tq_load(s.cac, a.cac_i + 128 * k0, 8 * c64, &s.bar); break;
      case 5: tq_load(s.cdc, a.cdc_i + 8 * k0, c64 / 2, &s.bar); break;
      case 6: tq_load(s.mv4[0], a.mv4_y_i + 16 * k0, c64, &s.bar); break;
      case 7: tq_load(s.mv4[1], a.mv4_x_i + 16 * k0, c64, &s.bar); break;
    }
  }
  __syncthreads();                  // the mbarrier's init before its waits

  const long long kt = k0 + t;
  const bool valid = kt < a.mbs;
  const long long k = valid ? kt : a.mbs - 1;
  const Mb b = locate(a, k);
  const int qrow = a.qp_rows ? b.n * a.mbh + b.r : b.n;
  const int qp = a.qp[qrow], qpc = a.qpc[qrow];

  // 2. "wants intra" of the tile's MBs (their mode16 and luma edges too),
  // of the MBs above them, and (warp 0) of the MB before the tile: the
  // decision's halo, recomputed here
  int mode;
  {
    uint4 top, t1;
    int l0, l1, m1, a1, b1;
    const bool own = wants_intra(a, k, g, mode, top, l0, l1);
    const bool up = wants_intra(a, max(k - a.mbw, 0ll), g, m1, t1, a1, b1);
    if (g == 0) {
      s.want[0][t] = own;
      s.want[1][t] = up;
      if (valid) a.mode16[k] = mode;
    }
    if (threadIdx.x < 32) {
      const bool left = wants_intra(a, max(k0 - 1, 0ll), g, m1, t1, a1, b1);
      if (threadIdx.x == 0) s.want_left = left;
    }
    // the luma edges: lane g the top word g (g < 4), left rows 2 g, 2 g + 1
    uint8_t* e = s.edge[t];
    if (g < 4)
      reinterpret_cast<uint32_t*>(e)[g] = g == 0 ? top.x : g == 1 ? top.y
                                        : g == 2 ? top.z : top.w;
    e[16 + 2 * g] = (uint8_t)l0;
    e[17 + 2 * g] = (uint8_t)l1;
  }

  // 3. the chroma edges of the MB, from the inter reconstruction of its
  // neighbours (0 where the plain version has 0): lane g, plane g >> 2, the
  // top bytes 2 i, 2 i + 1 and left rows 2 i, 2 i + 1 (i = g & 3)
  {
    const bool up = b.m >= a.mbw, before = b.m >= 1;
    const int p = g >> 2, i = g & 3;
    const uint8_t* rc = p ? a.rec_v_i : a.rec_u_i;
    uint8_t* ce = s.cedge[t][p];
    const uint8_t* ct = rc + 64 * (k - a.mbw) + 56 + 2 * i;
    ce[2 * i] = up ? ct[0] : 0;
    ce[2 * i + 1] = up ? ct[1] : 0;
    const uint8_t* cl = rc + 64 * (k - 1) + 16 * i + 7;
    ce[8 + 2 * i] = before ? cl[0] : 0;
    ce[9 + 2 * i] = before ? cl[8] : 0;
  }
  __syncthreads();                  // every group's wants and edges

  // the decision: Intra_16x16 only if it wants intra and neither available
  // neighbour does (the MB before it is the tile's previous one, or the
  // MB before the tile)
  const bool i16 = s.want[0][t]
                   && !(b.left && b.m >= 1
                        && (t > 0 ? s.want[0][t - 1] : s.want_left))
                   && !(b.top && b.m >= a.mbw && s.want[1][t]);
  const uint8_t* e = s.edge[t];
  const uint32_t* etop = reinterpret_cast<const uint32_t*>(e);
  const uint32_t* eleft = reinterpret_cast<const uint32_t*>(e + 16);
  const int st = (int)tq_sad4(etop[0], 0, tq_sad4(etop[1], 0, tq_sad4(
      etop[2], 0, tq_sad4(etop[3], 0, 0))));
  const int sl = (int)tq_sad4(eleft[0], 0, tq_sad4(eleft[1], 0, tq_sad4(
      eleft[2], 0, tq_sad4(eleft[3], 0, 0))));
  const int dc = luma_dc(b, st, sl);
  tq_mbar_wait(&s.bar);

  // 4. chroma prediction: the summed U + V SAD of DC (per quadrant), H and
  // V; lane g: plane g >> 2, rows 2 i and 2 i + 1 (i = g & 3)
  int cmode;
  {
    const int p = g >> 2, i = g & 3;
    const uint8_t* ce = s.cedge[t][p];
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(s.src_c[p][t]
                                                           + 16 * i);
    const uint32_t* ct = reinterpret_cast<const uint32_t*>(ce);
    const uint32_t d0 = tq_splat(chroma_dc(ce, b.top, b.left, i >> 1, 0));
    const uint32_t d1 = tq_splat(chroma_dc(ce, b.top, b.left, i >> 1, 1));
    const uint32_t h0 = tq_splat(ce[8 + 2 * i]), h1 = tq_splat(ce[9 + 2 * i]);
    uint32_t sd = 0, sh = 0, sv = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      sd = tq_sad4(sw[w], (w & 1) ? d1 : d0, sd);
      sh = tq_sad4(sw[w], w < 2 ? h0 : h1, sh);
      sv = tq_sad4(sw[w], ct[w & 1], sv);
    }
    const int sad_dc = tq_sum8((int)sd), sad_h = tq_sum8((int)sh),
              sad_v = tq_sum8((int)sv);
    // the first valid least of DC, H, V
    cmode = 0;
    int best = sad_dc;
    if ((b.left ? sad_h : kInvalid) < best) {
      best = sad_h;
      cmode = 1;
    }
    if ((b.top ? sad_v : kInvalid) < best) cmode = 2;
  }

  // 5. the Intra_16x16 TQ of every MB: lane g blocks (bi, bj) and (bi + 2,
  // bj), bi = g >> 2, bj = g & 3; their DCs first
  {
    const int bi = g >> 2, bj = g & 3;
    const uint32_t pv = etop[bj];
    uint32_t src[2][4], pred[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int row = 4 * (bi + 2 * h) + y;
        src[h][y] = *reinterpret_cast<const uint32_t*>(
            s.src_y[t] + 16 * row + 4 * bj);
        pred[h][y] = mode == 0 ? pv : mode == 1 ? tq_splat(e[16 + row])
                                                : tq_splat(dc);
      }
    const TqQuant q = tq_quant(qp);
    // transform.quant_luma_dc and dequant_luma_dc over the group
    int d0 = word_dc(src[0], pred[0]), d1 = word_dc(src[1], pred[1]);
    tq_hadamard4(d0, d1, lane);
    const int qbits = 17 + q.div6;
    d0 = tq_sgn_mag(d0, (abs(d0) * q.mf[0] + (1 << (qbits - 1))) >> qbits);
    d1 = tq_sgn_mag(d1, (abs(d1) * q.mf[0] + (1 << (qbits - 1))) >> qbits);
    if (valid) {
      a.dc_lev[16 * k + 4 * bi + bj] = d0;
      a.dc_lev[16 * k + 4 * (bi + 2) + bj] = d1;
    }
    tq_hadamard4(d0, d1, lane);
    int deq[2] = {d0 * q.v[0], d1 * q.v[0]};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      deq[h] = q.div6 >= 2 ? deq[h] * (1 << (q.div6 - 2))
                           : (deq[h] + (1 << (1 - q.div6))) >> (2 - q.div6);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int blk = 4 * (bi + 2 * h) + bj;
      int x[16], lev[16];
#pragma unroll
      for (int y = 0; y < 4; ++y) tq_residual_row(x, y, src[h][y],
                                                  pred[h][y]);
      tq_fdct(x);
      tq_quant_levels(x, lev, q, a.dz);
      lev[0] = 0;
      if (valid) tq_store16(a.ac_lev + 256 * k + 16 * blk, lev);
      if (i16)
        recon_block(lev, deq[h], q, pred[h],
                    s.rec_y[t] + 64 * (bi + 2 * h) + 4 * bj, 16);
    }
  }

  // 6. the chroma TQ of the Intra_16x16 MBs: lane g block (bi, bj) of
  // plane p, g = 4 p + 2 bi + bj
  if (__any_sync(kTqFull, i16)) {
    const int p = g >> 2, bi = (g >> 1) & 1, bj = g & 1;
    const uint8_t* ce = s.cedge[t][p];
    const uint32_t cdc = tq_splat(chroma_dc(ce, b.top, b.left, bi, bj));
    uint32_t pred[4];
    int x[16];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      pred[y] = cmode == 0 ? cdc
              : cmode == 1 ? tq_splat(ce[8 + 4 * bi + y])
                           : reinterpret_cast<const uint32_t*>(ce)[bj];
      tq_residual_row(x, y, *reinterpret_cast<const uint32_t*>(
          s.src_c[p][t] + 32 * bi + 8 * y + 4 * bj), pred[y]);
    }
    const TqQuant q = tq_quant(qpc);
    tq_fdct(x);
    int dc_deq;
    const int dc_lev = tq_chroma_dc(x[0], q, bi, bj, dc_deq);
    int lev[16];
    tq_quant_levels(x, lev, q, a.dz);
    lev[0] = 0;
    if (i16 && valid) {
      s.cdc[t][g] = dc_lev;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        reinterpret_cast<int4*>(s.cac[t] + 16 * g)[i] =
            make_int4(lev[4 * i], lev[4 * i + 1], lev[4 * i + 2],
                      lev[4 * i + 3]);
      recon_block(lev, dc_deq, q, pred, s.rec_c[p][t] + 32 * bi + 4 * bj,
                  8);
    }
  }

  // 7. the fields: an Intra_16x16 MB's MV grids zeroed in shared memory;
  // the per-MB words and the Intra_4x4 fills from the lanes
  if (valid) {
    if (i16) {
      reinterpret_cast<int2*>(s.mv4[0][t])[g] = make_int2(0, 0);
      reinterpret_cast<int2*>(s.mv4[1][t])[g] = make_int2(0, 0);
    }
    if (g == 0) {
      a.sel[k] = i16 ? TQ_SEL_I16 : TQ_SEL_INTER;
      a.cmode[k] = cmode;
      a.mv_y[k] = i16 ? 0 : a.mv_y_i[k];
      a.mv_x[k] = i16 ? 0 : a.mv_x_i[k];
      a.shape[k] = i16 ? 0 : a.shape_i[k];
    }
    // 12 stores of 16 B an MB: i4modes (2), i4sym_v and i4sym_l (0)
    for (int w = g; w < 12; w += 8) {
      int32_t* to = (w < 4 ? a.i4modes : w < 8 ? a.i4sym_v : a.i4sym_l)
                    + 16 * k + 4 * (w & 3);
      const int v = w < 4 ? 2 : 0;
      *reinterpret_cast<int4*>(to) = make_int4(v, v, v, v);
    }
  }

  // 8. the tile's copied-or-coded arrays back out by bulk stores
  tq_fence_async();
  __syncthreads();
  if (threadIdx.x < 32) {
    const int i = lane & 15;
    if (lane < 16 && i < cnt)
      tq_store(a.rec_y + 256 * (k0 + i), s.rec_y[i], 256);
    const unsigned c64 = 64 * cnt;
    switch (lane) {
      case 16: tq_store(a.rec_u + 64 * k0, s.rec_c[0], c64); break;
      case 17: tq_store(a.rec_v + 64 * k0, s.rec_c[1], c64); break;
      case 18: tq_store(a.cac + 128 * k0, s.cac, 8 * c64); break;
      case 19: tq_store(a.cdc + 8 * k0, s.cdc, c64 / 2); break;
      case 20: tq_store(a.mv4_y + 16 * k0, s.mv4[0], c64); break;
      case 21: tq_store(a.mv4_x + 16 * k0, s.mv4[1], c64); break;
    }
    tq_store_wait();
  }
}

}  // namespace

// The arguments, as `residual.select_tiles` writes them: the 17 inputs'
// and 18 outputs' addresses, then n, mbw, mbh, qp_rows, dz, pen_bits and
// the stream.
extern "C" int h264lab_select_parallel(const long long* w) {
  const long long n = w[35];
  const int mbw = (int)w[36], mbh = (int)w[37];
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  const long long mbs = n * mbw * mbh;
  if (mbs >= (1ll << 31) * kTile) return (int)cudaErrorInvalidValue;
  auto p = [&](int i) { return (void*)w[i]; };
  Args a{(const uint8_t*)p(0), (const uint8_t*)p(1), (const uint8_t*)p(2),
         (const int32_t*)p(3), (const int32_t*)p(4), (const uint8_t*)p(5),
         (const int32_t*)p(6), (const uint8_t*)p(7), (const uint8_t*)p(8),
         (const uint8_t*)p(9), (const int32_t*)p(10), (const int32_t*)p(11),
         (const int32_t*)p(12), (const int32_t*)p(13), (const int32_t*)p(14),
         (const int32_t*)p(15), (const int32_t*)p(16), (int32_t*)p(17),
         (int32_t*)p(18), (int32_t*)p(19), (int32_t*)p(20), (int32_t*)p(21),
         (int32_t*)p(22), (int32_t*)p(23), (uint8_t*)p(24), (uint8_t*)p(25),
         (uint8_t*)p(26), (int32_t*)p(27), (int32_t*)p(28), (int32_t*)p(29),
         (int32_t*)p(30), (int32_t*)p(31), (int32_t*)p(32), (int32_t*)p(33),
         (int32_t*)p(34), mbs, mbw * mbh, mbw, mbh, (int)w[38], (int)w[39],
         (int)w[40]};
  select_parallel_kernel<<<(unsigned)((mbs + kTile - 1) / kTile), kThreads,
                           0, (cudaStream_t)p(41)>>>(a);
  return (int)cudaGetLastError();
}
