// K8 of h264lab_tpu_torch: the fully parallel mode decision of P frames
// (encode speeds 2 and up, no Intra_4x4), the `select` stage of those
// frames, written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces h264lab_tpu/models/mbscan.py:338-405 (the parallel P branch of
// `select_stage_core`) with the merge of the inter fields at :415-428,
// which the JAX package left to XLA (no Pallas kernel). In the port that
// branch was about 450 eager operations a P step, each a launch and a few
// microseconds of host issue: the stage was bound by host issue (PERF.md
// §5). It takes what the port's plain version `select_parallel_plain`
// (models/mbscan.py) takes, in the form `mbscan.select_parallel_args`
// packs, and writes what it returns, array for array (integer arithmetic
// throughout): sel, mode16, cmode, the Intra_16x16 levels of every MB, the
// merged chroma levels and reconstruction, the Intra_4x4 fills and the MV
// fields with intra MBs zeroed (lev_inter is the inter stage's, passed
// through by the wrapper).
//
// An MB may be Intra_16x16 only if it "wants intra" (its Intra_16x16 SAD
// plus the intra-in-P penalty is under its inter cost) and neither its
// left nor its top neighbour, where available, wants intra: every intra
// prediction then reads the inter stage's reconstruction. So an MB's
// decision reads its neighbours' "wants intra". Two launches, in stream
// order:
//   A. `select_want_kernel`, a warp per MB: the MB's three Intra_16x16
//      predictions from the inter reconstruction of the MB above and the
//      MB before it, their SADs (a lane 8 pixels, a warp sum each), the
//      first valid least one, mode16, and one byte per MB, whether it
//      wants intra;
//   B. `select_code_kernel`, a warp per MB: the decision from its own byte
//      and its neighbours', then the Intra_16x16 TQ of the MB (lanes 0-15
//      a block each; the luma DC Hadamard through shared memory), the
//      chroma intra prediction (the per-quadrant DC, H and V, the summed
//      U + V SAD), the chroma TQ (lanes 16-23 a block each), and the
//      merged outputs.
// Recomputing the left and top neighbours' SADs inside one launch would
// read three MBs' source and edges and triple the SAD work, the largest
// part of A; the byte per MB costs 130 KB at 16 frames of 1080p and one
// launch of a few microseconds, and stream order is the grid-wide barrier
// the decision needs.
//
// Bound. Each input is read once and each output written once: of an MB
// 384 B of source, the inter reconstruction (384 B) and cost, the inter
// chroma levels (544 B) and MVs (136 B) in; the levels of Intra_16x16 and
// chroma (1,632 B), the reconstruction (384 B), the MV fields (136 B) and
// the Intra_4x4 fills (192 B) out: about 3.8 KB an MB, 0.15 ms for 16
// frames of 1080p at 3.35 TB/s (chip_smoke.k8_bytes counts them). The
// neighbours' edges and bytes come again from L2, and the arithmetic
// (the SADs of 3 luma and 3 chroma modes, 24 block transforms) is a few
// thousand integer operations an MB: the bytes bound it.
//
// Plain C interface, loaded with ctypes; the entry point launches both
// kernels on the given stream, allocates nothing (the caller hands it the
// byte-per-MB scratch) and returns the launches' error.

#include <cstdint>
#include <cuda_runtime.h>

#include "tq.h"

namespace {

constexpr int kWarps = 4;                 // MBs a block
constexpr int kInvalid = 1 << 30;         // ops/intra.py INVALID_COST

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
  uint8_t* want;            // (N, nmb) scratch: A writes, B reads
  long long mbs;
  int nmb, mbw, mbh, qp_rows, dz, pen_bits;
};

// The MB's place: frame n, index m in the frame, row r.
struct Mb {
  long long k;
  int n, m, r;
  bool top, left;           // avail_top, avail_left
};

__device__ __forceinline__ Mb locate(const Args& a, long long k) {
  Mb b;
  b.k = k;
  b.n = (int)(k / a.nmb);
  b.m = (int)(k - (long long)b.n * a.nmb);
  b.r = b.m / a.mbw;
  b.top = a.avail[b.m] != 0;
  b.left = a.avail[a.nmb + b.m] != 0;
  return b;
}

// Lane l's luma edge sample of the MB: the top row (the inter
// reconstruction's bottom row of the MB above, 0 on the frame's first row)
// on lanes 0-15, the left column (the right column of the MB before it in
// raster order, 0 for the frame's first MB) on lanes 16-31, as the plain
// version's `above` and `left` build them.
__device__ __forceinline__ int luma_edge(const Args& a, const Mb& b, int l) {
  if (l < 16)
    return b.m >= a.mbw ? a.rec_y_i[256 * (b.k - a.mbw) + 240 + l] : 0;
  return b.m >= 1 ? a.rec_y_i[256 * (b.k - 1) + 16 * (l - 16) + 15] : 0;
}

// The Intra_16x16 DC prediction (intra.predict_16x16), from the lanes'
// edge samples.
__device__ __forceinline__ int luma_dc(const Mb& b, int e, int l) {
  const int st = __reduce_add_sync(kTqFull, l < 16 ? e : 0);
  const int sl = __reduce_add_sync(kTqFull, l < 16 ? 0 : e);
  return b.top && b.left ? (st + sl + 16) >> 5
         : b.top ? (st + 8) >> 4 : b.left ? (sl + 8) >> 4 : 128;
}

__global__ void __launch_bounds__(kWarps * 32)
select_want_kernel(const Args a) {
  __shared__ uint8_t edge[kWarps][32];      // top 16, left 16
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kWarps + warp;
  if (k >= a.mbs) return;                   // the whole warp
  const Mb b = locate(a, k);
  const int e = luma_edge(a, b, l);
  edge[warp][l] = (uint8_t)e;
  const int dc = luma_dc(b, e, l);
  __syncwarp();
  // lane l: row l >> 1, columns x0..x0 + 7
  const int y = l >> 1, x0 = (l & 1) * 8;
  const uint2 s = *reinterpret_cast<const uint2*>(a.src_y + 256 * k + 16 * y
                                                  + x0);
  const int left = edge[warp][16 + y];
  int sad_v = 0, sad_h = 0, sad_dc = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int v = ((j < 4 ? s.x : s.y) >> (8 * (j & 3))) & 0xff;
    sad_v += abs(v - edge[warp][x0 + j]);
    sad_h += abs(v - left);
    sad_dc += abs(v - dc);
  }
  sad_v = __reduce_add_sync(kTqFull, sad_v);
  sad_h = __reduce_add_sync(kTqFull, sad_h);
  sad_dc = __reduce_add_sync(kTqFull, sad_dc);
  // intra.select_mode: the first valid least of V, H, DC
  int mode = 0, cost = b.top ? sad_v : kInvalid;
  if ((b.left ? sad_h : kInvalid) < cost) {
    cost = sad_h;
    mode = 1;
  }
  if (sad_dc < cost) {
    cost = sad_dc;
    mode = 2;
  }
  if (l == 0) {
    const int qp0 = a.qp[a.qp_rows ? b.n * a.mbh : b.n];
    a.mode16[k] = mode;
    a.want[k] = cost + kTqLambda[qp0] * a.pen_bits < a.inter_cost[k];
  }
}

// The luma DC Hadamard (transform.hadamard4x4) of a block grid in shared
// memory: output (i, j) = sum over (p, q) of H[i][p] H[j][q] x[p][q], H
// the symmetric rows (1 1 1 1) (1 1 -1 -1) (1 -1 -1 1) (1 -1 1 -1), a bit
// of 0xA6C0 at 4 i + p where H[i][p] is -1.
__device__ __forceinline__ int hadamard4(const int* x, int i, int j) {
  int out = 0;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    int row = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      row += (0xA6C0 >> (4 * j + q)) & 1 ? -x[4 * p + q] : x[4 * p + q];
    out += (0xA6C0 >> (4 * i + p)) & 1 ? -row : row;
  }
  return out;
}

// The chroma DC prediction of quadrant (qy, qx) of a plane
// (intra.predict_chroma): `e` its edge samples, the top 8, then the left
// 8.
__device__ __forceinline__ int chroma_dc(const uint8_t* e, bool top,
                                         bool left, int qy, int qx) {
  const int st = e[4 * qx] + e[4 * qx + 1] + e[4 * qx + 2] + e[4 * qx + 3];
  const int sl = e[8 + 4 * qy] + e[9 + 4 * qy] + e[10 + 4 * qy]
                 + e[11 + 4 * qy];
  const int t = (st + 2) >> 2, lf = (sl + 2) >> 2;
  if (qy == qx) return top && left ? (st + sl + 4) >> 3
                       : top ? t : left ? lf : 128;
  if (qy == 0) return top ? t : left ? lf : 128;    // top right: top first
  return left ? lf : top ? t : 128;                 // bottom left
}

__global__ void __launch_bounds__(kWarps * 32)
select_code_kernel(const Args a) {
  __shared__ uint8_t edge[kWarps][32];      // luma: top 16, left 16
  __shared__ uint8_t cedge[kWarps][2][16];  // chroma: top 8, left 8 a plane
  __shared__ int dcs[kWarps][16];           // luma DC coefficients, levels
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const long long k = (long long)blockIdx.x * kWarps + warp;
  if (k >= a.mbs) return;                   // the whole warp
  const Mb b = locate(a, k);
  const int qrow = a.qp_rows ? b.n * a.mbh + b.r : b.n;
  const int qp = a.qp[qrow], qpc = a.qpc[qrow];
  // Intra_16x16 only if it wants intra and neither available neighbour
  // does (the neighbours' bytes, 0 before the frame's first MB or row)
  const bool i16 = a.want[k]
                   && !(b.left && b.m >= 1 && a.want[k - 1])
                   && !(b.top && b.m >= a.mbw && a.want[k - a.mbw]);
  const int mode = a.mode16[k];
  const int e = luma_edge(a, b, l);
  edge[warp][l] = (uint8_t)e;
  const int dc = luma_dc(b, e, l);
  // chroma edges: lane l, plane l >> 4, top (j < 8) or left sample j - 8
  {
    const int p = l >> 4, j = l & 15;
    const uint8_t* rec = p ? a.rec_v_i : a.rec_u_i;
    cedge[warp][p][j] = j < 8 ? (b.m >= a.mbw ? rec[64 * (k - a.mbw) + 56 + j]
                                              : 0)
                              : (b.m >= 1 ? rec[64 * (k - 1) + 8 * (j - 8) + 7]
                                          : 0);
  }
  __syncwarp();

  // chroma prediction: the summed U + V SAD of DC (per quadrant), H and
  // V; lane l: plane l >> 4, row y, pixels x0..x0 + 3
  int cmode;
  {
    const int p = l >> 4, y = (l & 15) >> 1, x0 = (l & 1) * 4;
    const uint32_t s = *reinterpret_cast<const uint32_t*>(
        (p ? a.src_v : a.src_u) + 64 * k + 8 * y + x0);
    const int dcv = chroma_dc(cedge[warp][p], b.top, b.left, y >> 2, x0 >> 2);
    const int h = cedge[warp][p][8 + y];
    int sad[3] = {0, 0, 0};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = (s >> (8 * j)) & 0xff;
      sad[0] += abs(v - dcv);
      sad[1] += abs(v - h);
      sad[2] += abs(v - cedge[warp][p][x0 + j]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) sad[i] = __reduce_add_sync(kTqFull, sad[i]);
    // the first valid least of DC, H, V
    cmode = 0;
    int best = sad[0];
    if ((b.left ? sad[1] : kInvalid) < best) {
      best = sad[1];
      cmode = 1;
    }
    if ((b.top ? sad[2] : kInvalid) < best) cmode = 2;
  }

  // the TQ: luma block l on lanes 0-15, chroma block l - 16 on 16-23
  const bool luma = l < 16;
  const int cb = (l - 16) & 7, cp = cb >> 2;
  const int bi = luma ? l >> 2 : (cb >> 1) & 1;
  const int bj = luma ? l & 3 : cb & 1;
  int x[16], rec[16], lev[16];
  uint32_t prow[4];
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    uint32_t src, pred = 0;
    if (luma) {
      src = *reinterpret_cast<const uint32_t*>(a.src_y + 256 * k + 64 * bi
                                               + 16 * y + 4 * bj);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = mode == 0 ? edge[warp][4 * bj + j]
                    : mode == 1 ? edge[warp][16 + 4 * bi + y] : dc;
        pred |= (uint32_t)v << (8 * j);
      }
    } else {
      src = *reinterpret_cast<const uint32_t*>(
          (cp ? a.src_v : a.src_u) + 64 * k + 32 * bi + 8 * y + 4 * bj);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = cmode == 0 ? chroma_dc(cedge[warp][cp], b.top, b.left,
                                             bi, bj)
                    : cmode == 1 ? cedge[warp][cp][8 + 4 * bi + y]
                                 : cedge[warp][cp][4 * bj + j];
        pred |= (uint32_t)v << (8 * j);
      }
    }
    prow[y] = pred;
    tq_residual_row(x, y, src, pred);
  }
  const TqQuant q = tq_quant(luma ? qp : qpc);
  tq_fdct(x);
  // chroma DC on lanes 16-23 (every lane shuffles)
  int dc_deq;
  const int cdc_lev = tq_chroma_dc(x[0], q, bi, bj, dc_deq);
  // luma DC (transform.quant_luma_dc, dequant_luma_dc) through shared
  // memory: lane l < 16 gives block l's DC and takes output l
  if (luma) dcs[warp][l] = x[0];
  __syncwarp();
  int ldc_lev = 0;
  if (luma) {
    const int f = hadamard4(dcs[warp], bi, bj);
    const int qbits = 17 + q.div6;
    ldc_lev = tq_sgn_mag(f, (abs(f) * q.mf[0] + (1 << (qbits - 1))) >> qbits);
  }
  __syncwarp();
  if (luma) dcs[warp][l] = ldc_lev;
  __syncwarp();
  if (luma) {
    const int g = hadamard4(dcs[warp], bi, bj) * q.v[0];
    dc_deq = q.div6 >= 2 ? g * (1 << (q.div6 - 2))
                         : (g + (1 << (1 - q.div6))) >> (2 - q.div6);
  }
  tq_quant_block(x, lev, rec, q, a.dz);
  lev[0] = 0;
  rec[0] = dc_deq;
  tq_idct(rec);

  // outputs: the intra levels of every MB; the chroma levels and the
  // reconstruction of the decision
  if (luma) {
    a.dc_lev[16 * k + l] = ldc_lev;
    tq_store16(a.ac_lev + 256 * k + 16 * l, lev);
    const long long at = 256 * k + 64 * bi + 4 * bj;
#pragma unroll
    for (int y = 0; y < 4; ++y)
      *reinterpret_cast<uint32_t*>(a.rec_y + at + 16 * y) =
          i16 ? tq_recon_row(rec, y, prow[y])
              : *reinterpret_cast<const uint32_t*>(a.rec_y_i + at + 16 * y);
    const long long at4 = 16 * k + l;
    a.mv4_y[at4] = i16 ? 0 : a.mv4_y_i[at4];
    a.mv4_x[at4] = i16 ? 0 : a.mv4_x_i[at4];
    a.i4modes[at4] = 2;
    a.i4sym_v[at4] = 0;
    a.i4sym_l[at4] = 0;
    if (l == 0) {
      a.sel[k] = i16 ? TQ_SEL_I16 : TQ_SEL_INTER;
      a.cmode[k] = cmode;
      a.mv_y[k] = i16 ? 0 : a.mv_y_i[k];
      a.mv_x[k] = i16 ? 0 : a.mv_x_i[k];
      a.shape[k] = i16 ? 0 : a.shape_i[k];
    }
  } else if (l < 24) {
    const long long blk = 8 * k + cb;
    if (i16) {
      a.cdc[blk] = cdc_lev;
      tq_store16(a.cac + 16 * blk, lev);
    } else {
      a.cdc[blk] = a.cdc_i[blk];
      const int4* from = reinterpret_cast<const int4*>(a.cac_i + 16 * blk);
      int4* to = reinterpret_cast<int4*>(a.cac + 16 * blk);
#pragma unroll
      for (int i = 0; i < 4; ++i) to[i] = from[i];
    }
    const long long at = 64 * k + 32 * bi + 4 * bj;
    uint8_t* out = cp ? a.rec_v : a.rec_u;
    const uint8_t* in = cp ? a.rec_v_i : a.rec_u_i;
#pragma unroll
    for (int y = 0; y < 4; ++y)
      *reinterpret_cast<uint32_t*>(out + at + 8 * y) =
          i16 ? tq_recon_row(rec, y, prow[y])
              : *reinterpret_cast<const uint32_t*>(in + at + 8 * y);
  }
}

}  // namespace

extern "C" int h264lab_select_parallel(
    const void* src_y, const void* src_u, const void* src_v, const void* qp,
    const void* qpc, const void* avail, const void* inter_cost,
    const void* rec_y_i, const void* rec_u_i, const void* rec_v_i,
    const void* cdc_i, const void* cac_i, const void* mv_y_i,
    const void* mv_x_i, const void* mv4_y_i, const void* mv4_x_i,
    const void* shape_i, void* sel, void* mode16, void* cmode, void* dc_lev,
    void* ac_lev, void* cdc, void* cac, void* rec_y, void* rec_u, void* rec_v,
    void* i4modes, void* i4sym_v, void* i4sym_l, void* mv_y, void* mv_x,
    void* shape, void* mv4_y, void* mv4_x, void* want, long long n, int mbw,
    int mbh, int qp_rows, int dz, int pen_bits, void* stream) {
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  const long long mbs = n * mbw * mbh;
  if (mbs >= (1ll << 31) * kWarps) return (int)cudaErrorInvalidValue;
  Args a{(const uint8_t*)src_y, (const uint8_t*)src_u, (const uint8_t*)src_v,
         (const int32_t*)qp, (const int32_t*)qpc, (const uint8_t*)avail,
         (const int32_t*)inter_cost, (const uint8_t*)rec_y_i,
         (const uint8_t*)rec_u_i, (const uint8_t*)rec_v_i,
         (const int32_t*)cdc_i, (const int32_t*)cac_i, (const int32_t*)mv_y_i,
         (const int32_t*)mv_x_i, (const int32_t*)mv4_y_i,
         (const int32_t*)mv4_x_i, (const int32_t*)shape_i, (int32_t*)sel,
         (int32_t*)mode16, (int32_t*)cmode, (int32_t*)dc_lev,
         (int32_t*)ac_lev, (int32_t*)cdc, (int32_t*)cac, (uint8_t*)rec_y,
         (uint8_t*)rec_u, (uint8_t*)rec_v, (int32_t*)i4modes,
         (int32_t*)i4sym_v, (int32_t*)i4sym_l, (int32_t*)mv_y,
         (int32_t*)mv_x, (int32_t*)shape, (int32_t*)mv4_y, (int32_t*)mv4_x,
         (uint8_t*)want, mbs, mbw * mbh, mbw, mbh, qp_rows, dz, pen_bits};
  const unsigned blocks = (unsigned)((mbs + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  select_want_kernel<<<blocks, kWarps * 32, 0, s>>>(a);
  select_code_kernel<<<blocks, kWarps * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}
