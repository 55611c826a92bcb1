// K3 of h264lab_tpu_torch: the slope-2 intra wavefront, the mode selection
// and intra transform of a batch of frames or slice bands (Intra_16x16,
// Intra_4x4 and chroma, with an optional inter candidate), in one kernel
// written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces h264lab_tpu/models/mbscan.py:541 `_wavefront_scan` (the
// `lax.scan` over slope-2 MB diagonals at :689) together with
// h264lab_tpu/ops/intra4.py:175 `encode_i4x4_mb` (its `lax.scan` over the
// 16 blocks at :295), which the JAX package left to XLA (no Pallas
// kernel). It takes what the port's plain version `_select_wavefront_plain`
// (models/mbscan.py) takes - the MB source tiles, per-frame QPs, the
// mode-decision lambda and intra-in-P penalty, the MB availability, and
// on P frames the inter candidate's cost and reconstruction - and writes
// its 13 outputs, equal array for array (integer arithmetic throughout).
//
// Bound. Each input is read once and each output written once: 384 B of
// source per MB (and 388 B of inter candidate on P frames) in; 384 B of
// reconstruction, 1024 B of `ac_lev`, 512 B of `cac_lev` and 300 B of the
// rest out: about 2.6 KB per MB, 0.10 ms for 16 frames of 1080p at 3.35
// TB/s. What sets the time is the serial chain: MB (r, c) needs the
// reconstruction of its left, top, top-left and top-right neighbours, so
// row r can take MB c only once row r - 1 has finished MB min(c + 1,
// mbw - 1), and a frame takes mbw + 2 (mbh - 1) MB steps (254 at 1080p)
// whatever the number of frames. Inside an MB step the Intra_4x4 chain of
// 16 dependent blocks (nine predictions, a SAD each, the argmin and a 4x4
// transform, quantisation and reconstruction per block) is the critical
// path.
//
// Design (simple and right first; not yet tuned):
//   - one block of three warps per MB row of one frame or band, rows drawn
//     from a global ticket in launch order (as K1 and K2 draw theirs), not
//     from blockIdx: ticket t is row t / n of frame t % n, so every frame's
//     row r starts before any frame's row r + 1, and a row waits only on
//     ticket t - n (the row above, same frame), which was drawn earlier by
//     a resident (or finished) block: no launch order can deadlock;
//   - MB (r, c) waits until the row above has finished MB min(c + 1,
//     mbw - 1): thread 0 spins on that row's progress count with an
//     acquire load, the block meets at a barrier, and the three records
//     above (top-left, top, top-right) are read with L2 loads (ld.cg),
//     never a stale L1 line. A record is 48 bytes: the bottom lines of the
//     MB's Y, U and V reconstruction and its bottom Intra_4x4 modes; its
//     writers fence, the block meets, and thread 0 publishes the count
//     with a release store. The left neighbour stays in shared memory;
//   - the three candidates are independent until the selection: warp 0
//     runs the Intra_4x4 chain, a lane per pixel of the 4x4 block (lanes
//     16-31 repeat lanes 0-15), the nine predictions and SADs in every
//     lane, the transforms by shuffles within 4-lane rows and columns;
//     warp 1 runs Intra_16x16 (three SADs, then a lane per 4x4 block for
//     the transform, the luma DC Hadamard and its quantisation a lane per
//     DC coefficient); warp 2 runs chroma (the summed U and V SADs of the
//     three modes, then a lane per 4x4 block of U and V, the 2x2 DC a
//     lane per coefficient). Then the block meets, selects over (inter,
//     I16, I4) - the first minimum wins, so inter wins ties - writes the
//     outputs and the record, and publishes its progress;
//   - neighbours that are unavailable (outside the frame, or not
//     available by `avail_top` / `avail_left`) are never read: their
//     samples are zeros, which feed only modes that are invalid there, as
//     the clamped records of the plain version do. Row 0 and column 0 are
//     unavailable whatever the availability flags say.
//
// Integer semantics of ops/transform.py, ops/intra.py and ops/intra4.py:
// `>>` of negative ints is arithmetic; `* (1 << s)` where they write
// `<< s` (a left shift of a negative int is undefined in C++17); the
// deadzone f = dz << (qbits - 8); level = sign(W) * mag; the exact
// rounding of the luma DC dequantisation below QP 12. QUANT_MF, DEQUANT_V,
// POS_CLASS and BLOCK_SCAN_4x4 come from ops/tables.py as a device array.
//
// Plain C interface, loaded with ctypes; the entry point launches on the
// given stream, allocates nothing (the caller zeroes the ticket and the
// progress counts, 4 bytes per row, and gives a record buffer of 48 bytes
// per MB) and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 96;              // warps: I4, I16, chroma
constexpr int kInvalid = 1 << 30;         // ops/intra.py INVALID_COST
constexpr int kRecBytes = 48;             // the record of an MB
constexpr int kCanW = 21;                 // Intra_4x4 canvas row: left
                                          // column, 16 pixels, 4 top-right
constexpr int kTables = 18 + 18 + 16 + 16;

struct Args {
  const uint8_t* src_y;     // (N, nmb, 16, 16)
  const uint8_t* src_u;     // (N, nmb, 8, 8)
  const uint8_t* src_v;
  const int32_t* qp;        // (N,)
  const int32_t* qpc;
  const int32_t* lam;       // (N,) lambda_me(qp)
  const int32_t* pen;       // (N,) the intra-in-P penalty (0 on I frames)
  const uint8_t* avail_top;   // (nmb,)
  const uint8_t* avail_left;
  const int32_t* inter_cost;  // (N, nmb), or null without inter candidate
  const uint8_t* rec_y_inter;  // (N, nmb, 16, 16)
  const uint8_t* rec_u_inter;  // (N, nmb, 8, 8)
  const uint8_t* rec_v_inter;
  const int32_t* tables;    // QUANT_MF (6x3), DEQUANT_V (6x3), POS_CLASS,
                            // BLOCK_SCAN_4x4
  int32_t* sel;             // (N, nmb)
  int32_t* mode16;
  int32_t* cmode;
  int32_t* dc_lev;          // (N, nmb, 4, 4)
  int32_t* ac_lev;          // (N, nmb, 4, 4, 4, 4)
  int32_t* cdc_lev;         // (N, nmb, 2, 2, 2)
  int32_t* cac_lev;         // (N, nmb, 2, 2, 2, 4, 4)
  uint8_t* recon_y;         // (N, nmb, 16, 16)
  uint8_t* recon_u;         // (N, nmb, 8, 8)
  uint8_t* recon_v;
  int32_t* i4modes;         // (N, nmb, 16) raster
  int32_t* i4sym_v;         // (N, nmb, 16) coded order
  int32_t* i4sym_l;
  uint8_t* records;         // (N, nmb, 48)
  int* sync;                // [0] the ticket, [1 + t] row t's progress
  int n, mbw, mbh, deadzone, i4_penalty;
};

struct alignas(16) Smem {
  int mf[18], dv[18], pos[16], scan[16];
  // the MB's inputs
  alignas(16) uint8_t src_y[256];
  uint8_t src_u[64], src_v[64];
  alignas(16) uint8_t top[36];  // the record above: Y 16, U 8, V 8,
                                // 4 modes
  uint8_t tl, tr[4];            // top-left pixel, top-right 4 pixels
  uint8_t pad0[3];
  // the left MB (the row's previous MB), final; then this MB's
  alignas(16) uint8_t fin_y[256];
  uint8_t fin_u[64], fin_v[64];
  int em_r[4];              // the left MB's right-column Intra_4x4 modes
  // Intra_4x4
  int can[17 * kCanW];      // row 0 the top edge, column 0 the left edge
  int nb[13];               // a block's neighbours: l3..l0, tl, t0..t7
  int lev4[256];
  int modes[16], symv[16], syml[16];
  int cost4;
  // Intra_16x16
  int ac16[256];
  int dccoef[16], dclev[16], dcdeq[16];
  alignas(16) uint8_t rec16[256];
  int mode16, cost16;
  // chroma
  int cac[128];
  int cdccoef[8], cdclev[8], cdcdeq[8];
  alignas(16) uint8_t rec_c[128];
  int cmode;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ int tap3(int a, int b, int c) {
  return (a + 2 * b + c + 2) >> 2;
}

// Output k of the forward 1-D core transform (transform._bf).
__device__ __forceinline__ int bf(int x0, int x1, int x2, int x3, int k) {
  const int t0 = x0 + x3, t1 = x0 - x3, t2 = x1 + x2, t3 = x1 - x2;
  return k == 0 ? t0 + t2 : k == 1 ? 2 * t1 + t3 : k == 2 ? t0 - t2
                                                          : t1 - 2 * t3;
}

// Output k of the inverse 1-D core transform (transform._ibf).
__device__ __forceinline__ int ibf(int d0, int d1, int d2, int d3, int k) {
  const int e0 = d0 + d2, e1 = d0 - d2;
  const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  return k == 0 ? e0 + e3 : k == 1 ? e1 + e2 : k == 2 ? e1 - e2 : e0 - e3;
}

// Forward 4x4 core transform of a block in registers (transform.fdct4x4:
// columns, then rows).
__device__ __forceinline__ void fdct(int* x) {
  int t[16];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      t[k * 4 + j] = bf(x[j], x[4 + j], x[8 + j], x[12 + j], k);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[i * 4 + k] = bf(t[i * 4], t[i * 4 + 1], t[i * 4 + 2], t[i * 4 + 3],
                        k);
}

// Inverse 4x4 core transform with the final (x + 32) >> 6
// (transform.idct4x4: rows, then columns).
__device__ __forceinline__ void idct(int* x) {
  int t[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      t[i * 4 + k] = ibf(x[i * 4], x[i * 4 + 1], x[i * 4 + 2], x[i * 4 + 3],
                         k);
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[k * 4 + j] = (ibf(t[j], t[4 + j], t[8 + j], t[12 + j], k) + 32) >> 6;
}

// transform.quant4x4 of one coefficient at position class `cls`.
__device__ __forceinline__ int quant_ac(const Smem& s, int w, int qp, int cls,
                                        int dz) {
  const int qbits = 15 + qp / 6;
  const int mag = (abs(w) * s.mf[(qp % 6) * 3 + cls] + (dz << (qbits - 8)))
                  >> qbits;
  return w > 0 ? mag : w < 0 ? -mag : 0;
}

// transform.dequant4x4 of one level.
__device__ __forceinline__ int dequant_ac(const Smem& s, int lev, int qp,
                                          int cls) {
  return lev * s.dv[(qp % 6) * 3 + cls] * (1 << (qp / 6));
}

// Element (i, j) of the 4x4 Hadamard transform (transform.hadamard4x4) of
// a raster 4x4 grid x: H x H^T with H's rows (1, 1, 1, 1), (1, 1, -1, -1),
// (1, -1, -1, 1), (1, -1, 1, -1).
__device__ __forceinline__ int hsign(int i, int k) {
  const int h = (i == 0) ? 0 : (i == 1) ? (k >> 1) : (i == 2)
                ? ((k ^ (k >> 1)) & 1) : (k & 1);
  return h ? -1 : 1;
}

__device__ __forceinline__ int hadamard4(const int* x, int i, int j) {
  int f = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    int row = 0;
#pragma unroll
    for (int n = 0; n < 4; ++n) row += hsign(j, n) * x[m * 4 + n];
    f += hsign(i, m) * row;
  }
  return f;
}

// Element k ((0, 0), (0, 1), (1, 0), (1, 1)) of the 2x2 Hadamard
// (transform.hadamard2x2).
__device__ __forceinline__ int hadamard2(const int* x, int k) {
  const int a = x[0], b = x[1], c = x[2], d = x[3];
  return k == 0 ? a + b + c + d : k == 1 ? a - b + c - d
         : k == 2 ? a + b - c - d : a - b - c + d;
}

__device__ __forceinline__ int sgn_mag(int f, int mag) {
  return f > 0 ? mag : f < 0 ? -mag : 0;
}

__device__ __forceinline__ int warp_sum(int v, int width) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    if (o < width) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// warp 0: Intra_4x4 (intra4.encode_i4x4_mb)
// ---------------------------------------------------------------------------

__device__ void intra4_warp(Smem& s, int lane, bool a_top, bool a_left,
                            bool a_tl, bool a_tr, int qp, int lam, int dz,
                            int i4_penalty) {
  // canvas row 0: top-left, the top row, the top-right 4; column 0 of
  // rows 1-16: the left MB's right column
  for (int k = lane; k < kCanW + 16; k += 32) {
    if (k == 0) s.can[0] = s.tl;
    else if (k <= 16) s.can[k] = s.top[k - 1];
    else if (k < kCanW) s.can[k] = s.tr[k - 17];
    else s.can[(k - kCanW + 1) * kCanW] = s.fin_y[(k - kCanW) * 16 + 15];
  }
  __syncwarp();
  const int pix = lane & 15, py = pix >> 2, px = pix & 3;
  const int cls = s.pos[pix];
  int cost = 0;
  for (int b = 0; b < 16; ++b) {
    const int bi = b >> 2, bj = b & 3, y0 = 4 * bi, x0 = 4 * bj;
    const bool at = bi > 0 || a_top, al = bj > 0 || a_left;
    const bool atl = (bi > 0 && bj > 0) ? true
                     : (bi == 0 && bj == 0) ? a_tl : (bi == 0 ? a_top
                                                               : a_left);
    // the neighbours U = [l3, l2, l1, l0, tl, t0..t3, t4..t7]; t4..t7
    // replicate t3 where the top-right is not available (NO_TOPRIGHT)
    if (lane < 13) {
      int v;
      if (lane < 4) {
        v = s.can[(y0 + 4 - lane) * kCanW + x0];
      } else if (lane < 9) {
        v = s.can[y0 * kCanW + x0 + lane - 4];
      } else {
        const bool no_tr = b == 5 || b == 7 || b == 11 || b == 13 || b == 15;
        const bool tr_ok = !no_tr && (bi > 0 || (bj == 3 ? a_tr : a_top));
        v = s.can[y0 * kCanW + x0 + (tr_ok ? 5 + lane - 9 : 4)];
      }
      s.nb[lane] = v;
    }
    __syncwarp();
    const int* U = s.nb;
    int pred[9];
    pred[0] = U[5 + px];                                  // V
    pred[1] = U[3 - py];                                  // H
    {                                                     // DC
      const int st = U[5] + U[6] + U[7] + U[8];
      const int sl = U[0] + U[1] + U[2] + U[3];
      pred[2] = (at && al) ? (st + sl + 4) >> 3
                : at ? (st + 2) >> 2 : al ? (sl + 2) >> 2 : 128;
    }
    if (px == 3 && py == 3) {                             // DDL
      pred[3] = (U[11] + 3 * U[12] + 2) >> 2;
    } else {
      const int id = min(px + py, 6);
      pred[3] = tap3(U[id + 5], U[min(id + 1, 7) + 5], U[min(id + 2, 7) + 5]);
    }
    {                                                     // DDR
      const int i0 = px - py + 4;
      pred[4] = tap3(U[i0 - 1], U[i0], U[i0 + 1]);
    }
    {                                                     // VR, on v = U
      const int z = 2 * px - py;
      if (z >= 0) {
        const int iv = px - (py >> 1) + 5;
        const int a = U[clip3(0, 8, iv - 2)], bb = U[clip3(0, 8, iv - 1)],
                  cc = U[clip3(0, 8, iv)];
        pred[5] = (z & 1) ? tap3(a, bb, cc) : (bb + cc + 1) >> 1;
      } else {
        const int nv = 5 + z;
        pred[5] = tap3(U[clip3(0, 8, nv - 1)], U[clip3(0, 8, nv)],
                       U[clip3(0, 8, nv + 1)]);
      }
    }
    {                                                 // HD, w[i] = U[8 - i]
      const int z = 2 * py - px;
      if (z >= 0) {
        const int iw = py - (px >> 1) + 5;
        const int a = U[8 - clip3(0, 8, iw - 2)],
                  bb = U[8 - clip3(0, 8, iw - 1)], cc = U[8 - clip3(0, 8, iw)];
        pred[6] = (z & 1) ? tap3(a, bb, cc) : (bb + cc + 1) >> 1;
      } else {
        const int nw = 5 + z;
        pred[6] = tap3(U[8 - clip3(0, 8, nw - 1)], U[8 - clip3(0, 8, nw)],
                       U[8 - clip3(0, 8, nw + 1)]);
      }
    }
    {                                                 // VL, p[i] = U[i + 4]
      const int xv = px + (py >> 1);
      const int a = U[min(xv, 7) + 5], bb = U[min(xv + 1, 7) + 5],
                cc = U[min(xv + 2, 7) + 5];
      pred[7] = (py & 1) ? tap3(a, bb, cc) : (a + bb + 1) >> 1;
    }
    {                                                 // HU, l[j] = U[3 - j]
      const int yu = py + (px >> 1), zhu = px + 2 * py;
      const int la = U[3 - min(yu, 3)], lb = U[3 - min(yu + 1, 3)],
                lc = U[3 - min(yu + 2, 3)];
      pred[8] = zhu > 5 ? U[0]
                : zhu == 5 ? (U[1] + 3 * U[0] + 2) >> 2
                : (zhu & 1) ? tap3(la, lb, lc) : (la + lb + 1) >> 1;
    }
    const int src = s.src_y[(y0 + py) * 16 + x0 + px];
    // SADs of the 16 pixels, two modes per word (each at most 4080)
    int sad[9];
#pragma unroll
    for (int m = 0; m < 9; m += 2) {
      int v = abs(src - pred[m]);
      if (m + 1 < 9) v |= abs(src - pred[m + 1]) << 16;
      v = warp_sum(v, 16);
      sad[m] = v & 0xffff;
      if (m + 1 < 9) sad[m + 1] = v >> 16;
    }
    // the predicted mode (spec 8.3.1.1)
    const int ma = bj == 0 ? s.em_r[bi] : s.modes[b - 1];
    const int mb = bi == 0 ? s.top[32 + bj] : s.modes[b - 4];
    const int pm = (at && al) ? min(ma, mb) : 2;
    const bool diag = at && al && atl;
    const bool valid[9] = {at, al, true, at, diag, diag, diag, at, al};
    int m = 0, cmin = kInvalid;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int c = valid[k] ? sad[k] + lam * (k == pm ? 1 : 4) : kInvalid;
      if (k == 0 || c < cmin) {
        cmin = c;
        m = k;
      }
    }
    cost += cmin;
    int p = pred[0];
#pragma unroll
    for (int k = 1; k < 9; ++k)
      if (m == k) p = pred[k];
    // transform, quantise, reconstruct: a lane per coefficient, rows and
    // columns gathered by shuffles within the lane's 16
    const int res = src - p;
    int t = bf(__shfl_sync(0xffffffffu, res, px, 16),
               __shfl_sync(0xffffffffu, res, 4 + px, 16),
               __shfl_sync(0xffffffffu, res, 8 + px, 16),
               __shfl_sync(0xffffffffu, res, 12 + px, 16), py);
    const int w = bf(__shfl_sync(0xffffffffu, t, py * 4, 16),
                     __shfl_sync(0xffffffffu, t, py * 4 + 1, 16),
                     __shfl_sync(0xffffffffu, t, py * 4 + 2, 16),
                     __shfl_sync(0xffffffffu, t, py * 4 + 3, 16), px);
    const int lev = quant_ac(s, w, qp, cls, dz);
    const int d = dequant_ac(s, lev, qp, cls);
    t = ibf(__shfl_sync(0xffffffffu, d, py * 4, 16),
            __shfl_sync(0xffffffffu, d, py * 4 + 1, 16),
            __shfl_sync(0xffffffffu, d, py * 4 + 2, 16),
            __shfl_sync(0xffffffffu, d, py * 4 + 3, 16), px);
    const int r = (ibf(__shfl_sync(0xffffffffu, t, px, 16),
                       __shfl_sync(0xffffffffu, t, 4 + px, 16),
                       __shfl_sync(0xffffffffu, t, 8 + px, 16),
                       __shfl_sync(0xffffffffu, t, 12 + px, 16), py) + 32)
                  >> 6;
    if (lane < 16) {
      s.can[(y0 + 1 + py) * kCanW + x0 + 1 + px] = clip3(0, 255, r + p);
      s.lev4[b * 16 + pix] = lev;
    }
    if (lane == 0) {
      const bool eq = m == pm;
      s.modes[b] = m;
      s.symv[b] = eq ? 1 : (m < pm ? m : m - 1);
      s.syml[b] = eq ? 1 : 4;
    }
    __syncwarp();
  }
  if (lane == 0) s.cost4 = cost + lam * i4_penalty;
}

// ---------------------------------------------------------------------------
// warp 1: Intra_16x16 (intra.predict_16x16, intra.select_mode,
// mbscan._encode_luma_i16)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int pred16(const Smem& s, int mode, int dc, int y,
                                      int x) {
  return mode == 0 ? s.top[x] : mode == 1 ? s.fin_y[y * 16 + 15] : dc;
}

__device__ void intra16_warp(Smem& s, int lane, bool a_top, bool a_left,
                             int qp, int dz) {
  int st = 0, sl = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    st += s.top[k];
    sl += s.fin_y[k * 16 + 15];
  }
  const int dc = (a_top && a_left) ? (st + sl + 16) >> 5
                 : a_top ? (st + 8) >> 4 : a_left ? (sl + 8) >> 4 : 128;
  // a lane per half row
  const int y = lane >> 1, xb = (lane & 1) * 8;
  int sv = 0, sh = 0, sd = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int x = xb + k, v = s.src_y[y * 16 + x];
    sv += abs(v - s.top[x]);
    sh += abs(v - s.fin_y[y * 16 + 15]);
    sd += abs(v - dc);
  }
  sv = warp_sum(sv, 32);
  sh = warp_sum(sh, 32);
  sd = warp_sum(sd, 32);
  const int c[3] = {a_top ? sv : kInvalid, a_left ? sh : kInvalid, sd};
  int mode = 0, cost = c[0];
  if (c[1] < cost) { mode = 1; cost = c[1]; }
  if (c[2] < cost) { mode = 2; cost = c[2]; }
  // a lane per 4x4 block
  int x[16], lev[16];
  const int bi = (lane & 15) >> 2, bj = lane & 3;
  if (lane < 16) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int yy = 4 * bi + (k >> 2), xx = 4 * bj + (k & 3);
      x[k] = s.src_y[yy * 16 + xx] - pred16(s, mode, dc, yy, xx);
    }
    fdct(x);
    s.dccoef[lane] = x[0];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      lev[k] = quant_ac(s, x[k], qp, s.pos[k], dz);
      x[k] = dequant_ac(s, lev[k], qp, s.pos[k]);
    }
  }
  __syncwarp();
  // the luma DC: Hadamard, quantise (transform.quant_luma_dc), then
  // Hadamard and scale (dequant_luma_dc), a lane per coefficient
  const int q6 = qp % 6, d6 = qp / 6;
  if (lane < 16) {
    const int f = hadamard4(s.dccoef, lane >> 2, lane & 3);
    const int qbits = 17 + d6;
    s.dclev[lane] = sgn_mag(f, (abs(f) * s.mf[q6 * 3] + (1 << (qbits - 1)))
                                   >> qbits);
  }
  __syncwarp();
  if (lane < 16) {
    const int f = hadamard4(s.dclev, lane >> 2, lane & 3) * s.dv[q6 * 3];
    s.dcdeq[lane] = d6 >= 2 ? f * (1 << (d6 - 2))
                            : (f + (1 << (1 - d6))) >> (2 - d6);
  }
  __syncwarp();
  if (lane < 16) {
    x[0] = s.dcdeq[lane];
    idct(x);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int yy = 4 * bi + (k >> 2), xx = 4 * bj + (k & 3);
      s.rec16[yy * 16 + xx] =
          (uint8_t)clip3(0, 255, x[k] + pred16(s, mode, dc, yy, xx));
      s.ac16[lane * 16 + k] = k == 0 ? 0 : lev[k];
    }
  }
  if (lane == 0) {
    s.mode16 = mode;
    s.cost16 = cost;
  }
}

// ---------------------------------------------------------------------------
// warp 2: chroma (intra.predict_chroma with the per-quadrant DC, the summed
// SAD argmin, mbscan._encode_chroma)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int predc(const Smem& s, int plane, int mode,
                                     int dc, int y, int x) {
  const uint8_t* fin = plane ? s.fin_v : s.fin_u;
  return mode == 0 ? dc : mode == 1 ? fin[y * 8 + 7]
                                    : s.top[16 + 8 * plane + x];
}

// The DC prediction of quadrant q (raster) of a chroma plane: quadrants 0
// and 3 from the top and left sums, 1 preferring the top, 2 the left.
__device__ __forceinline__ int chroma_dc(const Smem& s, int plane, int q,
                                         bool a_top, bool a_left) {
  const uint8_t* fin = plane ? s.fin_v : s.fin_u;
  const uint8_t* top = s.top + 16 + 8 * plane;
  int st = 0, sl = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    st += top[(q & 1) * 4 + k];
    sl += fin[((q >> 1) * 4 + k) * 8 + 7];
  }
  const int both = (st + sl + 4) >> 3, t_only = (st + 2) >> 2,
            l_only = (sl + 2) >> 2;
  if (q == 0 || q == 3)
    return (a_top && a_left) ? both : a_top ? t_only : a_left ? l_only : 128;
  if (q == 1) return a_top ? t_only : a_left ? l_only : 128;
  return a_left ? l_only : a_top ? t_only : 128;
}

__device__ void chroma_warp(Smem& s, int lane, bool a_top, bool a_left,
                            int qpc, int dz) {
  // the three modes' SADs over U and V: a lane per half row of a plane
  {
    const int p = lane >> 4, y = (lane & 15) >> 1, xb = (lane & 1) * 4;
    const uint8_t* src = p ? s.src_v : s.src_u;
    const int dc = chroma_dc(s, p, (y >> 2) * 2 + (lane & 1), a_top, a_left);
    int sd = 0, sh = 0, sv = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = xb + k, v = src[y * 8 + x];
      sd += abs(v - dc);
      sh += abs(v - predc(s, p, 1, dc, y, x));
      sv += abs(v - predc(s, p, 2, dc, y, x));
    }
    sd = warp_sum(sd, 32);
    sh = warp_sum(sh, 32);
    sv = warp_sum(sv, 32);
    const int c[3] = {sd, a_left ? sh : kInvalid, a_top ? sv : kInvalid};
    int mode = 0, cost = c[0];
    if (c[1] < cost) { mode = 1; cost = c[1]; }
    if (c[2] < cost) mode = 2;
    if (lane == 0) s.cmode = mode;
  }
  __syncwarp();
  const int mode = s.cmode;
  // a lane per 4x4 block of U (lanes 0-3) and V (4-7)
  const int p = (lane >> 2) & 1, blk = lane & 3, bi = blk >> 1, bj = blk & 1;
  // a 4x4 block lies in one DC quadrant
  const int dc = chroma_dc(s, p, blk, a_top, a_left);
  int x[16], lev[16];
  if (lane < 8) {
    const uint8_t* src = p ? s.src_v : s.src_u;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int yy = 4 * bi + (k >> 2), xx = 4 * bj + (k & 3);
      x[k] = src[yy * 8 + xx] - predc(s, p, mode, dc, yy, xx);
    }
    fdct(x);
    s.cdccoef[lane] = x[0];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      lev[k] = quant_ac(s, x[k], qpc, s.pos[k], dz);
      x[k] = dequant_ac(s, lev[k], qpc, s.pos[k]);
    }
  }
  __syncwarp();
  // the chroma DC (transform.quant_chroma_dc, dequant_chroma_dc), a lane
  // per coefficient
  const int q6 = qpc % 6, d6 = qpc / 6;
  if (lane < 8) {
    const int f = hadamard2(s.cdccoef + 4 * p, blk);
    const int qbits = 16 + d6;
    s.cdclev[lane] = sgn_mag(f, (abs(f) * s.mf[q6 * 3] + (1 << (qbits - 1)))
                                    >> qbits);
  }
  __syncwarp();
  if (lane < 8)
    s.cdcdeq[lane] = (hadamard2(s.cdclev + 4 * p, blk) * s.dv[q6 * 3]
                      * (1 << d6)) >> 1;
  __syncwarp();
  if (lane < 8) {
    x[0] = s.cdcdeq[lane];
    idct(x);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int yy = 4 * bi + (k >> 2), xx = 4 * bj + (k & 3);
      s.rec_c[p * 64 + yy * 8 + xx] =
          (uint8_t)clip3(0, 255, x[k] + predc(s, p, mode, dc, yy, xx));
      s.cac[lane * 16 + k] = k == 0 ? 0 : lev[k];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
wavefront_kernel(const Args a) {
  __shared__ Smem s;
  __shared__ int ticket_s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int k = tid; k < kTables; k += kThreads) {
    const int v = a.tables[k];
    if (k < 18) s.mf[k] = v;
    else if (k < 36) s.dv[k - 18] = v;
    else if (k < 52) s.pos[k - 36] = v;
    else s.scan[k - 52] = v;
  }
  if (tid == 0) ticket_s = atomicAdd(a.sync, 1);
  __syncthreads();
  const int ticket = ticket_s;
  if (ticket >= a.n * a.mbh) return;
  const int r = ticket / a.n, f = ticket % a.n;
  const int nmb = a.mbw * a.mbh;
  const int qp = clip3(0, 51, a.qp[f]), qpc = clip3(0, 51, a.qpc[f]);
  const int lam = a.lam[f], pen = a.pen[f];
  int* progress = a.sync + 1 + ticket;
  const int* above = progress - (r > 0 ? a.n : 0);   // the row above's count
  const bool has_inter = a.inter_cost != nullptr;

  for (int c = 0; c < a.mbw; ++c) {
    const int i = r * a.mbw + c;
    const long long g = (long long)f * nmb + i;
    const bool a_top = r > 0 && a.avail_top[i];
    const bool a_left = c > 0 && a.avail_left[i];
    const bool a_tl = a_top && a_left, a_tr = a_top && c < a.mbw - 1;
    // wait for the row above to finish MB min(c + 1, mbw - 1)
    if (tid == 0 && a_top) {
      const int need = min(c + 2, a.mbw);
      while (ld_acquire(above) < need) {
      }
    }
    __syncthreads();
    // the source tiles: a word per thread
    {
      const uint32_t* src = tid < 64
          ? reinterpret_cast<const uint32_t*>(a.src_y + g * 256) + tid
          : tid < 80 ? reinterpret_cast<const uint32_t*>(a.src_u + g * 64)
                           + (tid - 64)
                     : reinterpret_cast<const uint32_t*>(a.src_v + g * 64)
                           + (tid - 80);
      uint32_t* dst = tid < 64 ? reinterpret_cast<uint32_t*>(s.src_y) + tid
          : tid < 80 ? reinterpret_cast<uint32_t*>(s.src_u) + (tid - 64)
                     : reinterpret_cast<uint32_t*>(s.src_v) + (tid - 80);
      *dst = __ldg(src);
    }
    // the records above, from L2; zeros where not available
    if (tid < 9) {
      const uint32_t v = a_top ? __ldcg(reinterpret_cast<const uint32_t*>(
                                     a.records + (g - a.mbw) * kRecBytes)
                                 + tid)
                               : 0u;
      reinterpret_cast<uint32_t*>(s.top)[tid] = v;
    } else if (tid == 9) {
      const uint32_t v = a_tl ? __ldcg(reinterpret_cast<const uint32_t*>(
                                    a.records + (g - a.mbw - 1) * kRecBytes)
                                + 3)
                              : 0u;
      s.tl = (uint8_t)(v >> 24);                 // pixel 15 of its bottom row
    } else if (tid == 10) {
      const uint32_t v = a_tr ? __ldcg(reinterpret_cast<const uint32_t*>(
                                    a.records + (g - a.mbw + 1) * kRecBytes))
                              : 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) s.tr[k] = (uint8_t)(v >> (8 * k));
    }
    if (c == 0) {          // no left MB: zeros, read by invalid modes only
      for (int k = tid; k < 96; k += kThreads) {
        uint32_t* fin = k < 64 ? reinterpret_cast<uint32_t*>(s.fin_y) + k
            : k < 80 ? reinterpret_cast<uint32_t*>(s.fin_u) + (k - 64)
                     : reinterpret_cast<uint32_t*>(s.fin_v) + (k - 80);
        *fin = 0u;
      }
      if (tid < 4) s.em_r[tid] = 2;
    }
    __syncthreads();
    if (warp == 0)
      intra4_warp(s, lane, a_top, a_left, a_tl, a_tr, qp, lam, a.deadzone,
                  a.i4_penalty);
    else if (warp == 1)
      intra16_warp(s, lane, a_top, a_left, qp, a.deadzone);
    else
      chroma_warp(s, lane, a_top, a_left, qpc, a.deadzone);
    __syncthreads();
    // the selection over (inter, I16, I4): the first minimum wins
    const int ci = has_inter ? a.inter_cost[g] : kInvalid;
    const int c16 = s.cost16 + pen, c4 = s.cost4 + pen;
    int sel = 0, best = ci;
    if (c16 < best) { sel = 1; best = c16; }
    if (c4 < best) sel = 2;
    // the reconstruction, a word per thread: Y words 0-63, U 64-79, V 80-95
    {
      uint32_t v;
      if (tid < 64) {
        if (sel == 0) {
          v = __ldg(reinterpret_cast<const uint32_t*>(a.rec_y_inter + g * 256)
                    + tid);
        } else if (sel == 1) {
          v = reinterpret_cast<const uint32_t*>(s.rec16)[tid];
        } else {
          const int* row = s.can + ((tid >> 2) + 1) * kCanW + 1 + (tid & 3) * 4;
          v = (uint32_t)row[0] | ((uint32_t)row[1] << 8)
              | ((uint32_t)row[2] << 16) | ((uint32_t)row[3] << 24);
        }
        reinterpret_cast<uint32_t*>(a.recon_y + g * 256)[tid] = v;
        reinterpret_cast<uint32_t*>(s.fin_y)[tid] = v;
      } else {
        const int p = tid >= 80, k = tid - 64 - 16 * p;
        if (sel == 0)
          v = __ldg(reinterpret_cast<const uint32_t*>(
                        (p ? a.rec_v_inter : a.rec_u_inter) + g * 64) + k);
        else
          v = reinterpret_cast<const uint32_t*>(s.rec_c + 64 * p)[k];
        reinterpret_cast<uint32_t*>((p ? a.recon_v : a.recon_u) + g * 64)[k] =
            v;
        reinterpret_cast<uint32_t*>(p ? s.fin_v : s.fin_u)[k] = v;
      }
    }
    for (int k = tid; k < 256; k += kThreads)
      a.ac_lev[g * 256 + k] = sel == 2 ? s.lev4[k] : s.ac16[k];
    for (int k = tid; k < 128; k += kThreads) a.cac_lev[g * 128 + k] = s.cac[k];
    if (tid < 16) {
      a.dc_lev[g * 16 + tid] = s.dclev[tid];
      a.i4modes[g * 16 + tid] = s.modes[tid];
      a.i4sym_v[g * 16 + tid] = s.symv[s.scan[tid]];
      a.i4sym_l[g * 16 + tid] = s.syml[s.scan[tid]];
    } else if (tid < 24) {
      a.cdc_lev[g * 8 + tid - 16] = s.cdclev[tid - 16];
    } else if (tid == 24) {
      a.sel[g] = sel;
      a.mode16[g] = s.mode16;
      a.cmode[g] = s.cmode;
    }
    __syncthreads();                       // fin_* hold this MB now
    // the record for the row below: bottom lines and bottom I4 modes; the
    // right column and modes stay here for the next MB
    if (tid < 9) {
      uint32_t v;
      if (tid < 4) {
        v = reinterpret_cast<const uint32_t*>(s.fin_y + 240)[tid];
      } else if (tid < 8) {
        v = reinterpret_cast<const uint32_t*>(
            (tid < 6 ? s.fin_u : s.fin_v) + 56)[tid & 1];
      } else {
        v = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v |= (uint32_t)(sel == 2 ? s.modes[12 + k] : 2) << (8 * k);
      }
      reinterpret_cast<uint32_t*>(a.records + g * kRecBytes)[tid] = v;
      __threadfence();
    } else if (tid >= 32 && tid < 36) {
      s.em_r[tid - 32] = sel == 2 ? s.modes[(tid - 32) * 4 + 3] : 2;
    }
    __syncthreads();
    if (tid == 0) st_release(progress, c + 1);
  }
}

}  // namespace

extern "C" int h264lab_wavefront(
    const void* src_y, const void* src_u, const void* src_v, const void* qp,
    const void* qpc, const void* lam, const void* pen, const void* avail_top,
    const void* avail_left, const void* inter_cost, const void* rec_y_inter,
    const void* rec_u_inter, const void* rec_v_inter, const void* tables,
    void* sel, void* mode16, void* cmode, void* dc_lev, void* ac_lev,
    void* cdc_lev, void* cac_lev, void* recon_y, void* recon_u,
    void* recon_v, void* i4modes, void* i4sym_v, void* i4sym_l,
    void* records, void* sync, long long n, int mbw, int mbh, int deadzone,
    int i4_penalty, void* stream) {
  if (n <= 0 || mbw <= 0 || mbh <= 0) return 0;
  if (n * mbh >= (1ll << 31) || n * mbw * mbh >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint8_t*)src_y, (const uint8_t*)src_u,
               (const uint8_t*)src_v, (const int32_t*)qp,
               (const int32_t*)qpc, (const int32_t*)lam, (const int32_t*)pen,
               (const uint8_t*)avail_top, (const uint8_t*)avail_left,
               (const int32_t*)inter_cost, (const uint8_t*)rec_y_inter,
               (const uint8_t*)rec_u_inter, (const uint8_t*)rec_v_inter,
               (const int32_t*)tables, (int32_t*)sel, (int32_t*)mode16,
               (int32_t*)cmode, (int32_t*)dc_lev, (int32_t*)ac_lev,
               (int32_t*)cdc_lev, (int32_t*)cac_lev, (uint8_t*)recon_y,
               (uint8_t*)recon_u, (uint8_t*)recon_v, (int32_t*)i4modes,
               (int32_t*)i4sym_v, (int32_t*)i4sym_l, (uint8_t*)records,
               (int*)sync, (int)n, mbw, mbh, deadzone, i4_penalty};
  // one block per MB row of each frame; each block draws its row from the
  // ticket
  wavefront_kernel<<<(unsigned)(n * mbh), kThreads, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
