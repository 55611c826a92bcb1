// The 4x4 transform, quantisation and prediction helpers that K7
// (csrc/inter.cu) and K8 (csrc/select.cu) share: the integer arithmetic
// of ops/transform.py, op for op, one 4x4 block in the registers of one
// lane. The tables come from tq_tables.h, which `python -m
// h264lab_tpu_torch.ops.residual` writes from the port's own tables.
//
// Integer semantics of ops/transform.py: `>>` of a negative int is
// arithmetic; `* (1 << s)` where it writes `<< s` (a left shift of a
// negative int is undefined in C++17); the deadzone f = dz << (qbits - 8);
// level = sign(W) * ((|W| * MF + f) >> qbits); the zero thresholds are a
// floor division of positive ints; every intermediate fits int32 (|W| is
// at most 16 x 255 x 4 before the multiplier).
//
// The helpers marked "every lane" shuffle across the warp: all 32 lanes
// must call them together.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tq_tables.h"

namespace {

constexpr unsigned kTqFull = 0xffffffffu;
__constant__ int kTqMF[18] = TQ_QUANT_MF;      // (qp % 6, class)
__constant__ int kTqV[18] = TQ_DEQUANT_V;
__constant__ int kTqLambda[52] = TQ_LAMBDA_ME;  // ops/me.py LAMBDA_ME

__device__ __forceinline__ int tq_clip3(int lo, int hi, int x) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ int tq_sgn_mag(int f, int mag) {
  return f > 0 ? mag : f < 0 ? -mag : 0;
}

// Output k of the forward 1-D core transform (transform._bf).
__device__ __forceinline__ int tq_bf(int x0, int x1, int x2, int x3, int k) {
  const int t0 = x0 + x3, t1 = x0 - x3, t2 = x1 + x2, t3 = x1 - x2;
  return k == 0 ? t0 + t2 : k == 1 ? 2 * t1 + t3 : k == 2 ? t0 - t2
                                                          : t1 - 2 * t3;
}

// Output k of the inverse 1-D core transform (transform._ibf).
__device__ __forceinline__ int tq_ibf(int d0, int d1, int d2, int d3, int k) {
  const int e0 = d0 + d2, e1 = d0 - d2;
  const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  return k == 0 ? e0 + e3 : k == 1 ? e1 + e2 : k == 2 ? e1 - e2 : e0 - e3;
}

// Forward 4x4 core transform in place (transform.fdct4x4: columns, then
// rows), raster order.
__device__ __forceinline__ void tq_fdct(int* x) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int a = x[j], b = x[4 + j], c = x[8 + j], d = x[12 + j];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[4 * k + j] = tq_bf(a, b, c, d, k);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = x[4 * i], b = x[4 * i + 1], c = x[4 * i + 2],
              d = x[4 * i + 3];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[4 * i + k] = tq_bf(a, b, c, d, k);
  }
}

// Inverse 4x4 core transform with the final (x + 32) >> 6, in place
// (transform.idct4x4: rows, then columns).
__device__ __forceinline__ void tq_idct(int* x) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = x[4 * i], b = x[4 * i + 1], c = x[4 * i + 2],
              d = x[4 * i + 3];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[4 * i + k] = tq_ibf(a, b, c, d, k);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int a = x[j], b = x[4 + j], c = x[8 + j], d = x[12 + j];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x[4 * k + j] = (tq_ibf(a, b, c, d, k) + 32) >> 6;
  }
}

// The quantiser of one QP: MF and V of the three position classes, qp / 6.
struct TqQuant {
  int mf[3], v[3], div6, mod6;
};

__device__ __forceinline__ TqQuant tq_quant(int qp) {
  TqQuant q;
  q.div6 = qp / 6;
  q.mod6 = qp - 6 * q.div6;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q.mf[c] = kTqMF[3 * q.mod6 + c];
    q.v[c] = kTqV[3 * q.mod6 + c];
  }
  return q;
}

// transform.quant4x4's levels of a block's 16 coefficients at deadzone
// `dz` (Q8).
__device__ __forceinline__ void tq_quant_levels(const int* w, int* lev,
                                                const TqQuant& q, int dz) {
  const int qbits = 15 + q.div6;
  const int f = dz << (qbits - 8);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int mag = (abs(w[i]) * q.mf[TQ_POS_CLASS(i)] + f) >> qbits;
    lev[i] = tq_sgn_mag(w[i], mag);
  }
}

// transform.dequant4x4 of a block's 16 levels (`deq` may be `lev`).
__device__ __forceinline__ void tq_dequant(const int* lev, int* deq,
                                           const TqQuant& q) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    deq[i] = lev[i] * q.v[TQ_POS_CLASS(i)] * (1 << q.div6);
}

// transform.quant4x4 and dequant4x4 of a block's 16 coefficients.
__device__ __forceinline__ void tq_quant_block(const int* w, int* lev,
                                               int* deq, const TqQuant& q,
                                               int dz) {
  tq_quant_levels(w, lev, q, dz);
  tq_dequant(lev, deq, q);
}

// Whether every coefficient of the block sits at or under
// transform.zero_thr4x4(qp, thr_q8): (thr_q8 << (qbits - 8)) // MF.
__device__ __forceinline__ bool tq_under(const int* w, const TqQuant& q,
                                         int thr_q8) {
  const int num = thr_q8 << (7 + q.div6);
  const int t[3] = {num / q.mf[0], num / q.mf[1], num / q.mf[2]};
  bool under = true;
#pragma unroll
  for (int i = 0; i < 16; ++i) under &= abs(w[i]) <= t[TQ_POS_CLASS(i)];
  return under;
}

// The 2x2 chroma DC Hadamard (transform.hadamard2x2) across the lanes of a
// plane's four blocks, lane ^ 1 the block beside (bj) and lane ^ 2 the one
// below (bi): each lane gives its block's value and gets the output at its
// own (bi, bj). Every lane.
__device__ __forceinline__ int tq_hadamard2(int h, int bi, int bj) {
  int o = __shfl_xor_sync(kTqFull, h, 1);
  h = bj == 0 ? h + o : o - h;
  o = __shfl_xor_sync(kTqFull, h, 2);
  return bi == 0 ? h + o : o - h;
}

// The chroma DC of a plane's four blocks (transform.quant_chroma_dc and
// dequant_chroma_dc): `w0` the lane's block's DC coefficient; returns its
// level at the lane's own (bi, bj) and sets `dc_deq`, the dequantised DC
// there. Every lane; a plane's four blocks lie on lanes 4 i + 2 bi + bj.
__device__ __forceinline__ int tq_chroma_dc(int w0, const TqQuant& q, int bi,
                                            int bj, int& dc_deq) {
  // doubled step, rounding 1/2
  const int f = tq_hadamard2(w0, bi, bj);
  const int qbits = 16 + q.div6;
  const int lev = tq_sgn_mag(
      f, (abs(f) * q.mf[0] + (1 << (qbits - 1))) >> qbits);
  // ((f * V00) << qp / 6) >> 1
  dc_deq = (tq_hadamard2(lev, bi, bj) * q.v[0] * (1 << q.div6)) >> 1;
  return lev;
}

// Row y (0-3) of a 4x4 block's reconstruction: clamp(rec + pred, 0, 255),
// four bytes in one word; `pred` the row's four predicted bytes.
__device__ __forceinline__ uint32_t tq_recon_row(const int* rec, int y,
                                                 uint32_t pred) {
  uint32_t out = 0;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int p = (pred >> (8 * x)) & 0xff;
    out |= (uint32_t)tq_clip3(0, 255, rec[4 * y + x] + p) << (8 * x);
  }
  return out;
}

// A row of four bytes as the residual against `pred` (both packed).
__device__ __forceinline__ void tq_residual_row(int* x, int y, uint32_t src,
                                                uint32_t pred) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    x[4 * y + j] = (int)((src >> (8 * j)) & 0xff)
                   - (int)((pred >> (8 * j)) & 0xff);
}

// 16 int32 to global memory in four 16-byte stores (16-byte aligned).
__device__ __forceinline__ void tq_store16(int32_t* dst, const int* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<int4*>(dst)[i] =
        make_int4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// c plus the SAD of the 4 bytes of a and b (one VABSDIFF4 with its
// accumulator); tq_sad4(a, 0, c) adds the bytes of a.
__device__ __forceinline__ uint32_t tq_sad4(uint32_t a, uint32_t b,
                                            uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// A value's byte in all four bytes of a word.
__device__ __forceinline__ uint32_t tq_splat(int v) {
  return (uint32_t)v * 0x01010101u;
}

// The sum over a lane's group of 8 (lanes 8 g .. 8 g + 7). Every lane.
__device__ __forceinline__ int tq_sum8(int v) {
  v += __shfl_xor_sync(kTqFull, v, 1);
  v += __shfl_xor_sync(kTqFull, v, 2);
  return v + __shfl_xor_sync(kTqFull, v, 4);
}

// The 4x4 Hadamard of transform.hadamard4x4 (rows (1 1 1 1) (1 1 -1 -1)
// (1 -1 -1 1) (1 -1 1 -1), output (i, j) = sum over (p, q) of H[i][p]
// H[j][q] x[p][q]) of an MB's 16 block values held two a lane by a group
// of 8 lanes: lane g (g = lane & 7) holds (bi, bj) = (g >> 2, g & 3) in
// `lo` and (g >> 2 + 2, g & 3) in `hi`, and gets the outputs at the same
// places. The column pass pairs lanes g and g ^ 4 (rows 0, 2 and 1, 3);
// the row pass is a butterfly over lane ^ 2 and ^ 1, after which lane q
// holds output (0, 3, 1, 2)[q], and one shuffle puts each output on its
// own lane. Every lane.
__device__ __forceinline__ void tq_hadamard4(int& lo, int& hi, int lane) {
  const int g = lane & 7, bj = g & 3;
  {
    const int s = lo + hi, t = lo - hi;
    const int ps = __shfl_xor_sync(kTqFull, s, 4);
    const int pt = __shfl_xor_sync(kTqFull, t, 4);
    lo = g < 4 ? s + ps : pt + t;         // rows 0 | 1
    hi = g < 4 ? t - pt : ps - s;         // rows 2 | 3
  }
  const int src = (lane & ~3) | ((0x1320 >> (4 * bj)) & 3);
  auto row = [&](int x) {
    int o = __shfl_xor_sync(kTqFull, x, 2);
    x = bj < 2 ? x + o : o - x;
    o = __shfl_xor_sync(kTqFull, x, 1);
    x = (bj & 1) == 0 ? x + o : o - x;
    return __shfl_sync(kTqFull, x, src);
  };
  lo = row(lo);
  hi = row(hi);
}

// --- bulk copies (TMA without a tensor map) and their mbarrier --------

__device__ __forceinline__ unsigned tq_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void tq_mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(tq_smem(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The one arrival on the mbarrier, expecting `bytes` of copies.
__device__ __forceinline__ void tq_mbar_expect(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(tq_smem(bar)), "r"(bytes) : "memory");
}

// Wait until the mbarrier's first phase has completed.
__device__ __forceinline__ void tq_mbar_wait(unsigned long long* bar) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(tq_smem(bar)) : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory, completed on `bar`.
__device__ __forceinline__ void tq_load(void* dst, const void* src,
                                        unsigned bytes,
                                        unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(tq_smem(dst)), "l"(src), "r"(bytes), "r"(tq_smem(bar))
      : "memory");
}

// `bytes` (as for tq_load) from shared to global memory in the issuing
// thread's bulk group.
__device__ __forceinline__ void tq_store(void* dst, const void* src,
                                         unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(tq_smem(src)), "r"(bytes) : "memory");
}

// The issuing thread's bulk stores committed, and waited for until their
// shared memory has been read (it may then be released).
__device__ __forceinline__ void tq_store_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Shared memory written by threads, made visible to the bulk copies that
// read it (each writer, before the block's barrier).
__device__ __forceinline__ void tq_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

}  // namespace
