// K1 of h264lab_tpu_torch: device-side bit packing of the CAVLC symbol
// grid, written by hand for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_stitch_kernel` (h264lab_tpu/ops/bitpack.py:152,
// reached through pack_frame_pallas) together with the XLA levels around
// it, and returns what `pack_frame_fast` (bitpack.py:199-236) returns: the
// frame's symbols concatenated MSB-first into uint32 words, (cap_words +
// 256) words per frame, writes at or past that length dropped.
//
// The TPU kernel walks the MBs of a frame in order on one core and rolls
// each MB's word buffer into place with power-of-two rotations. Hopper
// runs blocks in parallel and in no order, so the design is two
// order-free passes instead:
//   (a) mb_words_kernel — one block per (frame, MB): an exclusive scan of
//       the MB's slot lengths in shared memory, then every slot ORs its
//       <= 2 word pieces into a 128-word shared buffer (levels L1 + L2 of
//       the JAX packer fused: bits simply concatenate, so unit boundaries
//       need no separate pass). Writes mb_words and mb_bits.
//   torch.cumsum of mb_bits then gives each MB's frame bit offset (the
//   JAX packer scans outside its kernel too, bitpack.py:194).
//   (b) stitch_kernel — one block per (frame, MB): thread i forms output
//       word i of the MB from (w[i] >> s) | (w[i-1] << (32 - s)), with
//       s = off & 31 and the s == 0 case guarded (a shift by 32 is
//       undefined), and ORs it into word (off >> 5) + i.
// Bits of different symbols and MBs never overlap, so OR equals the JAX
// packer's add and the result does not depend on the order of atomics.
//
// Bound: bytes. Every length must be read (16 x 8160 x 952 x 4 B = 0.50 GB
// at 1080p x 16 lanes), but a value only where its length is non-zero (a
// few percent of the slots at QP 33), and the (cap_words + 256)-word
// frames are written once (67 MB at the IDR capacity): about 0.58 GB, or
// ~0.17 ms at the H100's 3.35 TB/s. The design reads each length once
// (each thread a contiguous run of slots) and a value only for a non-empty
// slot, keeps the per-MB word assembly in shared memory, and makes the
// 128-word MB buffers the only intermediate in device memory.
//
// Inputs: vals are uint32 bit patterns (int32 tensors on the Python side),
// lens in [0, 32], and each MB's symbols fit in 128 words (the spec's
// 3200-bit macroblock bound leaves headroom). Plain C interface, loaded
// with ctypes; each entry point launches on the given stream and returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMbWords = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStitchThreads = 160;  // >= kMbWords + 1, whole warps

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
mb_words_kernel(const uint32_t* __restrict__ vals,
                const int32_t* __restrict__ lens, int nslots,
                uint32_t* __restrict__ mb_words,
                int32_t* __restrict__ mb_bits) {
  __shared__ uint32_t words[kMbWords];
  __shared__ uint32_t warp_sums[kWarps];
  const long long mb = blockIdx.x;
  const uint32_t* v = vals + mb * nslots;
  const int32_t* l = lens + mb * nslots;
  const int tid = threadIdx.x;
  const int per = (nslots + kThreads - 1) / kThreads;
  const int first = tid * per;
  const int last = min(first + per, nslots);

  for (int i = tid; i < kMbWords; i += kThreads) words[i] = 0u;

  // block-wide exclusive scan of the per-thread bit counts
  uint32_t local = 0;
  for (int s = first; s < last; ++s) local += (uint32_t)l[s];
  const uint32_t incl = warp_inclusive_scan(local);
  if ((tid & 31) == 31) warp_sums[tid >> 5] = incl;
  __syncthreads();
  if (tid < 32) {
    uint32_t ws = tid < kWarps ? warp_sums[tid] : 0u;
    ws = warp_inclusive_scan(ws);
    if (tid < kWarps) warp_sums[tid] = ws;
  }
  __syncthreads();
  uint32_t off = incl - local + ((tid >> 5) ? warp_sums[(tid >> 5) - 1] : 0u);

  for (int s = first; s < last; ++s) {
    const int len = l[s];
    if (len > 0) {
      uint32_t val = v[s];
      if (len < 32) val &= (1u << len) - 1u;
      const uint32_t sh = off & 31u;
      const uint32_t w = off >> 5;
      // the symbol left-aligned at bit `sh` of a 64-bit window over words
      // w, w+1; the shift is in [1, 63] for len in [1, 32]
      const unsigned long long x =
          (unsigned long long)val << (64 - len - (int)sh);
      const uint32_t hi = (uint32_t)(x >> 32);
      const uint32_t lo = (uint32_t)x;
      if (hi && w < kMbWords) atomicOr(&words[w], hi);
      if (lo && w + 1 < kMbWords) atomicOr(&words[w + 1], lo);
    }
    off += (uint32_t)len;
  }
  __syncthreads();
  for (int i = tid; i < kMbWords; i += kThreads)
    mb_words[mb * kMbWords + i] = words[i];
  if (tid == kThreads - 1) mb_bits[mb] = (int32_t)off;  // = the MB total
}

__global__ void __launch_bounds__(kStitchThreads)
stitch_kernel(const uint32_t* __restrict__ mb_words,
              const int32_t* __restrict__ offs, int nmb,
              long long out_words, uint32_t* __restrict__ out) {
  const long long mb = blockIdx.x;
  const int i = threadIdx.x;
  if (i > kMbWords) return;
  const uint32_t off = (uint32_t)offs[mb];
  const uint32_t s = off & 31u;
  const uint32_t* w = mb_words + mb * kMbWords;
  const uint32_t cur = i < kMbWords ? w[i] : 0u;
  uint32_t word = cur;
  if (s != 0u) {
    const uint32_t prev = i > 0 ? w[i - 1] : 0u;
    word = (cur >> s) | (prev << (32u - s));
  }
  const long long idx = (long long)(off >> 5) + i;
  if (word != 0u && idx < out_words)
    atomicOr(&out[(mb / nmb) * out_words + idx], word);
}

}  // namespace

extern "C" int h264lab_bitpack_mb_words(const void* vals, const void* lens,
                                        long long n_mb, int nslots,
                                        void* mb_words, void* mb_bits,
                                        void* stream) {
  if (n_mb <= 0) return 0;
  mb_words_kernel<<<(unsigned)n_mb, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)vals, (const int32_t*)lens, nslots,
      (uint32_t*)mb_words, (int32_t*)mb_bits);
  return (int)cudaGetLastError();
}

extern "C" int h264lab_bitpack_stitch(const void* mb_words, const void* offs,
                                      long long n_frames, int nmb,
                                      long long out_words, void* out,
                                      void* stream) {
  if (n_frames <= 0 || nmb <= 0) return 0;
  stitch_kernel<<<(unsigned)(n_frames * nmb), kStitchThreads, 0,
                  (cudaStream_t)stream>>>(
      (const uint32_t*)mb_words, (const int32_t*)offs, nmb, out_words,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}
