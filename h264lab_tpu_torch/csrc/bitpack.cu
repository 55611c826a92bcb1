// K1 of h264lab_tpu_torch: device-side bit packing of the CAVLC symbol
// grid, one fused single-pass kernel written by hand for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_stitch_kernel` (h264lab_tpu/ops/bitpack.py:152,
// reached through pack_frame_pallas) together with the XLA levels around
// it, and returns what `pack_frame_fast` (bitpack.py:199-236) returns: each
// frame's symbols concatenated MSB-first into (cap_words + 256) uint32
// words, and the frame's bit count. It follows that packer's drop rules: a
// bit at offset 704 or more of its 34-slot unit (L1 keeps 22 words,
// bitpack.py:121-124), at offset 4096 or more of its MB (L2 keeps 128
// words, :143-148), or in frame word cap_words + 256 or later (L3, :235)
// reads as 0, while every offset and the bit count count all bits
// (:101-102, :134, :194-195).
//
// Bound: bytes. Every length is read once (16 x 8160 x 952 x 4 B = 0.50 GB
// at 1080p x 16 lanes), a value only where its length is non-zero (9% of
// the slots at QP 33), and the (cap_words + 256)-word frames are written
// once (67 MB at the IDR capacity): 0.61 GB, 0.18 ms at 3.35 TB/s
// (chip_smoke.py counts it from each run's data).
//
// Design. A block of kTile warps packs a tile of kTile consecutive MBs of
// one frame, one warp per MB:
//   1. The block draws its tile from a global ticket, so every tile it may
//      wait on belongs to a block that started earlier (no deadlock).
//   2. One thread brings the tile's lengths, one contiguous span of
//      kTile x 3808 B, into shared memory with a 1-D bulk copy (TMA) on an
//      mbarrier. Every length is read from device memory once.
//   3. Each lane takes one segment of the MB's slots, in slot order: lanes
//      0-4 share the header unit (mb_type, the 16 intra 4x4 modes and 3
//      more symbols), lanes 5-31 take units 1-27. The lanes walk their
//      slots in step, sum the lengths and list their symbols (slot, offset
//      in the segment, length) at the front of their own segment. A warp
//      scan of the segment sums gives offsets in the MB and its bit count.
//   4. Decoupled look-back over the frame's tiles: a tile publishes its
//      aggregate at once, then its inclusive prefix, each with its flag in
//      one 64-bit word and one release store. Warp 0 reads 32 tiles back
//      at a time and waits only for those up to the nearest prefix. The
//      frame's last tile writes nbits.
//   5. Before that, each warp places its MB's symbols 32 at a time, the
//      load of kRounds rounds of values first: symbol e goes to lane e % 32,
//      which finds the segment that listed it by a binary search over the
//      lanes' counts. Each symbol's kept bits are ORed into the MB's
//      128-word buffer in shared memory. The buffer then goes to the frame
//      shifted by off & 31: plain stores for the words that hold only this
//      MB's bits, atomicOr for its first and last word, which a neighbour
//      may share. Writes at or past cap_words + 256 are dropped; an MB
//      with no bits writes nothing.
// Against the two-pass kernel it replaces (0.586 ms, 31% of the bound):
// no per-MB word buffers in device memory (134 MB of traffic), no cumsum,
// subtraction or sum around it (one launch beside the zero fills of the
// output and of the 8 B-per-tile look-back state), 30 KB bulk loads in
// place of 3.8 KB blocks of scalar loads, 2 global atomics per MB in place
// of one per word, and work spread evenly over the lanes: a unit holds up
// to 34 symbols, many units none.
//
// Inputs: vals are uint32 bit patterns (int32 tensors on the Python side),
// lens in [0, 32], 952 slots per MB, both 16-byte aligned. Plain C
// interface, loaded with ctypes; the entry point launches on the given
// stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnitSlots = 34;
constexpr int kUnits = 28;
constexpr int kSlots = kUnits * kUnitSlots;   // 952 slots per MB
constexpr int kUnitKeep = 22 * 32;            // bits kept of a unit
constexpr int kMbKeep = 128 * 32;             // bits kept of an MB
constexpr int kBufWords = 129;                // kept MB bits after a shift
constexpr int kBufStride = 132;               // 128 MB words, then zeros
constexpr int kTile = 8;                      // MBs per block
constexpr int kRounds = 4;                    // of 32 symbols, values first
constexpr int kThreads = kTile * 32;
constexpr unsigned long long kFlagAggregate = 1ull << 32;
constexpr unsigned long long kFlagPrefix = 2ull << 32;

__device__ __forceinline__ uint32_t warp_inclusive_scan(uint32_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// OR the k (1..32) bits of v, MSB first, into buf at bit p: the bits
// left-aligned at bit p & 31 of a 64-bit window over words p >> 5 and
// (p >> 5) + 1, a shift in [1, 63]
__device__ __forceinline__ void place(uint32_t* buf, uint32_t p, int k,
                                      uint32_t v) {
  const unsigned long long x =
      (unsigned long long)v << (64 - k - (int)(p & 31u));
  const uint32_t hi = (uint32_t)(x >> 32);
  const uint32_t lo = (uint32_t)x;
  if (hi) atomicOr(&buf[p >> 5], hi);
  if (lo) atomicOr(&buf[(p >> 5) + 1], lo);
}

__device__ __forceinline__ uint32_t low_bits(uint32_t v, int len) {
  return len < 32 ? v & ((1u << len) - 1u) : v;
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ vals,
            const int32_t* __restrict__ lens, int nmb, int tiles_per_frame,
            long long out_words, uint32_t* __restrict__ out,
            int32_t* __restrict__ nbits, unsigned long long* status,
            unsigned int* ticket) {
  // the tile's lengths as loaded; step 3 lists each segment's symbols at
  // its front
  __shared__ __align__(16) int32_t s_lens[kTile * kSlots];
  __shared__ uint32_t s_words[kTile][kBufStride];   // per MB, MB-local
  __shared__ uint32_t s_mb_bits[kTile];
  __shared__ uint32_t s_mb_off[kTile];
  __shared__ unsigned long long s_bar;
  __shared__ unsigned int s_tile;
  __shared__ uint32_t s_prefix;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const uint32_t bar = smem_addr(&s_bar);

  // 1-2. a tile from the ticket, its lengths by one bulk copy
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const uint32_t t = atomicAdd(ticket, 1u);
    const uint32_t f = t / (uint32_t)tiles_per_frame;
    const int mb0 = (int)(t - f * tiles_per_frame) * kTile;
    const uint32_t bytes = (uint32_t)(min(kTile, nmb - mb0) * kSlots * 4);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(s_lens)),
        "l"(lens + ((long long)f * nmb + mb0) * kSlots), "r"(bytes), "r"(bar)
        : "memory");
    s_tile = t;
  }
  for (int i = tid; i < kTile * kBufStride; i += kThreads)
    (&s_words[0][0])[i] = 0u;
  __syncthreads();
  const uint32_t tile = s_tile;
  const uint32_t frame = tile / (uint32_t)tiles_per_frame;
  const int ti = (int)(tile - frame * tiles_per_frame);
  const bool active = warp < min(kTile, nmb - ti * kTile);
  int32_t* sl_mb = s_lens + warp * kSlots;
  const uint32_t* v_mb =
      vals + ((long long)frame * nmb + ti * kTile + warp) * kSlots;
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(bar)
      : "memory");

  // 3. per lane one segment of the MB's slots; the symbols it lists go
  // over lengths it has already read
  const int seg = lane < 5 ? 8 * lane : kUnitSlots * (lane - 4);
  const int seg_pairs = lane < 4 ? 4 : (lane == 4 ? 1 : kUnitSlots / 2);
  int32_t* sl = sl_mb + seg;
  uint32_t so = 0;                               // offset in the segment
  int n_sym = 0;
  if (active) {
#pragma unroll
    for (int k = 0; k < kUnitSlots / 2; ++k) {
      if (k < seg_pairs) {
        const int2 l2 = reinterpret_cast<const int2*>(sl)[k];
        if (l2.x > 0)
          sl[n_sym++] = (seg + 2 * k) | (so << 10) | (l2.x << 21);
        so += (uint32_t)l2.x;
        if (l2.y > 0)
          sl[n_sym++] = (seg + 2 * k + 1) | (so << 10) | (l2.y << 21);
        so += (uint32_t)l2.y;
      }
    }
  }
  const uint32_t sincl = warp_inclusive_scan(so);
  const uint32_t mb_bits = __shfl_sync(0xffffffffu, sincl, 31);
  const uint32_t seg_start = sincl - so;         // offset in the MB
  const uint32_t unit_start = lane < 5 ? 0u : seg_start;
  const int n_incl = (int)warp_inclusive_scan((uint32_t)n_sym);
  const int n_mb = __shfl_sync(0xffffffffu, n_incl, 31);
  if (lane == 0) s_mb_bits[warp] = active ? mb_bits : 0u;
  __syncthreads();

  // 4a. the tile's aggregate, published at once for the tiles after it
  uint32_t agg = 0;
  if (warp == 0) {
    const uint32_t b = lane < kTile ? s_mb_bits[lane] : 0u;
    const uint32_t incl = warp_inclusive_scan(b);
    if (lane < kTile) s_mb_off[lane] = incl - b;
    agg = __shfl_sync(0xffffffffu, incl, 31);
    if (lane == 0)
      store_release(status + tile,
                    (ti == 0 ? kFlagPrefix : kFlagAggregate) | agg);
  }

  // 5. the MB's symbols into its buffer, 32 at a time: symbol e is the
  // (e - first listed of L)-th symbol listed by lane L, the first lane
  // whose inclusive count exceeds e. Each keeps its bits below the unit
  // and MB drop boundaries.
  uint32_t* buf = s_words[warp];
  for (int e0 = 0; e0 < n_mb; e0 += 32 * kRounds) {
    uint32_t meta[kRounds], val[kRounds], start[kRounds], ustart[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int e = e0 + 32 * r + lane;
      int owner = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(0xffffffffu, n_incl, owner + step - 1) <= e)
          owner += step;
      owner = min(owner, 31);
      const int first_e = __shfl_sync(0xffffffffu, n_incl - n_sym, owner);
      start[r] = __shfl_sync(0xffffffffu, seg_start, owner);
      ustart[r] = __shfl_sync(0xffffffffu, unit_start, owner);
      const int o_seg = owner < 5 ? 8 * owner : kUnitSlots * (owner - 4);
      meta[r] = e < n_mb ? (uint32_t)sl_mb[o_seg + e - first_e] : 0u;
      val[r] = e < n_mb ? __ldg(v_mb + (meta[r] & 1023u)) : 0u;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int len = (int)(meta[r] >> 21);
      const uint32_t mo = start[r] + ((meta[r] >> 10) & 2047u);
      const int k = min(len, min(kUnitKeep - (int)(mo - ustart[r]),
                                 kMbKeep - (int)mo));
      if (k > 0) place(buf, mo, k, low_bits(val[r], len) >> (len - k));
    }
  }

  // 4b. the tile's place in the frame, by warp 0 after its own step 5:
  // lane i reads tile t - 1 - i, and the window moves back 32 tiles at a
  // time; only the tiles up to the nearest one with a prefix are waited for
  if (warp == 0) {
    uint32_t excl = 0;
    const int first = (int)tile - ti;           // the frame's first tile
    for (int j = (int)tile - 1; j >= first; j -= 32) {
      const int k = j - lane;                   // before the frame: prefix 0
      unsigned long long s = k >= first ? load_acquire(status + k)
                                        : kFlagPrefix;
      unsigned pmask, need;
      for (;;) {
        pmask = __ballot_sync(0xffffffffu, (s >> 32) == 2);
        need = pmask ? pmask ^ (pmask - 1) : 0xffffffffu;  // lanes <= it
        const unsigned wait =
            need & __ballot_sync(0xffffffffu, (s >> 32) == 0);
        if (!wait) break;
        if (wait >> lane & 1u) s = load_acquire(status + k);
      }
      excl += warp_sum(need >> lane & 1u ? (uint32_t)s : 0u);
      if (pmask) break;
    }
    if (lane == 0) {
      if (ti > 0) store_release(status + tile, kFlagPrefix | (excl + agg));
      if (ti == tiles_per_frame - 1) nbits[frame] = (int32_t)(excl + agg);
      s_prefix = excl;
    }
  }
  __syncthreads();
  if (!active || mb_bits == 0) return;

  // the buffer into the frame at bit offset off: word j of the MB's span
  // is (w[j] >> s) | (w[j - 1] << (32 - s)), s = off & 31, with s == 0
  // apart (a shift by 32 is undefined)
  const uint32_t off = s_prefix + s_mb_off[warp];
  const uint32_t s = off & 31u;
  const uint32_t end = s + mb_bits;              // bits from word 0's start
  const int n_words = (int)min((end + 31u) >> 5, (uint32_t)kBufWords);
  const int last = (int)((end - 1u) >> 5);
  uint32_t* fout = out + (long long)frame * out_words;
  const long long base = off >> 5;
  for (int j = lane; j < n_words; j += 32) {
    const long long idx = base + j;
    if (idx >= out_words) break;
    uint32_t w = buf[j];                         // buf[128] is 0
    if (s) w = (w >> s) | (j ? buf[j - 1] << (32u - s) : 0u);
    if (j == 0 || j == last) {
      if (w) atomicOr(&fout[idx], w);
    } else {
      fout[idx] = w;
    }
  }
}

}  // namespace

extern "C" long long h264lab_bitpack_tiles(long long n_frames, int nmb) {
  return n_frames * ((nmb + kTile - 1) / kTile);
}

extern "C" int h264lab_bitpack(const void* vals, const void* lens,
                               long long n_frames, int nmb,
                               long long out_words, void* out, void* nbits,
                               void* status, void* stream) {
  const long long n_tiles = h264lab_bitpack_tiles(n_frames, nmb);
  if (n_tiles <= 0) return 0;
  if (n_tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  // status: n_tiles look-back words, then the ticket counter, all zero
  pack_kernel<<<(unsigned)n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)vals, (const int32_t*)lens, nmb,
      (nmb + kTile - 1) / kTile, out_words, (uint32_t*)out, (int32_t*)nbits,
      (unsigned long long*)status,
      (unsigned int*)((unsigned long long*)status + n_tiles));
  return (int)cudaGetLastError();
}
