// Dynamic-block precheck of the block finder on Hopper (sm_90a).
//
// Replaces repro/kernels/precode_check.py::precode_check_blocks
// (src/repro/kernels/precode_check.py:75; its pallas_call at :83, kernel
// body at :47): for every bit
// offset o in [start_bit, start_bit + n_offsets) of an LSB-first byte
// stream, 1 if the deflate header read at o passes steps 1-4 of the finder
// (paper §3.4.2), else 0:
//
//   (1) final bit 0;  (2) block type bits (0, 1);  (3) HLIT = field(3, 5) < 30;
//   (4) over k < HCLEN + 4, HCLEN = field(13, 4), cl_k = field(17 + 3k, 3):
//       the sum of 128 >> cl_k over the cl_k > 0 equals 128 (Kraft).
//
// Each offset reads a 74-bit window (17 header bits + 19 x 3 precode bits).
// Bytes past the buffer read as zero: the reference's zero sentinel row.
//
// The reference read one int32 per bit, 32 bytes of memory per input byte.
// Here the input is the compressed bytes themselves, the output one uint8
// per offset.
//
// Bound: bytes (1/8 B in and 1 B out per offset). The first version ran
// the whole cascade for every offset, about 120 instructions each, and was
// bound by its own instruction count at 16x the byte bound. This one does
// the least work that chip_smoke.py counts for the bound:
//   * steps 1-3 bit-sliced: a lane owns W words of 32 offsets; a word's
//     bit planes P_k = header bit k at each of its offsets are funnel
//     shifts of two stage words, and ~P0 & ~P1 & P2 & ~(P4 & P5 & P6 & P7)
//     is the word of offsets that pass (about 1 in 9 on compressed data);
//   * step 4 only for those survivors, compacted per warp so that all 32
//     lanes work: a prefix sum of the lanes' popcounts places each survivor
//     in a queue in shared memory, and the warp takes the queue 32 at a
//     time. A survivor's precode lengths are masked to its HCLEN + 4 (two
//     masks from a 16-entry table) and summed through a 64-entry table of
//     the Kraft terms of two lengths at once: 10 lookups, one bank each,
//     so no conflicts;
//   * the result bits go to a per-word mask in shared memory, and each
//     lane expands 16 of them to 16 bytes (a nibble to 4 bytes by one
//     multiply and mask) for one 16-byte store: a warp writes 512
//     contiguous bytes a store.
// A block stages its bytes once, shifted by the start bit, with aligned
// 4-byte loads (bounds-checked only in a block that touches either end of
// the buffer); after that every phase is warp-local.
//
// What holds it back now is step 4's integer work: on an NVIDIA H100 80GB
// HBM3 (700.00 W power limit), the 12.76 MB gzip of chip_smoke.py's main
// path takes about 0.060 ms against a 0.034 ms byte bound, and the same
// kernel without its stores about 0.048 ms. The survivors' shifts, masks and table sums issue
// on the ALU pipe (16 lanes a clock per SM quarter); what a warp pays once
// per word (prefix sum, the divergent enqueue loop, a queue's last partial
// round) is spread over W = 4 words a lane for large launches. Small
// launches take W = 1, which spreads the same offsets over 4x the warps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// Offsets a block takes with W words a lane.
template <int W>
__host__ __device__ constexpr int block_offsets() { return THREADS * 32 * W; }

__host__ __device__ constexpr uint32_t kraft_term(uint32_t cl) { return cl ? 128u >> cl : 0u; }

// The little-endian 32-bit word at data + i, bytes outside [0, n_bytes)
// reading as zero; data + i is 4-byte aligned.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ data, int64_t n_bytes,
                                              int64_t i) {
  if (i >= 0 && i + 4 <= n_bytes) return __ldg(reinterpret_cast<const uint32_t*>(data + i));
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i + k >= 0 && i + k < n_bytes) w |= static_cast<uint32_t>(__ldg(data + i + k)) << (8 * k);
  }
  return w;
}

// Bits 0..3 of x as the bytes 0/1 of a word (bit i to bit 8 i: no carries).
__device__ __forceinline__ uint32_t spread(uint32_t x) { return (x * 0x00204081u) & 0x01010101u; }

template <int W>
__global__ void __launch_bounds__(THREADS)
precode_check_kernel(const uint8_t* __restrict__ data, int64_t n_bytes, int64_t start_bit,
                     int64_t n_offsets, uint8_t* __restrict__ out, bool out16) {
  // Offset 32 i + j of the block reads bits up to 32 i + 31 + 73: stage
  // words i .. i + 3.
  constexpr int STAGE_WORDS = THREADS * W + 3;
  // An offset that passes steps 1-3 has bits (0, 0, 1) at o, o + 1, o + 2,
  // so the next one starts at o + 3 or later: a warp's 1024 W offsets hold
  // at most ceil(1024 W / 3).
  constexpr int QUEUE = (1024 * W + 2) / 3;
  __shared__ uint32_t stage[STAGE_WORDS];
  __shared__ uint32_t result[THREADS * W];
  __shared__ uint16_t queue[WARPS][QUEUE];
  __shared__ uint2 masks[16];     // HCLEN -> masks of precode lengths 0..9 and 10..18
  __shared__ uint8_t kraft2[64];  // two lengths (a | b << 3) -> their Kraft terms' sum

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * block_offsets<W>();

  // Stage word i = stream bits bit0 + 32 i .. + 31, from the aligned words
  // around it; neighbouring threads read neighbouring words.
  const int64_t bit0 = start_bit + first;
  const int64_t byte0 = bit0 >> 3;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(data) + byte0) & 3);
  const int64_t w0 = byte0 - mis;
  const int shift = 8 * mis + static_cast<int>(bit0 & 7);  // 0..31
  if (w0 >= 0 && w0 + 4 * (STAGE_WORDS + 1) <= n_bytes) {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(data + w0);
    for (int i = t; i < STAGE_WORDS; i += THREADS) {
      stage[i] = __funnelshift_r(__ldg(src + i), __ldg(src + i + 1), shift);
    }
  } else {
    for (int i = t; i < STAGE_WORDS; i += THREADS) {
      stage[i] = __funnelshift_r(load_word(data, n_bytes, w0 + 4 * i),
                                 load_word(data, n_bytes, w0 + 4 * i + 4), shift);
    }
  }
  if (t < 64) kraft2[t] = static_cast<uint8_t>(kraft_term(t & 7) + kraft_term(t >> 3));
  if (t < 16) {
    const int n = t + 4;  // precode lengths read
    const int n_lo = n < 10 ? n : 10;
    masks[t] = make_uint2((1u << (3 * n_lo)) - 1u, n > 10 ? (1u << (3 * (n - 10))) - 1u : 0u);
  }
#pragma unroll
  for (int k = 0; k < W; ++k) result[W * t + k] = 0;
  __syncthreads();

  // The warp's words are 32 W .. 32 W + 32 W - 1 of the block; the lane's
  // are W lane .. W lane + W - 1 of those.
  const uint32_t* st = stage + 32 * W * warp;
  uint32_t* res = result + 32 * W * warp;
  const int64_t warp_first = first + 1024 * W * warp;

  // Steps 1-3, bit-sliced, for the lane's W words.
  uint32_t pass[W];
  int count = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int wi = W * lane + k;
    const int64_t o = warp_first + 32 * wi;
    const uint32_t a = st[wi], b = st[wi + 1];
    const uint32_t p1 = __funnelshift_r(a, b, 1), p2 = __funnelshift_r(a, b, 2);
    const uint32_t hlit_top = __funnelshift_r(a, b, 4) & __funnelshift_r(a, b, 5) &
                              __funnelshift_r(a, b, 6) & __funnelshift_r(a, b, 7);
    uint32_t p = ~a & ~p1 & p2 & ~hlit_top;  // (1) (2) (3)
    if (o + 32 > n_offsets) p = o >= n_offsets ? 0u : p & ((1u << static_cast<int>(n_offsets - o)) - 1u);
    pass[k] = p;
    count += __popc(p);
  }

  // Queue the warp's survivors: entry = word << 5 | bit, words in order.
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  uint16_t* q = queue[warp];
  int pos = incl - count;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    for (uint32_t m = pass[k]; m; m &= m - 1) {
      q[pos++] = static_cast<uint16_t>((W * lane + k) << 5 | (__ffs(m) - 1));
    }
  }
  __syncwarp();

  // Step 4, one queued offset a lane.
  for (int r = lane; r < total; r += 32) {
    const int e = q[r];
    const int w = e >> 5, j = e & 31;
    const uint32_t s0 = st[w], s1 = st[w + 1], s2 = st[w + 2], s3 = st[w + 3];
    const uint32_t r0 = __funnelshift_r(s0, s1, j);  // window bits 0..31
    const uint32_t r1 = __funnelshift_r(s1, s2, j);  // 32..63
    const uint32_t r2 = __funnelshift_r(s2, s3, j);  // 64..95
    const uint2 m = masks[(r0 >> 13) & 15u];
    const uint32_t lo = __funnelshift_r(r0, r1, 17) & m.x;  // lengths 0..9 at bits 3k
    const uint32_t hi = __funnelshift_r(r1, r2, 15) & m.y;  // lengths 10..18
    const uint32_t kraft = kraft2[lo & 63u] + kraft2[(lo >> 6) & 63u] + kraft2[(lo >> 12) & 63u] +
                           kraft2[(lo >> 18) & 63u] + kraft2[lo >> 24] + kraft2[hi & 63u] +
                           kraft2[(hi >> 6) & 63u] + kraft2[(hi >> 12) & 63u] +
                           kraft2[(hi >> 18) & 63u] + kraft2[hi >> 24];
    if (kraft == 128u) atomicOr(&res[w], 1u << j);  // (4)
  }
  __syncwarp();

  // The warp's 1024 W mask bytes, 16 a lane per store.
#pragma unroll
  for (int h = 0; h < 2 * W; ++h) {
    const int local = 512 * h + 16 * lane;
    const uint32_t bits = res[local >> 5] >> (local & 16);
    const uint4 v = make_uint4(spread(bits & 15u), spread((bits >> 4) & 15u),
                               spread((bits >> 8) & 15u), spread((bits >> 12) & 15u));
    const int64_t at = warp_first + local;
    if (at + 16 <= n_offsets) {
      if (out16) {
        *reinterpret_cast<uint4*>(out + at) = v;
      } else {  // out is 8-byte aligned
        reinterpret_cast<uint2*>(out + at)[0] = make_uint2(v.x, v.y);
        reinterpret_cast<uint2*>(out + at)[1] = make_uint2(v.z, v.w);
      }
    } else {
      for (int k = 0; at + k < n_offsets; ++k) out[at + k] = static_cast<uint8_t>((bits >> k) & 1u);
    }
  }
}

template <int W>
void launch(const void* data, long long n_bytes, long long start_bit, long long n_offsets,
            void* out, cudaStream_t stream) {
  const long long blocks = (n_offsets + block_offsets<W>() - 1) / block_offsets<W>();
  const bool out16 = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  precode_check_kernel<W><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(data), n_bytes, start_bit, n_offsets,
      static_cast<uint8_t*>(out), out16);
}

}  // namespace

// data (n_bytes,) uint8 on the device; out (n_offsets,) uint8, 8-byte
// aligned. Offset i of out is bit start_bit + i of data, LSB first. Launches
// on `stream` and returns cudaGetLastError(). Four words a lane once the
// launch gives every SM at least two such blocks, one word a lane below.
extern "C" int precode_check_launch(const void* data, long long n_bytes, long long start_bit,
                                    long long n_offsets, void* out, void* stream) {
  if (n_offsets > 0) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_offsets >= 2LL * sms * block_offsets<4>()) {
      launch<4>(data, n_bytes, start_bit, n_offsets, out, s);
    } else {
      launch<1>(data, n_bytes, start_bit, n_offsets, out, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
