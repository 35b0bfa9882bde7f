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
// Bound: the work itself is bound by bytes (1/8 B in and 1 B out per
// offset): its least integer work, steps 1-3 bit-sliced over 32 offsets a
// word and step 4 only for the offsets that pass them (about 1 in 9), takes
// less time than the bytes (chip_smoke.py counts it on the run's data).
// This kernel is bound by integer operations instead: it runs the whole
// cascade for every offset, about 120 SASS instructions each, most of
// them in the 19 precode lengths and the 64-bit shifts of the precode word.
//
// Design (simple first version):
//   * one block of 256 threads per 2048 offsets; each thread owns 8
//     consecutive offsets and writes their mask bytes as one 8-byte store;
//   * the block stages its bytes in shared memory with coalesced loads,
//     already shifted by start_bit % 8, as 32-bit words: bit p of the stage
//     is bit start + p of the stream, so every thread's window starts in an
//     aligned word and __funnelshift_r by 0..31 builds it in registers;
//   * the cascade is branch-free; the Kraft terms come from one byte
//     permute of an 8-entry table (cl = 0 gives 0, so masking the precode
//     to its HCLEN + 4 lengths drops the inactive ones).
// A later version could evaluate steps 1-3 bit-sliced, 32 offsets per word
// (a handful of logic operations for 32 offsets), and run the Kraft step
// only for the offsets that pass them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int BLOCK = THREADS * PER_THREAD;  // 2048 offsets
// Thread t reads stage words t/4 .. t/4 + 3, so the stage holds 67 words
// (2144 bits): the block's 2048 + 73 bits and the last thread's overrun.
constexpr int STAGE_WORDS = (THREADS - 1) / 4 + 4;

// Kraft term 128 >> cl for cl = 1..7 and 0 for cl = 0, as bytes 0..7 of the
// pair (lo, hi) for __byte_perm.
constexpr uint32_t KRAFT_LO = 0x10204000u;
constexpr uint32_t KRAFT_HI = 0x01020408u;

__device__ __forceinline__ uint32_t load_byte(const uint8_t* __restrict__ data, int64_t n_bytes,
                                              int64_t i) {
  return (i >= 0 && i < n_bytes) ? static_cast<uint32_t>(__ldg(data + i)) : 0u;
}

// 1 if the 74 bits starting at bit 0 of (r0, r1, r2) pass steps 1-4.
__device__ __forceinline__ uint32_t check(uint32_t r0, uint32_t r1, uint32_t r2) {
  const bool head = (r0 & 7u) == 4u && ((r0 >> 3) & 31u) < 30u;  // (1) (2) (3)
  const uint32_t n_bits = 3u * (((r0 >> 13) & 15u) + 4u);      // 12..57
  // The precode lengths, bits 17..73, masked to the first HCLEN + 4.
  uint64_t pre = (static_cast<uint64_t>(__funnelshift_r(r1, r2, 17)) << 32) |
                 __funnelshift_r(r0, r1, 17);
  pre &= (1ull << n_bits) - 1ull;
  uint32_t kraft = 0;
#pragma unroll
  for (int k = 0; k < 19; ++k) {
    const uint32_t cl = static_cast<uint32_t>(pre >> (3 * k)) & 7u;
    kraft += __byte_perm(KRAFT_LO, KRAFT_HI, cl);
  }
  return (head && kraft == 128u) ? 1u : 0u;  // (4)
}

__global__ void __launch_bounds__(THREADS)
precode_check_kernel(const uint8_t* __restrict__ data, int64_t n_bytes, int64_t start_bit,
                     int64_t n_offsets, uint8_t* __restrict__ out) {
  __shared__ uint32_t stage[STAGE_WORDS];
  const int64_t first = (int64_t)blockIdx.x * BLOCK;  // first offset of the block
  const int64_t bit0 = start_bit + first;
  const int64_t byte0 = bit0 >> 3;
  const int shift = static_cast<int>(bit0 & 7);

  // Stage word i = stream bits bit0 + 32 i .. + 31, from bytes byte0 + 4 i ..
  // byte0 + 4 i + 4; neighbouring threads read neighbouring bytes.
  for (int i = threadIdx.x; i < STAGE_WORDS; i += THREADS) {
    const int64_t b = byte0 + 4 * i;
    uint64_t w = 0;
#pragma unroll
    for (int j = 0; j < 5; ++j) w |= static_cast<uint64_t>(load_byte(data, n_bytes, b + j)) << (8 * j);
    stage[i] = static_cast<uint32_t>(w >> shift);
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int base = (t & 3) * 8;  // the thread's first offset within word t / 4
  const uint32_t w0 = stage[t / 4], w1 = stage[t / 4 + 1];
  const uint32_t w2 = stage[t / 4 + 2], w3 = stage[t / 4 + 3];
  uint64_t bytes = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int sh = base + j;  // 0..31
    const uint32_t ok = check(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                              __funnelshift_r(w2, w3, sh));
    bytes |= static_cast<uint64_t>(ok) << (8 * j);
  }

  const int64_t o = first + t * PER_THREAD;
  if (o + PER_THREAD <= n_offsets) {
    *reinterpret_cast<uint64_t*>(out + o) = bytes;  // out is 8-byte aligned
  } else {
    for (int j = 0; j < PER_THREAD && o + j < n_offsets; ++j) {
      out[o + j] = static_cast<uint8_t>(bytes >> (8 * j));
    }
  }
}

}  // namespace

// data (n_bytes,) uint8 on the device; out (n_offsets,) uint8, 8-byte
// aligned. Offset i of out is bit start_bit + i of data, LSB first. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int precode_check_launch(const void* data, long long n_bytes, long long start_bit,
                                    long long n_offsets, void* out, void* stream) {
  if (n_offsets > 0) {
    const long long blocks = (n_offsets + BLOCK - 1) / BLOCK;
    precode_check_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), n_bytes, start_bit, n_offsets,
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
