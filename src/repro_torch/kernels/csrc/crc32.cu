// Per-lane CRC-32 on Hopper (sm_90a).
//
// Replaces repro/kernels/crc32.py::crc32_segments_batched (and, with B = 1,
// ::crc32_segments): for each of the B x 1024 lanes of a (B, 8, 128, seg_len)
// uint8 array, the reflected CRC-32 (poly 0xEDB88320, init and xorout
// 0xFFFFFFFF) of its seg_len bytes, byte at a time through a 256-entry
// table. The host merges lane CRCs with the GF(2) combine (core/crc32.py).
// The reference took the bytes as int32; here they are uint8, 4x fewer bytes.
//
// Bound: bytes, 1 B read per input byte. The least time is B * 1024 *
// seg_len bytes over 3.35 TB/s.
//
// Design (simple first version): the table lives in shared memory, one
// thread per lane, and each thread walks its lane 16 bytes per load.
//
// The gap to the bound has two known causes, left for a later change:
//   * lanes are contiguous along seg_len, so the 32 threads of a warp load
//     from addresses seg_len bytes apart: every load touches 32 different
//     sectors, and the L1 has to hold a sector per thread between steps
//     (uncoalesced). Transposing at pack time, or staging a (32 x 16 B) tile
//     through shared memory per step, would fix it;
//   * B = 1 gives only 1024 threads (8 blocks) on 132 SMs, so the card is
//     mostly idle; splitting each lane into sub-lanes combined on the device
//     would give the card enough blocks. The table walk is also a serial
//     dependency chain of a shared-memory load and two ALU operations per
//     byte, so one lane runs at latency, not at bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t step_word(const uint32_t* lut, uint32_t crc, uint32_t w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    crc = (crc >> 8) ^ lut[(crc ^ (w >> (8 * k))) & 0xFFu];
  }
  return crc;
}

__global__ void __launch_bounds__(THREADS)
crc32_lanes_kernel(const uint8_t* __restrict__ data, const uint32_t* __restrict__ table,
                   uint32_t* __restrict__ out, int64_t n_lanes, int64_t seg_len) {
  __shared__ uint32_t lut[256];
  for (int i = threadIdx.x; i < 256; i += THREADS) lut[i] = table[i];
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n_lanes) return;
  const uint8_t* p = data + lane * seg_len;
  uint32_t crc = 0xFFFFFFFFu;
  if ((seg_len & 15) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    for (int64_t i = 0; i < seg_len / 16; ++i) {
      const uint4 v = __ldg(q + i);
      crc = step_word(lut, crc, v.x);
      crc = step_word(lut, crc, v.y);
      crc = step_word(lut, crc, v.z);
      crc = step_word(lut, crc, v.w);
    }
  } else {
    for (int64_t i = 0; i < seg_len; ++i) crc = (crc >> 8) ^ lut[(crc ^ p[i]) & 0xFFu];
  }
  out[lane] = ~crc;
}

}  // namespace

// data (n_lanes, seg_len) uint8, 16-byte aligned; table (256,) uint32;
// out (n_lanes,) uint32; all on the device and contiguous. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int crc32_launch(const void* data, const void* table, void* out, long long n_lanes,
                            long long seg_len, void* stream) {
  if (n_lanes > 0) {
    const long long blocks = (n_lanes + THREADS - 1) / THREADS;
    crc32_lanes_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(data), static_cast<const uint32_t*>(table),
        static_cast<uint32_t*>(out), n_lanes, seg_len);
  }
  return static_cast<int>(cudaGetLastError());
}
