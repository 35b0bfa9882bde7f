// Stage-2 marker replacement on Hopper (sm_90a).
//
// Replaces repro/kernels/marker_replace.py::marker_replace_tiles_multi (and,
// with n_tables = 1, ::marker_replace_tiles):
//
//     out[t][i] = tables[tile_tables[t]][syms[t][i]]
//
// over tiles of TILE = 8 x 1024 symbols. A symbol below 256 is a literal and
// maps to itself; a symbol 256 + k is a marker and maps to byte k of the
// chunk's 32 KiB window. The reference carried int32 everywhere; here every
// type is as narrow as the data: symbols uint16 (stage 1 emits uint16 and
// every value is < TABLE_SIZE = 33024), tables and output uint8.
//
// Bound: bytes. Per symbol 2 B are read and 1 B written; the tables (33 KB
// each, at most a few per launch) are read through the read-only cache and
// stay in L1/L2, so the least time is 3 B/symbol over 3.35 TB/s.
//
// Design: one block per tile. The block reads its table id once, then each
// thread moves 8 symbols per step with one 16-byte load and one 8-byte
// store, so a warp's loads and stores cover contiguous, aligned memory. The
// gather into the table is the only scattered access. Staging the selected
// table in shared memory would cost 33 KB of loads per 8 KB tile, more than
// the gathers it saves, so the table is read through __ldg instead.
//
// Bounds: a symbol >= TABLE_SIZE or a table id outside [0, n_tables) writes
// 0. Pad lanes of a staging buffer hold whatever they last held, so the
// gather must never trust them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TABLE_SIZE = 33024;
constexpr int TILE = 8 * 1024;
constexpr int VEC = 8;  // symbols per thread step: 16 B in, 8 B out
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t gather2(const uint8_t* __restrict__ table, bool ok,
                                            uint32_t pair) {
  const uint32_t lo = pair & 0xFFFFu;
  const uint32_t hi = pair >> 16;
  const uint32_t a = (ok && lo < TABLE_SIZE) ? __ldg(table + lo) : 0u;
  const uint32_t b = (ok && hi < TABLE_SIZE) ? __ldg(table + hi) : 0u;
  return a | (b << 8);
}

__global__ void __launch_bounds__(THREADS)
marker_replace_kernel(const uint16_t* __restrict__ syms, const uint8_t* __restrict__ tables,
                      const int32_t* __restrict__ tile_tables, uint8_t* __restrict__ out,
                      int n_tables) {
  const int64_t tile = blockIdx.x;
  const int32_t tid = tile_tables[tile];
  const bool ok = tid >= 0 && tid < n_tables;
  const uint8_t* table = tables + (int64_t)(ok ? tid : 0) * TABLE_SIZE;
  const uint4* src = reinterpret_cast<const uint4*>(syms + tile * TILE);
  uint2* dst = reinterpret_cast<uint2*>(out + tile * TILE);
  for (int i = threadIdx.x; i < TILE / VEC; i += THREADS) {
    const uint4 v = src[i];
    uint2 r;
    r.x = gather2(table, ok, v.x) | (gather2(table, ok, v.y) << 16);
    r.y = gather2(table, ok, v.z) | (gather2(table, ok, v.w) << 16);
    dst[i] = r;
  }
}

}  // namespace

// syms (n_tiles, TILE) uint16, tables (n_tables, TABLE_SIZE) uint8,
// tile_tables (n_tiles,) int32, out (n_tiles, TILE) uint8; all on the device,
// contiguous, syms and out 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int marker_replace_launch(const void* syms, const void* tables,
                                     const void* tile_tables, void* out, int n_tiles,
                                     int n_tables, void* stream) {
  if (n_tiles > 0) {
    marker_replace_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(syms), static_cast<const uint8_t*>(tables),
        static_cast<const int32_t*>(tile_tables), static_cast<uint8_t*>(out), n_tables);
  }
  return static_cast<int>(cudaGetLastError());
}
