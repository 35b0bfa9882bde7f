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
// stay in L1/L2, so the least time is 3 B/symbol over 3.35 TB/s. At the
// engine's shapes (8 to 32 tiles, 0.06-0.25 MB) that is under 0.25 us, far
// below the cost of a launch; what bounds the kernel there is the launch,
// one load -> gather -> store round trip, and the rate at which L1 serves
// warp gathers that touch 32 distinct lines (about 0.7 gathers an SM clock
// on uniformly random symbols).
//
// Design: a thread's step is 8 symbols, one 16-byte load, 8 gathers and one
// 8-byte store, so a warp's loads and stores cover contiguous, aligned
// memory and the gather into the table is the only scattered access. While
// a launch fits one wave of resident 128-thread blocks (264 tiles on 132
// SMs), a block takes 128 steps, an eighth of a tile: 32 tiles spread over
// 256 blocks and every thread waits through one round trip. Past one wave,
// a 256-thread block takes a whole tile, 4 steps a thread with all loads
// issued before any gather: the first version's shape, which measured
// faster at 512 tiles x 8 tables and at Silesia size than 128-thread
// blocks of 4 or 8 steps, or a grid capped at 4 waves with a stride (1.9x
// slower at Silesia size). The block's table id is loaded beside the
// symbols, so it adds no round trip; the single-table form (no
// tile_tables) skips it and its bounds logic through a template parameter.
// Staging the selected table in shared memory would cost 33 KB of loads
// per 8 KB tile, more than the gathers it saves, so the table is read
// through __ldg instead.
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
constexpr int STEPS_PER_TILE = TILE / VEC;
// While a launch fits one wave of resident blocks, a 128-thread block takes
// one step a thread: a thread's one round trip is the whole kernel. Past
// that, a 256-thread block takes a whole tile, 4 steps a thread.
constexpr int SMALL_THREADS = 128;
constexpr int BLOCKS_PER_SM = 2048 / SMALL_THREADS;  // resident at full occupancy
constexpr int DEEP_THREADS = 256;
constexpr int DEEP_STEPS = 4;
static_assert(DEEP_THREADS * DEEP_STEPS == STEPS_PER_TILE, "a deep block is one tile");

__device__ __forceinline__ uint32_t gather2(const uint8_t* __restrict__ table, bool ok,
                                            uint32_t pair) {
  const uint32_t lo = pair & 0xFFFFu;
  const uint32_t hi = pair >> 16;
  const uint32_t a = (ok && lo < TABLE_SIZE) ? __ldg(table + lo) : 0u;
  const uint32_t b = (ok && hi < TABLE_SIZE) ? __ldg(table + hi) : 0u;
  return a | (b << 8);
}

// Each block covers THREADS * STEPS consecutive steps, which lie in one tile
// (THREADS * STEPS divides STEPS_PER_TILE), so it has one table.
// A thread takes steps i, i + THREADS, ...: each of its loads is coalesced
// across the warp, and all of them are issued before any gather.
// MULTI: each tile names its table in tile_tables; otherwise every tile
// reads table 0 and tile_tables is not touched.
template <int THREADS, int STEPS, bool MULTI>
__global__ void __launch_bounds__(THREADS)
marker_replace_kernel(const uint4* __restrict__ syms, const uint8_t* __restrict__ tables,
                      const int32_t* __restrict__ tile_tables, uint2* __restrict__ out,
                      int n_tables) {
  const int64_t first = (int64_t)blockIdx.x * THREADS * STEPS;
  const int32_t tid = MULTI ? __ldg(tile_tables + first / STEPS_PER_TILE) : 0;
  uint4 v[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) v[s] = __ldg(syms + first + s * THREADS + threadIdx.x);
  const bool ok = !MULTI || (tid >= 0 && tid < n_tables);
  const uint8_t* table = tables + (int64_t)(ok ? tid : 0) * TABLE_SIZE;
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
    uint2 r;
    r.x = gather2(table, ok, v[s].x) | (gather2(table, ok, v[s].y) << 16);
    r.y = gather2(table, ok, v[s].z) | (gather2(table, ok, v[s].w) << 16);
    out[first + s * THREADS + threadIdx.x] = r;
  }
}

int one_wave() {
  static int sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132 * BLOCKS_PER_SM;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  return BLOCKS_PER_SM * sms[dev];
}

template <int THREADS, int STEPS>
void launch(const uint4* in, const uint8_t* tabs, const int32_t* tids, uint2* dst,
            int64_t n_steps, int n_tables, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>(n_steps / (THREADS * STEPS));
  if (tids != nullptr) {
    marker_replace_kernel<THREADS, STEPS, true>
        <<<blocks, THREADS, 0, s>>>(in, tabs, tids, dst, n_tables);
  } else {
    marker_replace_kernel<THREADS, STEPS, false>
        <<<blocks, THREADS, 0, s>>>(in, tabs, tids, dst, n_tables);
  }
}

}  // namespace

// syms (n_tiles, TILE) uint16, tables (n_tables, TABLE_SIZE) uint8,
// tile_tables (n_tiles,) int32 or null (every tile reads table 0), out
// (n_tiles, TILE) uint8; all on the device, contiguous, syms and out 16-byte
// aligned. Launches on `stream` and returns cudaGetLastError().
extern "C" int marker_replace_launch(const void* syms, const void* tables,
                                     const void* tile_tables, void* out, int n_tiles,
                                     int n_tables, void* stream) {
  if (n_tiles > 0) {
    const int64_t n_steps = (int64_t)n_tiles * STEPS_PER_TILE;
    const uint4* in = static_cast<const uint4*>(syms);
    const uint8_t* tabs = static_cast<const uint8_t*>(tables);
    const int32_t* tids = static_cast<const int32_t*>(tile_tables);
    uint2* dst = static_cast<uint2*>(out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_steps / SMALL_THREADS <= one_wave()) {
      launch<SMALL_THREADS, 1>(in, tabs, tids, dst, n_steps, n_tables, s);
    } else {
      launch<DEEP_THREADS, DEEP_STEPS>(in, tabs, tids, dst, n_steps, n_tables, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
