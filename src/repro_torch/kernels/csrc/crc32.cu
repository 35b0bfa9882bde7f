// Per-lane CRC-32 on Hopper (sm_90a).
//
// Replaces repro/kernels/crc32.py::crc32_segments_batched (and, with B = 1,
// ::crc32_segments): for each of the B x 1024 lanes of a (B, 8, 128, seg_len)
// uint8 array, the reflected CRC-32 (poly 0xEDB88320, init and xorout
// 0xFFFFFFFF) of its seg_len bytes, byte at a time through a 256-entry
// table. The reference took the bytes as int32; here they are uint8, 4x
// fewer bytes. A folding launch also writes each request's CRC over its
// first full[b] lanes (see "Fold" below), which the reference's host merged
// lane by lane with the GF(2) combine (core/crc32.py).
//
// Bound: bytes, 1 B read per input byte. The least time is B * 1024 *
// seg_len bytes over 3.35 TB/s. What bounds this kernel instead is the
// table walk: one shared-memory lookup per byte, a dependent chain within a
// thread, and lookups of random bytes that collide in the 32 banks.
//
// Design: one warp per lane, split into 32 pieces. A lane is seen as
// 32 * piece_len bytes with 32 * piece_len - seg_len zero bytes in front
// (piece_len = 4 * ceil(seg_len / 128)); zeros ahead of a register that
// starts at 0 leave it at 0, so every piece has the same length, even for a
// ragged seg_len. In rounds of 64 bytes a piece, the warp stages its lane in
// shared memory with coalesced 4-byte loads (byte loads where seg_len is not
// a multiple of 4), 17 words a piece so that thread k reading piece k hits 32
// distinct banks; thread k then runs its piece through the table from a zero
// register. The 32 registers merge pairwise in 5 warp-shuffle levels by the
// linear identity reg(A|B) = shift_|B|(reg(A)) ^ reg(B), where shift_n feeds
// n zero bytes through a register: at level l thread k (k a multiple of
// 2^(l+1)) takes thread k + 2^l's register and shifts its own by
// piece_len * 2^l bytes. Last, the init: crc = ~(shift_seg_len(~0) ^ reg).
// The host builds the 5 shift operators (32-word GF(2) matrices) and
// shift_seg_len(~0) for each seg_len and passes them as kernel parameters,
// so each matrix row is a constant-bank operand. At B = 1 and seg_len 2048
// a thread's chain is 64 lookups and 5 matrix steps instead of 2048
// lookups, and 32 768 threads run instead of 1024.
//
// Below SPLIT_MIN_SEG_LEN (128, in crc32.py; the host passes piece_words 0)
// one thread walks each lane, as the first version did. A first split
// kernel cost 1.7 us more than that walk at 32 bytes, and the walk grows by
// about 37 ns a byte on this card, so the two cross near 80 bytes; from 128
// bytes on every piece is at least a whole word.
//
// Fold: a request's first full lanes are consecutive pieces of one stream,
// so by the same identity its CRC is the XOR over s < full of crc_s
// shifted by (full - 1 - s) * seg_len bytes. The shift is a product of the
// operators for seg_len * 2^j bytes, one for each set bit j of
// full - 1 - s (10 bits: 1024 lanes); the host builds the 10 operators
// and passes them, with each request's full, as kernel parameters. Each
// lane's share is XOR-ed within its block (all of a block's lanes belong to
// one request) and then, once a block or a warp, atomically into the
// request's word, which the launch zeroes first on its stream. XOR
// commutes, so the word does not depend on the order blocks finish in.
// Lanes at or past full add nothing: the engine packs only the first full
// and leaves stale bytes in the rest.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;  // lanes per block on the split path
constexpr int ROUND_WORDS = 16;      // words of each piece staged per round
constexpr int PIECE_STRIDE = ROUND_WORDS + 1;  // odd: conflict-free reads
constexpr int LEVELS = 5;                      // log2(32 pieces)

constexpr int N_SEGMENTS = 8 * 128;  // lanes a request
constexpr int FOLD_LEVELS = 10;      // log2(N_SEGMENTS)
constexpr int MAX_FOLD_BATCH = 64;   // requests a folding launch (crc32.py)

struct CombineOps {
  uint32_t shift[LEVELS][32];  // row b: the image of register bit b
  uint32_t init_shift;         // shift_seg_len(0xFFFFFFFF)
};

struct FoldOps {
  uint32_t level[FOLD_LEVELS][32];  // shift by seg_len * 2^j bytes
  int32_t full[MAX_FOLD_BATCH];     // lanes folded, a request
};
static_assert(sizeof(FoldOps) == 4 * (FOLD_LEVELS * 32 + MAX_FOLD_BATCH), "FoldOps layout");

struct NoFold {};
template <bool FOLD>
using FoldArg = std::conditional_t<FOLD, FoldOps, NoFold>;

// rows x over GF(2): the XOR of the rows of x's set bits, in four partial
// sums (a chain of 8 dependent XORs, not 32).
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* rows, uint32_t x) {
  uint32_t part[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 32; ++b) part[b & 3] ^= rows[b] & (0u - ((x >> b) & 1u));
  return (part[0] ^ part[1]) ^ (part[2] ^ part[3]);
}

// Lane `lane`'s share of its request's CRC: its CRC shifted past the lanes
// after it in the request, or 0 for a lane at or past full.
__device__ __forceinline__ uint32_t fold_share(const FoldOps& f, int64_t lane, uint32_t crc) {
  const int m = f.full[lane / N_SEGMENTS] - 1 - static_cast<int>(lane % N_SEGMENTS);
  if (m < 0) return 0u;
#pragma unroll
  for (int j = 0; j < FOLD_LEVELS; ++j) {
    if ((m >> j) & 1) crc = gf2_apply(f.level[j], crc);
  }
  return crc;
}

__device__ __forceinline__ uint32_t step_word(const uint32_t* lut, uint32_t crc, uint32_t w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    crc = (crc >> 8) ^ lut[(crc ^ (w >> (8 * k))) & 0xFFu];
  }
  return crc;
}

// One thread per lane (seg_len below SPLIT_MIN_SEG_LEN).
template <bool FOLD>
__global__ void __launch_bounds__(THREADS)
crc32_lanes_kernel(const uint8_t* __restrict__ data, const uint32_t* __restrict__ table,
                   uint32_t* __restrict__ out, uint32_t* __restrict__ folded, int64_t n_lanes,
                   int64_t seg_len, const __grid_constant__ FoldArg<FOLD> fold) {
  __shared__ uint32_t lut[256];
  for (int i = threadIdx.x; i < 256; i += THREADS) lut[i] = table[i];
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool live = lane < n_lanes;
  uint32_t crc = 0xFFFFFFFFu;
  if (live) {
    const uint8_t* p = data + lane * seg_len;
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
  if constexpr (FOLD) {
    // A block's THREADS lanes belong to one request: one atomic a warp.
    uint32_t x = live ? fold_share(fold, lane, ~crc) : 0u;
#pragma unroll
    for (int d = 16; d; d >>= 1) x ^= __shfl_xor_sync(0xFFFFFFFFu, x, d);
    if ((threadIdx.x & 31) == 0 && x) {
      atomicXor(folded + (int64_t)blockIdx.x * THREADS / N_SEGMENTS, x);
    }
  }
}

// Word of the lane at byte offset v (a multiple of 4 when ALIGNED); bytes
// before the lane (v < 0) are the zero padding.
template <bool ALIGNED>
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ p, int64_t v) {
  if (ALIGNED) return v < 0 ? 0u : __ldg(reinterpret_cast<const uint32_t*>(p + v));
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    if (v + b >= 0) w |= (uint32_t)__ldg(p + v + b) << (8 * b);
  }
  return w;
}

// One warp per lane. ALIGNED: seg_len % 4 == 0, so every lane starts on a
// word and the padding is whole words.
template <bool ALIGNED, bool FOLD>
__global__ void __launch_bounds__(THREADS)
crc32_split_kernel(const uint8_t* __restrict__ data, const uint32_t* __restrict__ table,
                   uint32_t* __restrict__ out, uint32_t* __restrict__ folded, int64_t n_lanes,
                   int64_t seg_len, int piece_words, const __grid_constant__ CombineOps ops,
                   const __grid_constant__ FoldArg<FOLD> fold) {
  __shared__ uint32_t lut[256];
  __shared__ uint32_t stage[WARPS][32 * PIECE_STRIDE];
  const int warp = threadIdx.x >> 5;
  const int k = threadIdx.x & 31;
  const int64_t lane = (int64_t)blockIdx.x * WARPS + warp;
  const bool live = lane < n_lanes;
  const uint8_t* p = data + lane * seg_len;
  const int64_t pad = 128LL * piece_words - seg_len;
  uint32_t* buf = stage[warp];
  // The table's loads and the first round's are in flight together.
  uint32_t t_words[256 / THREADS];
#pragma unroll
  for (int i = 0; i < 256 / THREADS; ++i) t_words[i] = __ldg(table + i * THREADS + threadIdx.x);
  uint32_t reg = 0;
  for (int r0 = 0; r0 < piece_words; r0 += ROUND_WORDS) {
    const int n = min(ROUND_WORDS, piece_words - r0);
    if (live) {
#pragma unroll
      for (int t = 0; t < ROUND_WORDS; ++t) {
        // Word q of the round is word j of piece pc: a warp's 32 loads
        // cover two runs of 64 contiguous bytes.
        const int q = t * 32 + k;
        const int pc = q / ROUND_WORDS;
        const int j = q % ROUND_WORDS;
        if (j < n) {
          const int64_t v = 4 * ((int64_t)pc * piece_words + r0 + j) - pad;
          buf[pc * PIECE_STRIDE + j] = load_word<ALIGNED>(p, v);
        }
      }
    }
    if (r0 == 0) {
#pragma unroll
      for (int i = 0; i < 256 / THREADS; ++i) lut[i * THREADS + threadIdx.x] = t_words[i];
      __syncthreads();
    } else {
      __syncwarp();
    }
    for (int j = 0; j < n; ++j) reg = step_word(lut, reg, buf[k * PIECE_STRIDE + j]);
    __syncwarp();
  }
  uint32_t crc = 0;
  if (live) {  // the whole warp takes the same branch
#pragma unroll
    for (int l = 0; l < LEVELS; ++l) {
      const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, reg, 1 << l);
      const uint32_t shifted = gf2_apply(ops.shift[l], reg);
      if ((k & ((2 << l) - 1)) == 0) reg = shifted ^ right;
    }
    crc = ~(reg ^ ops.init_shift);
    if (k == 0) out[lane] = crc;
  }
  if constexpr (FOLD) {
    // A block's WARPS lanes belong to one request: one atomic a block.
    __shared__ uint32_t share[WARPS];
    if (k == 0) share[warp] = live ? fold_share(fold, lane, crc) : 0u;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t x = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) x ^= share[w];
      if (x) atomicXor(folded + (int64_t)blockIdx.x * WARPS / N_SEGMENTS, x);
    }
  }
}

template <bool FOLD>
void launch(const uint8_t* in, const uint32_t* lut, uint32_t* dst, uint32_t* folded,
            long long n_lanes, long long seg_len, int piece_words, const void* ops,
            const FoldArg<FOLD>& fold, cudaStream_t s) {
  if (piece_words == 0) {
    const long long blocks = (n_lanes + THREADS - 1) / THREADS;
    crc32_lanes_kernel<FOLD><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        in, lut, dst, folded, n_lanes, seg_len, fold);
    return;
  }
  const CombineOps params = *static_cast<const CombineOps*>(ops);
  const unsigned blocks = static_cast<unsigned>((n_lanes + WARPS - 1) / WARPS);
  if (seg_len % 4 == 0) {
    crc32_split_kernel<true, FOLD><<<blocks, THREADS, 0, s>>>(in, lut, dst, folded, n_lanes,
                                                              seg_len, piece_words, params, fold);
  } else {
    crc32_split_kernel<false, FOLD><<<blocks, THREADS, 0, s>>>(in, lut, dst, folded, n_lanes,
                                                               seg_len, piece_words, params, fold);
  }
}

}  // namespace

// data (n_lanes, seg_len) uint8, 16-byte aligned; table (256,) uint32;
// out (n_lanes,) uint32; all on the device and contiguous. piece_words is
// ceil(seg_len / 128), or 0 for one thread per lane; ops (host memory) holds
// 5 x 32 operator rows then shift_seg_len(~0), as crc32.py builds them, and
// is read only when piece_words > 0. With folded (device, n_lanes / 1024
// uint32) the launch also folds: fold (host memory) holds 10 x 32 operator
// rows then MAX_FOLD_BATCH int32 fulls, and n_lanes is a multiple of 1024,
// at most MAX_FOLD_BATCH requests. Launches on `stream` and returns the
// first CUDA error.
extern "C" int crc32_launch(const void* data, const void* table, void* out, long long n_lanes,
                            long long seg_len, int piece_words, const void* ops, void* folded,
                            const void* fold, void* stream) {
  if (n_lanes > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint8_t* in = static_cast<const uint8_t*>(data);
    const uint32_t* lut = static_cast<const uint32_t*>(table);
    uint32_t* dst = static_cast<uint32_t*>(out);
    if (folded == nullptr) {
      launch<false>(in, lut, dst, nullptr, n_lanes, seg_len, piece_words, ops, NoFold{}, s);
    } else {
      uint32_t* words = static_cast<uint32_t*>(folded);
      const cudaError_t rc =
          cudaMemsetAsync(words, 0, sizeof(uint32_t) * (n_lanes / N_SEGMENTS), s);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      launch<true>(in, lut, dst, words, n_lanes, seg_len, piece_words, ops,
                   *static_cast<const FoldOps*>(fold), s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
