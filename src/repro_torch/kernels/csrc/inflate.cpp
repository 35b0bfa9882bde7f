// Stage 1 of the two-stage deflate decoder (paper §2.2, §3.3) in host C++.
//
// One call decodes a run of deflate blocks from a bit offset: the 3-bit
// block header, stored blocks, the fixed tables, the dynamic header, the
// literal/length/distance loop and the match copies. In marker mode
// (uint16 output) a reference before the chunk's start becomes the marker
// MARKER_BASE + (WINDOW_SIZE + src); in window mode (uint8 output) it reads
// the given window. The call returns at the stop rule, after a final block
// (the caller parses the gzip footer and the next header), when the output
// buffer cannot hold the next block (state rewound to that block's start,
// so the caller grows the buffer and calls again), when the block records
// are full, or with an error status. The semantics, errors included, are
// those of repro's Python decoder (src/repro/core/deflate.py), which the
// tests hold this against.
//
// Plain C entries, no Python or PyTorch headers: built with the host
// compiler and loaded with ctypes, which drops the GIL for the call.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t kWindowSize = 32768;
constexpr int64_t kMarkerBase = 256;
constexpr int kMaxCodeLen = 15;

// Return statuses. Non-negative: where the call stopped; negative: the
// error the Python decoder raises at the same input (see deflate.py).
enum Status : int {
  kStop = 0,        // at a block the next chunk's finder could find
  kFinal = 1,       // after a final block
  kFull = 2,        // the output cannot hold the next block; state at its start
  kBlocksFull = 3,  // the block records are full; state at a block start
  kEndOfStream = -1,
  kEndAtBoundary = -2,
  kEndInStored = -3,
  kReservedType = -4,
  kStoredLength = -5,
  kInvalidLiteral = -6,
  kInvalidLengthSymbol = -7,
  kInvalidDistance = -8,
  kInvalidDistanceSymbol = -9,
  kDistanceTooFar = -10,
  kBeforeStreamStart = -11,
  kInvalidHlit = -12,
  kCodeCount = -13,
  kOverSubscribed = -14,
  kEmptyCode = -15,
  kIncompleteCode = -16,
  kRepeatFirst = -17,
  kRepeatOverrun = -18,
  kZeroRepeatOverrun = -19,
  kDistanceStatus = -20,
  kLiteralStatus = -21,
  kNoEndOfBlock = -22,
};

// The state array shared with the caller (int64 each).
enum Slot : int {
  kPos = 0,          // in/out: bit position
  kOutLen = 1,       // in/out: symbols written
  kFirstMarker = 2,  // in/out
  kLastMarker = 3,   // in/out
  kInfo = 4,         // out: need (kFull), end bit (kStop), error detail
  kBlocks = 5,       // out: block records written by this call
  kInfo2 = 6,        // out: second error detail
  kHaveBlocks = 7,   // in: a block was already decoded in this chunk
};

const int kLengthBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                             31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const int kLengthExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                              2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const int kDistanceBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                               33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                               1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
const int kDistanceExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const int kPrecodeOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

// LSB-first bits at an absolute position; reads past the end are zero, as
// the Python reader's zero-padded peek, and consuming them is kEndOfStream.
struct Bits {
  const uint8_t* data;
  int64_t n_bytes;
  int64_t total;  // 8 * n_bytes
  int64_t pos;

  // At least 57 bits from pos (zero past the end).
  inline uint64_t peek() const {
    const int64_t byte = pos >> 3;
    uint64_t w = 0;
    if (byte + 8 <= n_bytes) {
      std::memcpy(&w, data + byte, 8);
    } else {
      for (int64_t i = byte; i < n_bytes; ++i) w |= uint64_t(data[i]) << (8 * (i - byte));
    }
    return w >> (pos & 7);
  }

  inline int read(int n, int64_t* value) {
    if (pos + n > total) return kEndOfStream;
    *value = int64_t(peek() & ((uint64_t(1) << n) - 1));
    pos += n;
    return 0;
  }
};

// Flat decode table: table[peek(bits)] = (length << 16) | symbol, -1 where
// no code covers the pattern (an incomplete code).
struct Table {
  std::vector<int32_t> entries;
  int bits = 0;
  uint64_t mask() const { return (uint64_t(1) << bits) - 1; }
};

// Kraft status: 0 complete, 1 incomplete, 2 over-subscribed, 3 empty.
int code_status(const uint8_t* lengths, int n) {
  int64_t total = 0;
  int codes = 0;
  for (int i = 0; i < n; ++i) {
    if (lengths[i]) {
      total += int64_t(1) << (kMaxCodeLen - lengths[i]);
      ++codes;
    }
  }
  if (codes == 0) return 3;
  const int64_t unit = int64_t(1) << kMaxCodeLen;
  if (total > unit) return 2;
  if (total < unit) return 1;
  return 0;
}

// HuffmanLUT.from_lengths' refusals for a status.
int refuse(int status, bool allow_incomplete) {
  if (status == 2) return kOverSubscribed;
  if (status == 3) return kEmptyCode;
  if (status == 1 && !allow_incomplete) return kIncompleteCode;
  return 0;
}

void build_table(Table* table, const uint8_t* lengths, int n) {
  int count[kMaxCodeLen + 1] = {0};
  int max_len = 0;
  for (int i = 0; i < n; ++i) {
    ++count[lengths[i]];
    if (lengths[i] > max_len) max_len = lengths[i];
  }
  count[0] = 0;
  int next[kMaxCodeLen + 2] = {0};
  int code = 0;
  for (int l = 1; l <= max_len; ++l) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  const int size = 1 << max_len;
  table->bits = max_len;
  table->entries.assign(size, -1);
  int32_t* t = table->entries.data();
  for (int sym = 0; sym < n; ++sym) {
    const int l = lengths[sym];
    if (!l) continue;
    int c = next[l]++;
    int rev = 0;
    for (int k = 0; k < l; ++k) {
      rev = (rev << 1) | (c & 1);
      c >>= 1;
    }
    const int32_t entry = (l << 16) | sym;
    for (int i = rev; i < size; i += 1 << l) t[i] = entry;
  }
}

const Table& fixed_literals() {
  static const Table table = [] {
    uint8_t lengths[288];
    for (int i = 0; i < 144; ++i) lengths[i] = 8;
    for (int i = 144; i < 256; ++i) lengths[i] = 9;
    for (int i = 256; i < 280; ++i) lengths[i] = 7;
    for (int i = 280; i < 288; ++i) lengths[i] = 8;
    Table t;
    build_table(&t, lengths, 288);
    return t;
  }();
  return table;
}

const Table& fixed_distances() {
  static const Table table = [] {
    uint8_t lengths[32];
    for (int i = 0; i < 32; ++i) lengths[i] = 5;
    Table t;
    build_table(&t, lengths, 32);
    return t;
  }();
  return table;
}

// A Dynamic Block header from b.pos (after the 3 header bits). strict: the
// block finder's checks (every code valid and complete, HLIT <= 29, an
// end-of-block code); otherwise the decoder's (an incomplete distance code
// is legal). Tables are built only when asked for.
int dynamic_header(Bits& b, bool strict, Table* literals, Table* distances, int64_t* state) {
  int64_t hlit, hdist, hclen;
  int st;
  if ((st = b.read(5, &hlit))) return st;
  if (strict && hlit > 29) return kInvalidHlit;
  if ((st = b.read(5, &hdist))) return st;
  if ((st = b.read(4, &hclen))) return st;
  const int n_lit = int(hlit) + 257;
  const int n_dist = int(hdist) + 1;
  if (n_lit > 286 || n_dist > 30) {
    state[kInfo] = hlit;
    state[kInfo2] = hdist;
    return kCodeCount;
  }

  uint8_t pre[19] = {0};
  for (int i = 0; i < hclen + 4; ++i) {
    int64_t v;
    if ((st = b.read(3, &v))) return st;
    pre[kPrecodeOrder[i]] = uint8_t(v);
  }
  if ((st = refuse(code_status(pre, 19), false))) return st;
  Table precode;
  build_table(&precode, pre, 19);  // complete: every entry is a code
  const int32_t* pt = precode.entries.data();
  const uint64_t pmask = precode.mask();

  uint8_t lengths[286 + 30] = {0};
  const int n_total = n_lit + n_dist;
  int i = 0;
  int prev = -1;
  while (i < n_total) {
    const int32_t entry = pt[b.peek() & pmask];
    const int l = entry >> 16;
    if (b.pos + l > b.total) return kEndOfStream;
    b.pos += l;
    const int sym = entry & 0xFFFF;
    int64_t r;
    if (sym < 16) {
      lengths[i++] = uint8_t(sym);
      prev = sym;
    } else if (sym == 16) {
      if (prev < 0) return kRepeatFirst;
      if ((st = b.read(2, &r))) return st;
      const int count = 3 + int(r);
      if (i + count > n_total) return kRepeatOverrun;
      std::memset(lengths + i, prev, count);
      i += count;
    } else {
      if ((st = b.read(sym == 17 ? 3 : 7, &r))) return st;
      const int count = (sym == 17 ? 3 : 11) + int(r);
      if (i + count > n_total) return kZeroRepeatOverrun;
      i += count;
      prev = 0;
    }
  }
  const uint8_t* lit = lengths;
  const uint8_t* dist = lengths + n_lit;

  if (strict) {
    // Paper §3.4.2: the distance code is checked before the literal code.
    const int ds = code_status(dist, n_dist);
    if (ds) {
      state[kInfo] = ds;
      return kDistanceStatus;
    }
    const int ls = code_status(lit, n_lit);
    if (ls) {
      state[kInfo] = ls;
      return kLiteralStatus;
    }
    if (lit[256] == 0) return kNoEndOfBlock;
  }
  if ((st = refuse(code_status(lit, n_lit), false))) return st;
  int dist_max = 0;
  for (int k = 0; k < n_dist; ++k) dist_max = dist[k] > dist_max ? dist[k] : dist_max;
  if (dist_max && (st = refuse(code_status(dist, n_dist), !strict))) return st;

  if (literals) {
    build_table(literals, lit, n_lit);
    if (dist_max) {
      build_table(distances, dist, n_dist);
    } else {
      // No distance codes: any match attempt fails.
      distances->bits = 1;
      distances->entries.assign(2, -1);
    }
  }
  return 0;
}

template <typename T, bool kMarkers>
struct Output {
  T* out;
  int64_t cap;
  int64_t n;
  int64_t first_marker;
  int64_t last_marker;
  const uint8_t* window;
  int64_t window_len;
  int64_t need;

  inline int copy_match(int64_t dist, int64_t length, int64_t* state) {
    if (dist > kWindowSize) {
      state[kInfo] = dist;
      return kDistanceTooFar;
    }
    int64_t src = n - dist;
    if (!kMarkers && src < 0 && -src > window_len) return kBeforeStreamStart;
    if (n + length > cap) {
      need = n + length;
      return kFull;
    }
    if (src < 0) {
      // Part (or all) of the match comes from the initial window.
      const int64_t from_window = length < -src ? length : -src;
      T* dst = out + n;
      if (kMarkers) {
        // Markers name window byte w = WINDOW_SIZE + src + i (paper §2.2).
        const int64_t w0 = kMarkerBase + kWindowSize + src;
        for (int64_t i = 0; i < from_window; ++i) dst[i] = T(w0 + i);
        if (first_marker < 0) first_marker = n;
        last_marker = n + from_window - 1;
      } else {
        const uint8_t* w = window + window_len + src;
        for (int64_t i = 0; i < from_window; ++i) dst[i] = w[i];
      }
      n += from_window;
      length -= from_window;
      src = 0;  // the rest copies from the chunk's own start
    }
    if (length > 0) {
      // Conservative, as the Python decoder: a copy from a region that may
      // hold markers may hold markers.
      if (kMarkers && last_marker >= src) {
        if (first_marker < 0) first_marker = n;
        last_marker = n + length - 1;
      }
      T* dst = out + n;
      const T* from = out + src;
      for (int64_t i = 0; i < length; ++i) dst[i] = from[i];  // overlap repeats
      n += length;
    }
    return 0;
  }

  int huffman(Bits& b, const Table& literals, const Table& distances, int64_t* state) {
    const int32_t* lt = literals.entries.data();
    const uint64_t lmask = literals.mask();
    const int32_t* dt = distances.entries.data();
    const uint64_t dmask = distances.mask();
    const int64_t total = b.total;
    for (;;) {
      // One load covers a code (15), length extra (5), distance code (15)
      // and distance extra (13): 48 of at least 57 bits.
      uint64_t w = b.peek();
      int32_t entry = lt[w & lmask];
      if (entry < 0) return kInvalidLiteral;
      int l = entry >> 16;
      if (b.pos + l > total) return kEndOfStream;
      b.pos += l;
      w >>= l;
      const int sym = entry & 0xFFFF;
      if (sym < 256) {
        if (n >= cap) {
          need = n + 1;
          return kFull;
        }
        out[n++] = T(sym);
        continue;
      }
      if (sym == 256) return 0;
      if (sym > 285) {
        state[kInfo] = sym;
        return kInvalidLengthSymbol;
      }
      int64_t length = kLengthBase[sym - 257];
      int extra = kLengthExtra[sym - 257];
      if (extra) {
        if (b.pos + extra > total) return kEndOfStream;
        length += int64_t(w & ((uint64_t(1) << extra) - 1));
        b.pos += extra;
        w >>= extra;
      }
      entry = dt[w & dmask];
      if (entry < 0) return kInvalidDistance;
      l = entry >> 16;
      if (b.pos + l > total) return kEndOfStream;
      b.pos += l;
      w >>= l;
      const int dsym = entry & 0xFFFF;
      if (dsym > 29) {
        state[kInfo] = dsym;
        return kInvalidDistanceSymbol;
      }
      int64_t dist = kDistanceBase[dsym];
      extra = kDistanceExtra[dsym];
      if (extra) {
        if (b.pos + extra > total) return kEndOfStream;
        dist += int64_t(w & ((uint64_t(1) << extra) - 1));
        b.pos += extra;
      }
      const int st = copy_match(dist, length, state);
      if (st) return st;
    }
  }

  int stored(Bits& b) {
    // Byte-align: the rest of the header's byte is in the data.
    b.pos = (b.pos + 7) & ~int64_t(7);
    int64_t len, nlen;
    int st;
    if ((st = b.read(16, &len))) return st;
    if ((st = b.read(16, &nlen))) return st;
    if (len != (~nlen & 0xFFFF)) return kStoredLength;
    const int64_t start = b.pos >> 3;
    if (start + len > b.n_bytes) return kEndInStored;
    b.pos = (start + len) * 8;
    if (len == 0) return 0;
    if (n + len > cap) {
      need = n + len;
      return kFull;
    }
    const uint8_t* src = b.data + start;
    T* dst = out + n;
    if (kMarkers) {
      for (int64_t i = 0; i < len; ++i) dst[i] = src[i];
    } else {
      std::memcpy(dst, src, size_t(len));
    }
    n += len;
    return 0;
  }
};

template <typename T, bool kMarkers>
int inflate(const uint8_t* data, int64_t n_bytes, int64_t* state, int64_t stop_bit, T* out,
            int64_t cap, const uint8_t* window, int64_t window_len, int64_t* blocks,
            int64_t max_blocks) {
  Bits b{data, n_bytes, n_bytes * 8, state[kPos]};
  Output<T, kMarkers> o{out, cap, state[kOutLen], state[kFirstMarker], state[kLastMarker],
                        window, window_len, 0};
  bool have_blocks = state[kHaveBlocks] != 0;
  int64_t n_blocks = 0;
  Table literals, distances;
  int status;
  for (;;) {
    const int64_t block_start = b.pos;
    // +7: a stored block's canonical offset can sit up to 7 bits after its
    // true start, and the canonical offset is what meets the stop offset.
    if (have_blocks && block_start + 7 >= stop_bit) {
      // Stop only at a block the next chunk's finder could find: non-final
      // Dynamic or Non-Compressed (paper §3.3).
      const uint64_t probe = b.peek() & 7;
      const int btype = int(probe >> 1) & 3;
      if (!(probe & 1) && (btype == 0 || btype == 2)) {
        const int64_t effective =
            btype == 0 ? 8 * ((block_start + 3 + 7) / 8) - 3 : block_start;
        if (effective >= stop_bit) {
          state[kInfo] = effective;
          status = kStop;
          break;
        }
      }
    }
    if (b.total - b.pos < 3) return kEndAtBoundary;
    if (n_blocks == max_blocks) {
      status = kBlocksFull;
      break;
    }
    int64_t header = 0;
    b.read(3, &header);  // three bits are left: checked above
    const bool is_final = header & 1;
    const int btype = int(header >> 1);
    const int64_t n0 = o.n, first0 = o.first_marker, last0 = o.last_marker;
    int64_t* record = blocks + 4 * n_blocks++;
    record[0] = block_start;
    record[1] = o.n;
    record[2] = btype;
    record[3] = is_final;
    if (btype == 0) {
      status = o.stored(b);
    } else if (btype == 1) {
      status = o.huffman(b, fixed_literals(), fixed_distances(), state);
    } else if (btype == 2) {
      status = dynamic_header(b, false, &literals, &distances, state);
      if (status == 0) status = o.huffman(b, literals, distances, state);
    } else {
      return kReservedType;
    }
    if (status == kFull) {
      // Rewind to the block's start: the caller grows the buffer and
      // decodes this block again.
      b.pos = block_start;
      o.n = n0;
      o.first_marker = first0;
      o.last_marker = last0;
      --n_blocks;
      state[kInfo] = o.need;
      break;
    }
    if (status) return status;
    have_blocks = true;
    if (is_final) {
      status = kFinal;
      break;
    }
  }
  state[kPos] = b.pos;
  state[kOutLen] = o.n;
  state[kFirstMarker] = o.first_marker;
  state[kLastMarker] = o.last_marker;
  state[kBlocks] = n_blocks;
  return status;
}

}  // namespace

extern "C" {

// Decode blocks from state[kPos] into out (capacity cap symbols: uint16 if
// marker_mode, else uint8 with window[0:window_len] before the chunk).
// blocks receives up to max_blocks records (bit offset, output offset,
// type, final). Returns a Status; the state array is written back for
// every non-negative status.
int rg_inflate(const uint8_t* data, int64_t n_bytes, int64_t* state, int64_t stop_bit,
               void* out, int64_t cap, int marker_mode, const uint8_t* window,
               int64_t window_len, int64_t* blocks, int64_t max_blocks) {
  if (marker_mode) {
    return inflate<uint16_t, true>(data, n_bytes, state, stop_bit, static_cast<uint16_t*>(out),
                                   cap, window, window_len, blocks, max_blocks);
  }
  return inflate<uint8_t, false>(data, n_bytes, state, stop_bit, static_cast<uint8_t*>(out), cap,
                                 window, window_len, blocks, max_blocks);
}

// Parse a Dynamic Block header at state[kPos] (after the 3 header bits)
// with the decoder's or, if strict, the block finder's checks. On success
// state[kPos] is the first bit after the header.
int rg_dynamic_header(const uint8_t* data, int64_t n_bytes, int64_t* state, int strict) {
  Bits b{data, n_bytes, n_bytes * 8, state[kPos]};
  const int status = dynamic_header(b, strict != 0, nullptr, nullptr, state);
  if (status == 0) state[kPos] = b.pos;
  return status;
}

}  // extern "C"
