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
// The block finder's candidate search (paper §3.4) lives here too, so its
// strict checks 5-7 are the decoder's own dynamic_header: rg_find_dynamic
// returns the next offset that passes the §3.4.2 cascade, rg_find_stored
// the next canonical Non-Compressed offset, and rg_count_dynamic counts
// checks 1-4 over a range for FilterStats (core/block_finder.py).
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

// -- the block finder ---------------------------------------------------------

// Offsets of a dynamic header's fields from the block's first bit.
constexpr int kHlitAt = 3;
constexpr int kHclenAt = 13;
constexpr int kPrecodeAt = 17;
// Offsets of one 64-bit window checked at once: checks 1-2 need bits
// i..i+2 and HLIT bits i+3..i+7 of a window that holds at least 57.
constexpr int kWindowOffsets = 48;

// Slots of the finder's io array (int64 each).
enum FindSlot : int {
  kFindPos = 0,       // in: first offset (stored: LEN byte); out: the candidate or -1
  kFindEnd = 1,       // in: end of the range, exclusive
  kFindStrict = 2,    // in: run checks 5-7
  kFindMoved = 3,     // out: offsets moved over (stored: in bits)
  kFindParsed = 4,    // out: headers parsed by checks 5-7
  kFindBadData = 5,   // out: rejected by the precode data (check 5)
  kFindBadDist = 6,   // out: rejected by the distance code (check 6)
  kFindBadLit = 7,    // out: rejected by the literal code (check 7)
};

// Slots of rg_count_dynamic's counts (FilterStats' checks 1-4).
enum CountSlot : int {
  kTested = 0,
  kBadFinal = 1,
  kBadType = 2,
  kBadHlit = 3,
  kBadPrecode = 4,
};

inline uint64_t peek_at(const Bits& b, int64_t pos) {
  Bits at = b;
  at.pos = pos;
  return at.peek();
}

// Offsets i (bit i of the mask) of the window w = peek at p whose first
// three bits are final 0 and type 0b10 (checks 1-2), among the first n.
inline uint64_t dynamic_prefix(uint64_t w, int n) {
  const uint64_t m = ~w & ~(w >> 1) & (w >> 2);
  return m & ((uint64_t(1) << n) - 1);
}

// kraft4[v]: the Kraft sum, in units of 2^-7, of the four 3-bit code
// lengths packed in v (a length of 0 adds nothing).
const uint16_t* kraft4() {
  static const std::vector<uint16_t> table = [] {
    std::vector<uint16_t> t(1 << 12);
    for (int v = 0; v < (1 << 12); ++v) {
      for (int k = 0; k < 4; ++k) {
        const int cl = (v >> (3 * k)) & 7;
        if (cl) t[v] += 128 >> cl;
      }
    }
    return t;
  }();
  return table.data();
}

// Check 4: the precode's code lengths satisfy Kraft's equality, which
// holds exactly for a valid and complete code.
inline bool precode_complete(const Bits& b, int64_t at, const uint16_t* kraft) {
  const int n_codes = int(peek_at(b, at + kHclenAt) & 15) + 4;
  // 19 x 3 = 57 bits; the lengths past HCLEN + 4 are not the precode's.
  const uint64_t lengths = peek_at(b, at + kPrecodeAt) & ((uint64_t(1) << (3 * n_codes)) - 1);
  int sum = 0;
  for (int k = 0; k < 60; k += 12) sum += kraft[(lengths >> k) & 0xFFF];
  return sum == 128;
}

// Checks 5-7 at an offset that passed 1-4: the strict header parse.
// Returns 0 or the check that refused it (kFindBadData/Dist/Lit).
int strict_reject(const Bits& b, int64_t at) {
  Bits h = b;
  h.pos = at + 3;
  int64_t scratch[8];
  const int st = dynamic_header(h, true, nullptr, nullptr, scratch);
  if (st == 0) return 0;
  if (st == kDistanceStatus) return kFindBadDist;
  if (st == kLiteralStatus || st == kNoEndOfBlock) return kFindBadLit;
  return kFindBadData;
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

// The first offset in [io[kFindPos], io[kFindEnd]) that passes checks 1-4
// (final bit, type, HLIT < 30, the precode's Kraft equality) and, if
// io[kFindStrict], checks 5-7, into io[kFindPos] (-1 if none), with the
// offsets moved over and the strict checks' counts. The caller keeps every
// offset within 74 bits of the data's end out of the range.
int rg_find_dynamic(const uint8_t* data, int64_t n_bytes, int64_t* io) {
  const Bits b{data, n_bytes, n_bytes * 8, 0};
  const int64_t start = io[kFindPos], end = io[kFindEnd];
  const bool strict = io[kFindStrict] != 0;
  const uint16_t* kraft = kraft4();
  for (int s = kFindParsed; s <= kFindBadLit; ++s) io[s] = 0;
  for (int64_t p = start; p < end; p += kWindowOffsets) {
    const int n = end - p < kWindowOffsets ? int(end - p) : kWindowOffsets;
    const uint64_t w = peek_at(b, p);
    for (uint64_t m = dynamic_prefix(w, n); m; m &= m - 1) {
      const int i = __builtin_ctzll(m);
      if (((w >> (i + kHlitAt)) & 31) >= 30) continue;
      if (!precode_complete(b, p + i, kraft)) continue;
      if (strict) {
        ++io[kFindParsed];
        const int reject = strict_reject(b, p + i);
        if (reject) {
          ++io[reject];
          continue;
        }
      }
      io[kFindPos] = p + i;
      io[kFindMoved] = p + i + 1 - start;
      return 0;
    }
  }
  io[kFindPos] = -1;
  io[kFindMoved] = end > start ? end - start : 0;
  return 0;
}

// FilterStats' checks 1-4 over every offset of [io[kFindPos],
// io[kFindEnd]), as the reference counts a batch: counts[kTested..
// kBadPrecode] (set, not added).
int rg_count_dynamic(const uint8_t* data, int64_t n_bytes, int64_t* io, int64_t* counts) {
  const Bits b{data, n_bytes, n_bytes * 8, 0};
  const int64_t start = io[kFindPos], end = io[kFindEnd];
  io[kFindMoved] = end > start ? end - start : 0;
  const uint16_t* kraft = kraft4();
  for (int s = kTested; s <= kBadPrecode; ++s) counts[s] = 0;
  for (int64_t p = start; p < end; p += kWindowOffsets) {
    const int n = end - p < kWindowOffsets ? int(end - p) : kWindowOffsets;
    const uint64_t w = peek_at(b, p);
    const uint64_t in_range = (uint64_t(1) << n) - 1;
    const uint64_t prefix = dynamic_prefix(w, n);
    counts[kTested] += n;
    counts[kBadFinal] += __builtin_popcountll(w & in_range);
    counts[kBadType] += __builtin_popcountll(~w & in_range) - __builtin_popcountll(prefix);
    for (uint64_t m = prefix; m; m &= m - 1) {
      const int i = __builtin_ctzll(m);
      if (((w >> (i + kHlitAt)) & 31) >= 30) {
        ++counts[kBadHlit];
      } else if (!precode_complete(b, p + i, kraft)) {
        ++counts[kBadPrecode];
      }
    }
  }
  return 0;
}

// The first LEN byte p >= io[kFindPos], p <= n_bytes - 4, whose canonical
// Non-Compressed offset 8p - 3 lies before io[kFindEnd], with the byte
// before it zero in its top 3 bits (non-final, type 00, zero padding) and
// LEN == ~NLEN (paper §3.4.1), into io[kFindPos] (-1 if none).
int rg_find_stored(const uint8_t* data, int64_t n_bytes, int64_t* io) {
  const int64_t start = io[kFindPos], end_bit = io[kFindEnd];
  int64_t last = n_bytes - 4;
  if (last > (end_bit + 2) / 8) last = (end_bit + 2) / 8;  // 8p - 3 < end_bit
  // Eight LEN bytes a step: y's byte j is zero where LEN's low byte at
  // p + j is NLEN's complemented, z's where both of LEN's bytes are; a
  // step with no zero byte in z holds no candidate.
  constexpr uint64_t kLow7 = 0x7F7F7F7F7F7F7F7Full;
  for (int64_t p = start; p <= last;) {
    if (p + 7 <= last && p + 10 < n_bytes) {
      uint64_t a, c;
      std::memcpy(&a, data + p, 8);
      std::memcpy(&c, data + p + 2, 8);
      const uint64_t y = ~(a ^ c);
      const uint64_t y8 = uint64_t(0xFF ^ data[p + 8] ^ data[p + 10]);
      const uint64_t z = y | (y >> 8) | (y8 << 56);
      // Each byte's high bit set where that byte of z is nonzero.
      if ((((z & kLow7) + kLow7) | z | kLow7) == ~uint64_t(0)) {
        p += 8;
        continue;
      }
    }
    const int64_t stop = p + 8 <= last + 1 ? p + 8 : last + 1;
    for (; p < stop; ++p) {
      if ((data[p] ^ data[p + 2]) != 0xFF || (data[p + 1] ^ data[p + 3]) != 0xFF) continue;
      if (data[p - 1] & 0xE0) continue;
      io[kFindPos] = p;
      io[kFindMoved] = 8 * (p + 1 - start);
      return 0;
    }
  }
  io[kFindPos] = -1;
  io[kFindMoved] = last >= start ? 8 * (last + 1 - start) : 0;
  return 0;
}

}  // extern "C"
