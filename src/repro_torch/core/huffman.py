"""Canonical Huffman code construction and LUT decoding (RFC 1951 §3.2.2).

Decode LUTs map a ``max_len``-bit *LSB-first* peek window directly to
``(symbol, code_length)``; because deflate packs Huffman codes MSB-first into
an otherwise LSB-first stream, each code's bits must be reversed when filling
the table.

Validity semantics (paper §3.4.2, Fig 6):
  * *invalid*   — over-subscribed: more codes than the binary tree permits.
  * *inefficient* — incomplete: unused leaves remain.
The block finder rejects both ("valid and efficient"); the actual decoder is
lenient where RFC/zlib are (an incomplete *distance* code with <=1 codes is
legal, and an unused-entry lookup only errors when actually consumed).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .errors import DeflateError

# Sentinel for LUT entries not covered by any code (incomplete codes).
INVALID_ENTRY = np.int32(-1)

#: code length order for the precode (RFC 1951 §3.2.7)
PRECODE_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)

MAX_PRECODE_LEN = 7
MAX_CODE_LEN = 15


def reverse_bits(value: int, width: int) -> int:
    out = 0
    for _ in range(width):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


def check_code_lengths(lengths: Sequence[int], max_len: int) -> int:
    """Kraft-sum check. Returns:

    0  -> valid and complete ("efficient")
    1  -> incomplete (unused leaves; paper calls these "non-optimal")
    2  -> over-subscribed (invalid)
    3  -> empty (no symbols at all)
    """
    total = 0
    unit = 1 << max_len
    n_codes = 0
    for l in lengths:
        if l:
            total += unit >> l
            n_codes += 1
    if n_codes == 0:
        return 3
    if total > unit:
        return 2
    if total < unit:
        return 1
    return 0


class HuffmanLUT:
    """Flat decode LUT: ``table[peek(max_len)] -> (length << 16) | symbol``."""

    __slots__ = ("table", "max_len", "n_symbols")

    def __init__(self, table: np.ndarray, max_len: int, n_symbols: int):
        self.table = table
        self.max_len = max_len
        self.n_symbols = n_symbols

    @staticmethod
    def from_lengths(
        lengths: Sequence[int],
        *,
        strict: bool = False,
        allow_incomplete: bool = False,
    ) -> "HuffmanLUT":
        """Build from per-symbol code lengths.

        strict=True          -> reject over-subscribed AND incomplete codes
                                (block-finder semantics, paper Fig 6).
        allow_incomplete     -> permit incomplete codes; unfilled entries decode
                                to INVALID and raise only if consumed (zlib
                                distance-code semantics).
        """
        lengths = np.asarray(lengths, dtype=np.int64)
        status = check_code_lengths(lengths, MAX_CODE_LEN)
        if status == 2:
            raise DeflateError("over-subscribed Huffman code")
        if status == 3:
            raise DeflateError("empty Huffman code")
        if status == 1 and (strict or not allow_incomplete):
            raise DeflateError("incomplete Huffman code")

        max_len = int(lengths.max())
        size = 1 << max_len

        # Canonical code assignment: codes ordered by (length, symbol).
        bl_count = np.bincount(lengths, minlength=MAX_CODE_LEN + 1)
        bl_count[0] = 0
        next_code = np.zeros(MAX_CODE_LEN + 2, dtype=np.int64)
        code = 0
        for l in range(1, max_len + 1):
            code = (code + bl_count[l - 1]) << 1
            next_code[l] = code

        table = np.full(size, INVALID_ENTRY, dtype=np.int32)
        for sym, l in enumerate(lengths):
            if l == 0:
                continue
            c = int(next_code[l])
            next_code[l] += 1
            rev = reverse_bits(c, int(l))
            entry = (int(l) << 16) | sym
            # All peek windows whose low ``l`` bits equal the reversed code.
            table[rev :: 1 << int(l)] = entry
        return HuffmanLUT(table, max_len, int(len(lengths)))

    def decode(self, bitreader) -> int:
        """Decode one symbol from the bit reader."""
        entry = int(self.table[bitreader.peek(self.max_len)])
        if entry < 0:
            raise DeflateError("invalid Huffman bit pattern (unused code)")
        bitreader.skip(entry >> 16)
        return entry & 0xFFFF


# ---------------------------------------------------------------------------
# Fixed (type-1) deflate codes, RFC 1951 §3.2.6 — built once at import time.
# ---------------------------------------------------------------------------

def _fixed_literal_lengths() -> np.ndarray:
    lengths = np.empty(288, dtype=np.int64)
    lengths[0:144] = 8
    lengths[144:256] = 9
    lengths[256:280] = 7
    lengths[280:288] = 8
    return lengths


FIXED_LITERAL_LUT = HuffmanLUT.from_lengths(_fixed_literal_lengths())
# The fixed distance "code" is 5-bit flat; 30/31 are invalid if consumed.
FIXED_DISTANCE_LUT = HuffmanLUT.from_lengths(np.full(32, 5, dtype=np.int64))


# ---------------------------------------------------------------------------
# Length / distance extra-bit tables (RFC 1951 §3.2.5) as numpy arrays so the
# decoder can index them without branching.
# ---------------------------------------------------------------------------

LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
     35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int64,
)
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
     3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0],
    dtype=np.int64,
)
DISTANCE_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
     257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
     8193, 12289, 16385, 24577],
    dtype=np.int64,
)
DISTANCE_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
     7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13],
    dtype=np.int64,
)


def decode_code_lengths(bitreader, precode_lut: HuffmanLUT, n_total: int, *, strict: bool = False) -> np.ndarray:
    """Decode ``n_total`` literal+distance code lengths using the precode.

    Handles repeat codes 16/17/18. ``strict`` is the block-finder mode: any
    structural violation (repeat at start, overrun) raises immediately —
    paper Table 1 row "Invalid Precode-encoded data".
    """
    lengths = np.zeros(n_total, dtype=np.int64)
    i = 0
    prev = -1
    while i < n_total:
        sym = precode_lut.decode(bitreader)
        if sym < 16:
            lengths[i] = sym
            prev = sym
            i += 1
        elif sym == 16:
            if prev < 0:
                raise DeflateError("repeat code with no previous length")
            count = 3 + bitreader.read(2)
            if i + count > n_total:
                raise DeflateError("repeat overruns code-length table")
            lengths[i : i + count] = prev
            i += count
        elif sym == 17:
            count = 3 + bitreader.read(3)
            if i + count > n_total:
                raise DeflateError("zero-repeat overruns code-length table")
            i += count
            prev = 0
        else:  # 18
            count = 11 + bitreader.read(7)
            if i + count > n_total:
                raise DeflateError("zero-repeat overruns code-length table")
            i += count
            prev = 0
    return lengths
