"""Two-stage deflate chunk decoder (paper §2.2, §3.3, Fig 3).

A decompression thread starting at an arbitrary bit offset does not know the
preceding 32 KiB LZ77 window. Stage 1 decodes into a 16-bit intermediate
stream where values < 256 are resolved literals and values >= 256 are
*markers*: ``MARKER_BASE + w`` names byte ``w`` of the unknown initial window
(w = 0 is the oldest byte, 32767 the byte immediately before the chunk).
Stage 2 (``markers.py`` / ``kernels/marker_replace.py``) replaces markers once
the predecessor chunk has produced the real window — a pure gather that is an
order of magnitude faster than decoding (paper Table 2) and the part that maps
onto the TPU VPU.

When the window *is* known (seek-index hit, or stream start where the window
is empty) the decoder runs in conventional single-stage mode straight to
uint8. Mid-chunk, the decoder tracks the last marker position so callers can
see when output became marker-free (paper §3.3's fallback optimization).

The stop condition mirrors rapidgzip exactly: decoding continues until a
block that (a) starts at or after the stop offset, (b) is a Dynamic or
Non-Compressed block, and (c) is not final — i.e. a block the *block finder
of the next chunk could also have found*. Fixed and final blocks are decoded
past the nominal boundary (paper §3.3/§3.4.3).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .bitreader import BitReader
from .errors import DeflateError, EndOfStream, GzipFooterError
from .gzip_format import parse_gzip_footer, parse_gzip_header
from .huffman import (
    DISTANCE_BASE,
    DISTANCE_EXTRA,
    FIXED_DISTANCE_LUT,
    FIXED_LITERAL_LUT,
    LENGTH_BASE,
    LENGTH_EXTRA,
    MAX_PRECODE_LEN,
    PRECODE_ORDER,
    HuffmanLUT,
    decode_code_lengths,
)

WINDOW_SIZE = 32768
MARKER_BASE = 256  # symbol value 256 + w refers to unknown-window byte w

BT_STORED = 0
BT_FIXED = 1
BT_DYNAMIC = 2


def canonical_stored_offset(block_start_bit: int) -> int:
    """Canonical bit offset for a Non-Compressed block (paper §3.4.1).

    The zero padding before a stored block's LEN field makes its true start
    ambiguous (final/type bits are zero, indistinguishable from padding), so
    both the block finder and the decoder's stop offset use the *latest*
    possible start: the 3 header bits flush against the LEN field at byte
    ``p``, i.e. ``8*p - 3``. Decoding from the canonical offset yields the
    identical block.
    """
    len_byte = (block_start_bit + 3 + 7) // 8
    return 8 * len_byte - 3


@dataclass
class BlockBoundary:
    bit_offset: int
    out_offset: int
    block_type: int
    is_final: bool


@dataclass
class MemberEnd:
    """A gzip member footer encountered inside the chunk."""

    out_offset: int  # chunk-local decompressed offset at which the member ends
    crc32: int
    isize: int
    footer_end_bit: int


@dataclass
class MemberStart:
    """A gzip member header encountered inside the chunk."""

    header_start_bit: int
    deflate_start_bit: int
    out_offset: int


@dataclass
class DecodeResult:
    start_bit: int
    end_bit: int
    data: np.ndarray  # uint16 (marker mode) or uint8 (window mode)
    marker_mode: bool
    blocks: List[BlockBoundary] = field(default_factory=list)
    member_ends: List[MemberEnd] = field(default_factory=list)
    member_starts: List[MemberStart] = field(default_factory=list)
    ended_at_eos: bool = False  # reached end of the whole file
    first_marker: int = -1  # chunk-local offset of first marker symbol (-1: none)
    last_marker: int = -1  # conservative last position that may hold a marker

    @property
    def size(self) -> int:
        return int(self.data.shape[0])

    def contains_markers(self) -> bool:
        return self.marker_mode and self.first_marker >= 0


class DeflateChunkDecoder:
    """Decodes one chunk of a (possibly multi-member) gzip/deflate byte stream."""

    def __init__(self, data, *, framing: str = "gzip"):
        if framing not in ("gzip", "raw"):
            raise ValueError("framing must be 'gzip' or 'raw'")
        self.data = data if isinstance(data, (bytes, memoryview)) else bytes(data)
        self.framing = framing

    # -- public API ---------------------------------------------------------

    def decode_chunk(
        self,
        start_bit: int,
        stop_bit: Optional[int] = None,
        *,
        window: Optional[bytes] = None,
        max_out: Optional[int] = None,
        initial_capacity: int = 1 << 17,
    ) -> DecodeResult:
        """Decode deflate blocks from ``start_bit`` until the stop condition.

        window=None  -> two-stage marker mode (unknown window).
        window=bytes -> single-stage mode; b"" means known-empty (stream start).
        """
        total_bits = len(self.data) * 8
        if stop_bit is None:
            stop_bit = total_bits
        br = BitReader(self.data, start_bit)

        marker_mode = window is None
        dtype = np.uint16 if marker_mode else np.uint8
        out = np.empty(max(initial_capacity, 1024), dtype=dtype)
        if window:
            win_arr = np.frombuffer(window, dtype=np.uint8)
        else:
            win_arr = np.empty(0, dtype=np.uint8)
        win_len = int(win_arr.shape[0])

        state = _DecodeState(out, marker_mode, win_arr, win_len, max_out)
        result = DecodeResult(start_bit=start_bit, end_bit=start_bit, data=out, marker_mode=marker_mode)

        while True:
            block_start = br.bit_pos
            # +7: a stored block's canonical offset can sit up to 7 bits
            # after its true start, and the canonical offset is what must be
            # compared against the stop offset.
            if result.blocks and block_start + 7 >= stop_bit:
                # Stop only at a block the next chunk's finder could find:
                # non-final Dynamic or Non-Compressed (paper §3.3).
                probe = br.peek(3)
                is_final = probe & 1
                btype = (probe >> 1) & 3
                if not is_final and btype in (BT_STORED, BT_DYNAMIC):
                    # Compare (and record) the canonical offset for stored
                    # blocks so stop offsets always match finder candidates
                    # and index seek points (padding ambiguity, §3.4.1).
                    effective = (
                        canonical_stored_offset(block_start)
                        if btype == BT_STORED
                        else block_start
                    )
                    if effective >= stop_bit:
                        result.end_bit = effective
                        break
            if br.bits_left() < 3:
                raise EndOfStream("chunk ran out of bits at block boundary")

            is_final = br.read(1)
            btype = br.read(2)
            result.blocks.append(
                BlockBoundary(block_start, state.n, btype, bool(is_final))
            )
            if btype == BT_STORED:
                self._decode_stored(br, state)
            elif btype == BT_FIXED:
                self._decode_huffman(br, state, FIXED_LITERAL_LUT, FIXED_DISTANCE_LUT)
            elif btype == BT_DYNAMIC:
                lit_lut, dist_lut = read_dynamic_header(br)
                self._decode_huffman(br, state, lit_lut, dist_lut)
            else:
                raise DeflateError("reserved block type 11")

            if is_final:
                if self.framing == "raw":
                    result.end_bit = br.bit_pos
                    result.ended_at_eos = True
                    break
                # gzip footer: byte-align, CRC32 + ISIZE (paper Fig 1).
                br.align_to_byte()
                footer = parse_gzip_footer(br)
                result.member_ends.append(
                    MemberEnd(state.n, footer.crc32, footer.isize, br.bit_pos)
                )
                if br.bits_left() < 8:
                    result.end_bit = br.bit_pos
                    result.ended_at_eos = True
                    break
                header_start = br.bit_pos
                hdr = parse_gzip_header(br)
                result.member_starts.append(
                    MemberStart(header_start, br.bit_pos, state.n)
                )
                # Next member's first block continues the loop; the stop
                # check at the top applies to it like any other boundary.

        result.data = state.out[: state.n]
        result.first_marker = state.first_marker
        result.last_marker = state.last_marker
        if not result.blocks:
            raise DeflateError("no blocks decoded")
        return result

    # -- block bodies ---------------------------------------------------------

    def _decode_stored(self, br: BitReader, state: "_DecodeState") -> None:
        br.align_to_byte()
        length = br.read(16)
        nlen = br.read(16)
        if length != (~nlen & 0xFFFF):
            raise DeflateError("stored block LEN/NLEN mismatch")
        raw = br.read_bytes(length)
        state.append_literal_bytes(raw)

    def _decode_huffman(
        self,
        br: BitReader,
        state: "_DecodeState",
        lit_lut: HuffmanLUT,
        dist_lut: HuffmanLUT,
    ) -> None:
        # Local bindings for speed in the hot loop.
        lit_table = lit_lut.table
        lit_bits = lit_lut.max_len
        dist_table = dist_lut.table
        dist_bits = dist_lut.max_len
        peek = br.peek
        skip = br.skip
        read = br.read
        lb, le = LENGTH_BASE, LENGTH_EXTRA
        db, de = DISTANCE_BASE, DISTANCE_EXTRA

        while True:
            entry = int(lit_table[peek(lit_bits)])
            if entry < 0:
                raise DeflateError("invalid literal/length code")
            skip(entry >> 16)
            sym = entry & 0xFFFF
            if sym < 256:
                state.append_literal(sym)
                continue
            if sym == 256:
                return
            if sym > 285:
                raise DeflateError("invalid length symbol %d" % sym)
            li = sym - 257
            length = int(lb[li])
            extra = int(le[li])
            if extra:
                length += read(extra)

            entry = int(dist_table[peek(dist_bits)])
            if entry < 0:
                raise DeflateError("invalid distance code")
            skip(entry >> 16)
            dsym = entry & 0xFFFF
            if dsym > 29:
                raise DeflateError("invalid distance symbol %d" % dsym)
            dist = int(db[dsym])
            extra = int(de[dsym])
            if extra:
                dist += read(extra)
            state.copy_match(dist, length)


def read_dynamic_header(br: BitReader, *, strict: bool = False) -> Tuple[HuffmanLUT, HuffmanLUT]:
    """Parse a Dynamic Block header into (literal LUT, distance LUT).

    ``strict=True`` applies block-finder semantics: all three Huffman codes
    must be valid AND complete (paper §3.4.2 steps 4-7). ``strict=False``
    applies decoder semantics (zlib-compatible leniency for incomplete
    distance codes).
    """
    hlit = br.read(5)
    if strict and hlit > 29:
        raise DeflateError("invalid HLIT")
    hdist = br.read(5)
    hclen = br.read(4)
    n_lit = hlit + 257
    n_dist = hdist + 1
    if n_lit > 286 or n_dist > 30:
        raise DeflateError("code count out of range (HLIT=%d HDIST=%d)" % (hlit, hdist))

    precode_lengths = np.zeros(19, dtype=np.int64)
    for i in range(hclen + 4):
        precode_lengths[PRECODE_ORDER[i]] = br.read(3)
    precode_lut = HuffmanLUT.from_lengths(precode_lengths, strict=strict, allow_incomplete=False)

    try:
        all_lengths = decode_code_lengths(br, precode_lut, n_lit + n_dist, strict=strict)
    except DeflateError as exc:
        raise DeflateError("precode data: %s" % exc) from exc
    lit_lengths = all_lengths[:n_lit]
    dist_lengths = all_lengths[n_lit:]

    if strict:
        # Paper §3.4.2 order: distance code (6) is checked BEFORE the literal
        # code (7) — it is the cheaper check and filters 40x more often
        # (Table 1). LUTs are only built after both pass.
        from .huffman import check_code_lengths

        dstatus = check_code_lengths(dist_lengths, 15)
        if dstatus != 0:
            raise DeflateError("distance code: status %d" % dstatus)
        lstatus = check_code_lengths(lit_lengths, 15)
        if lstatus != 0:
            raise DeflateError("literal code: status %d" % lstatus)
        if lit_lengths[256] == 0:
            raise DeflateError("literal code: no end-of-block symbol")

    lit_lut = HuffmanLUT.from_lengths(lit_lengths, strict=strict, allow_incomplete=False)
    # Distance code: zlib permits an incomplete code (e.g. a single code or
    # none at all, for blocks without matches).
    if dist_lengths.max() == 0:
        # No distance codes: any match attempt must fail. Use an all-invalid
        # 1-bit table.
        dist_lut = HuffmanLUT(np.full(2, -1, dtype=np.int32), 1, 0)
    else:
        dist_lut = HuffmanLUT.from_lengths(dist_lengths, strict=strict, allow_incomplete=True)
    return lit_lut, dist_lut


class _DecodeState:
    """Mutable output buffer + LZ77 window bookkeeping for one chunk."""

    __slots__ = (
        "out",
        "n",
        "marker_mode",
        "win_arr",
        "win_len",
        "max_out",
        "first_marker",
        "last_marker",
    )

    def __init__(self, out, marker_mode, win_arr, win_len, max_out):
        self.out = out
        self.n = 0
        self.marker_mode = marker_mode
        self.win_arr = win_arr
        self.win_len = win_len
        self.max_out = max_out
        self.first_marker = -1
        self.last_marker = -1

    # -- capacity -----------------------------------------------------------

    def _ensure(self, extra: int) -> None:
        need = self.n + extra
        cap = self.out.shape[0]
        if need <= cap:
            return
        if self.max_out is not None and need > self.max_out:
            raise DeflateError(
                "chunk output exceeds max_out=%d (suspected false positive or "
                "extreme compression ratio)" % self.max_out
            )
        new_cap = cap
        while new_cap < need:
            new_cap *= 2
        grown = np.empty(new_cap, dtype=self.out.dtype)
        grown[: self.n] = self.out[: self.n]
        self.out = grown

    # -- emission -----------------------------------------------------------

    def append_literal(self, value: int) -> None:
        self._ensure(1)
        self.out[self.n] = value
        self.n += 1

    def append_literal_bytes(self, raw: bytes) -> None:
        if not raw:
            return
        self._ensure(len(raw))
        arr = np.frombuffer(raw, dtype=np.uint8)
        if self.marker_mode:
            self.out[self.n : self.n + len(raw)] = arr  # widens to uint16
        else:
            self.out[self.n : self.n + len(raw)] = arr
        self.n += len(raw)

    def copy_match(self, dist: int, length: int) -> None:
        if dist > WINDOW_SIZE:
            raise DeflateError("distance %d exceeds window" % dist)
        n = self.n
        src = n - dist
        if src < 0 and not self.marker_mode:
            # Known window: the reference must fit inside it.
            if -src > self.win_len:
                raise DeflateError("distance reaches before stream start")
        self._ensure(length)
        out = self.out
        end = n + length

        if src < 0:
            # Part (or all) of the match comes from the initial window.
            from_window = min(length, -src)
            if self.marker_mode:
                # Markers name absolute positions in the unknown window:
                # window index w = WINDOW_SIZE + src + i (paper §2.2 step 2).
                w0 = WINDOW_SIZE + src
                out[n : n + from_window] = np.arange(
                    MARKER_BASE + w0, MARKER_BASE + w0 + from_window, dtype=np.uint16
                )
                if self.first_marker < 0:
                    self.first_marker = n
                self.last_marker = n + from_window - 1
            else:
                w0 = self.win_len + src
                out[n : n + from_window] = self.win_arr[w0 : w0 + from_window]
            n += from_window
            length -= from_window
            src = 0  # remainder copies from the chunk's own start

        # Remaining copy is chunk-internal; handle overlap by periodic copy
        # with doubling (classic LZ77 overlap expansion).
        while length > 0:
            avail = n - src
            take = min(length, avail)
            seg = out[src : src + take]
            out[n : n + take] = seg
            if self.marker_mode and self.last_marker >= src:
                # Conservative: copied region may contain markers.
                self.first_marker = self.first_marker if self.first_marker >= 0 else n
                self.last_marker = n + take - 1
            n += take
            length -= take
        self.n = n


# ---------------------------------------------------------------------------
# Convenience sequential API (used by tests and as the single-thread baseline)
# ---------------------------------------------------------------------------

def inflate_raw(data: bytes, max_out: Optional[int] = None) -> bytes:
    """Sequentially inflate a raw deflate stream from bit 0."""
    dec = DeflateChunkDecoder(data, framing="raw")
    res = dec.decode_chunk(0, len(data) * 8, window=b"", max_out=max_out)
    return res.data.tobytes()


def gzip_decompress_sequential(data: bytes, *, verify: bool = True) -> bytes:
    """Sequentially decompress a (multi-member) gzip byte stream.

    This is the paper's single-threaded baseline path ("rapidgzip -P 1"): the
    same custom deflate decoder, no speculation, known-empty window.
    """
    import zlib as _zlib

    br = BitReader(data)
    hdr = parse_gzip_header(br)
    dec = DeflateChunkDecoder(data, framing="gzip")
    res = dec.decode_chunk(br.bit_pos, len(data) * 8, window=b"")
    out = res.data.tobytes()
    if verify:
        prev = 0
        for me in res.member_ends:
            segment = out[prev : me.out_offset]
            if (_zlib.crc32(segment) & 0xFFFFFFFF) != me.crc32:
                raise GzipFooterError("CRC32 mismatch in gzip member")
            if (len(segment) & 0xFFFFFFFF) != me.isize:
                raise GzipFooterError("ISIZE mismatch in gzip member")
            prev = me.out_offset
    return out
