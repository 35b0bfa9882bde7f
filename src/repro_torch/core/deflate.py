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

The port decodes the blocks in compiled host code (``kernels/csrc/
inflate.cpp``, built by the host C++ compiler at first use through
``repro_torch._native``, which imports no torch, and called through
``ctypes``, which releases the GIL), so the first pass's workers
decode at once instead of queueing on one interpreter. That is why this
module is no longer a verbatim copy of ``repro.core.deflate``: one call runs
the whole block loop (headers, stored blocks, the Huffman loop, the stop
rule, markers); Python keeps the gzip framing between members and the
output buffer, which it doubles when a block does not fit (the call then
returns at that block's start, and the block is decoded again). Output,
block boundaries, marker bounds, stop offsets and the type of every error
are those of the reference's Python decoder, which the tests hold it to.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .. import _native
from ..obs import trace as _obs_trace
from .bitreader import BitReader
from .errors import DeflateError, EndOfStream, GzipFooterError
from .gzip_format import parse_gzip_footer, parse_gzip_header

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
        # A start outside the data raises as the reference's reader does.
        BitReader(self.data, start_bit)
        if stop_bit is None:
            stop_bit = len(self.data) * 8
        src = np.frombuffer(self.data, dtype=np.uint8)

        marker_mode = window is None
        dtype = np.uint16 if marker_mode else np.uint8
        out = np.empty(max(initial_capacity, 1024), dtype=dtype)
        win_arr = np.frombuffer(window, dtype=np.uint8) if window else _NO_WINDOW

        state = np.array([start_bit, 0, -1, -1, 0, 0, 0, 0], dtype=np.int64)
        records = np.empty((_RECORDS_PER_CALL, 4), dtype=np.int64)
        result = DecodeResult(start_bit=start_bit, end_bit=start_bit, data=out, marker_mode=marker_mode)

        while True:
            state[_HAVE_BLOCKS] = 1 if result.blocks else 0
            status = _inflate(src, state, stop_bit, out, marker_mode, win_arr, records)
            result.blocks.extend(
                BlockBoundary(bit, pos, btype, bool(final))
                for bit, pos, btype, final in records[: state[_BLOCKS]].tolist()
            )
            if status == _STOP:
                result.end_bit = int(state[_INFO])
                break
            if status == _BLOCKS_FULL:
                continue
            if status == _FULL:
                # The block at state[_POS] needs ``need`` symbols of room:
                # grow by doubling, under max_out, and decode it again.
                need = int(state[_INFO])
                if max_out is not None and need > max_out:
                    raise DeflateError(
                        "chunk output exceeds max_out=%d (suspected false positive or "
                        "extreme compression ratio)" % max_out
                    )
                new_cap = out.shape[0]
                while new_cap < need:
                    new_cap *= 2
                grown = np.empty(new_cap, dtype=dtype)
                n = int(state[_OUT_LEN])
                grown[:n] = out[:n]
                out = grown
                continue
            # _FINAL: the end of a deflate stream.
            end = int(state[_POS])
            n = int(state[_OUT_LEN])
            if self.framing == "raw":
                result.end_bit = end
                result.ended_at_eos = True
                break
            # gzip footer: byte-align, CRC32 + ISIZE (paper Fig 1).
            br = BitReader(self.data, end)
            br.align_to_byte()
            footer = parse_gzip_footer(br)
            result.member_ends.append(MemberEnd(n, footer.crc32, footer.isize, br.bit_pos))
            if br.bits_left() < 8:
                result.end_bit = br.bit_pos
                result.ended_at_eos = True
                break
            header_start = br.bit_pos
            parse_gzip_header(br)
            result.member_starts.append(MemberStart(header_start, br.bit_pos, n))
            # Next member's first block continues the loop; the stop check
            # applies to it like any other boundary.
            state[_POS] = br.bit_pos

        result.data = out[: state[_OUT_LEN]]
        result.first_marker = int(state[_FIRST_MARKER])
        result.last_marker = int(state[_LAST_MARKER])
        return result


def read_dynamic_header(br: BitReader, *, strict: bool = False) -> None:
    """Parse a Dynamic Block header at ``br``'s position (after the 3 block
    header bits) and advance ``br`` past it; raises ``DeflateError`` or
    ``EndOfStream`` as the reference's parser does at the same input.

    ``strict=True`` applies block-finder semantics: all three Huffman codes
    must be valid AND complete (paper §3.4.2 steps 4-7), the distance code
    checked before the literal code. ``strict=False`` applies decoder
    semantics (zlib-compatible leniency for incomplete distance codes). The
    decode tables themselves are built only inside the compiled decoder.
    """
    state = np.zeros(_STATE_SLOTS, dtype=np.int64)
    state[_POS] = br.bit_pos
    src = np.frombuffer(br.data, dtype=np.uint8)
    status = _entry("rg_dynamic_header")(src.ctypes.data, src.shape[0], state.ctypes.data, int(strict))
    if status:
        _raise(status, state)
    br.seek(int(state[_POS]))


# ---------------------------------------------------------------------------
# The compiled decoder (kernels/csrc/inflate.cpp)
# ---------------------------------------------------------------------------

# State slots shared with the library (int64 each).
_POS, _OUT_LEN, _FIRST_MARKER, _LAST_MARKER, _INFO, _BLOCKS, _INFO2, _HAVE_BLOCKS = range(8)
_STATE_SLOTS = 8

# Statuses: where a call stopped; negative ones are errors.
_STOP, _FINAL, _FULL, _BLOCKS_FULL = 0, 1, 2, 3

#: (bit offset, output offset, type, final) records a call can return.
_RECORDS_PER_CALL = 256

_NO_WINDOW = np.empty(0, dtype=np.uint8)

_ERRORS = {
    -1: (EndOfStream, "bit reader exhausted"),
    -2: (EndOfStream, "chunk ran out of bits at block boundary"),
    -3: (EndOfStream, "read_bytes past end"),
    -4: (DeflateError, "reserved block type 11"),
    -5: (DeflateError, "stored block LEN/NLEN mismatch"),
    -6: (DeflateError, "invalid literal/length code"),
    -7: (DeflateError, "invalid length symbol %d"),
    -8: (DeflateError, "invalid distance code"),
    -9: (DeflateError, "invalid distance symbol %d"),
    -10: (DeflateError, "distance %d exceeds window"),
    -11: (DeflateError, "distance reaches before stream start"),
    -12: (DeflateError, "invalid HLIT"),
    -13: (DeflateError, "code count out of range (HLIT=%d HDIST=%d)"),
    -14: (DeflateError, "over-subscribed Huffman code"),
    -15: (DeflateError, "empty Huffman code"),
    -16: (DeflateError, "incomplete Huffman code"),
    -17: (DeflateError, "precode data: repeat code with no previous length"),
    -18: (DeflateError, "precode data: repeat overruns code-length table"),
    -19: (DeflateError, "precode data: zero-repeat overruns code-length table"),
    -20: (DeflateError, "distance code: status %d"),
    -21: (DeflateError, "literal code: status %d"),
    -22: (DeflateError, "literal code: no end-of-block symbol"),
}

_ARGTYPES = {
    "rg_inflate": [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64,
    ],
    "rg_dynamic_header": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int],
}

_stats_lock = threading.Lock()
_stats: Dict[str, int] = {"calls": 0, "blocks": 0, "symbols": 0, "regrowths": 0}


def stats() -> Dict[str, int]:
    """Process-wide counts of the compiled decoder: ``calls``, ``blocks``
    decoded (a block decoded again after a regrowth counts once),
    ``symbols`` written, and ``regrowths`` (blocks decoded twice because
    the output buffer filled)."""
    with _stats_lock:
        return dict(_stats)


def _entry(symbol: str):
    """An entry of the decoder library, built and loaded at first use."""
    return _native.HOST.entry("inflate", symbol, _ARGTYPES[symbol])


def _raise(status: int, state: np.ndarray) -> None:
    cls, fmt = _ERRORS[status]
    n_args = fmt.count("%d")
    args = (int(state[_INFO]), int(state[_INFO2]))[:n_args]
    raise cls(fmt % args if n_args else fmt)


def _inflate(src, state, stop_bit, out, marker_mode, win_arr, records) -> int:
    """One compiled call (span ``stage1.decode``, its output symbols an
    attribute); raises on an error status."""
    fn = _entry("rg_inflate")
    n0 = int(state[_OUT_LEN])
    with _obs_trace.span("stage1.decode") as sp:
        status = fn(
            src.ctypes.data, src.shape[0], state.ctypes.data, stop_bit, out.ctypes.data,
            out.shape[0], int(marker_mode), win_arr.ctypes.data, win_arr.shape[0],
            records.ctypes.data, records.shape[0],
        )
        if status >= 0:
            sp.set_attr("symbols", int(state[_OUT_LEN]) - n0)
    with _stats_lock:
        _stats["calls"] += 1
        if status >= 0:
            _stats["blocks"] += int(state[_BLOCKS])
            _stats["symbols"] += int(state[_OUT_LEN]) - n0
            _stats["regrowths"] += status == _FULL
    if status < 0:
        _raise(status, state)
    return status


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
