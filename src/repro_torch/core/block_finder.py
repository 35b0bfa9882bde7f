"""Deflate block finders (paper §3.4, Tables 1 & 2).

The finder returns *candidate* bit offsets of Dynamic or Non-Compressed
deflate blocks. It may return false positives (unavoidable from an arbitrary
offset — paper §3.4) and need not find every block; the cache-and-prefetch
architecture absorbs both error modes.

Three Dynamic-Block-finder implementations are provided, mirroring the
paper's Table 2 comparison ladder:

  * ``find_dynamic_trial``   — trial header parse at every bit offset
                                ("DBF custom deflate").
  * ``find_dynamic_skiplut`` — sequential walk with the 14-bit skip-LUT
                                ("DBF skip-LUT").
  * ``scan_dynamic_candidates`` — the production finder ("DBF rapidgzip"):
                                checks 1-3 on 48 offsets of a 64-bit window
                                at once, then the precode Kraft check on the
                                survivors (the algorithm the CUDA kernel
                                ``kernels/csrc/precode_check.cu`` runs on the
                                card, bit-sliced).

The check cascade is the paper's §3.4.2 order:
  (1) final-block bit == 0           (2) block type == 0b01 (dynamic)
  (3) HLIT not in {30, 31}           (4) precode histogram valid & complete
  (5) precode-decoded CLs valid      (6) distance code valid & complete
  (7) literal code valid & complete

Non-Compressed-Block candidates are canonicalized to bit offset ``8*p - 3``
(p = byte offset of the LEN field) because the zero padding makes the true
start ambiguous (paper §3.4.1); ``deflate`` records stop offsets with the
same canonicalization so cache keys match.

The port scans in compiled host code (``kernels/csrc/inflate.cpp``, beside
the decoder, whose strict header parse is checks 5-7; built through
``repro_torch._native``, which imports no torch, and called through
``ctypes``, which releases the GIL), so the first pass's workers search
their chunks at once instead of queueing on one interpreter. That is why
this module, like ``core/deflate.py``, is no longer a verbatim copy of
``repro.core.block_finder``: one call returns the next candidate (or, with
``stats``, counts checks 1-4 over a batch), and the NumPy bit planes are
gone. The candidates, their order and ``FilterStats`` after any number
pulled are the reference's, which ``tests/test_torch_stage1_native.py``
holds them to.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from .. import _native
from ..obs import trace as _obs_trace
from .bitreader import BitReader
from .deflate import read_dynamic_header
from .errors import DeflateError, EndOfStream

# -- layout constants (RFC 1951 dynamic header) ------------------------------
_PRECODE_AT = 17  # (HCLEN+4) x 3 bits after the block's first bit
_MAX_PRECODE_BITS = 19 * 3
_HEADER_PROBE_BITS = _PRECODE_AT + _MAX_PRECODE_BITS  # 74


@dataclass
class FilterStats:
    """Per-stage rejection counters — reproduces paper Table 1."""

    tested: int = 0
    invalid_final: int = 0
    invalid_type: int = 0
    invalid_hlit: int = 0  # paper: "Invalid Precode size"
    invalid_precode_histogram: int = 0  # invalid + non-optimal precode code
    invalid_precode_data: int = 0
    invalid_distance: int = 0
    invalid_literal: int = 0
    valid: int = 0

    def as_dict(self) -> dict:
        return {k: int(getattr(self, k)) for k in self.__dataclass_fields__}


# ---------------------------------------------------------------------------
# The compiled search (kernels/csrc/inflate.cpp)
# ---------------------------------------------------------------------------

# Slots of a search's io array (int64 each), as the library names them.
_POS, _END, _STRICT, _MOVED, _PARSED, _BAD_DATA, _BAD_DIST, _BAD_LIT = range(8)

_ARGTYPES = {
    "rg_find_dynamic": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
    "rg_find_stored": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
    "rg_count_dynamic": [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p],
}

_stats_lock = threading.Lock()
_stats: Dict[str, int] = {"calls": 0, "bits": 0, "candidates": 0, "strict_checks": 0}


def stats() -> Dict[str, int]:
    """Process-wide counts of the compiled finder: ``calls``, ``bits``
    (offsets moved over), ``candidates`` returned, and ``strict_checks``
    (headers parsed by checks 5-7)."""
    with _stats_lock:
        return dict(_stats)


class _Search:
    """One scan's buffer and io array, and its compiled calls (span
    ``stage1.find`` each, the offsets moved over its ``bits``)."""

    def __init__(self, data):
        self.src = np.frombuffer(data, dtype=np.uint8)
        self.io = np.zeros(8, dtype=np.int64)
        self.counts = np.zeros(5, dtype=np.int64)
        self._args = (self.src.ctypes.data, self.src.shape[0], self.io.ctypes.data)

    def _call(self, symbol: str, pos: int, end: int, strict: bool = False, *extra) -> None:
        io = self.io
        io[_POS], io[_END], io[_STRICT] = pos, end, strict
        fn = _native.HOST.entry("inflate", symbol, _ARGTYPES[symbol])
        with _obs_trace.span("stage1.find") as sp:
            fn(*self._args, *extra)
            sp.set_attr("bits", int(io[_MOVED]))
        with _stats_lock:
            _stats["calls"] += 1
            _stats["bits"] += int(io[_MOVED])

    def next(self, symbol: str, pos: int, end: int, strict: bool = False) -> int:
        """The next candidate of ``symbol``'s search from ``pos``, or -1."""
        self._call(symbol, pos, end, strict)
        found = int(self.io[_POS])
        with _stats_lock:
            _stats["candidates"] += found >= 0
            _stats["strict_checks"] += int(self.io[_PARSED])
        return found

    def count(self, start: int, end: int, stats: FilterStats) -> None:
        """Checks 1-4 of every offset in [start, end) into ``stats``."""
        self._call("rg_count_dynamic", start, end, False, self.counts.ctypes.data)
        tested, final, btype, hlit, precode = self.counts.tolist()
        stats.tested += tested
        stats.invalid_final += final
        stats.invalid_type += btype
        stats.invalid_hlit += hlit
        stats.invalid_precode_histogram += precode


# ---------------------------------------------------------------------------
# Dynamic Block finder (the production finder)
# ---------------------------------------------------------------------------

def scan_dynamic_candidates(
    data,
    start_bit: int,
    end_bit: int,
    *,
    batch_bits: int = 1 << 19,
    stats: Optional[FilterStats] = None,
    full_validation: bool = True,
) -> Iterator[int]:
    """Yield Dynamic-Block candidate bit offsets in [start_bit, end_bit).

    Lazy: in the common case the caller confirms the first candidate (by
    decompressing the chunk) and never pulls more, so one compiled call
    runs. With ``stats``, checks 1-4 are counted a ``batch_bits`` batch at
    a time as the scan enters it, and checks 5-7 a candidate at a time.
    """
    total_bits = len(data) * 8
    end_bit = min(end_bit, total_bits - _HEADER_PROBE_BITS)
    pos = start_bit
    if pos < 0 and pos < end_bit:
        raise ValueError("start_bit must be non-negative, not %d" % start_bit)
    search = _Search(data)
    while pos < end_bit:
        batch_end = end_bit if stats is None else min(pos + batch_bits, end_bit)
        if stats is not None:
            search.count(pos, batch_end, stats)
        while True:
            cand = search.next("rg_find_dynamic", pos, batch_end, full_validation)
            if stats is not None:
                io = search.io
                stats.invalid_precode_data += int(io[_BAD_DATA])
                stats.invalid_distance += int(io[_BAD_DIST])
                stats.invalid_literal += int(io[_BAD_LIT])
            if cand < 0:
                break
            if stats is not None:
                stats.valid += 1
            yield cand
            pos = cand + 1
        pos = batch_end


# ---------------------------------------------------------------------------
# Non-Compressed Block finder (paper §3.4.1)
# ---------------------------------------------------------------------------

def scan_stored_candidates(
    data,
    start_bit: int,
    end_bit: int,
    *,
    batch_bytes: int = 1 << 20,
) -> Iterator[int]:
    """Yield canonical NCB candidate offsets (``8*p - 3``) in [start_bit, end_bit).

    Checks: top 3 bits of the preceding byte zero (non-final, type 00, zero
    padding) and LEN == ~NLEN. False-positive rate ~1/512 KiB on random data
    (paper §3.4.1). ``batch_bytes`` is kept for the reference's signature:
    one compiled call scans to the next candidate whatever its distance.
    """
    del batch_bytes
    # p is the byte offset of LEN; candidate bit offset is 8p-3.
    p = max(1, (start_bit + 3 + 7) // 8)
    search = _Search(data)
    while True:
        p = search.next("rg_find_stored", p, end_bit)
        if p < 0:
            return
        yield 8 * p - 3
        p += 1


# ---------------------------------------------------------------------------
# Combined finder (paper §3.4: lower offset of the two specialized finders)
# ---------------------------------------------------------------------------

class CombinedBlockFinder:
    """Merged Dynamic + Non-Compressed candidate stream for one chunk."""

    def __init__(self, data, start_bit: int, end_bit: int, *, stats: Optional[FilterStats] = None):
        self._dyn = scan_dynamic_candidates(data, start_bit, end_bit, stats=stats)
        self._ncb = scan_stored_candidates(data, start_bit, end_bit)
        self._dyn_next = next(self._dyn, None)
        self._ncb_next = next(self._ncb, None)

    def __iter__(self) -> "CombinedBlockFinder":
        return self

    def __next__(self) -> int:
        d, s = self._dyn_next, self._ncb_next
        if d is None and s is None:
            raise StopIteration
        if s is None or (d is not None and d <= s):
            self._dyn_next = next(self._dyn, None)
            if s is not None and d == s:  # dedupe identical offsets
                self._ncb_next = next(self._ncb, None)
            return d
        self._ncb_next = next(self._ncb, None)
        return s


# ---------------------------------------------------------------------------
# Sequential skip-LUT finder (paper's own walk — kept for Table 2 parity)
# ---------------------------------------------------------------------------

_SKIP_LUT_BITS = 14


def _build_skip_lut() -> np.ndarray:
    """skip[v] = bits to advance to the first plausible candidate in window v.

    For shifts where the full (final, type, HLIT) prefix is visible the check
    is exact; for shifts with only partial visibility the skip is
    conservative (candidate assumed plausible).
    """
    size = 1 << _SKIP_LUT_BITS
    lut = np.empty(size, dtype=np.uint8)
    for v in range(size):
        skip = _SKIP_LUT_BITS  # nothing plausible in the whole window
        for s in range(_SKIP_LUT_BITS):
            vis = _SKIP_LUT_BITS - s
            w = v >> s
            if vis >= 1 and (w & 1) != 0:  # final bit must be 0
                continue
            if vis >= 2 and (w >> 1) & 1 != 0:  # type LSB must be 0
                continue
            if vis >= 3 and (w >> 2) & 1 != 1:  # type MSB must be 1
                continue
            if vis >= 8:
                hlit = (w >> 3) & 31
                if hlit >= 30:
                    continue
            skip = s
            break
        lut[v] = skip
    return lut


_SKIP_LUT: Optional[np.ndarray] = None


def skip_lut() -> np.ndarray:
    global _SKIP_LUT
    if _SKIP_LUT is None:
        _SKIP_LUT = _build_skip_lut()
    return _SKIP_LUT


def find_dynamic_skiplut(data, start_bit: int, end_bit: int) -> Iterator[int]:
    """Sequential Dynamic-Block walk using the 14-bit skip-LUT."""
    lut = skip_lut()
    total_bits = len(data) * 8
    end = min(end_bit, total_bits - _HEADER_PROBE_BITS)
    br = BitReader(data)
    pos = start_bit
    while pos < end:
        br.seek(pos)
        window = br.peek(_SKIP_LUT_BITS)
        s = int(lut[window])
        if s > 0:
            pos += s
            continue
        # Plausible prefix at pos: run the precode + full checks.
        try:
            br2 = BitReader(data, pos)
            br2.skip(3)
            read_dynamic_header(br2, strict=True)
            yield pos
        except (DeflateError, EndOfStream):
            pass
        pos += 1


def find_dynamic_trial(data, start_bit: int, end_bit: int) -> Iterator[int]:
    """Naive trial parse at every offset ("DBF custom deflate", Table 2)."""
    total_bits = len(data) * 8
    end = min(end_bit, total_bits - _HEADER_PROBE_BITS)
    for pos in range(start_bit, end):
        try:
            br = BitReader(data, pos)
            final = br.read(1)
            btype = br.read(2)
            if final or btype != 2:
                continue
            read_dynamic_header(br, strict=True)
            yield pos
        except (DeflateError, EndOfStream):
            continue


def find_dynamic_zlib(data, start_bit: int, end_bit: int) -> Iterator[int]:
    """Trial decompression with zlib at byte-shifted offsets ("DBF zlib").

    zlib cannot start at a bit offset, so each trial bit-shifts the buffer —
    this is exactly why it is the slowest finder in paper Table 2.
    """
    import zlib

    from .zlib_bridge import shift_bitstream

    total_bits = len(data) * 8
    end = min(end_bit, total_bits - _HEADER_PROBE_BITS)
    for pos in range(start_bit, end):
        shifted = shift_bitstream(data, pos, max_bytes=1 << 12)
        d = zlib.decompressobj(wbits=-15)
        try:
            d.decompress(shifted)
        except zlib.error:
            continue
        # Require some progress and a dynamic block prefix.
        first3 = shifted[0] & 7
        if first3 == 0b100:  # final=0, type=01 LSB-first
            yield pos
