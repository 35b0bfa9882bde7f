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
  * ``find_dynamic_vectorized`` — the rapidgzip-JAX finder: every bit offset
                                in a batch is checked *simultaneously* with
                                numpy vector ops (final/type/HLIT), then the
                                precode Kraft check runs bit-packed over the
                                surviving offsets ("DBF rapidgzip"; this is
                                also the algorithm the Pallas kernel
                                ``kernels/precode_check.py`` implements for
                                the TPU VPU).

The check cascade is the paper's §3.4.2 order:
  (1) final-block bit == 0           (2) block type == 0b01 (dynamic)
  (3) HLIT not in {30, 31}           (4) precode histogram valid & complete
  (5) precode-decoded CLs valid      (6) distance code valid & complete
  (7) literal code valid & complete

Non-Compressed-Block candidates are canonicalized to bit offset ``8*p - 3``
(p = byte offset of the LEN field) because the zero padding makes the true
start ambiguous (paper §3.4.1); ``deflate`` records stop offsets with the
same canonicalization so cache keys match.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np

from .bitreader import BitReader
from .deflate import canonical_stored_offset, read_dynamic_header
from .errors import DeflateError, EndOfStream

# -- layout constants (RFC 1951 dynamic header) ------------------------------
_HLIT_AT = 3  # 5 bits
_HDIST_AT = 8  # 5 bits
_HCLEN_AT = 13  # 4 bits
_PRECODE_AT = 17  # (HCLEN+4) x 3 bits
_MAX_PRECODE_BITS = 19 * 3
_HEADER_PROBE_BITS = _PRECODE_AT + _MAX_PRECODE_BITS  # 74


# ---------------------------------------------------------------------------
# Bit-plane helpers
# ---------------------------------------------------------------------------

def _bit_array(data, start_byte: int, n_bytes: int) -> np.ndarray:
    """LSB-first bit plane of data[start_byte : start_byte+n_bytes]."""
    buf = np.frombuffer(data, dtype=np.uint8, count=min(n_bytes, len(data) - start_byte), offset=start_byte)
    return np.unpackbits(buf, bitorder="little")


def _field(bits: np.ndarray, n_offsets: int, at: int, width: int) -> np.ndarray:
    """value[i] = LSB-first ``width``-bit field at bit offset i+at, for all i."""
    out = bits[at : at + n_offsets].astype(np.uint32)
    for j in range(1, width):
        out |= bits[at + j : at + j + n_offsets].astype(np.uint32) << j
    return out


# ---------------------------------------------------------------------------
# Vectorized Dynamic Block finder (the production finder)
# ---------------------------------------------------------------------------

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


def _precode_kraft_mask(bits: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """Vectorized precode histogram check for candidate offsets ``cand``.

    Gathers the 19 3-bit precode code lengths per candidate, builds the
    5-bit-packed frequency histogram (the paper's bit-level-parallel
    histogram: all 8 frequencies live in one 64-bit word) and applies the
    Kraft-completeness test: sum(count[l] << (7-l)) == 128.
    """
    hclen = (
        bits[cand + _HCLEN_AT].astype(np.uint32)
        | (bits[cand + _HCLEN_AT + 1].astype(np.uint32) << 1)
        | (bits[cand + _HCLEN_AT + 2].astype(np.uint32) << 2)
        | (bits[cand + _HCLEN_AT + 3].astype(np.uint32) << 3)
    )
    n_codes = hclen + 4

    # Packed histogram: bits [5l, 5l+5) hold the count of code length l.
    histo = np.zeros(cand.shape[0], dtype=np.uint64)
    kraft = np.zeros(cand.shape[0], dtype=np.uint32)
    for k in range(19):
        base = cand + (_PRECODE_AT + 3 * k)
        cl = (
            bits[base].astype(np.uint32)
            | (bits[base + 1].astype(np.uint32) << 1)
            | (bits[base + 2].astype(np.uint32) << 2)
        )
        active = (k < n_codes) & (cl > 0)
        histo += (active.astype(np.uint64)) << (np.uint64(5) * cl.astype(np.uint64))
        kraft += np.where(active, (128 >> cl).astype(np.uint32), 0)

    # Kraft equality <=> a valid AND complete ("efficient") code exists.
    del histo  # retained for parity with the packed-word formulation
    return kraft == 128


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

    Lazy/batched: in the common case the caller confirms the first candidate
    (by decompressing the chunk) and never pulls more, so only the first
    batch is ever scanned.
    """
    total_bits = len(data) * 8
    end_bit = min(end_bit, total_bits - _HEADER_PROBE_BITS)
    pos = start_bit
    while pos < end_bit:
        batch_end = min(pos + batch_bits, end_bit)
        n = batch_end - pos
        # Load bits with margin for the header probe.
        first_byte = pos // 8
        last_byte = min((batch_end + _HEADER_PROBE_BITS) // 8 + 1, len(data))
        bits = _bit_array(data, first_byte, last_byte - first_byte)
        rel = pos - first_byte * 8

        b0 = bits[rel : rel + n]
        b1 = bits[rel + 1 : rel + 1 + n]
        b2 = bits[rel + 2 : rel + 2 + n]
        # (1) final == 0, (2) type == 0b01 (stream order: 0 then 1).
        mask = (b0 == 0) & (b1 == 0) & (b2 == 1)
        if stats is not None:
            stats.tested += n
            nf = int(np.count_nonzero(b0))
            stats.invalid_final += nf
            nt = int(np.count_nonzero((b0 == 0) & ~((b1 == 0) & (b2 == 1))))
            stats.invalid_type += nt
        # (3) HLIT must encode <= 286 literal codes.
        hlit = _field(bits[rel:], n, _HLIT_AT, 5)
        bad_hlit = hlit >= 30
        if stats is not None:
            stats.invalid_hlit += int(np.count_nonzero(mask & bad_hlit))
        mask &= ~bad_hlit

        cand = np.nonzero(mask)[0].astype(np.int64) + rel
        if cand.shape[0]:
            # (4) precode histogram Kraft check, bit-packed & vectorized.
            ok = _precode_kraft_mask(bits, cand)
            if stats is not None:
                stats.invalid_precode_histogram += int(np.count_nonzero(~ok))
            cand = cand[ok]

        for c in cand:
            abs_off = int(c) - rel + pos
            if not full_validation:
                if stats is not None:
                    stats.valid += 1
                yield abs_off
                continue
            # (5)-(7): full strict header parse.
            try:
                br = BitReader(data, abs_off)
                br.skip(3)
                read_dynamic_header(br, strict=True)
            except (DeflateError, EndOfStream) as exc:
                if stats is not None:
                    msg = str(exc)
                    if msg.startswith("distance code"):
                        stats.invalid_distance += 1
                    elif msg.startswith("literal code"):
                        stats.invalid_literal += 1
                    else:
                        stats.invalid_precode_data += 1
                continue
            if stats is not None:
                stats.valid += 1
            yield abs_off
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
    (paper §3.4.1).
    """
    n_bytes = len(data)
    # p is the byte offset of LEN; candidate bit offset is 8p-3.
    p_min = max(1, (start_bit + 3 + 7) // 8)
    p_max_total = n_bytes - 4  # LEN+NLEN must fit
    pos = p_min
    while pos <= p_max_total:
        hi = min(pos + batch_bytes, p_max_total + 1)
        buf = np.frombuffer(data, dtype=np.uint8, count=min(hi + 4, n_bytes) - (pos - 1), offset=pos - 1)
        m = hi - pos  # number of candidate byte positions in this batch
        prev = buf[0:m]
        len_lo = buf[1 : 1 + m].astype(np.uint32)
        len_hi = buf[2 : 2 + m].astype(np.uint32)
        nlen_lo = buf[3 : 3 + m].astype(np.uint32)
        nlen_hi = buf[4 : 4 + m].astype(np.uint32)
        length = len_lo | (len_hi << 8)
        nlen = nlen_lo | (nlen_hi << 8)
        ok = ((prev & 0xE0) == 0) & (length == (~nlen & 0xFFFF))
        for i in np.nonzero(ok)[0]:
            p = pos + int(i)
            off = 8 * p - 3
            if start_bit <= off < end_bit:
                yield off
        pos = hi


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
