"""gzip member framing (RFC 1952) and BGZF detection (paper §3.4.4, Fig 1).

A gzip *file* is a concatenation of gzip *members*; each member wraps one raw
deflate stream with a header (magic, flags, optional extra/name/comment/hcrc)
and a footer (CRC32 + ISIZE). BGZF (the Blocked GNU Zip Format used by
htslib/bgzip) is a gzip subset whose FEXTRA field carries the compressed
member size, making member boundaries — and hence trivially parallel
decompression — directly available (the GzipChunkFetcher has a fast path for
it, mirroring rapidgzip).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .bitreader import BitReader
from .errors import EndOfStream, GzipHeaderError

MAGIC1, MAGIC2 = 0x1F, 0x8B
CM_DEFLATE = 8

FTEXT = 1
FHCRC = 2
FEXTRA = 4
FNAME = 8
FCOMMENT = 16
FRESERVED = 0xE0


@dataclass
class GzipHeader:
    header_bits: int  # size of the header in bits (always a multiple of 8)
    mtime: int = 0
    os: int = 255
    xfl: int = 0
    name: Optional[bytes] = None
    comment: Optional[bytes] = None
    extra: Optional[bytes] = None
    is_bgzf: bool = False
    bgzf_block_size: Optional[int] = None  # BSIZE+1: total member size in bytes


@dataclass
class GzipFooter:
    crc32: int
    isize: int


def parse_gzip_header(br: BitReader) -> GzipHeader:
    """Parse a gzip member header at the reader's (byte-aligned) position."""
    start = br.bit_pos
    if start % 8:
        raise GzipHeaderError("gzip header must be byte-aligned")
    try:
        id1 = br.read(8)
        id2 = br.read(8)
        if id1 != MAGIC1 or id2 != MAGIC2:
            raise GzipHeaderError("bad gzip magic %02x%02x" % (id1, id2))
        cm = br.read(8)
        if cm != CM_DEFLATE:
            raise GzipHeaderError("unsupported compression method %d" % cm)
        flg = br.read(8)
        if flg & FRESERVED:
            raise GzipHeaderError("reserved FLG bits set")
        mtime = br.read(32)
        xfl = br.read(8)
        os_ = br.read(8)

        hdr = GzipHeader(header_bits=0, mtime=mtime, os=os_, xfl=xfl)
        if flg & FEXTRA:
            xlen = br.read(16)
            extra = br.read_bytes(xlen) if xlen else b""
            hdr.extra = extra
            _parse_bgzf_extra(hdr, extra)
        if flg & FNAME:
            hdr.name = _read_zero_terminated(br)
        if flg & FCOMMENT:
            hdr.comment = _read_zero_terminated(br)
        if flg & FHCRC:
            br.read(16)  # header CRC16 — parsed, not verified (as rapidgzip)
    except EndOfStream as exc:
        raise GzipHeaderError("truncated gzip header") from exc
    hdr.header_bits = br.bit_pos - start
    return hdr


def _read_zero_terminated(br: BitReader) -> bytes:
    out = bytearray()
    while True:
        b = br.read(8)
        if b == 0:
            return bytes(out)
        out.append(b)
        if len(out) > 1 << 16:
            raise GzipHeaderError("unterminated gzip header string")


def _parse_bgzf_extra(hdr: GzipHeader, extra: bytes) -> None:
    """Scan FEXTRA subfields for the BGZF 'BC' marker (paper §3.4.4)."""
    pos = 0
    while pos + 4 <= len(extra):
        si1, si2, slen = extra[pos], extra[pos + 1], struct.unpack_from("<H", extra, pos + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2 and pos + 6 <= len(extra):  # 'B','C'
            bsize = struct.unpack_from("<H", extra, pos + 4)[0]
            hdr.is_bgzf = True
            hdr.bgzf_block_size = bsize + 1
            return
        pos += 4 + slen


def parse_gzip_footer(br: BitReader) -> GzipFooter:
    """Parse the 8-byte CRC32+ISIZE footer at a byte-aligned position."""
    if br.bit_pos % 8:
        raise GzipHeaderError("gzip footer must be byte-aligned")
    crc = br.read(32)
    isize = br.read(32)
    return GzipFooter(crc, isize)


# ---------------------------------------------------------------------------
# Whole-file helpers
# ---------------------------------------------------------------------------

def parse_first_header(data) -> GzipHeader:
    return parse_gzip_header(BitReader(data))


def detect_bgzf(data) -> bool:
    """True if the file starts with a BGZF member (bgzip fast path)."""
    try:
        return parse_first_header(data).is_bgzf
    except GzipHeaderError:
        return False


def scan_bgzf_members(reader, *, max_members: Optional[int] = None) -> List[Tuple[int, int]]:
    """Walk BGZF member headers via the BSIZE metadata.

    Returns [(member_byte_offset, member_byte_size), ...]. This is the
    "trivially parallel" path: no speculation, no two-stage decode needed.
    """
    members: List[Tuple[int, int]] = []
    offset = 0
    size = reader.size()
    while offset < size:
        head = reader.pread(offset, 1 << 12)
        if len(head) < 18:
            break
        hdr = parse_gzip_header(BitReader(head))
        if not hdr.is_bgzf or not hdr.bgzf_block_size:
            raise GzipHeaderError("non-BGZF member in BGZF scan at offset %d" % offset)
        members.append((offset, hdr.bgzf_block_size))
        offset += hdr.bgzf_block_size
        if max_members is not None and len(members) >= max_members:
            break
    return members
