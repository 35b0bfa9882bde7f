"""Synthetic gzip-variant compressors (test + benchmark data generation).

The paper evaluates decompression across files produced by gzip, pigz,
bgzip, and igzip at various levels (Table 3) — each tool produces a
structurally different gzip file. This module reproduces those structures
with zlib so benchmarks and tests can exercise every code path offline:

  * ``gzip_compress``        — single member, dynamic blocks (GNU gzip).
  * ``pigz_like_compress``   — independent deflate spans joined by empty
    stored (sync-flush) blocks, one member — pigz's byte-alignment
    workaround (paper §5).
  * ``multistream_gzip``     — concatenated gzip members (bgzip without
    metadata / concatenated .gz files).
  * ``bgzf_compress``        — Blocked GNU Zip Format: fixed-size members
    with the BC extra field carrying the compressed size (paper §3.4.4).
  * ``fixed_only_compress``  — every block uses fixed Huffman codes
    (zlib Z_FIXED): the block finder cannot find any block, so parallel
    decompression degrades to sequential — the igzip -0 analogue (§4.8).
  * ``stored_only_compress`` — level-0 stored blocks (bgzip -0 analogue:
    decompression is a memcpy via the NCB fast path).
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterable, List

_GZIP_HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"


def _gzip_member(raw_deflate: bytes, data: bytes) -> bytes:
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF)
    return _GZIP_HEADER + raw_deflate + footer


def gzip_compress(data: bytes, level: int = 6) -> bytes:
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    raw = c.compress(data) + c.flush(zlib.Z_FINISH)
    return _gzip_member(raw, data)


def pigz_like_compress(data: bytes, level: int = 6, block_size: int = 128 << 10) -> bytes:
    """Independent deflate spans + empty stored blocks, one gzip member."""
    parts: List[bytes] = []
    n = len(data)
    for off in range(0, max(n, 1), block_size):
        block = data[off : off + block_size]
        last = off + block_size >= n
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        body = c.compress(block)
        body += c.flush(zlib.Z_FINISH if last else zlib.Z_FULL_FLUSH)
        parts.append(body)
    return _gzip_member(b"".join(parts), data)


def multistream_gzip(data: bytes, level: int = 6, stream_size: int = 256 << 10) -> bytes:
    parts: List[bytes] = []
    for off in range(0, max(len(data), 1), stream_size):
        parts.append(gzip_compress(data[off : off + stream_size], level))
    return b"".join(parts)


#: BGZF EOF marker: empty member (fixed canonical bytes from the spec).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _bgzf_member(block: bytes, level: int) -> bytes:
    """One BGZF member: gzip header with the 'BC' subfield = member size."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    raw = c.compress(block) + c.flush(zlib.Z_FINISH)
    # header: magic, CM, FLG=FEXTRA, mtime, XFL, OS, XLEN=6, BC subfield
    xtra = b"BC" + struct.pack("<HH", 2, 0)  # BSIZE patched below
    header = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff" + struct.pack("<H", 6) + xtra
    footer = struct.pack("<II", zlib.crc32(block) & 0xFFFFFFFF, len(block) & 0xFFFFFFFF)
    member = bytearray(header + raw + footer)
    bsize = len(member) - 1  # BSIZE = total block size minus 1
    member[16:18] = struct.pack("<H", bsize)
    return bytes(member)


def bgzf_compress(data: bytes, level: int = 6, block_size: int = 0xFF00) -> bytes:
    """BGZF: gzip members with the 'BC' extra subfield = total member size."""
    out: List[bytes] = []
    for off in range(0, max(len(data), 1), block_size):
        out.append(_bgzf_member(data[off : off + block_size], level))
    out.append(BGZF_EOF)
    return b"".join(out)


class BgzfStreamWriter:
    """Incremental BGZF writer for the transcode pipeline.

    Feed decompressed bytes in arbitrary-size pieces via :meth:`write`;
    whole members are emitted to ``sink`` (any object with a
    ``write(bytes)`` method) as soon as a block's worth accumulates, so
    memory stays O(block_size) no matter the archive size. :meth:`finish`
    flushes the final partial member and appends the canonical EOF marker.
    Byte layout is identical to :func:`bgzf_compress`.
    """

    def __init__(self, sink, level: int = 6, block_size: int = 0xFF00):
        self._sink = sink
        self._level = level
        self._block_size = block_size
        self._buf = bytearray()
        self._finished = False
        self.bytes_in = 0
        self.bytes_out = 0
        self.members = 0

    def write(self, data: bytes) -> None:
        if self._finished:
            raise ValueError("write after finish")
        self._buf += data
        self.bytes_in += len(data)
        while len(self._buf) >= self._block_size:
            self._emit(bytes(self._buf[: self._block_size]))
            del self._buf[: self._block_size]

    def _emit(self, block: bytes) -> None:
        member = _bgzf_member(block, self._level)
        self._sink.write(member)
        self.bytes_out += len(member)
        self.members += 1

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        if self._buf or self.members == 0:
            self._emit(bytes(self._buf))
            self._buf.clear()
        self._sink.write(BGZF_EOF)
        self.bytes_out += len(BGZF_EOF)


def fixed_only_compress(data: bytes, level: int = 6) -> bytes:
    """Every block uses fixed Huffman codes: finder-invisible (igzip -0 case)."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    raw = c.compress(data) + c.flush(zlib.Z_FINISH)
    return _gzip_member(raw, data)


def stored_only_compress(data: bytes) -> bytes:
    """Level 0: all Non-Compressed blocks (bgzip -0 analogue)."""
    c = zlib.compressobj(0, zlib.DEFLATED, -15)
    raw = c.compress(data) + c.flush(zlib.Z_FINISH)
    return _gzip_member(raw, data)


def zstd_seekable_compress(data: bytes, level: int = 3, frame_size: int = 128 << 10) -> bytes:
    """Zstd seekable format: independent frames + the seek-table footer.

    The footer is the final skippable frame (magic 0x184D2A5E) holding one
    ``(compressed_size, decompressed_size)`` u32 pair per frame, then
    ``(frame_count, descriptor, 0x8F92EAB1)``. Needs a zstd library for the
    frame bodies (``core.codec.have_zstd``) — raises RuntimeError without
    one, so callers gate on availability rather than silently degrading.
    """
    import io

    sink = io.BytesIO()
    writer = ZstdSeekableStreamWriter(sink, level, frame_size)
    for off in range(0, max(len(data), 1), frame_size):
        writer.write(data[off : off + frame_size])
        writer.flush_frame()  # frame boundaries exactly at frame_size
    writer.finish()
    return sink.getvalue()


class ZstdSeekableStreamWriter:
    """Incremental zstd-seekable writer (transcode pipeline counterpart of
    :class:`BgzfStreamWriter`).

    Buffers decompressed input up to ``frame_size``, emits each chunk as an
    independent zstd frame, and :meth:`finish` appends the seek-table
    skippable frame (magic 0x184D2A5E, 8-byte entries, no checksums) that
    ``core.codec.parse_zstd_seek_table`` reads back. Needs a zstd library
    (``core.codec.have_zstd``) — raises RuntimeError without one.
    """

    def __init__(self, sink, level: int = 3, frame_size: int = 128 << 10):
        from .codec import zstd_backend

        self._backend = zstd_backend()
        if self._backend is None:
            raise RuntimeError("ZstdSeekableStreamWriter needs a zstd library")
        self._sink = sink
        self._level = level
        self._frame_size = frame_size
        self._buf = bytearray()
        self._entries: List[bytes] = []
        self._finished = False
        self.bytes_in = 0
        self.bytes_out = 0

    @property
    def members(self) -> int:
        return len(self._entries)

    def write(self, data: bytes) -> None:
        if self._finished:
            raise ValueError("write after finish")
        self._buf += data
        self.bytes_in += len(data)
        while len(self._buf) >= self._frame_size:
            self._emit(bytes(self._buf[: self._frame_size]))
            del self._buf[: self._frame_size]

    def flush_frame(self) -> None:
        """Force a frame boundary at the current buffered position."""
        if self._buf:
            self._emit(bytes(self._buf))
            self._buf.clear()

    def _emit(self, block: bytes) -> None:
        frame = self._backend.compress(block, self._level)
        self._sink.write(frame)
        self.bytes_out += len(frame)
        self._entries.append(struct.pack("<II", len(frame), len(block)))

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        if self._buf or not self._entries:
            self._emit(bytes(self._buf))
            self._buf.clear()
        table = b"".join(self._entries) + struct.pack(
            "<IBI", len(self._entries), 0, 0x8F92EAB1
        )
        skippable = struct.pack("<II", 0x184D2A5E, len(table)) + table
        self._sink.write(skippable)
        self.bytes_out += len(skippable)


COMPRESSORS = {
    "gzip-1": lambda d: gzip_compress(d, 1),
    "gzip-6": lambda d: gzip_compress(d, 6),
    "gzip-9": lambda d: gzip_compress(d, 9),
    "pigz-like-6": lambda d: pigz_like_compress(d, 6),
    "multistream-6": lambda d: multistream_gzip(d, 6),
    "bgzf-6": lambda d: bgzf_compress(d, 6),
    "bgzf-0": lambda d: bgzf_compress(d, 0),
    "fixed-only-6": lambda d: fixed_only_compress(d, 6),
    "stored-only": stored_only_compress,
}
