"""Seek-point index (paper §1.3 "Index for Seeking", §3.3).

Each seek point stores (compressed bit offset, decompressed byte offset, the
32 KiB window preceding it, flags). Decompression can resume at any point
with no work before it; offsets between points cost at most one point
spacing of sequential decode. The index is built *on the fly* during the
first pass (not a preprocessing step), can be exported/imported (like
indexed_gzip), rebalances chunk sizes for the second pass (equal
decompressed spacing -> load balance), and enables zlib delegation.

Windows are stored zlib-compressed — with default spacing the raw windows
would often dominate the index size.
"""

from __future__ import annotations

import io
import json
import struct
import threading
import zlib
from bisect import bisect_right
from dataclasses import dataclass
from typing import BinaryIO, List, Optional, Union

from .deflate import WINDOW_SIZE
from .errors import IndexError_

#: v1 (legacy): no codec tag in the meta header — imports as "deflate".
_MAGIC_V1 = b"RPGZIDX1"
#: v2: JSON meta carries ``"codec": <tag>``; point records are unchanged.
_MAGIC_V2 = b"RPGZIDX2"
_MAGIC = _MAGIC_V2

FLAG_STREAM_START = 1  # point sits right after a gzip member header
FLAG_HAS_INTERIOR_MEMBER_END = 2  # chunk [this, next) contains a member footer
FLAG_STORED_BLOCK = 4  # point is the canonical offset of a stored block
#: zlib delegation is only valid when stored-block padding survives the bit
#: shift: the chunk must start byte-aligned or contain no stored blocks
#: (stored blocks re-derive their padding from zlib's own byte alignment).
FLAG_ZLIB_UNSAFE = 8


@dataclass
class SeekPoint:
    compressed_bit: int
    decompressed_byte: int
    window: Optional[bytes]  # None => empty/unknown (stream start needs none)
    flags: int = 0

    @property
    def is_stream_start(self) -> bool:
        return bool(self.flags & FLAG_STREAM_START)


class GzipIndex:
    """Sorted, thread-safe collection of seek points.

    ``codec_tag`` names the codec whose chunk semantics the points encode
    (see ``core.codec``). It is serialized in the v2 header; legacy v1
    blobs carry no tag and import as ``"deflate"``.
    """

    def __init__(self, codec_tag: str = "deflate") -> None:
        self._points: List[SeekPoint] = []
        self._dec_offsets: List[int] = []  # parallel array for bisect
        self._lock = threading.RLock()
        self.finalized = False
        self.decompressed_size: Optional[int] = None
        self.compressed_size: Optional[int] = None
        self.codec_tag = codec_tag
        #: First-pass observations recorded by the reader (chunk counts,
        #: marker-mode chunks, fixed-only chunks, interior split points).
        #: Purely in-memory — never serialized; ``Codec.seek_hostility``
        #: reads them to score how seek-hostile the archive proved to be.
        #: An imported index has no observations and always scores 0.0.
        self.observations: dict = {}

    # -- construction -------------------------------------------------------

    def add_point(self, point: SeekPoint) -> None:
        with self._lock:
            if self._points and point.decompressed_byte <= self._dec_offsets[-1]:
                if point.decompressed_byte == self._dec_offsets[-1] and (
                    self._points[-1].compressed_bit == point.compressed_bit
                ):
                    return  # idempotent re-add
                if point.compressed_bit <= self._points[-1].compressed_bit:
                    return  # already covered
            self._points.append(point)
            self._dec_offsets.append(point.decompressed_byte)

    def finalize(self, decompressed_size: int, compressed_size: int) -> None:
        with self._lock:
            self.decompressed_size = decompressed_size
            self.compressed_size = compressed_size
            self.finalized = True

    # -- queries ------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._points)

    def points(self) -> List[SeekPoint]:
        with self._lock:
            return list(self._points)

    def point_at(self, i: int) -> SeekPoint:
        with self._lock:
            return self._points[i]

    def covered_until(self) -> int:
        """Largest decompressed offset with a seek point at/before it."""
        with self._lock:
            return self._dec_offsets[-1] if self._points else 0

    def find(self, decompressed_offset: int) -> Optional[int]:
        """Index of the last seek point at or before ``decompressed_offset``."""
        with self._lock:
            i = bisect_right(self._dec_offsets, decompressed_offset) - 1
            return i if i >= 0 else None

    def chunk_output_size(self, i: int) -> Optional[int]:
        """Decompressed size of index chunk i (None for the open last chunk)."""
        with self._lock:
            if i + 1 < len(self._points):
                return self._dec_offsets[i + 1] - self._dec_offsets[i]
            if self.finalized and self.decompressed_size is not None:
                return self.decompressed_size - self._dec_offsets[i]
            return None

    # -- import/export ------------------------------------------------------

    def export_file(self, dest: Union[str, BinaryIO]) -> None:
        """Binary format: magic, JSON header, zlib-compressed windows."""
        own = isinstance(dest, str)
        f: BinaryIO = open(dest, "wb") if own else dest  # type: ignore[assignment]
        try:
            with self._lock:
                meta = {
                    "finalized": self.finalized,
                    "decompressed_size": self.decompressed_size,
                    "compressed_size": self.compressed_size,
                    "n_points": len(self._points),
                    "codec": self.codec_tag,
                }
                blob = json.dumps(meta).encode()
                f.write(_MAGIC)
                f.write(struct.pack("<I", len(blob)))
                f.write(blob)
                for p in self._points:
                    wz = zlib.compress(p.window or b"", 6)
                    f.write(struct.pack("<QQII", p.compressed_bit, p.decompressed_byte, p.flags, len(wz)))
                    f.write(wz)
        finally:
            if own:
                f.close()

    @classmethod
    def import_file(cls, src: Union[str, BinaryIO]) -> "GzipIndex":
        own = isinstance(src, str)
        f: BinaryIO = open(src, "rb") if own else src  # type: ignore[assignment]
        try:
            magic = f.read(len(_MAGIC))
            if magic not in (_MAGIC_V1, _MAGIC_V2):
                raise IndexError_("bad index magic")
            (blob_len,) = struct.unpack("<I", f.read(4))
            meta = json.loads(f.read(blob_len).decode())
            # v1 predates codec tags; every v1 index was built by the
            # deflate machinery (including BGZF files — deflate-compatible).
            idx = cls(codec_tag=meta.get("codec", "deflate"))
            for _ in range(meta["n_points"]):
                cb, db, flags, wlen = struct.unpack("<QQII", f.read(24))
                wz = f.read(wlen)
                window = zlib.decompress(wz) if wlen else b""
                idx.add_point(SeekPoint(cb, db, window, flags))
            if meta["finalized"]:
                idx.finalize(meta["decompressed_size"], meta["compressed_size"])
            return idx
        finally:
            if own:
                f.close()

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.export_file(buf)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "GzipIndex":
        return cls.import_file(io.BytesIO(data))
