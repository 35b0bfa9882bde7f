"""The reference of a gzip read: the decompressed bytes are the text the
benchmark compressed, so a delivered range is judged against that text
byte for byte, and a copy of the archive whose trailer no longer matches
its bytes has to be refused. The control puts zlib in the program's place
with one of the configuration's guarantees broken (the member's CRC and
size are not checked, and the archive it reads has one bit flipped)."""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np


def mismatched_bytes(text: bytes, offset: int, data: bytes, expected_len: int) -> int:
    """Bytes of ``data`` that differ from ``text`` at ``offset``, plus the
    bytes missing from or added to the ``expected_len`` asked for."""
    want = text[offset : offset + expected_len]
    n = min(len(want), len(data))
    a = np.frombuffer(want, np.uint8, count=n)
    b = np.frombuffer(data, np.uint8, count=n)
    return int(np.count_nonzero(a != b)) + abs(len(want) - len(data))


TRAILER_FIELDS = {"crc32": slice(-8, -4), "isize": slice(-4, None)}


def corrupt_trailer(archive: bytes, field: str, bit: int) -> bytes:
    """``archive`` (one member) with bit ``bit`` (0-31) of its trailer's
    ``field`` ("crc32" or "isize") flipped: a read that verifies the member
    has to refuse it."""
    out = bytearray(archive)
    at = range(len(out))[TRAILER_FIELDS[field]][bit // 8]
    out[at] ^= 1 << (bit % 8)
    return bytes(out)


def control_decompress(archive: bytes, flip_at: Optional[int] = None) -> bytes:
    """The control: raw inflate of ``archive`` past its 10-byte header,
    with bit 0 of byte ``flip_at`` of the deflate stream flipped (if
    given) and the trailer's CRC and size never compared (the guarantee it
    breaks). Empty where zlib refuses the stream."""
    body = bytearray(archive[10:-8])
    if flip_at is not None:
        body[flip_at % len(body)] ^= 1
    d = zlib.decompressobj(-15)
    try:
        return d.decompress(bytes(body)) + d.flush()
    except zlib.error:
        return b""
