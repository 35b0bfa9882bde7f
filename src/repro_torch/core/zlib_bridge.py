"""zlib delegation for index-backed decompression (paper §1.3, §3.3).

Once a seek point (bit offset + 32 KiB window) exists, decompression can be
delegated to zlib — "more than twice as fast as the two-stage decompression"
(paper §1.3). zlib can only start at byte boundaries, so the compressed
stream is re-aligned by a vectorized bit shift first; the window is primed
via ``zdict`` on a raw-deflate decompressobj.
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from .errors import DeflateError


def shift_bitstream(data, bit_offset: int, max_bytes: Optional[int] = None) -> bytes:
    """Re-pack ``data`` starting at ``bit_offset`` onto a byte boundary.

    Vectorized: each output byte pulls ``8-k`` low bits from one input byte
    and ``k`` bits from the next (deflate is LSB-first, so the shift moves
    toward the LSB).
    """
    byte, bit = divmod(bit_offset, 8)
    if max_bytes is None:
        end = len(data)
    else:
        end = min(len(data), byte + max_bytes + 1)
    at_eof = end >= len(data)
    if bit == 0:
        hi_end = end if max_bytes is None else min(byte + max_bytes, len(data))
        return bytes(data[byte:hi_end])
    arr = np.frombuffer(data, dtype=np.uint8, count=end - byte, offset=byte)
    if arr.shape[0] == 0:
        return b""
    lo = arr >> np.uint8(bit)
    hi = np.empty_like(arr)
    hi[:-1] = arr[1:] << np.uint8(8 - bit)
    hi[-1] = 0
    out = lo | hi
    if not at_eof:
        # The final byte is only partially determined without the next input
        # byte — emit fully-formed bytes only; the caller advances by the
        # returned length and re-reads the boundary byte.
        out = out[:-1]
    return out.tobytes()


def zlib_inflate_at(
    data,
    bit_offset: int,
    window: bytes,
    out_size: int,
    *,
    feed_bytes: int = 1 << 16,
    max_input_bytes: Optional[int] = None,
) -> bytes:
    """Inflate exactly ``out_size`` bytes starting at ``bit_offset``.

    The stream is fed incrementally so only O(out_size / ratio) input is
    bit-shifted, not the whole file tail.

    ``max_input_bytes`` must bound the chunk's compressed span when known:
    zlib eagerly parses the *next* block header even with no output space
    remaining, and a stored-block header does not survive the bit-shift
    realignment — truncating the input at the chunk boundary keeps zlib
    waiting for input instead of erroring on the successor's header.
    """
    if out_size == 0:
        return b""
    d = zlib.decompressobj(wbits=-zlib.MAX_WBITS, zdict=window)
    out = []
    produced = 0
    pos = bit_offset
    total_bits = len(data) * 8
    if max_input_bytes is not None:
        total_bits = min(total_bits, bit_offset + max_input_bytes * 8)
    while produced < out_size:
        if pos >= total_bits:
            raise DeflateError("compressed stream exhausted before chunk end")
        piece = shift_bitstream(data, pos, max_bytes=min(feed_bytes, (total_bits - pos) // 8 + 1))
        if max_input_bytes is not None and pos + len(piece) * 8 > total_bits:
            piece = piece[: max(1, (total_bits - pos) // 8)]
        pos += len(piece) * 8
        try:
            chunk = d.decompress(d.unconsumed_tail + piece, out_size - produced)
        except zlib.error as exc:
            raise DeflateError("zlib delegation failed: %s" % exc) from exc
        out.append(chunk)
        produced += len(chunk)
        if d.eof:
            # End of this deflate stream (gzip member boundary). A chunk can
            # span members; the caller's seek points are built so member
            # boundaries coincide with chunk boundaries or interior block
            # boundaries — restart a fresh raw stream after the footer is
            # not handled here; chunks with interior member ends use the
            # custom decoder instead.
            break
    result = b"".join(out)
    if len(result) < out_size:
        raise DeflateError(
            "zlib delegation produced %d of %d bytes" % (len(result), out_size)
        )
    return result
