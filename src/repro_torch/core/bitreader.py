"""LSB-first buffered bit reader (paper §4.1, Fig 7).

Deflate packs data LSB-first within each byte (RFC 1951 §3.1.1); Huffman codes
are packed starting from the code's most-significant bit, so a peek() of the
raw LSB-first bits yields the code bits *reversed* — decode LUTs account for
that (see ``huffman.py``).

The paper's key observation (Fig 7) is that bit-reader bandwidth grows with
the number of bits per call, so callers should batch reads. This
implementation keeps a 64-bit-ish Python-int bit buffer refilled 8 bytes at a
time, giving a read cost that is amortized over many bits.
"""

from __future__ import annotations

from .errors import EndOfStream

_MASKS = [(1 << n) - 1 for n in range(65)]


class BitReader:
    """Reads LSB-first bit fields from a bytes-like buffer.

    The reader may be positioned at any absolute *bit* offset — the
    foundation of the speculative block finder, which must test candidate
    deflate headers at every bit position.
    """

    __slots__ = ("data", "n_bytes", "_byte_pos", "_buf", "_nbits")

    def __init__(self, data, start_bit: int = 0):
        # memoryview avoids copies when slicing refills.
        self.data = bytes(data) if not isinstance(data, (bytes, memoryview)) else data
        self.n_bytes = len(self.data)
        self._byte_pos = 0
        self._buf = 0
        self._nbits = 0
        if start_bit:
            self.seek(start_bit)

    # -- position ---------------------------------------------------------

    @property
    def bit_pos(self) -> int:
        """Absolute bit offset of the next bit to be read."""
        return self._byte_pos * 8 - self._nbits

    def seek(self, bit_offset: int) -> None:
        if bit_offset < 0:
            raise ValueError("negative bit offset")
        byte, bit = divmod(bit_offset, 8)
        self._byte_pos = byte
        self._buf = 0
        self._nbits = 0
        if bit:
            self._refill(bit)
            self._buf >>= bit
            self._nbits -= bit

    def bits_left(self) -> int:
        return self.n_bytes * 8 - self.bit_pos

    def eof(self) -> bool:
        return self.bit_pos >= self.n_bytes * 8

    # -- refill -----------------------------------------------------------

    def _refill(self, need: int) -> None:
        """Ensure at least ``need`` bits are buffered (pads at EOF)."""
        while self._nbits < need:
            take = min(8, self.n_bytes - self._byte_pos)
            if take <= 0:
                raise EndOfStream("bit reader exhausted")
            word = int.from_bytes(self.data[self._byte_pos : self._byte_pos + take], "little")
            self._buf |= word << self._nbits
            self._nbits += take * 8
            self._byte_pos += take

    # -- reads ------------------------------------------------------------

    def read(self, n: int) -> int:
        """Read ``n`` bits LSB-first; raises EndOfStream past the end."""
        if self._nbits < n:
            self._refill(n)
        val = self._buf & _MASKS[n]
        self._buf >>= n
        self._nbits -= n
        return val

    def peek(self, n: int) -> int:
        """Peek ``n`` bits without consuming; zero-padded at EOF.

        Zero padding (rather than raising) lets Huffman LUT decode peek a
        full max-length window near the end of the buffer; the subsequent
        ``skip`` detects actual overruns.
        """
        if self._nbits < n:
            try:
                self._refill(n)
            except EndOfStream:
                pass  # zero-padded peek at EOF
        return self._buf & _MASKS[n]

    def skip(self, n: int) -> None:
        if self._nbits < n:
            self._refill(n)  # raises EndOfStream on true overrun
        self._buf >>= n
        self._nbits -= n

    def align_to_byte(self) -> int:
        """Skip to the next byte boundary; returns number of bits skipped."""
        rem = self.bit_pos % 8
        if rem:
            self.skip(8 - rem)
            return 8 - rem
        return 0

    def read_bytes(self, n: int) -> bytes:
        """Read ``n`` byte-aligned bytes (fast path for stored blocks)."""
        if self.bit_pos % 8:
            raise ValueError("read_bytes requires byte alignment")
        start = self.bit_pos // 8
        if start + n > self.n_bytes:
            raise EndOfStream("read_bytes past end")
        out = bytes(self.data[start : start + n])
        # Drop buffered bits and jump.
        self._byte_pos = start + n
        self._buf = 0
        self._nbits = 0
        return out
