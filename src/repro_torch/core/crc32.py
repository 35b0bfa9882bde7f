"""Parallel CRC32: per-chunk CRCs merged with GF(2) combine.

The paper lists checksum verification as future work (§6); rapidgzip-JAX
implements it. Each chunk's CRC32 is computed independently on the thread
pool (``zlib.crc32`` or the Pallas slice-by-8 kernel) and the per-chunk
values are merged sequentially with the O(log n) zlib ``crc32_combine``
matrix trick — the merge touches 32-bit state only, so the sequential part
of checksumming is negligible (same Amdahl argument as window propagation).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

_POLY = 0xEDB88320


def _gf2_matrix_times(mat: Sequence[int], vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_matrix_square(mat: Sequence[int]) -> List[int]:
    return [_gf2_matrix_times(mat, mat[i]) for i in range(32)]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32 of the concatenation of two blocks (zlib's crc32_combine)."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    # Operator for one zero bit.
    odd = [_POLY] + [1 << (i - 1) for i in range(1, 32)]
    even = _gf2_matrix_square(odd)  # two zero bits
    odd = _gf2_matrix_square(even)  # four zero bits
    crc1 &= 0xFFFFFFFF
    crc2 &= 0xFFFFFFFF
    # Apply len2 zero bytes to crc1, alternating the squared operators.
    do_odd = False
    n = len2
    while n:
        if do_odd:
            odd = _gf2_matrix_square(even)
            if n & 1:
                crc1 = _gf2_matrix_times(odd, crc1)
        else:
            even = _gf2_matrix_square(odd)
            if n & 1:
                crc1 = _gf2_matrix_times(even, crc1)
        do_odd = not do_odd
        n >>= 1
    return (crc1 ^ crc2) & 0xFFFFFFFF


class RunningCRC:
    """Sequential CRC folding of per-chunk (crc, length) parts."""

    def __init__(self) -> None:
        self.crc = 0
        self.length = 0

    def add(self, crc: int, length: int) -> None:
        self.crc = crc32_combine(self.crc, crc, length)
        self.length += length

    def reset(self) -> None:
        self.crc = 0
        self.length = 0


def combine_parts(parts: Sequence[Tuple[int, int]]) -> int:
    """Fold [(crc, len), ...] left to right."""
    acc = RunningCRC()
    for crc, length in parts:
        acc.add(crc, length)
    return acc.crc
