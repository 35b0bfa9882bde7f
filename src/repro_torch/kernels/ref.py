"""Constant tables of stage 2, built as torch tensors.

Counterparts of ``repro/kernels/ref.py::make_replacement_table`` and
``repro/kernels/crc32.py::make_crc_table``. The port keeps the narrow types
the data really has: a replacement table holds byte values, so it is uint8
(33 KB) where the reference used int32 (132 KB). The CRC table keeps the
reference's int32 bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

MARKER_BASE = 256
WINDOW_SIZE = 32768
TABLE_SIZE = MARKER_BASE + WINDOW_SIZE  # 33 024

_CRC_TABLE = None


def make_replacement_table(window) -> torch.Tensor:
    """(TABLE_SIZE,) uint8 replacement table ``[0..255] ++ window``.

    A short window is right-aligned and zero-padded on the left, as in the
    reference; a long one keeps its last 32 KiB.
    """
    w = np.frombuffer(bytes(window), np.uint8)[-WINDOW_SIZE:]
    table = np.zeros(TABLE_SIZE, np.uint8)
    table[:MARKER_BASE] = np.arange(MARKER_BASE, dtype=np.uint8)
    table[TABLE_SIZE - w.shape[0] :] = w
    return torch.from_numpy(table)


def make_crc_table() -> torch.Tensor:
    """Reflected CRC-32 (poly 0xEDB88320) byte table as (256,) int32 on the
    CPU, the same bit pattern as the reference. Built once per process."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = np.empty(256, dtype=np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0xEDB88320 if c & 1 else 0)
            table[i] = c
        _CRC_TABLE = torch.from_numpy(table.view(np.int32))
    return _CRC_TABLE
