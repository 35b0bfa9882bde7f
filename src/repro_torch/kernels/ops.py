"""Per-call entry points over the hand kernels: the kernel-level API.

Counterpart of ``repro/kernels/ops.py``: each function takes host data
(numpy or bytes), pads and packs it into the kernel's layout on the device,
launches, and returns host results the reference's way. There is no
interpret switch: ``device="cuda"`` (the default) launches the CUDA kernels
and raises without a card; ``device="cpu"`` runs their plain versions.

Constant tables are cached per device: the CRC byte table and the
empty-window replacement table (the first chunk of any stream). For
batching across chunks on the read path, see ``engine.py``.
"""

from __future__ import annotations

import zlib as _zlib
from typing import Dict, Optional

import numpy as np
import torch

from ._build import resolve_device
from .crc32 import N_SEGMENTS, SEG_COLS, SEG_ROWS, crc32_fold_batched
from .marker_replace import TILE, TILE_COLS, TILE_ROWS, marker_replace_tiles
from .precode_check import HALO, precode_check_packed
from .ref import make_crc_table, make_replacement_table

_EMPTY_WINDOW_TABLES: Dict[torch.device, torch.Tensor] = {}
_CRC_TABLES: Dict[torch.device, torch.Tensor] = {}


def replacement_table_device(window: Optional[bytes], device="cuda") -> torch.Tensor:
    """(TABLE_SIZE,) uint8 replacement table for ``window`` on ``device``.

    The empty-window table (every marker resolves to 0) is cached per
    device; real windows are content-dependent and built per call.
    """
    dev = resolve_device(device)
    if not window:
        table = _EMPTY_WINDOW_TABLES.get(dev)
        if table is None:
            table = _EMPTY_WINDOW_TABLES[dev] = make_replacement_table(b"").to(dev)
        return table
    return make_replacement_table(window).to(dev)


# -- marker replacement -------------------------------------------------------

def marker_replace(symbols: np.ndarray, window: Optional[bytes], *, device="cuda") -> np.ndarray:
    """Resolve a uint16 marker stream to bytes through the marker kernel."""
    dev = resolve_device(device)
    n = symbols.shape[0]
    table = replacement_table_device(window, dev)
    n_tiles = max(1, -(-n // TILE))
    padded = np.zeros(n_tiles * TILE, dtype=np.uint16)
    padded[:n] = symbols
    tiles = torch.from_numpy(padded).to(dev).reshape(n_tiles, TILE_ROWS, TILE_COLS)
    out = marker_replace_tiles(tiles, table)
    return out.reshape(-1)[:n].cpu().numpy()


# -- block-finder precheck ----------------------------------------------------

def precode_candidates(data: bytes, start_bit: int = 0, end_bit: Optional[int] = None, *,
                       device="cuda") -> np.ndarray:
    """Bit offsets in ``[start_bit, end_bit)`` passing finder steps 1-4.

    Only the bytes the range reads go to the device; the mask is compacted
    there and only the candidates come back, as absolute int64 offsets.
    Callers confirm them with the strict host parse (steps 5-7), as the
    production finder does.
    """
    dev = resolve_device(device)
    total_bits = len(data) * 8
    if end_bit is None:
        end_bit = total_bits - HALO
    end_bit = min(end_bit, total_bits - HALO)
    if end_bit <= start_bit:
        return np.empty(0, dtype=np.int64)
    n = end_bit - start_bit

    first_byte = start_bit // 8
    rel = start_bit - first_byte * 8
    need_bytes = -(-(rel + n + HALO) // 8)
    raw = np.frombuffer(data, np.uint8, count=need_bytes, offset=first_byte).copy()
    mask = precode_check_packed(torch.from_numpy(raw).to(dev), rel, n)
    hits = torch.nonzero(mask).reshape(-1)
    return hits.cpu().numpy().astype(np.int64) + start_bit


# -- crc32 --------------------------------------------------------------------

def crc32_parallel(data: bytes, *, device="cuda") -> int:
    """CRC32 of ``data`` via N_SEGMENTS parallel lanes, folded in the launch."""
    dev = resolve_device(device)
    n = len(data)
    if n == 0:
        return 0
    seg_len = max(1, -(-n // N_SEGMENTS))
    padded = np.zeros(N_SEGMENTS * seg_len, dtype=np.uint8)
    padded[:n] = np.frombuffer(data, np.uint8)
    tiles = torch.from_numpy(padded).to(dev).reshape(SEG_ROWS, SEG_COLS, seg_len)
    table = _CRC_TABLES.get(dev)
    if table is None:
        table = _CRC_TABLES[dev] = make_crc_table().to(dev)
    # Zero padding inside a segment changes its CRC, so only the full
    # segments are folded and the partial one runs on from their CRC.
    full = n // seg_len
    _, folded = crc32_fold_batched(tiles[None], table, [full])
    return _zlib.crc32(data[full * seg_len :], int(folded[0]) & 0xFFFFFFFF)
