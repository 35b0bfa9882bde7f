"""Stage-2 marker replacement (paper §2.2 step 3): hand kernel and plain
version.

    out[t] = tables[tile_tables[t]][syms[t]]

Counterpart of ``repro/kernels/marker_replace.py``. The public functions keep
the reference's layout — symbols in (n_tiles, 8, 1024) tiles, tables
(n_tables, TABLE_SIZE), one table id per tile — with narrow types: symbols
uint16, tables and output uint8.

A CUDA tensor launches ``csrc/marker_replace.cu`` or raises; a CPU tensor
takes ``marker_replace_tiles_multi_plain``. Out-of-range symbols and table
ids give 0 on both routes.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import TABLE_SIZE

TILE_ROWS = 8
TILE_COLS = 1024
TILE = TILE_ROWS * TILE_COLS

#: Launches of the CUDA kernel since the last reset; the plain version and
#: the checks before a launch do not count.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def marker_replace_tiles_multi_plain(
    syms: torch.Tensor, tables: torch.Tensor, tile_tables: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    n_tiles, n_tables = syms.shape[0], tables.shape[0]
    # torch cannot index with uint16: widen to int64 first.
    s = syms.reshape(n_tiles, -1).to(torch.int64)
    t = tile_tables.to(torch.int64)
    ok = ((t >= 0) & (t < n_tables))[:, None] & (s < TABLE_SIZE)
    idx = t.clamp(0, n_tables - 1)[:, None] * TABLE_SIZE + s.clamp(max=TABLE_SIZE - 1)
    out = torch.where(ok, tables.reshape(-1)[idx], 0)
    return out.to(torch.uint8).reshape(syms.shape)


def _check(syms, tables, tile_tables) -> None:
    if syms.dim() != 3 or tuple(syms.shape[1:]) != (TILE_ROWS, TILE_COLS):
        raise ValueError("syms must be (n_tiles, %d, %d), got %s"
                         % (TILE_ROWS, TILE_COLS, tuple(syms.shape)))
    if tables.dim() != 2 or tables.shape[1] != TABLE_SIZE or tables.shape[0] < 1:
        raise ValueError("tables must be (n_tables >= 1, %d), got %s"
                         % (TABLE_SIZE, tuple(tables.shape)))
    if tile_tables is not None and tuple(tile_tables.shape) != (syms.shape[0],):
        raise ValueError("tile_tables must be (n_tiles,), got %s" % (tuple(tile_tables.shape),))
    for name, t, dtype in (("syms", syms, torch.uint16), ("tables", tables, torch.uint8),
                           ("tile_tables", tile_tables, torch.int32)):
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
        if t.device != syms.device:
            raise ValueError("%s is on %s, syms on %s" % (name, t.device, syms.device))


def _launch(syms, tables, tile_tables) -> torch.Tensor:
    """Launch the kernel; ``tile_tables`` None means every tile reads table 0
    (the kernel then skips the table-id load)."""
    global launches
    for name, t in (("syms", syms), ("tables", tables), ("tile_tables", tile_tables)):
        if t is not None and not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    if syms.data_ptr() % 16:
        raise ValueError("syms must be 16-byte aligned")
    fn = _build.entry("marker_replace", "marker_replace_launch",
                      [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = torch.empty(syms.shape, dtype=torch.uint8, device=syms.device)
    with torch.cuda.device(syms.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(syms.data_ptr(), tables.data_ptr(),
                None if tile_tables is None else tile_tables.data_ptr(), out.data_ptr(),
                syms.shape[0], tables.shape[0], stream)
    if rc != 0:
        raise RuntimeError("marker_replace kernel launch failed: cudaError %d" % rc)
    launches += 1
    return out


def marker_replace_tiles_multi(
    syms: torch.Tensor, tables: torch.Tensor, tile_tables: torch.Tensor
) -> torch.Tensor:
    """Gather-replace tiles drawn from many windows in one call.

    syms:        (n_tiles, 8, 1024) uint16
    tables:      (n_tables, TABLE_SIZE) uint8, one replacement table per window
    tile_tables: (n_tiles,) int32, the table of each tile
    returns (n_tiles, 8, 1024) uint8.
    """
    _check(syms, tables, tile_tables)
    if syms.is_cuda:
        return _launch(syms, tables, tile_tables)
    return marker_replace_tiles_multi_plain(syms, tables, tile_tables)


def marker_replace_tiles(syms: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out = table[syms]`` over (n_tiles, 8, 1024) uint16 tiles and one
    (TABLE_SIZE,) uint8 table: the kernel above with n_tables = 1."""
    tables = table.reshape(1, -1)
    _check(syms, tables, None)
    if syms.is_cuda:
        return _launch(syms, tables, None)
    tile_tables = torch.zeros(syms.shape[0], dtype=torch.int32, device=syms.device)
    return marker_replace_tiles_multi_plain(syms, tables, tile_tables)
