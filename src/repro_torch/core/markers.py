"""Stage-2 marker replacement and window propagation (paper §2.2 step 3).

The entire stage reduces to one gather through a 33 024-entry table:
``table = [0..255] ++ window`` and ``out[i] = table[sym[i]]`` — identity for
resolved literals, window lookup for markers. This formulation is shared
with the Pallas TPU kernel (``kernels/marker_replace.py``): the table fits
comfortably in VMEM and the gather streams at memory bandwidth.

Window *propagation* (computing the successor chunk's 32 KiB window) only
needs the replacement applied to the final 32 KiB of a chunk — the paper's
Amdahl mitigation: the sequential critical path per chunk is O(32 KiB),
while full-chunk replacement runs in parallel on the thread pool.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .deflate import MARKER_BASE, WINDOW_SIZE


def full_window(window: Optional[bytes]) -> np.ndarray:
    """Left-pad a (possibly short) window to exactly WINDOW_SIZE bytes."""
    arr = np.zeros(WINDOW_SIZE, dtype=np.uint8)
    if window:
        w = np.frombuffer(window, dtype=np.uint8)[-WINDOW_SIZE:]
        arr[WINDOW_SIZE - w.shape[0] :] = w
    return arr


def replacement_table(window: Optional[bytes]) -> np.ndarray:
    """256 identity entries followed by the 32 KiB window."""
    table = np.empty(MARKER_BASE + WINDOW_SIZE, dtype=np.uint8)
    table[:MARKER_BASE] = np.arange(MARKER_BASE, dtype=np.uint8)
    table[MARKER_BASE:] = full_window(window)
    return table


def replace_markers(symbols: np.ndarray, window: Optional[bytes]) -> np.ndarray:
    """Resolve a uint16 intermediate chunk into uint8 bytes."""
    if symbols.dtype == np.uint8:
        return symbols
    return replacement_table(window)[symbols]


def replace_markers_segment(
    symbols: np.ndarray, table: np.ndarray, start: int, end: int
) -> np.ndarray:
    """Resolve one chunk segment (unit of thread-pool parallelism)."""
    return table[symbols[start:end]]


def propagate_window(
    symbols: np.ndarray,
    prev_window: Optional[bytes],
    *,
    first_marker: int = 0,
    last_marker: Optional[int] = None,
) -> bytes:
    """Next chunk's window from this chunk's tail (sequential critical path).

    Only the final WINDOW_SIZE symbols are resolved; if the chunk is shorter
    than the window the previous window fills the gap.
    """
    n = symbols.shape[0]
    take = min(n, WINDOW_SIZE)
    tail = symbols[n - take :]
    if symbols.dtype == np.uint16:
        tail = replacement_table(prev_window)[tail]
    if take >= WINDOW_SIZE:
        return tail.tobytes()
    prev = full_window(prev_window)
    return np.concatenate([prev[take:], tail]).tobytes()
