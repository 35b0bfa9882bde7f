"""Per-lane CRC-32 (paper §6 future work): hand kernel and plain version.

Counterpart of ``repro/kernels/crc32.py``. Each of the 8 x 128 lanes of a
request holds ``seg_len`` contiguous bytes (zero padded); the result is the
reflected CRC-32 of every lane, with the reference's int32 bit pattern. The
host merges lanes with ``core.crc32.combine_parts``. Input bytes are uint8
where the reference took int32.

A CUDA tensor launches ``csrc/crc32.cu`` or raises; a CPU tensor takes
``crc32_segments_batched_plain``. The kernel splits each lane into 32
pieces and merges their registers on the device with GF(2) shift
operators, which ``combine_operators`` builds here on the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from . import _build
from ..core.crc32 import _POLY, _gf2_matrix_square, _gf2_matrix_times, crc32_combine

SEG_ROWS = 8
SEG_COLS = 128
N_SEGMENTS = SEG_ROWS * SEG_COLS

#: Shortest lane the kernel splits into 32 pieces (a word each); shorter
#: lanes are walked by one thread each (see csrc/crc32.cu for why 128).
SPLIT_MIN_SEG_LEN = 128
PIECES = 32
LEVELS = 5  # pairwise merges of 32 pieces

#: Launches of the CUDA kernel since the last reset; the plain version and
#: the checks before a launch do not count.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def crc32_segments_batched_plain(data: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    uint32 support on the CPU is thin, so the state runs in int64 masked to
    32 bits and is cast to the int32 bit pattern at the end.
    """
    lut = table.to(torch.int64) & 0xFFFFFFFF
    steps = data.movedim(-1, 0)
    crc = torch.full(data.shape[:-1], 0xFFFFFFFF, dtype=torch.int64, device=data.device)
    for i in range(steps.shape[0]):
        crc = (crc >> 8) ^ lut[(crc ^ steps[i].to(torch.int64)) & 0xFF]
    crc = crc ^ 0xFFFFFFFF
    return torch.where(crc >= 1 << 31, crc - (1 << 32), crc).to(torch.int32)


def shift_operator(nbytes: int) -> List[int]:
    """The GF(2) matrix that feeds ``nbytes`` zero bytes through a reflected
    CRC-32 register: row ``b`` is the image of register bit ``b``, so
    ``reg(A + B) == apply(shift_operator(len(B)), reg(A)) ^ reg(B)``
    (zlib's ``crc32_combine``)."""
    bit = [_POLY] + [1 << (i - 1) for i in range(1, 32)]  # one zero bit
    op = _gf2_matrix_square(_gf2_matrix_square(_gf2_matrix_square(bit)))  # one zero byte
    out = [1 << i for i in range(32)]
    while nbytes:
        if nbytes & 1:
            out = [_gf2_matrix_times(op, row) for row in out]
        nbytes >>= 1
        if nbytes:
            op = _gf2_matrix_square(op)
    return out


def piece_words(seg_len: int) -> int:
    """Words (4 bytes) in each of a lane's 32 pieces; 0 below
    ``SPLIT_MIN_SEG_LEN``, where the kernel walks a lane with one thread."""
    return 0 if seg_len < SPLIT_MIN_SEG_LEN else -(-seg_len // (4 * PIECES))


@functools.lru_cache(maxsize=64)
def combine_operators(seg_len: int) -> Tuple[int, ...]:
    """What the split kernel merges pieces with, for lanes of ``seg_len``
    bytes: the operators shifting by ``piece_len * 2**l`` bytes for
    ``l = 0..4`` (32 rows each, level by level), then
    ``shift_seg_len(0xFFFFFFFF)``, the init's share of the register."""
    piece_len = 4 * piece_words(seg_len)
    op = shift_operator(piece_len)
    rows: List[int] = []
    for _ in range(LEVELS):
        rows += op
        op = _gf2_matrix_square(op)
    return tuple(rows) + (crc32_combine(0xFFFFFFFF, 0, seg_len),)


@functools.lru_cache(maxsize=64)
def _ops_buffer(seg_len: int):
    rows = combine_operators(seg_len)
    return (ctypes.c_uint32 * len(rows))(*rows)


def _check(data: torch.Tensor, table: torch.Tensor) -> None:
    if data.dim() != 4 or tuple(data.shape[1:3]) != (SEG_ROWS, SEG_COLS):
        raise ValueError("data must be (B, %d, %d, seg_len), got %s"
                         % (SEG_ROWS, SEG_COLS, tuple(data.shape)))
    if data.dtype != torch.uint8:
        raise TypeError("data must be uint8, got %s" % data.dtype)
    if tuple(table.shape) != (256,) or table.dtype != torch.int32:
        raise ValueError("table must be (256,) int32, got %s %s" % (tuple(table.shape), table.dtype))
    if table.device != data.device:
        raise ValueError("table is on %s, data on %s" % (table.device, data.device))


def _launch(data: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    global launches
    if not (data.is_contiguous() and table.is_contiguous()):
        raise ValueError("data and table must be contiguous")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    fn = _build.entry("crc32", "crc32_launch",
                      [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_void_p, ctypes.c_void_p])
    seg_len = data.shape[3]
    words = piece_words(seg_len)
    ops = _ops_buffer(seg_len) if words else None
    out = torch.empty(data.shape[:3], dtype=torch.int32, device=data.device)
    n_lanes = data.shape[0] * N_SEGMENTS
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), table.data_ptr(), out.data_ptr(), n_lanes, seg_len, words,
                None if ops is None else ctypes.addressof(ops), stream)
    if rc != 0:
        raise RuntimeError("crc32 kernel launch failed: cudaError %d" % rc)
    launches += 1
    return out


def crc32_segments_batched(data: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-lane CRC-32 for a batch of byte streams in one launch.

    data:  (B, 8, 128, seg_len) uint8, each row one request, lane-major
    table: (256,) int32 reflected CRC table (``ref.make_crc_table``)
    returns (B, 8, 128) int32.
    """
    _check(data, table)
    if data.is_cuda:
        return _launch(data, table)
    return crc32_segments_batched_plain(data, table)


def crc32_segments(data: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(8, 128, seg_len) uint8 -> (8, 128) int32: the batched kernel with
    B = 1."""
    return crc32_segments_batched(data[None], table)[0]
