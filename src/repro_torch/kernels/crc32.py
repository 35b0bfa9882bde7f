"""Per-lane CRC-32 (paper §6 future work): hand kernel and plain version.

Counterpart of ``repro/kernels/crc32.py``. Each of the 8 x 128 lanes of a
request holds ``seg_len`` contiguous bytes (zero padded); the result is the
reflected CRC-32 of every lane, with the reference's int32 bit pattern.
Input bytes are uint8 where the reference took int32.

A CUDA tensor launches ``csrc/crc32.cu`` or raises; a CPU tensor takes
``crc32_segments_batched_plain``. The kernel splits each lane into 32
pieces and merges their registers on the device with GF(2) shift
operators, which ``combine_operators`` builds here on the host.

``crc32_fold_batched`` is the same launch, which also folds each request's
first ``full`` lane CRCs into the CRC of those bytes on the device, with
the operators of ``fold_operators`` (the reference's host merged lanes with
``core.crc32.combine_parts``, one ``crc32_combine`` a lane);
``crc32_fold_batched_plain`` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
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
#: A lane's shift in a fold, full - 1 - s lanes, has this many bits.
FOLD_LEVELS = 10
#: Requests in one folding launch (the kernel parameters' ``full`` array);
#: a larger batch takes one launch per slice.
MAX_FOLD_BATCH = 64

#: Launches of the CUDA kernel since the last reset; the plain version and
#: the checks before a launch do not count.
launches = 0
#: Of ``launches``, those of the folding form (``crc32_fold_batched``).
fold_launches = 0
#: Requests folded by ``crc32_fold_batched`` (kernel or plain version)
#: since the last reset.
folded_requests = 0


def reset_launches() -> None:
    global launches, fold_launches, folded_requests
    launches = 0
    fold_launches = 0
    folded_requests = 0


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


def _level_operators(nbytes: int, levels: int) -> Tuple[int, ...]:
    """The operators shifting by ``nbytes * 2**l`` bytes for ``l`` below
    ``levels``, 32 rows each, level by level."""
    op = shift_operator(nbytes)
    rows: List[int] = []
    for _ in range(levels):
        rows += op
        op = _gf2_matrix_square(op)
    return tuple(rows)


@functools.lru_cache(maxsize=64)
def combine_operators(seg_len: int) -> Tuple[int, ...]:
    """What the split kernel merges pieces with, for lanes of ``seg_len``
    bytes: the operators shifting by ``piece_len * 2**l`` bytes for
    ``l = 0..4`` (32 rows each, level by level), then
    ``shift_seg_len(0xFFFFFFFF)``, the init's share of the register."""
    return (_level_operators(4 * piece_words(seg_len), LEVELS)
            + (crc32_combine(0xFFFFFFFF, 0, seg_len),))


@functools.lru_cache(maxsize=64)
def _ops_buffer(seg_len: int):
    rows = combine_operators(seg_len)
    return (ctypes.c_uint32 * len(rows))(*rows)


@functools.lru_cache(maxsize=64)
def fold_operators(seg_len: int) -> Tuple[int, ...]:
    """What a fold shifts lane CRCs with, for lanes of ``seg_len`` bytes:
    the operators shifting by ``seg_len * 2**j`` bytes for ``j = 0..9``
    (32 rows each). Lane ``s`` of a request folded over ``full`` lanes is
    shifted by the product of those whose bit is set in ``full - 1 - s``."""
    return _level_operators(seg_len, FOLD_LEVELS)


@functools.lru_cache(maxsize=64)
def _fold_buffer(seg_len: int):
    """The fold's kernel parameters with every ``full`` 0."""
    return (ctypes.c_uint32 * (FOLD_LEVELS * 32 + MAX_FOLD_BATCH))(*fold_operators(seg_len))


@functools.lru_cache(maxsize=64)
def _fold_byte_tables(seg_len: int) -> torch.Tensor:
    """(FOLD_LEVELS, 4, 256) int64: entry [j, k, v] is operator j applied to
    byte v in register byte k, so an operator is four lookups and XORs."""
    rows = np.array(fold_operators(seg_len), np.int64).reshape(FOLD_LEVELS, 4, 1, 8)
    bits = (np.arange(256)[:, None] >> np.arange(8)) & 1  # (256, 8)
    return torch.from_numpy(np.bitwise_xor.reduce(rows * bits, axis=-1))


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


def _launch(data: torch.Tensor, table: torch.Tensor, out: torch.Tensor,
            folded: Optional[torch.Tensor] = None, full: Sequence[int] = ()) -> None:
    """One launch writing ``out``, and with ``folded`` each row's fold over
    its ``full`` (at most ``MAX_FOLD_BATCH`` rows)."""
    global launches, fold_launches
    if not (data.is_contiguous() and table.is_contiguous()):
        raise ValueError("data and table must be contiguous")
    if data.data_ptr() % 16:
        raise ValueError("data must be 16-byte aligned")
    fn = _build.entry("crc32", "crc32_launch",
                      [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
                      + [ctypes.c_void_p] * 4)
    seg_len = data.shape[3]
    words = piece_words(seg_len)
    ops = _ops_buffer(seg_len) if words else None
    fold = None
    if folded is not None:
        base = _fold_buffer(seg_len)
        fold = type(base).from_buffer_copy(base)
        fold[FOLD_LEVELS * 32 : FOLD_LEVELS * 32 + len(full)] = full
    n_lanes = data.shape[0] * N_SEGMENTS
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), table.data_ptr(), out.data_ptr(), n_lanes, seg_len, words,
                None if ops is None else ctypes.addressof(ops),
                None if folded is None else folded.data_ptr(),
                None if fold is None else ctypes.addressof(fold), stream)
    if rc != 0:
        raise RuntimeError("crc32 kernel launch failed: cudaError %d" % rc)
    launches += 1
    if folded is not None:
        fold_launches += 1


def crc32_segments_batched(data: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-lane CRC-32 for a batch of byte streams in one launch.

    data:  (B, 8, 128, seg_len) uint8, each row one request, lane-major
    table: (256,) int32 reflected CRC table (``ref.make_crc_table``)
    returns (B, 8, 128) int32.
    """
    _check(data, table)
    if data.is_cuda:
        out = torch.empty(data.shape[:3], dtype=torch.int32, device=data.device)
        _launch(data, table, out)
        return out
    return crc32_segments_batched_plain(data, table)


def crc32_fold_batched_plain(data: torch.Tensor, table: torch.Tensor,
                             full: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``crc32_fold_batched``, on any device: the
    lanes of ``crc32_segments_batched_plain``, then the kernel's fold with
    the same operators, vectorised over lanes."""
    lanes = crc32_segments_batched_plain(data, table)
    batch = lanes.shape[0]
    x = lanes.reshape(batch, N_SEGMENTS).to(torch.int64) & 0xFFFFFFFF
    fulls = torch.zeros(batch, dtype=torch.int64)
    fulls[: len(full)] = torch.tensor(list(full), dtype=torch.int64)
    shift = (fulls[:, None] - 1 - torch.arange(N_SEGMENTS)).to(x.device)  # lanes after s
    tables = _fold_byte_tables(data.shape[3]).to(x.device)
    for j in range(FOLD_LEVELS):
        t = tables[j]
        y = t[0][x & 0xFF] ^ t[1][(x >> 8) & 0xFF] ^ t[2][(x >> 16) & 0xFF] ^ t[3][x >> 24]
        x = torch.where((shift >> j) & 1 == 1, y, x)
    x = torch.where(shift >= 0, x, 0)
    bit = torch.arange(32, device=x.device)
    parity = ((x[..., None] >> bit) & 1).sum(dim=1) & 1  # (B, 32): XOR over lanes
    word = (parity << bit).sum(dim=-1)
    return lanes, torch.where(word >= 1 << 31, word - (1 << 32), word).to(torch.int32)


def crc32_fold_batched(data: torch.Tensor, table: torch.Tensor,
                       full: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``crc32_segments_batched`` that also folds each request's lanes.

    full: lanes to fold for each of the first ``len(full) <= B`` rows (0 to
    1024); the rows after them are bucket padding and fold nothing.
    returns (lanes, folded): lanes as ``crc32_segments_batched`` gives them,
    and (B,) int32, row b the CRC-32 of ``data[b]``'s first
    ``full[b] * seg_len`` bytes in lane order (0 where nothing is folded).
    Lanes at or past ``full[b]`` may hold anything.
    """
    global folded_requests
    _check(data, table)
    full = [int(f) for f in full]
    if len(full) > data.shape[0] or not all(0 <= f <= N_SEGMENTS for f in full):
        raise ValueError("full must give 0..%d lanes for at most %d rows, got %s"
                         % (N_SEGMENTS, data.shape[0], full))
    if data.is_cuda:
        lanes = torch.empty(data.shape[:3], dtype=torch.int32, device=data.device)
        folded = torch.empty(data.shape[:1], dtype=torch.int32, device=data.device)
        for b0 in range(0, data.shape[0], MAX_FOLD_BATCH):
            b1 = b0 + MAX_FOLD_BATCH
            _launch(data[b0:b1], table, lanes[b0:b1], folded[b0:b1], full[b0:b1])
    else:
        lanes, folded = crc32_fold_batched_plain(data, table, full)
    folded_requests += len(full)
    return lanes, folded


def crc32_segments(data: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(8, 128, seg_len) uint8 -> (8, 128) int32: the batched kernel with
    B = 1."""
    return crc32_segments_batched(data[None], table)[0]
