"""Dynamic-block precheck of the block finder (paper §3.4.2, steps 1-4): hand
kernel and plain version.

Counterpart of ``repro/kernels/precode_check.py``. At every bit offset of an
LSB-first stream, 1 if the deflate header read there has final bit 0, block
type bits (0, 1), HLIT < 30 and a precode whose HCLEN + 4 code lengths fill
the Kraft sum exactly; offsets that pass are confirmed by the strict host
parse (steps 5-7). Each offset reads ``HALO`` = 74 bits; bits past the end of
the buffer read as zero, as the reference's zero sentinel row does.

The reference took an int32 bit plane; ``precode_check_packed`` takes the
bytes themselves (uint8) and returns one uint8 per offset.
``precode_check_blocks`` keeps the reference's (n_blocks + 1, BLOCK) layout
as a uint8 0/1 plane.

A CUDA tensor launches ``csrc/precode_check.cu`` or raises; a CPU tensor
takes ``precode_check_packed_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: bits of header probed beyond an offset: 17 header bits + 19 * 3 precode bits
HALO = 74
#: offsets per block of the reference's bit-plane layout
BLOCK = 2048
#: offsets the plain version evaluates at once (bounds its scratch memory)
PLAIN_BATCH = 1 << 24

#: Launches of the CUDA kernel since the last reset; the plain version and
#: the checks before a launch do not count.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _plain_batch(data: torch.Tensor, bit: int, n: int) -> torch.Tensor:
    """The cascade over offsets ``bit .. bit + n`` of ``data``."""
    byte0 = bit // 8
    rel = bit - byte0 * 8
    need = -(-(rel + n + HALO) // 8)
    raw = torch.zeros(need, dtype=torch.int32, device=data.device)
    avail = max(0, min(need, data.numel() - byte0))
    raw[:avail] = data[byte0 : byte0 + avail].to(torch.int32)
    shifts = torch.arange(8, dtype=torch.int32, device=data.device)
    bits = ((raw[:, None] >> shifts) & 1).reshape(-1)[rel:]

    def field(at: int, width: int) -> torch.Tensor:
        out = bits[at : at + n].clone()
        for j in range(1, width):
            out |= bits[at + j : at + j + n] << j
        return out

    ok = (bits[:n] == 0) & (bits[1 : 1 + n] == 0) & (bits[2 : 2 + n] == 1)
    ok &= field(3, 5) < 30
    n_codes = field(13, 4) + 4
    kraft = torch.zeros(n, dtype=torch.int32, device=data.device)
    for k in range(19):
        cl = field(17 + 3 * k, 3)
        active = (n_codes > k) & (cl > 0)
        kraft += torch.where(active, 128 >> cl, 0)
    ok &= kraft == 128
    return ok.to(torch.uint8)


def precode_check_packed_plain(data: torch.Tensor, start_bit: int, n: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the reference's
    vectorised cascade (``repro/kernels/ref.py::precode_check_ref``) over
    bits unpacked with shifts, ``PLAIN_BATCH`` offsets at a time."""
    out = torch.empty(n, dtype=torch.uint8, device=data.device)
    for i in range(0, n, PLAIN_BATCH):
        m = min(PLAIN_BATCH, n - i)
        out[i : i + m] = _plain_batch(data, start_bit + i, m)
    return out


def _check(data: torch.Tensor, start_bit: int, n: int) -> None:
    if data.dim() != 1:
        raise ValueError("data must be 1-D, got %s" % (tuple(data.shape),))
    if data.dtype != torch.uint8:
        raise TypeError("data must be uint8, got %s" % data.dtype)
    if start_bit < 0 or n < 0 or start_bit + n > 8 * data.numel():
        raise ValueError("offsets [%d, %d) are not within the %d bits of data"
                         % (start_bit, start_bit + n, 8 * data.numel()))


def _launch(data: torch.Tensor, start_bit: int, n: int) -> torch.Tensor:
    global launches
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    fn = _build.entry("precode_check", "precode_check_launch",
                      [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p])
    out = torch.empty(n, dtype=torch.uint8, device=data.device)  # allocations are 256-B aligned
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(data.data_ptr(), data.numel(), start_bit, n, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("precode_check kernel launch failed: cudaError %d" % rc)
    launches += 1
    return out


def precode_check_packed(data: torch.Tensor, start_bit: int, n: int) -> torch.Tensor:
    """Candidate mask of offsets ``start_bit .. start_bit + n`` of ``data``.

    data: (n_bytes,) uint8, the stream LSB first; the offsets must lie in it,
          their 74-bit windows may run past its end (read as zero)
    returns (n,) uint8, 1 = candidate for steps 5-7.
    """
    start_bit, n = int(start_bit), int(n)
    _check(data, start_bit, n)
    if data.is_cuda:
        return _launch(data, start_bit, n)
    return precode_check_packed_plain(data, start_bit, n)


def precode_check_blocks(bits: torch.Tensor) -> torch.Tensor:
    """The reference's layout: (n_blocks + 1, BLOCK) uint8 0/1 bit plane, the
    last row the halo of the last block (a zero sentinel) -> (n_blocks,
    BLOCK) uint8 mask. The plane is packed 8 bits to a byte on its own
    device."""
    if bits.dim() != 2 or bits.shape[1] != BLOCK or bits.shape[0] < 2:
        raise ValueError("bits must be (n_blocks + 1, %d), got %s" % (BLOCK, tuple(bits.shape)))
    if bits.dtype != torch.uint8:
        raise TypeError("bits must be uint8, got %s" % bits.dtype)
    weights = torch.tensor([1 << j for j in range(8)], dtype=torch.uint8, device=bits.device)
    packed = (bits.reshape(-1, 8) * weights).sum(dim=1, dtype=torch.uint8)
    n_blocks = bits.shape[0] - 1
    return precode_check_packed(packed, 0, n_blocks * BLOCK).reshape(n_blocks, BLOCK)
