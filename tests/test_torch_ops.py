"""repro_torch.kernels.ops and the precode kernel against the JAX package.

On the CPU the entry points run the kernels' plain versions
(``device="cpu"``); they are held, exact to the bit (tolerance 0: the
outputs are masks, offsets, bytes and CRCs), against ``repro.kernels`` with
its Pallas kernels in interpret mode, the jnp oracle, the host block finder,
the host marker path and zlib. The CUDA kernels are held against the plain
versions on the card in ``test_torch_cuda.py``.
"""

import gzip
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jk
from repro.core.markers import replace_markers
from repro.kernels.precode_check import precode_check_blocks as pallas_precode_blocks
from repro.kernels.ref import precode_check_ref
from repro_torch.core import BitReader, DeflateChunkDecoder, parse_gzip_header
from repro_torch.core.block_finder import scan_dynamic_candidates
from repro_torch.kernels import ops
from repro_torch.kernels import precode_check as tpc

from conftest import make_random, make_text

BLOCK, HALO = tpc.BLOCK, tpc.HALO
TABLE_SIZE = 256 + 32768


def rng_for(*key):
    return np.random.default_rng(list(key))


def plane(bits: np.ndarray, n_blocks: int) -> np.ndarray:
    """(n_blocks + 1, BLOCK) 0/1 plane: ``bits`` then zeros, the last row a
    sentinel."""
    out = np.zeros((n_blocks + 1) * BLOCK, np.uint8)
    out[: min(bits.shape[0], out.shape[0])] = bits[: out.shape[0]]
    return out.reshape(n_blocks + 1, BLOCK)


# ---------------------------------------------------------------------------
# the precode kernel's layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks", [1, 4])
def test_precode_blocks_match_pallas_and_ref(n_blocks):
    rng = rng_for(1, n_blocks)
    bits = rng.integers(0, 2, (n_blocks, BLOCK), dtype=np.uint8)
    # Plant headers that pass steps 1-3 so the Kraft step decides often.
    starts = rng.integers(0, n_blocks * BLOCK - 20, 64)
    flat = bits.reshape(-1)
    for i, s in enumerate(starts):
        flat[s : s + 3] = (0, 0, 1)
        flat[s + 3 : s + 8] = 0
        if i % 2:  # HCLEN 0 and four code lengths of 2: a complete precode
            flat[s + 13 : s + 17] = 0
            flat[s + 17 : s + 29] = (0, 1, 0) * 4
    planes = plane(flat, n_blocks)
    ours = tpc.precode_check_blocks(torch.from_numpy(planes))
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == (n_blocks, BLOCK)
    ours = ours.numpy()
    pallas = np.asarray(pallas_precode_blocks(jnp.asarray(planes.astype(np.int32)), interpret=True))
    np.testing.assert_array_equal(ours, pallas)
    whole = planes.reshape(-1).astype(np.int32)
    for blk in range(n_blocks):
        ref = np.asarray(precode_check_ref(jnp.asarray(whole[blk * BLOCK : blk * BLOCK + BLOCK + HALO])))
        np.testing.assert_array_equal(ours[blk], ref)
    assert ours.any()


@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "buffer_end"])
@pytest.mark.parametrize("n", [1, 2047, 2049, 5000])
@pytest.mark.parametrize("start_bit", [0, 3, 13])
def test_precode_packed_matches_blocks(start_bit, n, tight):
    """Unaligned starts and ragged counts; with ``tight`` the buffer ends at
    the last offset, so the last windows read past it (as zeros)."""
    rng = rng_for(2, start_bit, n, tight)
    nbytes = -(-(start_bit + n) // 8) + (0 if tight else 16)
    data = rng.integers(0, 256, nbytes, dtype=np.uint8)
    ours = tpc.precode_check_packed(torch.from_numpy(data), start_bit, n)
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == (n,)
    bits = np.unpackbits(data, bitorder="little")[start_bit:]
    n_blocks = -(-n // BLOCK)
    blocks = tpc.precode_check_blocks(torch.from_numpy(plane(bits, n_blocks)))
    np.testing.assert_array_equal(ours.numpy(), blocks.numpy().reshape(-1)[:n])


@pytest.mark.parametrize("make", [
    lambda: (torch.zeros((2, 8), dtype=torch.uint8), 0, 1),
    lambda: (torch.zeros(8, dtype=torch.int32), 0, 1),
    lambda: (torch.zeros(8, dtype=torch.uint8), 0, 65),
    lambda: (torch.zeros(8, dtype=torch.uint8), -1, 2),
], ids=["not_1d", "not_uint8", "past_end", "negative_start"])
def test_precode_packed_refuses_bad_input(make):
    data, start_bit, n = make()
    with pytest.raises((TypeError, ValueError)):
        tpc.precode_check_packed(data, start_bit, n)


def test_precode_blocks_refuses_bad_layout():
    with pytest.raises(ValueError):
        tpc.precode_check_blocks(torch.zeros((1, BLOCK), dtype=torch.uint8))
    with pytest.raises(TypeError):
        tpc.precode_check_blocks(torch.zeros((2, BLOCK), dtype=torch.int32))


def test_plain_version_batches_agree(monkeypatch):
    """The plain version's batching does not change the answer."""
    data = torch.from_numpy(rng_for(3).integers(0, 256, 3000, dtype=np.uint8))
    whole = tpc.precode_check_packed_plain(data, 5, 20_000)
    monkeypatch.setattr(tpc, "PLAIN_BATCH", 777)
    assert torch.equal(tpc.precode_check_packed_plain(data, 5, 20_000), whole)


#: A header that passes steps 1-4: final 0, type (0, 1), HLIT = HDIST =
#: HCLEN = 0, then four precode lengths of 2 (LSB first): 29 bits.
VALID_HEADER = [0, 0, 1] + [0] * 14 + [0, 1, 0] * 4
#: The kernel's extremes of the share of offsets passing steps 1-3: none
#: (zeros, ones), the most possible (every third offset: (0, 0, 1)
#: repeated, none completing the Kraft step) and a valid header every 29
#: bits.
STREAMS = {"zeros": [0], "ones": [1], "001": [0, 0, 1], "header29": VALID_HEADER}


def stream_bits(kind: str, nbits: int) -> np.ndarray:
    return np.resize(np.array(STREAMS[kind], np.uint8), nbits)


def steps_1_3(bits: np.ndarray, n: int) -> np.ndarray:
    """Offsets < n whose final bit, type bits and HLIT pass, on 0/1 bits."""
    hlit = sum(bits[3 + j : 3 + j + n].astype(np.int32) << j for j in range(5))
    return (bits[:n] == 0) & (bits[1 : 1 + n] == 0) & (bits[2 : 2 + n] == 1) & (hlit < 30)


@pytest.mark.parametrize("tight", [False, True], ids=["roomy", "buffer_end"])
@pytest.mark.parametrize("kind", list(STREAMS))
def test_precode_extreme_streams_match_pallas_and_ref(kind, tight):
    """The streams at the extremes of survivors per word, through the plain
    version, the Pallas kernel (interpret mode) and the jnp oracle. With
    ``tight`` the start is unaligned and the buffer ends at the last offset,
    so the last windows read zeros."""
    start_bit, n_blocks = (13, 2) if tight else (0, 2)
    n = n_blocks * BLOCK - (100 if tight else 0)
    bits = stream_bits(kind, start_bit + n + (0 if tight else BLOCK))
    data = np.packbits(bits, bitorder="little")
    ours = tpc.precode_check_packed_plain(torch.from_numpy(data), start_bit, n).numpy()
    assert ours.dtype == np.uint8 and ours.shape == (n,)
    # The offsets' view of the stream, with the zeros past the buffer.
    seen = np.zeros((n_blocks + 1) * BLOCK, np.uint8)
    tail = np.unpackbits(data, bitorder="little")[start_bit:][: seen.shape[0]]
    seen[: tail.shape[0]] = tail
    pallas = np.asarray(pallas_precode_blocks(
        jnp.asarray(seen.reshape(n_blocks + 1, BLOCK).astype(np.int32)), interpret=True))
    np.testing.assert_array_equal(ours, pallas.reshape(-1)[:n])
    ref = np.asarray(precode_check_ref(jnp.asarray(seen[: n + HALO].astype(np.int32))))
    np.testing.assert_array_equal(ours, ref)

    inside = n - HALO if tight else n  # offsets whose windows lie in the buffer
    survivors = steps_1_3(seen, inside)
    if kind in ("zeros", "ones"):
        assert not survivors.any() and not ours.any()
    elif kind == "001":
        # A third survive steps 1-3: every offset where the pattern starts.
        np.testing.assert_array_equal(np.flatnonzero(survivors),
                                      np.arange((-start_bit) % 3, inside, 3))
        assert not ours[:inside].any()
    else:
        assert 0.15 < survivors.mean() < 0.2
        np.testing.assert_array_equal(np.flatnonzero(ours[:inside]),
                                      np.arange((-start_bit) % 29, inside, 29))


# ---------------------------------------------------------------------------
# ops.precode_candidates
# ---------------------------------------------------------------------------

RANGES = [(1000, 0, None), (40_000, 0, None), (40_000, 13, 200_001)]
RANGE_IDS = ["1000B", "40000B", "40000B_unaligned"]


@pytest.mark.parametrize("nbytes,start,end", RANGES, ids=RANGE_IDS)
def test_precode_candidates_match_reference(nbytes, start, end):
    blob = make_random(rng_for(4, nbytes), nbytes)
    ours = ops.precode_candidates(blob, start, end, device="cpu")
    assert ours.dtype == np.int64
    np.testing.assert_array_equal(ours, jk.precode_candidates(blob, start, end))


@pytest.mark.parametrize("nbytes,start,end", RANGES, ids=RANGE_IDS)
def test_precode_candidates_match_host_finder(nbytes, start, end):
    blob = make_random(rng_for(5, nbytes), nbytes)
    stop = nbytes * 8 - HALO if end is None else end
    ours = ops.precode_candidates(blob, start, end, device="cpu").tolist()
    host = [c for c in scan_dynamic_candidates(blob, start, nbytes * 8, full_validation=False)
            if c < stop]
    assert ours == host


def test_precode_candidates_find_real_blocks():
    data = make_text(rng_for(6), 300_000)
    comp = gzip.compress(data, 6)
    br = BitReader(comp)
    parse_gzip_header(br)
    res = DeflateChunkDecoder(comp).decode_chunk(br.bit_pos, len(comp) * 8, window=b"")
    dynamic = [b.bit_offset for b in res.blocks if b.block_type == 2 and not b.is_final]
    assert dynamic
    cands = set(ops.precode_candidates(comp, device="cpu").tolist())
    assert all(b in cands for b in dynamic)


@pytest.mark.parametrize("blob,start,end", [
    (b"", 0, None),
    (b"\x04" * 5, 0, None),
    (b"\x04" * 9, 0, None),
    (bytes(range(100)), 500, 400),
    (bytes(range(100)), 300, 300),
], ids=["empty", "5B", "9B_shorter_than_halo", "start_after_end", "start_equals_end"])
def test_precode_candidates_empty_ranges(blob, start, end):
    ours = ops.precode_candidates(blob, start, end, device="cpu")
    assert ours.dtype == np.int64 and ours.shape == (0,)
    np.testing.assert_array_equal(ours, jk.precode_candidates(blob, start, end))


# ---------------------------------------------------------------------------
# ops.marker_replace and ops.crc32_parallel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window_len", [0, 300, 32768])
@pytest.mark.parametrize("n", [0, 1, 1000, 8192, 8209])
def test_marker_replace_matches_reference(n, window_len):
    rng = rng_for(7, n, window_len)
    window = rng.integers(0, 256, window_len, dtype=np.uint8).tobytes() or None
    syms = rng.integers(0, TABLE_SIZE, n, dtype=np.int64).astype(np.uint16)
    ours = ops.marker_replace(syms, window, device="cpu")
    assert ours.dtype == np.uint8 and ours.shape == (n,)
    np.testing.assert_array_equal(ours, replace_markers(syms, window))
    np.testing.assert_array_equal(ours, jk.marker_replace(syms, window))


@pytest.mark.parametrize("n", [0, 1, 1023, 4096, 100_001])
def test_crc32_parallel_matches_zlib_and_reference(n):
    blob = make_random(rng_for(8, n), n)
    ours = ops.crc32_parallel(blob, device="cpu")
    assert ours == zlib.crc32(blob) & 0xFFFFFFFF
    assert ours == jk.crc32_parallel(blob)


def test_empty_window_table_is_cached_per_device():
    table = ops.replacement_table_device(None, "cpu")
    assert ops.replacement_table_device(b"", "cpu") is table
    assert table.dtype == torch.uint8 and not table[256:].any()


# ---------------------------------------------------------------------------
# devices and the package surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: ops.precode_candidates(bytes(64)),
    lambda: ops.marker_replace(np.zeros(4, np.uint16), None),
    lambda: ops.crc32_parallel(b"abc"),
], ids=["precode_candidates", "marker_replace", "crc32_parallel"])
def test_cuda_default_raises_without_a_card(call):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        ops.crc32_parallel(b"abc", device="meta")


def test_package_exports_and_marker_module():
    import repro_torch.kernels as tk
    from repro_torch.kernels import marker_replace

    assert isinstance(marker_replace, types.ModuleType)
    assert hasattr(marker_replace, "marker_replace_tiles_multi")
    assert tk.crc32_parallel is ops.crc32_parallel
    assert tk.precode_candidates is ops.precode_candidates
