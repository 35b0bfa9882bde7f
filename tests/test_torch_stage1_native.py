"""The port's compiled stage-1 decoder against the reference's Python one.

``repro_torch.core.deflate`` decodes deflate blocks in host C++
(``kernels/csrc/inflate.cpp``, built by the host compiler at first use);
``repro.core.deflate`` is the oracle. Every case runs both on the same
input and compares every field of the result (symbols and their dtype,
block boundaries, end bit, marker bounds, member ends and starts, the
end-of-stream flag) or, where the reference raises, the exception's type
and message. Inputs are small: the reference decodes about 0.5 MB/s.
"""

import base64
import ctypes
import functools
import itertools
import os
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import block_finder as ref_finder
from repro.core import deflate as ref_deflate
from repro.core.bitreader import BitReader as RefBitReader
from repro.core.block_finder import CombinedBlockFinder as RefFinder
from repro.core.block_finder import FilterStats as RefFilterStats
from repro.core.block_finder import scan_dynamic_candidates as ref_scan
from repro.core.synth import (
    bgzf_compress,
    fixed_only_compress,
    gzip_compress,
    multistream_gzip,
    pigz_like_compress,
    stored_only_compress,
)
from repro_torch import _native
from repro_torch.core import block_finder as port_finder
from repro_torch.core import deflate as port_deflate
from repro_torch.core.bitreader import BitReader as PortBitReader
from repro_torch.core.block_finder import CombinedBlockFinder as PortFinder
from repro_torch.core.block_finder import FilterStats as PortFilterStats
from repro_torch.core.block_finder import scan_dynamic_candidates as port_scan
from repro_torch.kernels import _build

from conftest import make_random, make_text

WINDOW = 32768


def make_b64_lines(rng, n):
    """The read cell's kind of text: base64 of random bytes, 76-column lines."""
    return base64.encodebytes(rng.integers(0, 256, (n * 3) // 4, dtype=np.uint8).tobytes())[:n]


CORPORA = {"text": make_text, "b64-lines": make_b64_lines, "random": make_random}

# Every producer of core/synth.py, cut to small sizes so members, sync
# flushes and BGZF blocks still repeat inside a few tens of KiB.
PRODUCERS = {
    "gzip-1": lambda d: gzip_compress(d, 1),
    "gzip-6": lambda d: gzip_compress(d, 6),
    "gzip-9": lambda d: gzip_compress(d, 9),
    "pigz-like-6": lambda d: pigz_like_compress(d, 6, block_size=12 << 10),
    "multistream-6": lambda d: multistream_gzip(d, 6, stream_size=20 << 10),
    "bgzf-6": lambda d: bgzf_compress(d, 6, block_size=16 << 10),
    "bgzf-0": lambda d: bgzf_compress(d, 0, block_size=16 << 10),
    "fixed-only-6": lambda d: fixed_only_compress(d, 6),
    "stored-only": stored_only_compress,
}


def _rng(*key):
    return np.random.default_rng([zlib.crc32(repr(key).encode())])


def corpus(kind, n, *key):
    return CORPORA[kind](_rng(kind, n, *key), n)


def outcome(module, data, start_bit, stop_bit=None, *, framing="gzip", **kw):
    """The decode's every field, or the exception's type name and message."""
    try:
        res = module.DeflateChunkDecoder(data, framing=framing).decode_chunk(start_bit, stop_bit, **kw)
    except Exception as exc:  # compared by type name: the packages' classes differ
        return ("raised", type(exc).__name__, str(exc))
    return (
        "ok",
        res.data.dtype.str,
        res.data.tobytes(),
        res.marker_mode,
        res.start_bit,
        res.end_bit,
        [(b.bit_offset, b.out_offset, b.block_type, b.is_final) for b in res.blocks],
        [(m.out_offset, m.crc32, m.isize, m.footer_end_bit) for m in res.member_ends],
        [(m.header_start_bit, m.deflate_start_bit, m.out_offset) for m in res.member_starts],
        res.ended_at_eos,
        res.first_marker,
        res.last_marker,
    )


def same(data, start_bit, stop_bit=None, **kw):
    want = outcome(ref_deflate, data, start_bit, stop_bit, **kw)
    got = outcome(port_deflate, data, start_bit, stop_bit, **kw)
    if want != got:  # a short diff instead of two megabytes of symbols
        assert want[:1] == got[:1], (want[:3], got[:3])
        for i, (w, g) in enumerate(zip(want, got)):
            assert w == g, "field %d differs" % i
    return want


def _header_bits(comp):
    br = RefBitReader(comp)
    ref_deflate.parse_gzip_header(br)
    return br.bit_pos


def full_decode(comp, framing="gzip"):
    start = 0 if framing == "raw" else _header_bits(comp)
    return ref_deflate.DeflateChunkDecoder(comp, framing=framing).decode_chunk(start, None, window=b"")


def spread(items, k):
    """At most ``k`` items spread over ``items``, first and last included."""
    if len(items) <= k:
        return list(items)
    idx = np.linspace(0, len(items) - 1, k).round().astype(int)
    return [items[i] for i in sorted(set(idx))]


# ---------------------------------------------------------------------------
# Whole streams, every producer and corpus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CORPORA))
@pytest.mark.parametrize("producer", sorted(PRODUCERS))
def test_whole_stream_known_window(producer, kind):
    data = corpus(kind, 40_000, producer)
    comp = PRODUCERS[producer](data)
    res = same(comp, _header_bits(comp), window=b"")
    assert res[0] == "ok" and res[2] == data


@pytest.mark.parametrize("producer", sorted(PRODUCERS))
def test_whole_stream_marker_mode(producer):
    """From the first block with the window unknown: no marker can appear,
    the symbols widen to uint16."""
    data = corpus("b64-lines", 40_000, producer)
    comp = PRODUCERS[producer](data)
    res = same(comp, _header_bits(comp), window=None)
    assert res[0] == "ok" and res[1] == np.dtype(np.uint16).str and res[10] == -1


# ---------------------------------------------------------------------------
# From every block boundary: marker mode, and window mode with the true window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["marker", "window"])
@pytest.mark.parametrize("producer", sorted(PRODUCERS))
def test_from_every_block_boundary(producer, mode):
    data = corpus("b64-lines", 80_000, producer, "blocks")
    comp = PRODUCERS[producer](data)
    full = full_decode(comp)
    bounds = [(b.bit_offset, b.out_offset) for b in full.blocks]
    assert len(bounds) >= 2, "the case needs several blocks"
    # Members restart the output: map each block to its place in ``data``.
    member_base = [0] + [m.out_offset for m in full.member_ends]
    for bit, out_off in spread(bounds, 8):
        if mode == "marker":
            same(comp, bit, bit + (24 << 13), window=None)
        else:
            base = max(b for b in member_base if b <= out_off)
            window = data[max(base, out_off - WINDOW) : out_off]
            res = same(comp, bit, bit + (24 << 13), window=window)
            assert res[0] == "ok" and data[out_off:].startswith(res[2])


def test_markers_name_the_unknown_window():
    data = corpus("b64-lines", 80_000, "markers")
    comp = gzip_compress(data, 6)
    blk = full_decode(comp).blocks[2]
    res = same(comp, blk.bit_offset, window=None)
    syms = np.frombuffer(res[2], dtype=np.uint16)
    assert res[10] >= 0 and res[11] >= res[10] and (syms >= 256).any()


# ---------------------------------------------------------------------------
# Raw framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_raw_framing(level):
    data = corpus("text", 60_000, "raw", level)
    comp = zlib.compress(data, level)[2:-4]
    res = same(comp, 0, window=b"", framing="raw")
    assert res[0] == "ok" and res[2] == data and res[9]
    for b in spread(full_decode(comp, "raw").blocks[1:], 3):
        same(comp, b.bit_offset, window=None, framing="raw")
    assert port_deflate.inflate_raw(comp) == data


# ---------------------------------------------------------------------------
# Stop bits: chunk boundaries, stored blocks' canonical offsets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("producer", ["gzip-6", "pigz-like-6", "stored-only", "bgzf-6", "multistream-6",
                                      "fixed-only-6"])
def test_stop_bits_near_block_starts(producer):
    """Stops a few bits before, at and after every later block's start and
    its canonical offset: where the rule stops, and where it decodes on."""
    data = corpus("b64-lines", 40_000, producer, "stops")
    comp = PRODUCERS[producer](data)
    blocks = full_decode(comp).blocks
    start = blocks[0].bit_offset
    stops = set()
    for b in spread(blocks[1:], 6):
        canon = ref_deflate.canonical_stored_offset(b.bit_offset)
        for d in (-8, -7, -1, 0, 1, 7, 8):
            stops.update((b.bit_offset + d, canon + d))
    for stop in sorted(stops):
        same(comp, start, stop, window=b"")


@pytest.mark.parametrize("chunk_kib", [4, 7, 16])
@pytest.mark.parametrize("producer", ["gzip-6", "pigz-like-6", "stored-only"])
def test_nominal_chunk_split(producer, chunk_kib):
    """The first pass's split: each chunk from its first true block to its
    nominal end, in marker mode, as the fetcher asks."""
    data = corpus("b64-lines", 48_000, producer, "chunks")
    comp = PRODUCERS[producer](data)
    blocks = full_decode(comp).blocks
    chunk_bits = chunk_kib << 13
    for k in range(len(comp) * 8 // chunk_bits):
        lo, hi = k * chunk_bits, (k + 1) * chunk_bits
        inside = [b.bit_offset for b in blocks if lo <= b.bit_offset < hi]
        if inside:
            same(comp, inside[0], hi, window=None, max_out=4 * (chunk_kib << 10) * 8)


# ---------------------------------------------------------------------------
# Capacity: regrowth mid-block, max_out
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [0, 1, 1023, 1024, 1025, 3000, 1 << 14, 1 << 20])
@pytest.mark.parametrize("producer", ["gzip-6", "stored-only", "fixed-only-6"])
def test_small_initial_capacity_regrows(producer, capacity):
    data = corpus("text", 40_000, producer, "capacity")
    comp = PRODUCERS[producer](data)
    before = port_deflate.stats()
    res = same(comp, _header_bits(comp), window=b"", initial_capacity=capacity)
    after = port_deflate.stats()
    assert res[0] == "ok" and res[2] == data
    if max(capacity, 1024) < len(data):
        assert after["regrowths"] > before["regrowths"]


@pytest.mark.parametrize("capacity", [1, 1500, 5000])
def test_regrowth_in_marker_mode_from_mid_stream(capacity):
    """A block that overflows is decoded again from its start: its marker
    bounds too."""
    data = corpus("b64-lines", 80_000, "marker-regrowth")
    comp = gzip_compress(data, 6)
    for b in full_decode(comp).blocks[1:4]:
        res = same(comp, b.bit_offset, window=None, initial_capacity=capacity)
        assert res[10] >= 0


@pytest.mark.parametrize("marker_mode", [True, False])
def test_call_never_writes_past_capacity(marker_mode):
    """The compiled call's own contract: it returns at a block it cannot
    fit, without writing a symbol past the capacity it was given."""
    data = corpus("text", 30_000, "guard")
    comp = pigz_like_compress(data, 6, block_size=4 << 10) + stored_only_compress(data)
    src = np.frombuffer(comp, dtype=np.uint8)
    dtype = np.uint16 if marker_mode else np.uint8
    sentinel = np.iinfo(dtype).max
    records = np.empty((4, 4), dtype=np.int64)
    for cap in (1, 700, 4096, 9000):
        buf = np.full(cap + 300_000, sentinel, dtype=dtype)
        state = np.array([80, 0, -1, -1, 0, 0, 0, 0], dtype=np.int64)
        fulls = 0
        while True:
            status = port_deflate._inflate(src, state, len(comp) * 8, buf[:cap], marker_mode,
                                           port_deflate._NO_WINDOW, records)
            assert (buf[cap:] == sentinel).all(), cap
            if status == port_deflate._FULL:
                assert state[port_deflate._INFO] > cap
                fulls += 1
                cap = int(state[port_deflate._INFO])
            elif status != port_deflate._BLOCKS_FULL:
                break
        assert status == port_deflate._FINAL and fulls >= 1
        assert buf[: state[port_deflate._OUT_LEN]].astype(np.uint8).tobytes() == data


def test_regrowth_restores_marker_bounds():
    """A block with internal copies, then a window reference, then copies
    past the first buffer: decoded again, its first marker stays where the
    window reference is."""
    lit_a, len3, len258 = (0x30 + 97, 8), (1, 7), (0xC5, 8)
    w = BitWriter().put(1, 1).put(1, 2).code(*lit_a).code(*len258).code(0, 5)
    w.code(*len3).code(21, 5).put(2000 - 1537, 9)
    for _ in range(3):
        w.code(*len258).code(0, 5)
    w.code(0, 7)
    blob = w.tobytes(pad=2)
    res = same(blob, 0, window=None, framing="raw", initial_capacity=1)
    assert res[10] == 259 and res[0] == "ok"


@pytest.mark.parametrize("marker_mode", [True, False])
def test_every_capacity_one_call(marker_mode):
    """One call at every capacity up to the stream's output: it returns
    full or done, and writes nothing past the capacity."""
    data = corpus("text", 1500, "every-cap")
    comp = gzip_compress(data, 9) + gzip_compress(data[:40], 0)
    src = np.frombuffer(comp, dtype=np.uint8)
    dtype = np.uint16 if marker_mode else np.uint8
    records = np.empty((4, 4), dtype=np.int64)
    buf = np.empty(len(data) + 64, dtype=dtype)
    for cap in range(0, len(data) + 1):
        buf[cap:] = 7
        state = np.array([80, 0, -1, -1, 0, 0, 0, 0], dtype=np.int64)
        status = port_deflate._inflate(src, state, len(comp) * 8, buf[:cap], marker_mode,
                                       port_deflate._NO_WINDOW, records)
        assert (buf[cap:] == 7).all(), cap
        assert status == (port_deflate._FINAL if cap >= len(data) else port_deflate._FULL), cap


@pytest.mark.parametrize("capacity", [1 << 17, 1500])
@pytest.mark.parametrize("mode", ["window", "marker", "stop"])
def test_more_blocks_than_one_calls_records(mode, capacity):
    """Sync flushes every 128 bytes: more blocks before the member's end
    than one call's records hold, so the call returns with its records full
    (between regrowths too, at the small capacity) and ``decode_chunk``
    calls again from the next block."""
    data = corpus("b64-lines", 60_000, "many-blocks")
    comp = pigz_like_compress(data, 6, block_size=128)
    blocks = full_decode(comp).blocks
    assert len(blocks) > 2 * port_deflate._RECORDS_PER_CALL
    before = port_deflate.stats()
    if mode == "window":
        res = same(comp, _header_bits(comp), window=b"", initial_capacity=capacity)
        assert res[0] == "ok" and res[2] == data
    elif mode == "marker":
        res = same(comp, blocks[3].bit_offset, window=None, initial_capacity=capacity)
        assert res[0] == "ok" and len(res[6]) == len(blocks) - 3
    else:
        stop = blocks[len(blocks) * 3 // 4].bit_offset - 1
        res = same(comp, blocks[1].bit_offset, stop, window=None, initial_capacity=capacity)
        assert res[0] == "ok" and len(res[6]) > 2 * port_deflate._RECORDS_PER_CALL
    calls = port_deflate.stats()["calls"] - before["calls"]
    assert calls > len(res[6]) // port_deflate._RECORDS_PER_CALL


@pytest.mark.parametrize("capacity", [1 << 17, 3000])
@pytest.mark.parametrize("producer", ["gzip-6", "pigz-like-6", "multistream-6", "stored-only",
                                      "fixed-only-6", "bgzf-6"])
def test_one_record_per_call(producer, capacity, monkeypatch):
    """The records buffer cut to one: after every block a call returns
    with it full, at every kind of block, between regrowths and across
    members."""
    monkeypatch.setattr(port_deflate, "_RECORDS_PER_CALL", 1)
    data = corpus("b64-lines", 40_000, producer, "one-record")
    comp = PRODUCERS[producer](data)
    blocks = full_decode(comp).blocks
    assert len(blocks) >= 2
    before = port_deflate.stats()
    res = same(comp, _header_bits(comp), window=b"", initial_capacity=capacity)
    assert res[0] == "ok" and res[2] == data
    assert port_deflate.stats()["calls"] - before["calls"] >= len(blocks)
    for b in spread(blocks[1:], 4):
        same(comp, b.bit_offset, b.bit_offset + (12 << 13), window=None, initial_capacity=capacity)


@pytest.mark.parametrize("max_out", [0, 1, 1023, 1024, 1025, 2047, 2048, 2049, 5000, 39_999, 40_000, 40_001])
@pytest.mark.parametrize("capacity", [1, 1500])
def test_max_out(max_out, capacity):
    """max_out is checked where the buffer must grow, as the reference does:
    the same overflow raises, and output up to the buffer is allowed."""
    data = corpus("text", 40_000, "max_out")
    comp = gzip_compress(data, 6)
    same(comp, _header_bits(comp), window=b"", max_out=max_out, initial_capacity=capacity)
    same(comp, _header_bits(comp), window=None, max_out=max_out, initial_capacity=capacity)


# ---------------------------------------------------------------------------
# Corrupt and truncated streams, false starts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(24))
def test_corrupt_stream_same_error(seed):
    rng = _rng("corrupt", seed)
    data = corpus(["text", "b64-lines", "random"][seed % 3], 12_000, "corrupt", seed)
    comp = bytearray([gzip_compress, fixed_only_compress, stored_only_compress][seed % 3 if seed % 4 else 0](data))
    for _ in range(1 + seed % 3):
        pos = int(rng.integers(10, len(comp) - 8))
        comp[pos] ^= 1 << int(rng.integers(0, 8))
    comp = bytes(comp)
    same(comp, 80, window=b"")
    same(comp, 80, window=None)


@pytest.mark.parametrize("producer", ["gzip-6", "fixed-only-6", "stored-only", "multistream-6"])
def test_truncated_stream_same_error(producer):
    data = corpus("b64-lines", 30_000, producer, "truncated")
    comp = PRODUCERS[producer](data)
    for cut in spread(list(range(11, len(comp))), 14) + [len(comp) - 4, len(comp) - 8, len(comp) - 9]:
        same(comp[:cut], 80, window=b"")


def test_false_starts_same_outcome():
    """From the finder's unvalidated candidates and from arbitrary bits of a
    stream, with the fetcher's max_out: the same decode or the same error."""
    data = corpus("b64-lines", 40_000, "false-starts")
    comp = gzip_compress(data, 6)
    total = len(comp) * 8
    cands = list(ref_scan(comp, 0, total, full_validation=False))
    offsets = spread(cands, 60) + [int(x) for x in _rng("false").integers(0, total, 60)]
    raised = 0
    for off in offsets:
        res = same(comp, off, off + (8 << 13), window=None, max_out=64 << 10)
        raised += res[0] == "raised"
    assert raised > 10


@settings(max_examples=60, deadline=None)
@given(blob=st.binary(min_size=0, max_size=400), start=st.integers(0, 64), marker=st.booleans())
def test_property_arbitrary_bytes(blob, start, marker):
    same(blob, start, window=None if marker else b"abc" * 20, framing="raw", initial_capacity=1)
    same(blob, start, window=None if marker else b"", max_out=2048)


@settings(max_examples=30, deadline=None)
@given(blob=st.binary(min_size=0, max_size=3000), level=st.integers(0, 9))
def test_property_roundtrip(blob, level):
    comp = gzip_compress(blob, level)
    assert same(comp, 80, window=b"")[2] == blob
    assert port_deflate.gzip_decompress_sequential(comp) == blob


# ---------------------------------------------------------------------------
# Crafted streams: every error of the block loop and the dynamic header
# ---------------------------------------------------------------------------


class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value, n):
        self.bits += [(value >> i) & 1 for i in range(n)]
        return self

    def code(self, code, n):
        """A Huffman code, most significant bit first."""
        self.bits += [(code >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def align(self):
        self.bits += [0] * (-len(self.bits) % 8)
        return self

    def raw(self, data):
        self.align()
        for byte in data:
            self.put(byte, 8)
        return self

    def tobytes(self, pad=0):
        bits = self.bits + [0] * (-len(self.bits) % 8)
        out = bytes(int("".join(map(str, bits[i : i + 8][::-1])), 2) for i in range(0, len(bits), 8))
        return out + bytes(pad)


def canonical(lengths):
    """symbol -> (code, length) of the canonical code for ``lengths``."""
    codes, code = {}, 0
    for length in range(1, 16):
        for sym, l in enumerate(lengths):
            if l == length:
                codes[sym] = (code, l)
                code += 1
        code <<= 1
    return codes


PRECODE = [4] * 13 + [5] * 6  # complete: symbols 0-12 of 4 bits, 13-18 of 5
ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)


def dynamic(w, lit, dist, *, final=1, hlit=None, hdist=None, precode=PRECODE, symbols=None):
    """A dynamic block header; ``symbols`` overrides the code-length stream
    (precode symbols with their extra bits)."""
    w.put(final, 1).put(2, 2)
    w.put(len(lit) - 257 if hlit is None else hlit, 5).put(len(dist) - 1 if hdist is None else hdist, 5)
    w.put(15, 4)
    for sym in ORDER:
        w.put(precode[sym], 3)
    pcodes = canonical(precode)
    for item in symbols if symbols is not None else [(l, 0, 0) for l in lit + dist]:
        sym, extra, n_extra = item
        if sym not in pcodes:  # a precode without it: the rest is filler
            break
        w.code(*pcodes[sym]).put(extra, n_extra)
    return canonical(lit), canonical(dist)


def lit_lengths(**syms):
    lengths = [0] * 258
    for name, l in syms.items():
        lengths[256 if name == "eob" else 257 if name == "len3" else ord(name)] = l
    return lengths


AB = lit_lengths(a=2, b=2, eob=2, len3=2)


def _match_block(lit, dist, emit_dist=True):
    w = BitWriter()
    lc, dc = dynamic(w, lit, dist)
    w.code(*lc[97]).code(*lc[98]).code(*lc[257])
    if emit_dist:
        w.code(*dc[0])
    else:
        w.put(0, 4)
    if 256 in lc:
        w.code(*lc[256])
    return w.tobytes(pad=2)


def _stored(length, nlen, body, final=1):
    return BitWriter().put(final, 1).put(0, 2).align().put(length, 16).put(nlen, 16).raw(body).tobytes()


def _fixed(*codes, pad=2):
    w = BitWriter().put(1, 1).put(1, 2)
    for code, n in codes:
        w.code(code, n)
    return w.tobytes(pad=pad)


CRAFTED = {
    "reserved-type": (BitWriter().put(1, 1).put(3, 2).tobytes(pad=2), None),
    "stored-ok": (_stored(5, 0xFFFA, b"hello"), "ok"),
    "stored-empty": (_stored(0, 0xFFFF, b""), "ok"),
    "stored-nlen": (_stored(5, 0, b"hello"), None),
    "stored-past-end": (_stored(100, 0xFF9B, b"short"), None),
    "stored-no-len": (BitWriter().put(1, 1).put(0, 2).align().put(5, 8).tobytes(), None),
    "fixed-ok": (_fixed((0x30 + 97, 8), (0, 7)), "ok"),
    "fixed-length-286": (_fixed((0x30 + 97, 8), (0xC6, 8), (0, 7)), None),
    "fixed-length-287": (_fixed((0xC7, 8)), None),
    "fixed-distance-30": (_fixed((0x30 + 97, 8), (1, 7), (30, 5), (0, 7)), None),
    "fixed-distance-31": (_fixed((0x30 + 97, 8), (1, 7), (31, 5), (0, 7)), None),
    "fixed-before-start": (_fixed((1, 7), (0, 5), (0, 7)), None),
    "fixed-far-match": (_fixed((0x30 + 97, 8), (1, 7), (29, 5), (0x1FFF, 13), (0, 7)), None),
    "fixed-no-eob": (_fixed((0x30 + 97, 8), pad=0), None),
    "fixed-cut-extra": (_fixed((0x30 + 97, 8), (0x30 + 97, 8), (0x30 + 97, 8), (9, 7), pad=0), None),
    "empty-input": (b"", None),
    "one-byte": (b"\x01", None),
    "dynamic-ok": (_match_block(AB, [1]), "ok"),
    "dynamic-one-distance": (_match_block(AB, [1, 0]), "ok"),
    "dynamic-no-distances": (_match_block(AB, [0], emit_dist=False), None),
    "dynamic-complete": (_match_block(AB, [1, 1]), "ok"),
    "dynamic-dist-oversubscribed": (_match_block(AB, [1, 1, 1]), None),
    "dynamic-lit-incomplete": (_match_block(lit_lengths(a=2, b=2, eob=2, len3=3), [1]), None),
    "dynamic-lit-oversubscribed": (_match_block(lit_lengths(a=1, b=2, eob=2, len3=2), [1]), None),
    "dynamic-no-eob": (_match_block(lit_lengths(a=2, b=2, c=2, len3=2), [1]), None),
}


def _header_only(lit=AB, dist=(1,), **kw):
    w = BitWriter()
    dynamic(w, lit, list(dist), **kw)
    return w.tobytes(pad=4)


CRAFTED.update({
    "hlit-30": (_header_only(hlit=30), None),
    "hlit-31": (_header_only(hlit=31), None),
    "hdist-30": (_header_only(hdist=30), None),
    "precode-oversubscribed": (_header_only(precode=[1] * 19), None),
    "precode-empty": (_header_only(precode=[0] * 19), None),
    "precode-incomplete": (_header_only(precode=[1] + [0] * 18), None),
    "repeat-first": (_header_only(symbols=[(16, 0, 2)]), None),
    "repeat-overrun": (_header_only(symbols=[(2, 0, 0)] * 256 + [(16, 3, 2)]), None),
    "zero-repeat-overrun-17": (_header_only(symbols=[(0, 0, 0)] * 255 + [(17, 7, 3)]), None),
    "zero-repeat-overrun-18": (_header_only(symbols=[(18, 127, 7)] * 3), None),
    "header-cut": (_header_only()[:6], None),
    # A complete distance code, so the strict check reaches the literal code.
    "strict-literal-incomplete": (_match_block(lit_lengths(a=2, b=2, eob=2, len3=3), [1, 1]), None),
    "strict-literal-no-eob": (_match_block(lit_lengths(a=2, b=2, c=2, len3=2), [1, 1]), None),
    "strict-literal-empty": (_header_only(lit=[0] * 258, dist=(1, 1)), None),
    "strict-complete": (_header_only(dist=(1, 1)), None),
})


@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_crafted_stream(name):
    data, expect = CRAFTED[name]
    for window in (b"", b"xyz" * 11, None):
        res = same(data, 0, framing="raw", window=window)
        if expect == "ok" and window is not None:
            assert res[0] == "ok", res[:3]
    if expect is None:
        assert same(data, 0, framing="raw", window=b"")[0] == "raised"


# ---------------------------------------------------------------------------
# The block finder's strict header check
# ---------------------------------------------------------------------------


def _header_outcome(module, reader_cls, data, bit, strict):
    br = reader_cls(data, bit)
    try:
        module.read_dynamic_header(br, strict=strict)
    except Exception as exc:
        return ("raised", type(exc).__name__, str(exc))
    return ("ok", br.bit_pos)


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("source", ["random", "gzip-6", "pigz-like-6", "gzip-1"])
def test_dynamic_header_every_offset(source, strict):
    """At every bit of a stretch: the same accept or reject, the same error,
    and the same advance of the reader."""
    if source == "random":
        data = make_random(_rng("headers"), 6000)
    else:
        data = PRODUCERS[source](corpus("b64-lines", 30_000, source, "headers"))
    accepted = 0
    for bit in range(0, min(len(data) * 8, 24_000)):
        want = _header_outcome(ref_deflate, RefBitReader, data, bit, strict)
        got = _header_outcome(port_deflate, PortBitReader, data, bit, strict)
        assert want == got, bit
        accepted += want[0] == "ok"
    assert accepted or source == "random"
    # Each crafted header too.
    for name, (blob, _) in CRAFTED.items():
        if len(blob) > 2:
            assert (_header_outcome(ref_deflate, RefBitReader, blob, 3, strict)
                    == _header_outcome(port_deflate, PortBitReader, blob, 3, strict)), name


@pytest.mark.parametrize("producer", sorted(PRODUCERS) + ["random"])
def test_finder_candidates_and_stats_equal_reference(producer):
    if producer == "random":
        comp = make_random(_rng("finder"), 40_000)
    else:
        comp = PRODUCERS[producer](corpus("b64-lines", 60_000, producer, "finder"))
    total = len(comp) * 8
    assert list(PortFinder(comp, 0, total)) == list(RefFinder(comp, 0, total))
    want, got = RefFilterStats(), PortFilterStats()
    assert list(port_scan(comp, 0, total, stats=got)) == list(ref_scan(comp, 0, total, stats=want))
    assert got.as_dict() == want.as_dict()


# ---------------------------------------------------------------------------
# The block finder's compiled search against the reference's NumPy scans
# ---------------------------------------------------------------------------


def sync_flush_gzip(data, every=3000):
    """A gzip member with a ``Z_SYNC_FLUSH`` (an empty stored block) every
    ``every`` bytes: dynamic blocks and stored ones side by side."""
    c = zlib.compressobj(6, zlib.DEFLATED, 31)
    parts = [c.compress(data[i : i + every]) + c.flush(zlib.Z_SYNC_FLUSH)
             for i in range(0, len(data), every)]
    return b"".join(parts) + c.flush()


@functools.lru_cache(maxsize=None)
def finder_data(kind):
    if kind == "random-200k":  # 1.6 Mbit: four batches of 2^19 offsets
        return make_random(_rng("finder", kind), 200_000)
    text = corpus("b64-lines", 60_000, "finder", kind)
    return {"gzip-6": lambda: gzip_compress(text, 6), "stored-only": lambda: stored_only_compress(text),
            "sync-flush": lambda: sync_flush_gzip(text)}[kind]()


FINDER_KINDS = ["random-200k", "gzip-6", "stored-only", "sync-flush"]


def finder_outcome(module, data, start, end, full_validation=True):
    """The dynamic scan's candidates and ``FilterStats``; with full
    validation also the stored scan's and the merged finder's."""
    stats = module.FilterStats()
    dyn = list(module.scan_dynamic_candidates(data, start, end, stats=stats,
                                              full_validation=full_validation))
    out = {"dynamic": dyn, "stats": stats.as_dict()}
    if full_validation:
        out["stored"] = list(module.scan_stored_candidates(data, start, end))
        out["combined"] = list(module.CombinedBlockFinder(data, start, end))
    return out


def same_finder(data, start, end, **kw):
    want = finder_outcome(ref_finder, data, start, end, **kw)
    assert finder_outcome(port_finder, data, start, end, **kw) == want, (start, end)
    return want


@pytest.mark.parametrize("full_validation", [True, False])
@pytest.mark.parametrize("start", [0, 7, 12_345])
@pytest.mark.parametrize("kind", FINDER_KINDS)
def test_finder_whole_range_equal_reference(kind, start, full_validation):
    """From aligned and unaligned starts to the end: every batch of a
    range of 2-4 batches, where stored and dynamic candidates meet."""
    data = finder_data(kind)
    want = same_finder(data, start, len(data) * 8, full_validation=full_validation)
    # Random bytes hold Kraft survivors but no whole dynamic header.
    assert want["dynamic"] or kind == "stored-only" or (full_validation and kind == "random-200k")
    if full_validation and kind in ("stored-only", "sync-flush"):
        assert want["stored"]
        # The merge's dedupe: an offset both scans yield appears once.
        assert len(want["combined"]) == len(set(want["dynamic"]) | set(want["stored"]))


@pytest.mark.parametrize("kind", FINDER_KINDS)
def test_finder_short_empty_and_end_ranges_equal_reference(kind):
    """Ranges inside one batch, empty and reversed ranges, and ends at,
    inside and past the 74 bits a header probe needs at the buffer's end."""
    data = finder_data(kind)
    total = len(data) * 8
    ranges = [(1, 3001), (4_097, 44_097), (8_003, 8_003), (9_000, 8_000), (total, total + 64)]
    for back in (0, 1, 3, 73, 74, 75, 81, 200):
        ranges += [(total - 4_000 - back, total - back), (total - back - 1, total - back)]
    ranges += [(total - 5, total), (total - 80, 10 ** 12)]
    # Ranges that end or start at a candidate and one bit past it.
    whole = finder_outcome(ref_finder, data, 0, total)
    for c in whole["stored"][:3] + whole["dynamic"][:3]:
        ranges += [(c - 900, c), (c - 900, c + 1), (c, c + 900), (c + 1, c + 900)]
    for start, end in ranges:
        same_finder(data, max(start, 0), end)
        same_finder(data, max(start, 0), end, full_validation=False)


@pytest.mark.parametrize("full_validation", [True, False])
@pytest.mark.parametrize("kind", FINDER_KINDS)
def test_finder_stats_after_partial_pulls(kind, full_validation):
    """``FilterStats`` after the first 1, 2 and 5 candidates, from the
    dynamic scan and from the merged finder (which pulls one ahead)."""
    data = finder_data(kind)
    for start in (0, 5, 333_333):
        for n in (1, 2, 5):
            got = []
            for module in (ref_finder, port_finder):
                stats = module.FilterStats()
                scan = module.scan_dynamic_candidates(data, start, len(data) * 8, stats=stats,
                                                      full_validation=full_validation)
                cands = list(itertools.islice(scan, n))
                merged_stats = module.FilterStats()
                merged = list(itertools.islice(
                    module.CombinedBlockFinder(data, start, len(data) * 8, stats=merged_stats), n))
                got.append((cands, stats.as_dict(), merged, merged_stats.as_dict()))
            assert got[0] == got[1], (start, n)


def strict_case(lit, dist, shift, **kw):
    """A non-final dynamic header ``shift`` zero bits into a buffer."""
    w = BitWriter().put(0, shift)
    dynamic(w, lit, list(dist), final=0, **kw)
    return w.tobytes(pad=24)


STRICT_CASES = {
    "valid": dict(lit=AB, dist=(1, 1)),
    "distance-incomplete": dict(lit=AB, dist=(1,)),
    "distance-oversubscribed": dict(lit=AB, dist=(1, 1, 1)),
    "literal-incomplete": dict(lit=lit_lengths(a=2, b=2, eob=2, len3=3), dist=(1, 1)),
    "literal-no-eob": dict(lit=lit_lengths(a=2, b=2, c=2, len3=2), dist=(1, 1)),
    "literal-empty": dict(lit=[0] * 258, dist=(1, 1)),
    "repeat-first": dict(lit=AB, dist=(1, 1), symbols=[(16, 0, 2)]),
    "hdist-30": dict(lit=AB, dist=(1, 1), hdist=30),
}


@pytest.mark.parametrize("name", sorted(STRICT_CASES))
def test_finder_strict_checks_count_as_reference(name):
    """Each of checks 5-7 refusing a header that passed 1-4, at shifts
    inside a byte: the same candidates and the same ``FilterStats``."""
    for shift in (0, 3, 13):
        data = strict_case(shift=shift, **STRICT_CASES[name])
        want = same_finder(data, 0, len(data) * 8)
        assert shift in same_finder(data, 0, len(data) * 8, full_validation=False)["dynamic"]
        assert (shift in want["dynamic"]) == (name == "valid")
        check = {"valid": "valid", "distance": "invalid_distance",
                 "literal": "invalid_literal"}.get(name.split("-")[0], "invalid_precode_data")
        assert want["stats"][check] >= 1


@functools.lru_cache(maxsize=None)
def cell_like_file():
    """The read cell's kind of file at 3.5 MiB of text: base64 lines at gzip -6."""
    return gzip_compress(make_b64_lines(_rng("cell-like"), 7 << 19), 6)


def margin_slice(comp, k, chunk=1 << 20):
    """Chunk k's buffer as the fetcher's ``_margins`` cuts it from a source
    without a view (one chunk and a 2 MiB margin), with its local range."""
    start, stop = k * chunk, (k + 1) * chunk
    return comp[start : min(stop + 2 * chunk, len(comp))], 0, (stop - start) * 8


@pytest.mark.parametrize("k", [1, 2])
def test_finder_on_the_cell_kind_of_chunk(k):
    """Chunks of the read cell's kind of file sliced as the first pass
    slices them: the first candidates and the stats after each pull; the
    whole chunk's lists for one chunk."""
    buf, start, end = margin_slice(cell_like_file(), k)
    got = []
    for module in (ref_finder, port_finder):
        stats = module.FilterStats()
        finder = module.CombinedBlockFinder(buf, start, end, stats=stats)
        got.append([(c, stats.as_dict()) for c in itertools.islice(finder, 5)])
    assert got[0] == got[1]
    if k == 1:
        same_finder(buf, start, end)


# ---------------------------------------------------------------------------
# The library, its counters and its span
# ---------------------------------------------------------------------------


def test_library_is_built_by_the_host_compiler():
    assert "inflate" in _native.HOST_SOURCES and "inflate" not in _build.SOURCES
    src = _native.HOST.source_path("inflate")
    assert src.suffix == ".cpp" and src.is_file()
    assert _native.HOST.library_path("inflate").parent == _native.build_dir() == _build.build_dir()
    _native.HOST.build(["inflate"])
    assert _native.HOST.library_path("inflate").is_file()
    lib = _native.HOST.load("inflate")
    # A CDLL call releases the GIL (a PyDLL call would hold it).
    assert type(lib) is ctypes.CDLL
    assert not lib.rg_inflate._flags_ & ctypes._FUNCFLAG_PYTHONAPI


def test_stage1_imports_neither_torch_nor_kernels():
    """``core`` is the host layer: decoding and the block finder build and
    load the library without importing torch or ``repro_torch.kernels``."""
    code = (
        "import sys\n"
        "from repro_torch.core import deflate\n"
        "from repro_torch.core.bitreader import BitReader\n"
        "import zlib\n"
        "c = zlib.compressobj(6, zlib.DEFLATED, 31)\n"
        "comp = c.compress(b'abc' * 1000) + c.flush()\n"
        "res = deflate.DeflateChunkDecoder(comp).decode_chunk(80, None, window=b'')\n"
        "assert res.data.tobytes() == b'abc' * 1000\n"
        "try:\n"
        "    deflate.read_dynamic_header(BitReader(bytes(64)), strict=True)\n"
        "except Exception:\n"
        "    pass\n"
        "from repro_torch.core.block_finder import CombinedBlockFinder\n"
        "c = zlib.compressobj(6, zlib.DEFLATED, 31)\n"
        "text = b' '.join(b'%d' % (i * i) for i in range(3000))\n"
        "comp = c.compress(text) + c.flush(zlib.Z_SYNC_FLUSH) + c.compress(text) + c.flush()\n"
        "assert next(CombinedBlockFinder(comp, 0, len(comp) * 8)) == 80\n"
        "bad = sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')\n"
        "             or m.startswith('repro_torch.kernels'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_python_decoder_is_gone():
    for name in ("_DecodeState", "_decode_huffman", "_decode_stored"):
        assert not hasattr(port_deflate, name)
        assert not hasattr(port_deflate.DeflateChunkDecoder, name)


def test_stats_count_calls_blocks_symbols_regrowths():
    data = corpus("text", 30_000, "stats")
    comp = gzip_compress(data, 6)
    n_blocks = len(full_decode(comp).blocks)
    before = port_deflate.stats()
    port_deflate.DeflateChunkDecoder(comp).decode_chunk(80, None, window=b"", initial_capacity=1)
    after = port_deflate.stats()
    delta = {k: after[k] - before[k] for k in before}
    assert delta["blocks"] == n_blocks
    assert delta["symbols"] == len(data)
    assert delta["regrowths"] >= 1
    assert delta["calls"] == 1 + delta["regrowths"]


def test_span_per_compiled_call_carries_symbols():
    from repro_torch.obs import trace

    data = corpus("b64-lines", 30_000, "span")
    comp = multistream_gzip(data, 6, stream_size=10_000)
    trace.reset_tracing()
    trace.enable_tracing()
    try:
        port_deflate.DeflateChunkDecoder(comp).decode_chunk(80, None, window=None)
        spans = [s for s in trace.drain_spans() if s["name"] == "stage1.decode"]
    finally:
        trace.disable_tracing()
        trace.reset_tracing()
    assert len(spans) >= 3  # a call a member at least
    assert sum(s["attrs"]["symbols"] for s in spans) == len(data)


def test_threads_decode_at_once():
    """More threads than cores, switching often: every decode is exact and
    the counters lose no update."""
    data = corpus("b64-lines", 60_000, "threads")
    comp = multistream_gzip(data, 6, stream_size=15_000)
    n_threads, rounds = 16, 5
    before = port_deflate.stats()
    results, errors = [], []

    def work():
        try:
            for _ in range(rounds):
                res = port_deflate.DeflateChunkDecoder(comp).decode_chunk(80, None, window=b"",
                                                                          initial_capacity=1)
                results.append(res.data.tobytes() == data)
        except Exception as exc:  # re-raised below, in the test's thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert results == [True] * (n_threads * rounds)
    after = port_deflate.stats()
    assert after["symbols"] - before["symbols"] == n_threads * rounds * len(data)
    per_decode = {k: after[k] - before[k] for k in ("calls", "blocks", "regrowths")}
    assert all(v % (n_threads * rounds) == 0 and v > 0 for v in per_decode.values()), per_decode


def _finder_calls(data, start, end):
    """The merged finder's candidates, with the counters and spans it added."""
    from repro_torch.obs import trace

    before = port_finder.stats()
    trace.reset_tracing()
    trace.enable_tracing()
    try:
        cands = list(PortFinder(data, start, end))
        spans = [s for s in trace.drain_spans() if s["name"] == "stage1.find"]
    finally:
        trace.disable_tracing()
        trace.reset_tracing()
    after = port_finder.stats()
    return cands, {k: after[k] - before[k] for k in before}, spans


@pytest.mark.parametrize("kind", ["sync-flush", "stored-only"])
def test_find_span_and_stats_count_a_known_stream(kind):
    """One ``stage1.find`` span a compiled call, its ``bits`` the offsets
    moved over; ``stats()`` counts one call a candidate and one a scan's
    end, each scan's whole range, and the reference's strict checks."""
    data = finder_data(kind)
    start, end = 11, len(data) * 8
    cands, delta, spans = _finder_calls(data, start, end)
    want = finder_outcome(ref_finder, data, start, end)
    assert cands == want["combined"]
    n_dyn, n_stored = len(want["dynamic"]), len(want["stored"])
    assert delta["calls"] == len(spans) == n_dyn + 1 + n_stored + 1
    assert delta["candidates"] == n_dyn + n_stored
    st = want["stats"]
    assert delta["strict_checks"] == (st["invalid_precode_data"] + st["invalid_distance"]
                                      + st["invalid_literal"] + st["valid"])
    dyn_bits = min(end, len(data) * 8 - 74) - start
    stored_bits = 8 * (min(len(data) - 4, (end + 2) // 8) - (start + 10) // 8 + 1)
    assert delta["bits"] == sum(s["attrs"]["bits"] for s in spans) == dyn_bits + stored_bits


def test_first_candidate_takes_three_calls():
    """The read path's common case: the merged finder's first candidate is
    the chunk's block, found in one call of each scan, and the merge pulls
    the dynamic scan's next one ahead, as the reference's does."""
    buf, start, end = margin_slice(cell_like_file(), 2)
    before = port_finder.stats()
    first = next(PortFinder(buf, start, end))
    after = port_finder.stats()
    assert first == next(RefFinder(buf, start, end))
    assert after["calls"] - before["calls"] == 3


def test_threads_find_at_once():
    """Sixteen threads, two on each of eight chunks, each finding every
    candidate of its chunk, at once and switching often: the lists one
    thread finds, and the counters lose no update."""
    comp = cell_like_file()
    chunk = len(comp) // 8
    jobs = [margin_slice(comp, k, chunk) for k in range(8)]
    alone = [list(PortFinder(*job)) for job in jobs]
    assert all(alone) and alone[3] == list(RefFinder(*jobs[3]))
    per_pass = port_finder.stats()
    for job in jobs:
        list(PortFinder(*job))
    after = port_finder.stats()
    per_pass = {k: after[k] - per_pass[k] for k in after}
    n_threads, rounds, results, errors = 16, 3, {}, []

    def work(t):
        try:
            results[t] = [list(PortFinder(*jobs[t % 8])) for _ in range(rounds)]
        except Exception as exc:  # re-raised below, in the test's thread
            errors.append(exc)

    before = port_finder.stats()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert [results[t] for t in range(n_threads)] == [[alone[t % 8]] * rounds for t in range(n_threads)]
    after = port_finder.stats()
    assert {k: after[k] - before[k] for k in after} == {k: 2 * rounds * v for k, v in per_pass.items()}


def test_numpy_scans_are_gone():
    for name in ("_bit_array", "_field", "_precode_kraft_mask"):
        assert not hasattr(port_finder, name)
