"""Codec interface: format-specific machinery behind the chunk/index model.

Everything above the chunk fetcher — caches, scheduler, index store, server,
gateway, fleet — treats an archive as *chunks addressed by an index*: a
sorted list of seek points ``(compressed bit offset, decompressed byte
offset, window, flags)`` plus per-chunk decompressed sizes. How those chunks
come to exist, and how their bytes are produced, is the codec's business.
This module defines that contract and ships three implementations that
exercise its opposite corners:

  * ``DeflateCodec`` — the paper's hard case (gzip / raw deflate). Chunk
    starts must be *guessed* by a block finder and confirmed by trial
    decompression (speculative first pass, paper §3.4); decoding without a
    known 32 KiB window runs in two-stage marker mode (§2.2); once a seek
    point exists, decompression is delegated to zlib (§1.3).
  * ``BgzfCodec`` — the trivially-parallel case (paper §3.4.4). The BC
    FEXTRA subfield gives every member's exact compressed size, so
    ``build_exact_index`` produces a complete, finalized index from a pure
    metadata walk: zero speculative decoding, zero marker passes. Inside a
    member it is plain deflate, so decode/delegate are inherited.
  * ``ZstdCodec`` — the format-native case (ACEAPEX direction). The zstd
    seekable format's seek-table footer enumerates independent frames with
    exact compressed+decompressed sizes; frames map 1:1 onto index chunks,
    ``window_size`` is 0, and decoding is always a native-library call.

## The codec contract

A ``Codec`` must provide:

``tag``
    Short stable string serialized into index blobs (``GzipIndex.codec_tag``)
    and mixed into ``IndexStore.file_identity`` keys. Never reuse a tag for
    incompatible chunk semantics.
``window_size``
    Bytes of preceding history a seek point must carry for mid-stream
    decoding (32768 for deflate, 0 for formats with independent chunks).
``probe(head)``
    True if ``head`` (the first few KiB of the file) looks like this codec's
    format. Probes must be order-robust: ``detect_codec`` consults the most
    specific codec first (BGZF before plain gzip, since BGZF *is* gzip) and
    a probe must never raise on another format's bytes.
``leading_header_bits(reader)``
    Bit offset where the first chunk's payload starts (after any leading
    container header). Only called when a speculative first pass will run.
``build_exact_index(reader, index)``
    Metadata-only construction of a complete index. Return True after
    populating and *finalizing* ``index`` (the reader then skips the
    speculative pass entirely); return False when the format offers no such
    shortcut. May raise ``FormatError`` on malformed metadata — the reader
    falls back to the speculative pass when the codec supports one.
``find_chunk_starts(buf, start_bit, stop_bit)``
    Iterator of candidate chunk-start bit offsets inside ``buf`` (the
    speculative finder). Only required when ``supports_speculation``.
``decode_chunk(buf, start_bit, stop_bit, *, window, max_out)``
    Decode one chunk to a ``DecodeResult``. ``window=None`` requests
    two-stage marker mode (only meaningful for marker codecs);
    ``window=b""`` / bytes requests exact single-stage output.
``delegate(buf, start_bit, window, out_size, *, max_input_bytes)``
    Native-library fast path producing exactly ``out_size`` bytes from a
    seek point. Raise ``FormatError`` when impossible; the fetcher consults
    ``decoder_required_flags`` first so it normally never is.
``decoder_required_flags``
    Seek-point flag mask for which ``delegate`` is invalid and
    ``decode_chunk`` must be used (deflate: interior member ends, shift-
    broken stored blocks).
``propagate_window(data, window)`` / ``replace_markers(data, window)``
    Stage-2 marker machinery; windowless codecs inherit the no-op defaults.
``set_stage2_resolver(resolver)``
    Optional pluggable stage-2 back end (``kernels.engine``): when set,
    marker resolution routes through it (batched device dispatch with CPU
    crossover); output stays bit-identical either way.
``split_candidate(block)``
    For marker codecs: may the on-the-fly indexer place an interior seek
    point at this block boundary? Returns ``(bit_offset, flags)`` or None.
``index_compatible_tags``
    Index ``codec_tag`` values this codec can serve. Legacy (pre-tag) index
    blobs import as ``"deflate"``; BGZF accepts those because its members
    are deflate-delegable.

## How chunk/index semantics map per codec

=============  =====================  =========================  ==========
codec          seek point sits at     chunk payload              window
=============  =====================  =========================  ==========
``deflate``    any deflate block      raw deflate, bit-aligned   32 KiB
               boundary (bit offset)
``bgzf``       first deflate bit      raw deflate of one member  b"" always
               after a member header
``zstd``       frame start (byte-     one complete zstd frame    none
               aligned, incl. the     (magic + blocks + opt.
               frame header)          checksum)
=============  =====================  =========================  ==========

## Checklist for adding a fourth codec

1. Pick a ``tag`` and decide ``window_size`` (0 if chunks are independent).
2. Implement ``probe`` + register the class in ``CODECS`` (and in
   ``_DETECTION_ORDER`` *before* any codec whose format yours embeds).
3. Implement ``build_exact_index`` if the format carries chunk metadata
   (sizes in headers/footers); otherwise implement ``find_chunk_starts`` +
   marker-mode ``decode_chunk`` and set ``supports_speculation = True``.
4. Implement ``delegate`` (the hot path for indexed reads) and declare
   ``decoder_required_flags`` for the cases it cannot handle.
5. Add a compressor to ``core.synth`` so tests/benchmarks can generate
   corpora offline, then extend the ``codec_case`` fixture in
   ``tests/conftest.py`` — the reader/pread round-trip suite and the
   ``codecs`` benchmark section pick the new codec up automatically.
6. Nothing above the fetcher should need changes; if it does, the new
   codec's semantics leaked — push them back down behind this interface.
"""

from __future__ import annotations

import struct
from typing import Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np

from .bitreader import BitReader
from .deflate import (
    BT_DYNAMIC,
    BT_STORED,
    WINDOW_SIZE,
    BlockBoundary,
    DecodeResult,
    DeflateChunkDecoder,
    canonical_stored_offset,
)
from .errors import FormatError, GzipHeaderError
from .gzip_format import parse_gzip_header, scan_bgzf_members
from .index import (
    FLAG_STORED_BLOCK,
    FLAG_STREAM_START,
    GzipIndex,
    SeekPoint,
)
from .markers import propagate_window as _propagate_window
from .markers import replace_markers as _replace_markers


class Codec:
    """Format plug-in for the chunk fetcher / reader (contract above).

    The base class implements the windowless, non-speculative defaults so a
    metadata-indexed codec only needs ``probe``/``build_exact_index``/
    ``delegate``.
    """

    tag: str = "abstract"
    window_size: int = 0
    supports_speculation: bool = False
    #: reader verifies per-member CRC32/ISIZE from DecodeResult.member_ends
    verifies_members: bool = False
    #: seek-point flags that force decode_chunk over delegate
    decoder_required_flags: int = 0
    #: optional stage-2 resolver (duck-typed: ``replace_markers``/``crc32``,
    #: e.g. ``kernels.engine.DeviceDecodeEngine``); None = host CPU path.
    stage2_resolver = None

    def set_stage2_resolver(self, resolver) -> None:
        """Route stage-2 marker resolution through ``resolver`` (or back to
        the CPU with None). The resolver decides device-vs-CPU per request;
        the codec contract (bit-identical output) is unchanged."""
        self.stage2_resolver = resolver

    @property
    def index_compatible_tags(self) -> frozenset:
        return frozenset((self.tag,))

    # -- detection / setup --------------------------------------------------

    def probe(self, head: bytes) -> bool:
        raise NotImplementedError

    def leading_header_bits(self, reader) -> int:
        raise FormatError("%s codec has no speculative first pass" % self.tag)

    def build_exact_index(self, reader, index: GzipIndex) -> bool:
        return False

    # -- speculative first pass --------------------------------------------

    def find_chunk_starts(self, buf, start_bit: int, stop_bit: int) -> Iterator[int]:
        raise FormatError("%s codec cannot speculate chunk starts" % self.tag)

    def decode_chunk(
        self,
        buf,
        start_bit: int,
        stop_bit: Optional[int] = None,
        *,
        window: Optional[bytes] = None,
        max_out: Optional[int] = None,
    ) -> DecodeResult:
        raise NotImplementedError

    # -- indexed fast path --------------------------------------------------

    def delegate(
        self,
        buf,
        start_bit: int,
        window: bytes,
        out_size: int,
        *,
        max_input_bytes: Optional[int] = None,
    ) -> bytes:
        raise NotImplementedError

    # -- stage-2 marker machinery (no-ops for windowless codecs) -----------

    def propagate_window(self, data: np.ndarray, window: Optional[bytes]) -> bytes:
        return b""

    def replace_markers(self, data: np.ndarray, window: Optional[bytes]) -> np.ndarray:
        if data.dtype != np.uint8:
            return data.astype(np.uint8)
        return data

    # -- on-the-fly index splitting ----------------------------------------

    def split_candidate(self, block: BlockBoundary) -> Optional[Tuple[int, int]]:
        """(bit offset, extra point flags) if an interior seek point may be
        placed at this block boundary, else None."""
        return None

    def stored_block_offsets(self, result: DecodeResult) -> List[int]:
        """Chunk-local output offsets of stored (uncompressed) blocks — the
        spans whose padding makes bit-shifted delegation unsafe
        (FLAG_ZLIB_UNSAFE). Empty for codecs without the concept."""
        return []

    # -- seek hostility (transcode trigger) ---------------------------------

    def seek_hostility(self, index: GzipIndex) -> float:
        """How seek-hostile did the archive prove during its first pass?

        Returns a score in [0, 1]; the transcode layer re-encodes archives
        scoring above its threshold as a parallel-friendly twin (BGZF /
        zstd-seekable). The base implementation — and any codec whose index
        comes from framing metadata alone — reports 0.0: such formats are
        already O(1)-seekable. Scores are computed from the in-memory
        ``index.observations`` the reader records while building the index,
        so only a freshly *built* index (first full decompression) can
        probe hostile; imported/warm indexes score 0.0.
        """
        return 0.0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<%s tag=%r>" % (type(self).__name__, self.tag)


# ---------------------------------------------------------------------------
# Deflate (gzip / raw) — the paper's speculative two-stage machinery
# ---------------------------------------------------------------------------

#: Largest leading gzip header accepted: FEXTRA (2+65535) + FNAME and
#: FCOMMENT (64 KiB each, the parser's own cap) + fixed fields fit well
#: under 1 MiB; anything bigger is malformed, not merely large.
_MAX_HEADER_BYTES = 1 << 20


class DeflateCodec(Codec):
    """gzip / raw deflate: speculative block finding + two-stage decode."""

    tag = "deflate"
    window_size = WINDOW_SIZE
    supports_speculation = True

    def __init__(self, framing: str = "gzip"):
        if framing not in ("gzip", "raw"):
            raise ValueError("framing must be 'gzip' or 'raw'")
        self.framing = framing
        self.verifies_members = framing == "gzip"

    @property
    def decoder_required_flags(self) -> int:  # type: ignore[override]
        from .index import FLAG_HAS_INTERIOR_MEMBER_END, FLAG_ZLIB_UNSAFE

        return FLAG_HAS_INTERIOR_MEMBER_END | FLAG_ZLIB_UNSAFE

    @property
    def index_compatible_tags(self) -> frozenset:
        # BGZF indexes are deflate-delegable (byte-aligned member starts,
        # empty windows), so a deflate reader can serve one and vice versa.
        return frozenset(("deflate", "bgzf"))

    def probe(self, head: bytes) -> bool:
        return len(head) >= 2 and head[0] == 0x1F and head[1] == 0x8B

    def leading_header_bits(self, reader) -> int:
        if self.framing == "raw":
            return 0
        # A fixed-size pread truncates headers with large FEXTRA/FNAME
        # fields; on a truncation (EndOfStream under the parser's
        # GzipHeaderError) retry with a doubled read while the file still
        # has bytes to give, capped with a clean error.
        from .errors import EndOfStream

        read_size = 1 << 16
        while True:
            head = reader.pread(0, read_size)
            try:
                hdr = parse_gzip_header(BitReader(head))
            except GzipHeaderError as exc:
                truncated = isinstance(exc.__cause__, EndOfStream)
                if truncated and len(head) == read_size:
                    if read_size >= _MAX_HEADER_BYTES:
                        raise GzipHeaderError(
                            "gzip header exceeds %d bytes" % _MAX_HEADER_BYTES
                        ) from exc
                    read_size *= 2
                    continue
                raise
            return hdr.header_bits

    def find_chunk_starts(self, buf, start_bit: int, stop_bit: int) -> Iterator[int]:
        from .block_finder import CombinedBlockFinder

        return iter(CombinedBlockFinder(buf, start_bit, stop_bit))

    def decode_chunk(
        self,
        buf,
        start_bit: int,
        stop_bit: Optional[int] = None,
        *,
        window: Optional[bytes] = None,
        max_out: Optional[int] = None,
    ) -> DecodeResult:
        decoder = DeflateChunkDecoder(buf, framing=self.framing)
        return decoder.decode_chunk(start_bit, stop_bit, window=window, max_out=max_out)

    def delegate(
        self,
        buf,
        start_bit: int,
        window: bytes,
        out_size: int,
        *,
        max_input_bytes: Optional[int] = None,
    ) -> bytes:
        from .zlib_bridge import zlib_inflate_at

        return zlib_inflate_at(
            buf, start_bit, window, out_size, max_input_bytes=max_input_bytes
        )

    def propagate_window(self, data: np.ndarray, window: Optional[bytes]) -> bytes:
        return _propagate_window(data, window)

    def replace_markers(self, data: np.ndarray, window: Optional[bytes]) -> np.ndarray:
        if self.stage2_resolver is not None and data.dtype != np.uint8:
            return self.stage2_resolver.replace_markers(data, window)
        return _replace_markers(data, window)

    def split_candidate(self, block: BlockBoundary) -> Optional[Tuple[int, int]]:
        # The finder can only resume at Dynamic or Non-Compressed blocks;
        # stored blocks use the canonical offset (padding ambiguity, paper
        # §3.4.1) and carry the flag so importers know.
        if block.block_type not in (BT_STORED, BT_DYNAMIC):
            return None
        if block.block_type == BT_STORED:
            return canonical_stored_offset(block.bit_offset), FLAG_STORED_BLOCK
        return block.bit_offset, 0

    def stored_block_offsets(self, result: DecodeResult) -> List[int]:
        return [b.out_offset for b in result.blocks if b.block_type == BT_STORED]

    def seek_hostility(self, index: GzipIndex) -> float:
        """Deflate hostility from first-pass observations (paper §4.8).

        Three signals, strongest wins:

        * **fixed-only members** — chunks whose every block is
          fixed-Huffman are invisible to the block finder; their fraction
          is the score (1.0 for a ``Z_FIXED`` archive).
        * **no block splits found** — speculation never landed a single
          chunk (no marker-mode chunk collected) *and* no interior split
          point was recorded: the whole first pass degraded to a
          sequential chain of exact tasks. Scores 0.9.
        * **two-stage-only point fraction** — seek points whose flags
          require the marker decoder forever (``decoder_required_flags``:
          interior member ends, zlib-unsafe stored spans). When ≥90% of
          points are stuck on the 2x two-stage path every cache recompute
          pays double, but random access still parallelizes — so this
          signal scores 0.5 × fraction, below the default transcode
          threshold on its own (it raises the score of an archive that is
          *also* split-starved, never condemns a healthy one: ordinary
          gzip of incompressible data hits it via stored-block
          realignment).
        """
        obs = getattr(index, "observations", None) or {}
        chunks = int(obs.get("chunks", 0))
        if not index.finalized or chunks <= 0:
            return 0.0
        score = float(obs.get("fixed_chunks", 0)) / chunks
        if (
            chunks >= 2
            and not obs.get("marker_chunks", 0)
            and not obs.get("split_points", 0)
        ):
            score = max(score, 0.9)
        points = index.points()
        if points:
            required = self.decoder_required_flags
            hard = sum(1 for p in points if p.flags & required)
            hard_frac = hard / len(points)
            if hard_frac >= 0.9:
                score = max(score, 0.5 * hard_frac)
        return min(1.0, score)


class BgzfCodec(DeflateCodec):
    """BGZF: exact member sizes from the BC FEXTRA subfield (paper §3.4.4).

    ``build_exact_index`` walks member headers via metadata alone and emits
    one finalized seek point per member — a cold open does zero speculative
    decoding and zero marker passes. Decoding inherits deflate (a BGZF
    member body is a raw deflate stream; seek points are byte-aligned with
    empty windows, so every chunk is zlib-delegable).
    """

    tag = "bgzf"

    def __init__(self):
        super().__init__(framing="gzip")

    @property
    def index_compatible_tags(self) -> frozenset:
        # Legacy (pre-tag) blobs import as "deflate"; older sessions also
        # built BGZF indexes under that tag — both decode identically here.
        return frozenset(("bgzf", "deflate"))

    def probe(self, head: bytes) -> bool:
        # The BC subfield, not just gzip magic: plain gzip with an unrelated
        # FEXTRA field must NOT probe as BGZF (it lacks member sizes).
        if not super().probe(head):
            return False
        try:
            return parse_gzip_header(BitReader(head)).is_bgzf
        except GzipHeaderError:
            return False

    def build_exact_index(self, reader, index: GzipIndex) -> bool:
        members = scan_bgzf_members(reader)
        out = 0
        for offset, size in members:
            head = reader.pread(offset, min(size, 1 << 12))
            hdr = parse_gzip_header(BitReader(head))
            footer = reader.pread(offset + size - 8, 8)
            isize = int.from_bytes(footer[4:8], "little")
            if isize == 0:
                continue  # BGZF EOF marker block
            index.add_point(
                SeekPoint(offset * 8 + hdr.header_bits, out, b"", FLAG_STREAM_START)
            )
            out += isize
        index.finalize(out, reader.size())
        return True

    def seek_hostility(self, index: GzipIndex) -> float:
        # Inherits DeflateCodec, but a BGZF index comes from framing
        # metadata alone: member boundaries are O(1)-seekable by
        # construction, so the deflate heuristics (which would misread the
        # zero-marker/zero-split profile as sequential degradation) never
        # apply. BGZF is the transcode *target*, never a source.
        return 0.0


# ---------------------------------------------------------------------------
# Zstandard (seekable format) — native frames, no windows, no speculation
# ---------------------------------------------------------------------------

_ZSTD_FRAME_MAGIC = 0xFD2FB528
_ZSTD_SKIPPABLE_MIN = 0x184D2A50
_ZSTD_SKIPPABLE_MAX = 0x184D2A5F
_ZSTD_SEEKABLE_SKIPPABLE = 0x184D2A5E  # seek-table skippable frame magic
_ZSTD_SEEKABLE_MAGIC = 0x8F92EAB1  # last 4 bytes of a seekable file


def zstd_backend():
    """The available zstd implementation, or None.

    Prefers the stdlib ``compression.zstd`` (Python 3.14+), falls back to
    the optional ``zstandard`` package. Both expose ``ZstdCompressor`` /
    ``ZstdDecompressor`` with compatible one-shot APIs; the returned shim
    normalizes the two call signatures.
    """
    try:
        from compression import zstd as _stdlib_zstd  # type: ignore

        class _StdlibShim:
            name = "compression.zstd"

            @staticmethod
            def compress(data: bytes, level: int = 3) -> bytes:
                return _stdlib_zstd.compress(data, level)

            @staticmethod
            def decompress_frame(data: bytes) -> bytes:
                # One frame only: trailing bytes beyond it are ignored.
                d = _stdlib_zstd.ZstdDecompressor()
                return d.decompress(data)

        return _StdlibShim
    except ImportError:
        pass
    try:
        import zstandard as _zstandard  # type: ignore

        class _ZstandardShim:
            name = "zstandard"

            @staticmethod
            def compress(data: bytes, level: int = 3) -> bytes:
                return _zstandard.ZstdCompressor(level=level).compress(data)

            @staticmethod
            def decompress_frame(data: bytes) -> bytes:
                # decompressobj stops cleanly at the frame end, tolerating
                # trailing bytes from the next frame in the same buffer.
                return _zstandard.ZstdDecompressor().decompressobj().decompress(data)

        return _ZstandardShim
    except ImportError:
        return None


def have_zstd() -> bool:
    return zstd_backend() is not None


def parse_zstd_seek_table(reader) -> List[Tuple[int, int, int]]:
    """[(frame_byte_offset, compressed_size, decompressed_size), ...].

    Parses the seekable-format footer: the file's final skippable frame
    carries N ``(compressed_size, decompressed_size[, checksum])`` entries
    followed by ``(frame_count: u32, descriptor: u8, 0x8F92EAB1: u32)``.
    Raises FormatError when the footer is absent or inconsistent.
    """
    size = reader.size()
    if size < 17:  # skippable header (8) + footer (9)
        raise FormatError("file too small for a zstd seek table")
    foot = reader.pread(size - 9, 9)
    n_frames, descriptor, magic = struct.unpack("<IBI", foot)
    if magic != _ZSTD_SEEKABLE_MAGIC:
        raise FormatError("zstd source has no seekable seek table")
    if descriptor & 0x7C:  # reserved bits must be zero
        raise FormatError("zstd seek table has reserved descriptor bits set")
    entry_size = 12 if descriptor & 0x80 else 8
    payload = n_frames * entry_size + 9
    table_start = size - payload - 8
    if table_start < 0:
        raise FormatError("zstd seek table larger than the file")
    head = reader.pread(table_start, 8)
    skip_magic, skip_size = struct.unpack("<II", head)
    if skip_magic != _ZSTD_SEEKABLE_SKIPPABLE or skip_size != payload:
        raise FormatError("zstd seek table framing is inconsistent")
    entries_raw = reader.pread(table_start + 8, n_frames * entry_size)
    if len(entries_raw) != n_frames * entry_size:
        raise FormatError("truncated zstd seek table")
    frames: List[Tuple[int, int, int]] = []
    comp_off = 0
    for i in range(n_frames):
        comp_size, dec_size = struct.unpack_from("<II", entries_raw, i * entry_size)
        frames.append((comp_off, comp_size, dec_size))
        comp_off += comp_size
    if comp_off != table_start:
        raise FormatError(
            "zstd seek table covers %d bytes but frames end at %d"
            % (comp_off, table_start)
        )
    return frames


class ZstdCodec(Codec):
    """Zstd seekable format: frames ARE chunks; the index IS the seek table.

    Opposite corner of the interface from deflate: no speculation, no
    markers, ``window_size == 0`` (frames are independent), every chunk
    decoded by one native-library call. Requires ``compression.zstd``
    (3.14+) or the optional ``zstandard`` package at decode time; ``probe``
    works without either.
    """

    tag = "zstd"
    window_size = 0
    supports_speculation = False
    verifies_members = False  # the library verifies per-frame checksums

    def probe(self, head: bytes) -> bool:
        if len(head) < 4:
            return False
        magic = struct.unpack_from("<I", head, 0)[0]
        return magic == _ZSTD_FRAME_MAGIC or (
            _ZSTD_SKIPPABLE_MIN <= magic <= _ZSTD_SKIPPABLE_MAX
        )

    def _backend(self):
        backend = zstd_backend()
        if backend is None:
            raise FormatError(
                "zstd source needs the 'compression.zstd' stdlib module "
                "(Python 3.14+) or the optional 'zstandard' package"
            )
        return backend

    def build_exact_index(self, reader, index: GzipIndex) -> bool:
        self._backend()  # fail early with a clear error, before any decode
        frames = parse_zstd_seek_table(reader)
        out = 0
        for comp_off, comp_size, dec_size in frames:
            if dec_size == 0:
                continue  # skippable or empty frame: nothing addressable
            index.add_point(SeekPoint(comp_off * 8, out, b"", FLAG_STREAM_START))
            out += dec_size
        index.finalize(out, reader.size())
        return True

    def decode_chunk(
        self,
        buf,
        start_bit: int,
        stop_bit: Optional[int] = None,
        *,
        window: Optional[bytes] = None,
        max_out: Optional[int] = None,
    ) -> DecodeResult:
        if start_bit % 8:
            raise FormatError("zstd frames are byte-aligned")
        stop_byte = len(buf) if stop_bit is None else (stop_bit + 7) // 8
        raw = self.delegate_bytes(buf, start_bit // 8, stop_byte)
        if max_out is not None and len(raw) > max_out:
            raise FormatError("zstd frame output exceeds max_out=%d" % max_out)
        data = np.frombuffer(raw, dtype=np.uint8)
        res = DecodeResult(
            start_bit=start_bit,
            end_bit=stop_byte * 8,
            data=data,
            marker_mode=False,
        )
        res.ended_at_eos = stop_byte >= len(buf)
        return res

    def delegate(
        self,
        buf,
        start_bit: int,
        window: bytes,
        out_size: int,
        *,
        max_input_bytes: Optional[int] = None,
    ) -> bytes:
        if start_bit % 8:
            raise FormatError("zstd frames are byte-aligned")
        start = start_bit // 8
        stop = len(buf) if max_input_bytes is None else min(len(buf), start + max_input_bytes)
        raw = self.delegate_bytes(buf, start, stop)
        if len(raw) < out_size:
            raise FormatError(
                "zstd frame produced %d of %d bytes" % (len(raw), out_size)
            )
        return raw[:out_size]

    def delegate_bytes(self, buf, start_byte: int, stop_byte: int) -> bytes:
        backend = self._backend()
        return backend.decompress_frame(bytes(buf[start_byte:stop_byte]))


# ---------------------------------------------------------------------------
# Registry + detection
# ---------------------------------------------------------------------------

#: tag -> zero-arg factory. ``resolve_codec`` also accepts "raw" as an alias
#: for raw-framed deflate.
CODECS = {
    "deflate": DeflateCodec,
    "bgzf": BgzfCodec,
    "zstd": ZstdCodec,
}

#: Most specific first: BGZF is a strict subset of gzip, so it must probe
#: before plain deflate; zstd's magic collides with neither.
_DETECTION_ORDER = ("bgzf", "zstd", "deflate")


def detect_codec(head: bytes) -> Codec:
    """Codec for a file starting with ``head`` (first few KiB).

    Detection never raises on valid input of any known format: each probe
    is consulted in most-specific-first order and a probe exception counts
    as "not mine". Unknown bytes fall back to ``DeflateCodec`` — the reader
    then produces the same clean GzipHeaderError it always has.
    """
    for tag in _DETECTION_ORDER:
        codec = CODECS[tag]()
        try:
            if codec.probe(head):
                return codec
        except Exception:
            continue
    return DeflateCodec()


def detect_codec_tag(source) -> str:
    """Cheap codec tag for an arbitrary source (path / bytes / FileReader).

    Reads at most 4 KiB of head bytes. Any probe failure degrades to
    "deflate" — identity keys must be computable for malformed sources too
    (the open that follows reports the real error).
    """
    try:
        head = _head_bytes(source)
    except Exception:
        return DeflateCodec.tag
    return detect_codec(head).tag


def _head_bytes(source, n: int = 1 << 12) -> bytes:
    import os

    if isinstance(source, (bytes, bytearray, memoryview)):
        return bytes(source[:n])
    if hasattr(source, "pread"):  # FileReader duck type
        return source.pread(0, n)
    if isinstance(source, (str, os.PathLike)):
        with open(os.fspath(source), "rb") as f:
            return f.read(n)
    if hasattr(source, "read") and hasattr(source, "seek"):
        pos = source.tell()
        try:
            source.seek(0)
            return source.read(n)
        finally:
            source.seek(pos)
    raise TypeError("cannot probe codec for %r" % type(source))


def resolve_codec(codec: Union[None, str, Codec], *, framing: str = "gzip",
                  head: Optional[bytes] = None) -> Codec:
    """Normalize a codec argument (instance, tag, or None=auto-detect)."""
    if isinstance(codec, Codec):
        return codec
    if isinstance(codec, str):
        if codec == "raw":
            return DeflateCodec(framing="raw")
        try:
            factory = CODECS[codec]
        except KeyError:
            raise ValueError(
                "unknown codec %r (known: %s)" % (codec, ", ".join(sorted(CODECS)))
            ) from None
        if factory is DeflateCodec:
            return DeflateCodec(framing=framing)
        return factory()
    if framing == "raw":
        return DeflateCodec(framing="raw")
    if head is not None:
        return detect_codec(head)
    return DeflateCodec(framing=framing)
