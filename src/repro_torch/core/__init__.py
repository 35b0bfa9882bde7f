"""rapidgzip core for the PyTorch port: the paper's contribution.

Parallel decompression of and random access into arbitrary gzip files via
speculative two-stage chunk decoding wrapped in a cache + parallelized
prefetcher (Knespel & Brunst, HPDC '23).
"""

from .bitreader import BitReader
from .block_finder import (
    CombinedBlockFinder,
    FilterStats,
    find_dynamic_skiplut,
    find_dynamic_trial,
    scan_dynamic_candidates,
    scan_stored_candidates,
)
from .chunk_fetcher import ChunkFetcher, FinalizedChunk, GzipChunkFetcher
from .codec import (
    CODECS,
    BgzfCodec,
    Codec,
    DeflateCodec,
    ZstdCodec,
    detect_codec,
    detect_codec_tag,
    have_zstd,
    resolve_codec,
)
from .crc32 import RunningCRC, crc32_combine
from .deflate import (
    DecodeResult,
    DeflateChunkDecoder,
    MARKER_BASE,
    WINDOW_SIZE,
    canonical_stored_offset,
    gzip_decompress_sequential,
    inflate_raw,
)
from .errors import (
    BlockNotFoundError,
    DeflateError,
    FormatError,
    GzipFooterError,
    GzipHeaderError,
    RapidgzipError,
    RemoteFileChangedError,
    RemoteIOError,
)
from .filereader import (
    BytesFileReader,
    FileReader,
    PythonFileReader,
    SharedFileReader,
    open_file_reader,
)
from .remote import RemoteFileReader, is_remote_url, remote_identity
from .gzip_format import detect_bgzf, parse_gzip_header, scan_bgzf_members
from .index import GzipIndex, SeekPoint
from .markers import propagate_window, replace_markers, replacement_table
from .prefetch import AdaptivePrefetchStrategy, BackwardPrefetchStrategy, NoPrefetch
from .reader import ParallelGzipReader

__all__ = [
    "AdaptivePrefetchStrategy",
    "BackwardPrefetchStrategy",
    "BgzfCodec",
    "BitReader",
    "BlockNotFoundError",
    "BytesFileReader",
    "CODECS",
    "ChunkFetcher",
    "Codec",
    "CombinedBlockFinder",
    "DecodeResult",
    "DeflateChunkDecoder",
    "DeflateCodec",
    "DeflateError",
    "FileReader",
    "FilterStats",
    "FinalizedChunk",
    "FormatError",
    "GzipChunkFetcher",
    "GzipFooterError",
    "GzipHeaderError",
    "GzipIndex",
    "MARKER_BASE",
    "NoPrefetch",
    "ParallelGzipReader",
    "PythonFileReader",
    "RapidgzipError",
    "RemoteFileChangedError",
    "RemoteFileReader",
    "RemoteIOError",
    "RunningCRC",
    "SeekPoint",
    "SharedFileReader",
    "WINDOW_SIZE",
    "ZstdCodec",
    "canonical_stored_offset",
    "crc32_combine",
    "detect_bgzf",
    "detect_codec",
    "detect_codec_tag",
    "have_zstd",
    "resolve_codec",
    "find_dynamic_skiplut",
    "find_dynamic_trial",
    "gzip_decompress_sequential",
    "inflate_raw",
    "is_remote_url",
    "open_file_reader",
    "remote_identity",
    "parse_gzip_header",
    "propagate_window",
    "replace_markers",
    "replacement_table",
    "scan_bgzf_members",
    "scan_dynamic_candidates",
    "scan_stored_candidates",
]
