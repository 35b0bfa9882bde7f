"""Exception hierarchy for the rapidgzip-JAX core."""


class RapidgzipError(Exception):
    """Base class for all core errors."""


class FormatError(RapidgzipError):
    """The byte stream does not conform to the gzip/deflate format."""


class DeflateError(FormatError):
    """Invalid deflate data (bad Huffman code, bad distance, truncated)."""


class GzipHeaderError(FormatError):
    """Invalid or truncated gzip member header."""


class GzipFooterError(FormatError):
    """CRC32 or ISIZE mismatch in a gzip member footer."""


class BlockNotFoundError(RapidgzipError):
    """No deflate block candidate could be confirmed inside a chunk."""


class IndexError_(RapidgzipError):
    """Seek-index import/export or consistency failure."""


class EndOfStream(RapidgzipError):
    """Ran out of compressed input mid-decode (not necessarily fatal for trials)."""


class RemoteIOError(RapidgzipError):
    """A remote range-GET failed after bounded retries (network/server fault)."""


class RemoteFileChangedError(RapidgzipError):
    """The remote object changed underneath us (ETag/Last-Modified/size
    mismatch between open-time validators and a later response). Never
    retried: serving a mix of old and new bytes would corrupt the stream."""
