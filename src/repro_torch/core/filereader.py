"""FileReader abstraction (paper §3, Fig 5).

Rapidgzip abstracts file access behind a ``FileReader`` interface so the same
decompression machinery can serve regular files, in-memory buffers, and Python
file-like objects (the paper uses this for recursive access to gzip-in-gzip).

``SharedFileReader`` is the thread-safe variant used by the parallel chunk
fetcher: every read is a *stateless* positioned read (POSIX ``pread`` semantics,
paper §4.2 / Fig 8) so worker threads never contend on a shared file position.
"""

from __future__ import annotations

import io
import os
import threading
from typing import Optional, Union


def check_pread_args(offset: int, size: int) -> None:
    """Shared argument contract for every ``pread`` implementation.

    A negative offset must raise rather than fall through to Python slicing
    (which would silently serve bytes from the *end* of an in-memory buffer)
    or to ``os.pread``/HTTP ranges (which fail with backend-specific errors).
    All backends agree: negative offset or size -> ValueError; reads at or
    past EOF -> b""; reads straddling EOF -> short result.
    """
    if offset < 0:
        raise ValueError("pread offset must be non-negative, got %d" % offset)
    if size < 0:
        raise ValueError("pread size must be non-negative, got %d" % size)


class FileReader:
    """Stateless positioned-read interface over a byte source."""

    def size(self) -> int:
        raise NotImplementedError

    def pread(self, offset: int, size: int) -> bytes:
        """Read up to ``size`` bytes at absolute ``offset`` (thread-safe).

        Contract (enforced by ``check_pread_args`` + the backend): negative
        ``offset``/``size`` raise ValueError; ``offset >= size()`` returns
        b""; a read straddling EOF returns the short tail; a short read from
        the underlying source never silently truncates mid-file.
        """
        raise NotImplementedError

    def identity(self) -> Optional[str]:
        """Cheap stable identity string for index caching, or None.

        Backends whose content identity is knowable without reading data
        (e.g. a remote object's URL + ETag + size) return it here so
        ``service.index_store.file_identity`` can key warm seek-indexes
        without downloading head/tail bytes.
        """
        return None

    def view(self) -> Optional[memoryview]:
        """Zero-copy view of the whole source, or None when unavailable.

        In-memory sources return a read-only ``memoryview`` so the chunk
        fetcher can scan without copying; file- and network-backed readers
        return None and are served via ``pread``. Public so callers never
        need to sniff concrete reader types for the fast path — a remote
        backend that cannot offer a view simply inherits this default.
        """
        return None

    def close(self) -> None:  # pragma: no cover - trivial
        pass

    def __enter__(self) -> "FileReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BytesFileReader(FileReader):
    """In-memory byte buffer source."""

    def __init__(self, data: Union[bytes, bytearray, memoryview]):
        self._data = bytes(data)

    def size(self) -> int:
        return len(self._data)

    def pread(self, offset: int, size: int) -> bytes:
        check_pread_args(offset, size)
        if offset >= len(self._data):
            return b""
        return self._data[offset : offset + size]

    def view(self) -> Optional[memoryview]:
        return memoryview(self._data)


class SharedFileReader(FileReader):
    """Thread-safe reader over a path using ``os.pread``.

    Mirrors the paper's SharedFileReader: many threads issue positioned reads
    against one file descriptor in parallel (Fig 8 benchmark).
    """

    def __init__(self, path: Union[str, os.PathLike]):
        self._path = os.fspath(path)
        self._fd = os.open(self._path, os.O_RDONLY)
        self._size = os.fstat(self._fd).st_size
        self._closed = False

    def size(self) -> int:
        return self._size

    def pread(self, offset: int, size: int) -> bytes:
        check_pread_args(offset, size)
        if offset >= self._size or size == 0:
            return b""
        out = []
        remaining = min(size, self._size - offset)
        while remaining > 0:
            chunk = os.pread(self._fd, remaining, offset)
            if not chunk:
                break
            out.append(chunk)
            offset += len(chunk)
            remaining -= len(chunk)
        return b"".join(out)

    def close(self) -> None:
        if not self._closed:
            os.close(self._fd)
            self._closed = True


class PythonFileReader(FileReader):
    """Adapter for arbitrary Python file-like objects (seek/read).

    File-like objects have a single cursor, so positioned reads are serialized
    behind a lock — this is the abstraction that lets rapidgzip-JAX decompress
    e.g. a gzip stream stored inside another ParallelGzipReader (recursive
    gzip-in-gzip access, paper §3).
    """

    def __init__(self, fileobj, *, close_fileobj: bool = False):
        if not (hasattr(fileobj, "read") and hasattr(fileobj, "seek")):
            raise TypeError("fileobj must support read() and seek()")
        self._f = fileobj
        self._close_fileobj = close_fileobj
        self._closed = False
        self._lock = threading.Lock()
        with self._lock:
            pos = self._f.tell()
            self._f.seek(0, io.SEEK_END)
            self._size = self._f.tell()
            self._f.seek(pos)

    def size(self) -> int:
        return self._size

    def pread(self, offset: int, size: int) -> bytes:
        check_pread_args(offset, size)
        with self._lock:
            self._f.seek(offset)
            # read(n) may legally return fewer than n bytes before EOF
            # (sockets, pipes, BufferedReader subclasses); loop so a short
            # read never silently truncates a chunk mid-file — a truncated
            # buffer poisons trial decompression downstream.
            out = []
            remaining = size
            while remaining > 0:
                chunk = self._f.read(remaining)
                if not chunk:
                    break
                out.append(chunk)
                remaining -= len(chunk)
            return b"".join(out)

    def close(self) -> None:
        if self._close_fileobj and not self._closed:
            self._f.close()
        self._closed = True


def open_file_reader(
    source: Union[str, os.PathLike, bytes, bytearray, memoryview, FileReader, object],
) -> FileReader:
    """Open any supported source as a FileReader."""
    if isinstance(source, FileReader):
        return source
    if isinstance(source, (bytes, bytearray, memoryview)):
        return BytesFileReader(source)
    if isinstance(source, str) and source.startswith(("http://", "https://")):
        from .remote import RemoteFileReader  # local import: avoids cycle

        return RemoteFileReader(source)
    if isinstance(source, (str, os.PathLike)):
        return SharedFileReader(source)
    return PythonFileReader(source)
