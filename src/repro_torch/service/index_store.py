"""IndexStore — persistent seek-index blobs keyed by file identity.

The paper's index (§1.3/§3.3) is built on the fly during the first pass and
can be exported/imported; with an imported index every read is an indexed
read and the speculative first pass is skipped entirely (paper Fig 9 "with
index"). For a service that reopens the same archives across requests and
restarts, that import path is the difference between O(file) and O(range)
work on every open — so the store makes it automatic: `ArchiveServer`
consults the store on open and persists finalized indexes on close.

Identity is content-addressed cheaply: path + size + mtime_ns for on-disk
files (an edited file gets a new key and a cold first pass — stale indexes
age out of the directory unreferenced), a head/tail content digest for
in-memory buffers, and url + ETag/Last-Modified + size for remote objects
(so a warm index hit skips the speculative first pass without re-downloading
anything beyond a HEAD probe). Blobs are the existing `GzipIndex` binary
format, one file per key under ``root`` (or an in-memory dict when
``root=None``).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Union

from ..core.filereader import FileReader
from ..core.index import GzipIndex
from ..core.remote import RemoteFileReader, is_remote_url

_EXT = ".rpgzidx"
#: Transcoded-twin slots, all keyed by the *origin's* identity so fleet
#: rendezvous placement never moves when a twin installs:
#:   <key>.twin      — the re-encoded archive bytes (BGZF / zstd-seekable)
#:   <key>.twinidx   — the twin's finalized exact index blob
#:   <key>.twinmeta  — JSON commit record; written *last*, its presence is
#:                     the install point (a crash earlier leaves garbage
#:                     files that resolve_twin ignores)
_TWIN_DATA_EXT = ".twin"
_TWIN_IDX_EXT = ".twinidx"
_TWIN_META_EXT = ".twinmeta"


def file_identity(
    source: Union[str, os.PathLike, bytes, bytearray, memoryview, FileReader],
    *,
    codec: Optional[str] = None,
) -> str:
    """Stable hex key for an archive source.

    Paths hash (realpath, size, mtime_ns) — no bulk content reads, safe for
    huge archives. Byte buffers hash (len, head 64 KiB, tail 64 KiB). Remote
    URLs (and any FileReader exposing ``identity()``) hash (url, ETag or
    Last-Modified, size) — one HEAD round trip, no downloads, and a changed
    object gets a new key so its stale index ages out unreferenced.

    Every branch also mixes in the source's codec tag (``codec=`` to pin it,
    else probed from ≤4 KiB of head bytes): a gzip twin and a zstd twin of
    the same logical content must never collide in the store or in fleet
    rendezvous routing — their indexes have incompatible chunk semantics.
    The probe is deterministic for every caller (router, server, dataset),
    which is what keeps fleet placement consistent.
    """
    if isinstance(source, str) and is_remote_url(source):
        # Small blocks: the probe costs one HEAD, and the codec probe plus
        # the digest fallback (validator-less servers only) a few 64 KiB
        # range GETs, not full-size default blocks. Probing happens on the
        # open reader — a URL string has no local head bytes to sniff.
        with RemoteFileReader(source, block_size=64 << 10, cache_blocks=2) as r:
            return file_identity(r, codec=codec)
    if codec is None:
        from ..core.codec import detect_codec_tag

        codec = detect_codec_tag(source)
    h = hashlib.sha256()
    h.update(b"codec\0")
    h.update(codec.encode())
    if isinstance(source, FileReader):
        ident = source.identity()
        if ident is not None:
            h.update(b"ident\0")
            h.update(ident.encode())
            return h.hexdigest()
        # No cheap identity (e.g. a remote object without validators):
        # fall through to the head/tail content digest below. For an open
        # RemoteFileReader the two 64 KiB preads round out to its block
        # size (up to two full blocks fetched) — bounded, and the blocks
        # stay cached for the header/footer reads that follow an open.
    if isinstance(source, (str, os.PathLike)):
        path = os.path.realpath(os.fspath(source))
        st = os.stat(path)
        h.update(b"path\0")
        h.update(path.encode())
        h.update(str(st.st_size).encode())
        h.update(str(st.st_mtime_ns).encode())
        return h.hexdigest()
    if isinstance(source, (bytes, bytearray, memoryview)):
        data = bytes(source)
        h.update(b"bytes\0")
        h.update(str(len(data)).encode())
        h.update(data[: 64 << 10])
        h.update(data[-(64 << 10):])
        return h.hexdigest()
    if isinstance(source, FileReader):
        size = source.size()
        h.update(b"reader\0")
        h.update(str(size).encode())
        h.update(source.pread(0, 64 << 10))
        h.update(source.pread(max(0, size - (64 << 10)), 64 << 10))
        return h.hexdigest()
    raise TypeError("unsupported source type for identity: %r" % type(source))


@dataclass
class IndexStoreStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0
    rejected: int = 0  # non-finalized indexes refused
    remote_hits: int = 0  # local misses satisfied by the remote fallback
    remote_misses: int = 0  # fallback consulted and came back empty/invalid
    twin_hits: int = 0  # opens resolved to a transcoded twin
    twin_installs: int = 0  # twins registered (atomic, meta-last)
    twin_rejected: int = 0  # twin registrations refused (unfinalized index)

    def as_dict(self) -> Dict[str, int]:
        return {k: int(getattr(self, k)) for k in self.__dataclass_fields__}


@dataclass
class TwinRecord:
    """A registered transcoded twin of a seek-hostile origin archive.

    ``source`` is what to hand ``ParallelGzipReader``: the twin's data-file
    path for a disk-backed store, or the twin bytes for an in-memory store.
    ``index_blob`` is the twin's finalized exact index. The record is keyed
    by — and carries — the *origin's* identity: ETags, fleet placement, and
    the index-exchange endpoint all keep speaking the origin's name.
    """

    origin_key: str
    codec_tag: str
    source: Any
    index_blob: bytes
    meta: Dict[str, Any] = field(default_factory=dict)


class IndexStore:
    """Get/put of finalized GzipIndex blobs by source identity.

    ``root=None`` keeps blobs in memory (useful for tests and single-process
    services); a path persists them across restarts.

    ``remote_fallback`` is the cross-node index exchange hook: a callable
    ``key -> Optional[bytes]`` consulted on a local miss (e.g. asking fleet
    peers' ``GET /v1/archives/{key}/index``). Fetches are single-flighted
    per key, the returned blob must parse as a *finalized* ``GzipIndex`` or
    it is discarded, and a valid blob is installed locally so later gets hit
    without another network round trip. Identity validation happens on both
    sides: keys are content-addressed (``file_identity``) so the fetcher can
    check the peer's ETag against the very key it asked for, and a blob that
    fails to parse or is unfinalized never reaches a reader.
    """

    def __init__(
        self,
        root: Optional[Union[str, os.PathLike]] = None,
        *,
        remote_fallback: Optional[Callable[[str], Optional[bytes]]] = None,
    ):
        self.root = os.fspath(root) if root is not None else None
        if self.root is not None:
            os.makedirs(self.root, exist_ok=True)
        self._mem: Dict[str, bytes] = {}
        self._twins: Dict[str, TwinRecord] = {}  # root=None twin records
        self._lock = threading.Lock()
        self._fallback = remote_fallback
        self._ff_lock = threading.Lock()
        self._ff_inflight: Dict[str, threading.Event] = {}
        self.stats = IndexStoreStats()

    def set_remote_fallback(
        self, fn: Optional[Callable[[str], Optional[bytes]]]
    ) -> None:
        """Install/replace the fallback after construction (fleet wiring
        happens once every peer's URL is known, after all servers bind)."""
        self._fallback = fn

    # -- keys ---------------------------------------------------------------

    def key_for(self, source, *, codec: Optional[str] = None) -> str:
        if isinstance(source, str) and _is_key(source):
            return source
        return file_identity(source, codec=codec)

    def _path(self, key: str) -> str:
        assert self.root is not None
        return os.path.join(self.root, key + _EXT)

    # -- get/put ------------------------------------------------------------

    def get(self, source) -> Optional[GzipIndex]:
        key = self.key_for(source)
        blob = self._local_blob(key)
        if blob is None and self._fallback is not None:
            blob = self._fetch_remote(key)
        with self._lock:
            if blob is None:
                self.stats.misses += 1
            else:
                self.stats.hits += 1
        return GzipIndex.from_bytes(blob) if blob is not None else None

    def get_blob(self, source) -> Optional[bytes]:
        """Raw local blob by key/source — no fallback, no hit/miss counting.

        This is the serving side of the index exchange (the gateway's
        ``/index`` endpoint): it must never recurse into the fallback (node A
        asking node B asking node A) and must not skew the open-path hit
        rate with exchange traffic.
        """
        return self._local_blob(self.key_for(source))

    def _local_blob(self, key: str) -> Optional[bytes]:
        if self.root is None:
            with self._lock:
                return self._mem.get(key)
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def _install(self, key: str, blob: bytes) -> None:
        if self.root is None:
            with self._lock:
                self._mem[key] = blob
            return
        tmp = "%s.%d.%x.tmp" % (self._path(key), os.getpid(), threading.get_ident())
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._path(key))

    def _fetch_remote(self, key: str) -> Optional[bytes]:
        """Single-flight remote fetch: concurrent cold opens of the same
        archive share one network fetch; losers wait and read the installed
        blob. A failed fetch lets the next waiter try again (bounded by the
        number of waiting threads), so a transient peer error does not stick."""
        while True:
            with self._ff_lock:
                ev = self._ff_inflight.get(key)
                if ev is None:
                    self._ff_inflight[key] = threading.Event()
                    break
            ev.wait()
            blob = self._local_blob(key)
            if blob is not None:
                return blob
            # Winner failed; fall through and claim the fetch ourselves.
        fallback = self._fallback
        blob = None
        try:
            try:
                raw = fallback(key) if fallback is not None else None
            except Exception:
                # Peer/network faults must degrade to a cold first pass,
                # never fail the open.
                raw = None
            blob = self._validate_remote(raw)
            with self._lock:
                if blob is None:
                    self.stats.remote_misses += 1
                else:
                    self.stats.remote_hits += 1
            if blob is not None:
                self._install(key, blob)
            return blob
        finally:
            with self._ff_lock:
                self._ff_inflight.pop(key).set()

    @staticmethod
    def _validate_remote(raw: Optional[bytes]) -> Optional[bytes]:
        if raw is None:
            return None
        try:
            index = GzipIndex.from_bytes(raw)
        except Exception:
            return None
        return raw if index.finalized else None

    def put(self, source, index: GzipIndex) -> Optional[str]:
        """Persist a *finalized* index; returns its key (None if refused)."""
        if not index.finalized:
            with self._lock:
                self.stats.rejected += 1
            return None
        key = self.key_for(source)
        # _install writes to a unique tmp per writer then renames: two
        # threads closing handles on the same archive race put() for the
        # same key, and a shared '<key>.tmp' would interleave their writes
        # before the rename, installing a torn blob despite the atomic
        # replace.
        self._install(key, index.to_bytes())
        with self._lock:
            self.stats.puts += 1
        return key

    # -- transcoded twins ---------------------------------------------------

    def _twin_paths(self, key: str) -> Dict[str, str]:
        assert self.root is not None
        base = os.path.join(self.root, key)
        return {
            "data": base + _TWIN_DATA_EXT,
            "idx": base + _TWIN_IDX_EXT,
            "meta": base + _TWIN_META_EXT,
        }

    def twin_tmp_path(self, source) -> Optional[str]:
        """Where a transcoder should stream the twin-in-progress: a unique
        tmp path next to the final data file (same filesystem, so the
        install ``os.replace`` is atomic), or None for an in-memory store
        (stream to a buffer and pass bytes to :meth:`register_twin`)."""
        if self.root is None:
            return None
        key = self.key_for(source)
        return "%s.%d.%x.tmp" % (
            self._twin_paths(key)["data"], os.getpid(), threading.get_ident(),
        )

    def register_twin(
        self,
        origin,
        *,
        codec_tag: str,
        data: Union[str, bytes],
        index: GzipIndex,
        meta: Optional[Dict[str, Any]] = None,
    ) -> Optional[str]:
        """Atomically install a transcoded twin under the origin's key.

        ``data`` is a tmp-file path (disk store: renamed into place) or the
        twin bytes (in-memory store). Install order is data → index → meta,
        with the meta JSON written last as the commit point: a crash at any
        earlier step leaves files that :meth:`resolve_twin` never returns.
        Refuses a non-finalized index (counted in ``stats.twin_rejected``).
        """
        if not index.finalized:
            with self._lock:
                self.stats.twin_rejected += 1
            return None
        key = self.key_for(origin)
        index_blob = index.to_bytes()
        record_meta = dict(meta or {})
        record_meta["codec"] = codec_tag
        record_meta.setdefault("decompressed", index.decompressed_size)
        if self.root is None:
            if not isinstance(data, (bytes, bytearray, memoryview)):
                raise TypeError("in-memory store needs twin bytes, not a path")
            blob = bytes(data)
            record_meta["bytes_out"] = len(blob)
            record = TwinRecord(key, codec_tag, blob, index_blob, record_meta)
            with self._lock:
                self._twins[key] = record
                self.stats.twin_installs += 1
            return key
        if not isinstance(data, (str, os.PathLike)):
            raise TypeError("disk store needs a tmp-file path for twin data")
        paths = self._twin_paths(key)
        record_meta["bytes_out"] = os.stat(data).st_size
        os.replace(os.fspath(data), paths["data"])
        self._install_at(paths["idx"], index_blob)
        self._install_at(paths["meta"], json.dumps(record_meta).encode())
        with self._lock:
            self.stats.twin_installs += 1
        return key

    def _install_at(self, path: str, blob: bytes) -> None:
        """Unique-tmp + fsync + atomic rename at an explicit path."""
        tmp = "%s.%d.%x.tmp" % (path, os.getpid(), threading.get_ident())
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def resolve_twin(self, origin) -> Optional[TwinRecord]:
        """The installed twin for an origin identity, or None.

        A half-written install (no meta, truncated data, unparseable or
        unfinalized index, codec mismatch) is treated as absent — the open
        path falls back to the origin archive, never a torn twin.
        """
        key = self.key_for(origin)
        if self.root is None:
            with self._lock:
                record = self._twins.get(key)
                if record is not None:
                    self.stats.twin_hits += 1
                return record
        paths = self._twin_paths(key)
        try:
            with open(paths["meta"], "rb") as f:
                meta = json.loads(f.read())
            if not isinstance(meta, dict):
                return None
            if os.stat(paths["data"]).st_size != meta.get("bytes_out"):
                return None
            with open(paths["idx"], "rb") as f:
                index_blob = f.read()
        except (OSError, ValueError):
            return None
        codec_tag = meta.get("codec")
        if self._validate_remote(index_blob) is None:
            return None
        if codec_tag != GzipIndex.from_bytes(index_blob).codec_tag:
            return None
        with self._lock:
            self.stats.twin_hits += 1
        return TwinRecord(key, codec_tag, paths["data"], index_blob, meta)

    def drop_twin(self, origin) -> None:
        """Uninstall a twin (meta removed first, so a concurrent resolve
        sees either the full record or nothing)."""
        key = self.key_for(origin)
        if self.root is None:
            with self._lock:
                self._twins.pop(key, None)
            return
        paths = self._twin_paths(key)
        for name in ("meta", "idx", "data"):
            try:
                os.unlink(paths[name])
            except FileNotFoundError:
                pass

    def __contains__(self, source) -> bool:
        key = self.key_for(source)
        if self.root is None:
            with self._lock:
                return key in self._mem
        return os.path.exists(self._path(key))

    def keys(self):
        if self.root is None:
            with self._lock:
                return list(self._mem.keys())
        return [
            name[: -len(_EXT)]
            for name in os.listdir(self.root)
            if name.endswith(_EXT)
        ]

    def clear(self) -> None:
        if self.root is None:
            with self._lock:
                self._mem.clear()
                self._twins.clear()
            return
        exts = (_EXT, _TWIN_DATA_EXT, _TWIN_IDX_EXT, _TWIN_META_EXT)
        for name in os.listdir(self.root):
            if name.endswith(exts):
                os.unlink(os.path.join(self.root, name))


def _is_key(s: str) -> bool:
    return len(s) == 64 and all(c in "0123456789abcdef" for c in s)
