"""Source resolution + background transcoding of seek-hostile archives.

The paper's architecture exists because gzip resists seeking, and its worst
case (§4.8: fixed-Huffman / splitless archives) degrades to sequential-only
decompression *on every cold open, forever*. ACEAPEX's observation is that
the durable fix is encode-time resolution: pay one sequential pass, re-encode
as a parallel-friendly format, and every later read is O(1)-seekable. This
module implements both halves:

* :func:`resolve_source` — the open-path seam. Every ``ArchiveServer`` handle
  resolves through it: compute the origin's ``file_identity``, consult the
  ``IndexStore`` for a registered twin, and transparently bind the reader to
  the twin's bytes + exact index when one exists. The handle keeps the
  *origin's* identity (ETags, fleet rendezvous placement, and the
  index-exchange endpoint are unchanged), and the served bytes are
  bit-identical by construction — the twin re-encodes the same decompressed
  stream and is byte-compared against the origin before install.

* :class:`TranscodeManager` — the background half. When a freshly built
  index probes hostile (``Codec.seek_hostility`` over the reader's
  first-pass observations), the manager re-encodes the archive as BGZF (or
  zstd-seekable) via ``core.synth`` streaming writers. The work runs as a
  chain of small batch-lane ``FairExecutor`` steps with byte-cost hints —
  DRR interleaves interactive reads between spans, so a transcode never
  starves a tenant — and survives crash/partial-write: the twin streams to a
  unique tmp file, is fsynced, re-opened, and byte-compared against the
  origin *before* ``IndexStore.register_twin`` commits it (meta-last, so a
  torn install is never resolved).

Adapted from the JAX package's ``service/transcode.py`` in one respect: a
reader the port builds without a resolver takes the process-wide CUDA
engine, so :class:`TranscodeManager` hands both of its readers (the job's
origin reader and the twin's validation reader) the stage-2 resolver it was
given. The ``ArchiveServer`` passes its own engine; a manager built alone
takes ``device=`` and reaches that device's engine explicitly.
"""

from __future__ import annotations

import io
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..core.index import GzipIndex
from ..core.reader import ParallelGzipReader
from ..core.synth import BgzfStreamWriter, ZstdSeekableStreamWriter
from .index_store import IndexStore, file_identity

__all__ = [
    "ResolvedSource",
    "TranscodeError",
    "TranscodeManager",
    "resolve_source",
]


class TranscodeError(RuntimeError):
    """A transcode job failed validation or could not be installed."""


@dataclass
class ResolvedSource:
    """What the server should actually open for a requested source.

    ``identity`` is always the *origin's* key — twin-bound or not — which is
    what keeps ETag semantics and fleet placement stable across a twin
    install. ``twin`` names the twin's codec tag when the read path was
    rebound (None = serving the origin directly).
    """

    source: Any
    codec: Optional[str]
    index: Optional[GzipIndex]
    identity: str
    index_was_warm: bool
    twin: Optional[str] = None


def resolve_source(
    store: Optional[IndexStore], source: Any, *, codec: Optional[str] = None
) -> ResolvedSource:
    """Resolve ``source`` through the store: twin first, then warm index.

    A registered twin rebinds the read path to the twin's bytes and exact
    index (cold open does zero speculative work); otherwise the origin is
    opened with its warm index when one is stored. A twin whose index blob
    fails to parse is ignored — the origin always remains servable.
    """
    identity = file_identity(source, codec=codec)
    if store is None:
        return ResolvedSource(source, codec, None, identity, False)
    twin = store.resolve_twin(identity)
    if twin is not None:
        try:
            index = GzipIndex.from_bytes(twin.index_blob)
        except Exception:
            index = None
        if index is not None and index.finalized:
            return ResolvedSource(
                twin.source, twin.codec_tag, index, identity, True, twin.codec_tag
            )
    index = store.get(identity)
    return ResolvedSource(source, codec, index, identity, index is not None)


#: Sources a background job can re-open by value, independently of the
#: handle that triggered it. An already-open FileReader object is excluded:
#: the job would share (and race the close of) the server entry's reader.
_REOPENABLE = (str, os.PathLike, bytes, bytearray, memoryview)


@dataclass
class _Job:
    identity: str
    source: Any
    origin_codec: str
    twin_codec: str
    hostility: float
    origin_index_blob: bytes
    bytes_in: int
    decompressed: int
    state: str = "pending"  # pending -> running -> installed | failed
    error: Optional[str] = None
    offset: int = 0
    spans_done: int = 0
    twin_points: int = 0
    started: float = 0.0
    elapsed_s: float = 0.0
    reader: Optional[ParallelGzipReader] = None
    sink: Any = None
    writer: Any = None
    tmp_path: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)


class TranscodeManager:
    """Background re-encoder for archives that probe seek-hostile.

    ``consider(identity, source, reader)`` is the trigger (the server calls
    it after an archive's first full decompression): when the codec's
    hostility score clears ``hostility_threshold`` and no twin or job exists
    yet, a job is scheduled as a chain of ``span_bytes``-sized batch-lane
    steps on ``executor`` under the dedicated ``tenant`` (whose DRR quantum
    is scaled down by ``batch_quantum`` so interactive tenants always win
    contention).

    ``fault_hook(stage)`` is a test seam: called at the named lifecycle
    stages (``"open"``, ``"span"``, ``"finish"``, ``"validate"``,
    ``"install"``); an exception it raises fails the job exactly as a crash
    at that point would — the atomicity tests kill the transcoder mid-install
    through it.

    ``resolver`` is the stage-2 resolver of the job's readers (the owning
    server's engine); without one the manager takes
    ``kernels.engine.shared_engine(device)``, which raises for
    ``device="cuda"`` on a host without a card.
    """

    _STATES = ("pending", "running", "installed", "failed")

    def __init__(
        self,
        index_store: IndexStore,
        executor,
        *,
        tenant: str = "transcode",
        twin_codec: str = "auto",
        span_bytes: int = 4 << 20,
        hostility_threshold: float = 0.7,
        min_input_bytes: int = 1 << 12,
        batch_quantum: float = 0.25,
        compare_span: int = 4 << 20,
        fault_hook=None,
        resolver=None,
        device: str = "cuda",
    ):
        if twin_codec not in ("auto", "bgzf", "zstd"):
            raise ValueError("twin_codec must be 'auto', 'bgzf', or 'zstd'")
        self.store = index_store
        self.tenant = tenant
        # BGZF decodes through the deflate stack everywhere; zstd twins need
        # a zstd library at *serve* time too, so they are opt-in.
        self.twin_codec = "bgzf" if twin_codec == "auto" else twin_codec
        self.span_bytes = max(1 << 16, int(span_bytes))
        self.hostility_threshold = float(hostility_threshold)
        self.min_input_bytes = int(min_input_bytes)
        self.compare_span = max(1 << 16, int(compare_span))
        self._executor = executor
        self._fault_hook = fault_hook
        if resolver is None:
            from ..kernels.engine import shared_engine

            resolver = shared_engine(device)
        #: Stage-2 resolver of every reader a job opens (never None).
        self.resolver = resolver
        self._lock = threading.Lock()
        self._jobs: Dict[str, _Job] = {}
        self._closed = False
        self.counters = {
            "considered": 0,
            "scheduled": 0,
            "installed": 0,
            "failed": 0,
            "skipped_unresolvable": 0,
        }
        if executor is not None:
            executor.set_tenant_quantum(tenant, batch_quantum)

    # -- trigger ------------------------------------------------------------

    def consider(self, identity: str, source: Any, reader) -> bool:
        """Probe a freshly built index; schedule a transcode if hostile.

        Idempotent and cheap on the read path: dedups against running jobs
        and installed twins, and returns False without side effects for
        friendly archives. Returns True when a job was scheduled.
        """
        if self._closed or self._executor is None:
            return False
        index = reader.index
        if not index.finalized:
            return False
        with self._lock:
            self.counters["considered"] += 1
        hostility = reader.codec.seek_hostility(index)
        if hostility < self.hostility_threshold:
            return False
        if (index.compressed_size or 0) < self.min_input_bytes:
            return False
        if not isinstance(source, _REOPENABLE):
            with self._lock:
                self.counters["skipped_unresolvable"] += 1
            return False
        with self._lock:
            if identity in self._jobs:
                return False
        if self.store.resolve_twin(identity) is not None:
            return False
        job = _Job(
            identity=identity,
            source=source,
            origin_codec=reader.codec.tag,
            twin_codec=self.twin_codec,
            hostility=hostility,
            origin_index_blob=index.to_bytes(),
            bytes_in=int(index.compressed_size or 0),
            decompressed=int(index.decompressed_size or 0),
        )
        with self._lock:
            if identity in self._jobs:
                return False
            self._jobs[identity] = job
            self.counters["scheduled"] += 1
        # Persist the origin's finalized index under the origin key first:
        # later cold opens of the *origin* (twin install may still fail) and
        # fleet index exchange both serve this blob, and the job's private
        # reader re-opens from it without a second sequential pass.
        self.store.put(identity, index)
        self._submit_step(job)
        return True

    # -- job steps (batch-lane executor tasks) ------------------------------

    def _submit_step(self, job: _Job) -> None:
        try:
            fut = self._executor.submit(
                self.tenant, self._step, job,
                _cost=self.span_bytes, _priority=False,
            )
        except RuntimeError as exc:  # executor already shut down
            self._fail(job, exc)
            return
        fut.add_done_callback(lambda f: self._step_reaped(job, f))

    def _step_reaped(self, job: _Job, fut) -> None:
        # _step handles its own exceptions; this reaps steps that never ran
        # (cancelled in queue by shutdown/cancel_view) so a job cannot hang
        # in "running" with no step scheduled.
        if fut.cancelled():
            self._fail(job, TranscodeError("transcode step cancelled"))

    def _fault(self, stage: str) -> None:
        if self._fault_hook is not None:
            self._fault_hook(stage)

    def _step(self, job: _Job) -> None:
        """One bounded unit of transcoding: re-encode ``span_bytes`` of
        decompressed origin, then reschedule. Small steps + byte-cost hints
        are what let DRR interleave interactive reads between spans."""
        if job.done.is_set():
            return
        if self._closed:
            self._fail(job, TranscodeError("transcode manager closed"))
            return
        try:
            if job.reader is None:
                self._open_job(job)
            total = job.decompressed
            data = job.reader.pread(job.offset, min(self.span_bytes, total - job.offset))
            self._fault("span")
            job.writer.write(data)
            job.offset += len(data)
            job.spans_done += 1
            if job.offset >= total or not data:
                self._finalize(job)
            else:
                self._submit_step(job)
        except Exception as exc:  # noqa: BLE001 — any failure fails the job
            self._fail(job, exc)

    def _open_job(self, job: _Job) -> None:
        self._fault("open")
        # Private single-threaded reader over the origin's finalized index:
        # every span is an indexed (often zlib-delegated) read, no frontier
        # work, no shared state with the triggering server handle.
        job.reader = ParallelGzipReader(
            job.source,
            index=job.origin_index_blob,
            parallelization=1,
            verify=False,
            resolver=self.resolver,
        )
        job.tmp_path = self.store.twin_tmp_path(job.identity)
        if job.tmp_path is None:
            job.sink = io.BytesIO()
        else:
            job.sink = open(job.tmp_path, "wb")
        if job.twin_codec == "zstd":
            job.writer = ZstdSeekableStreamWriter(job.sink)
        else:
            job.writer = BgzfStreamWriter(job.sink)
        job.state = "running"
        job.started = time.perf_counter()

    def _finalize(self, job: _Job) -> None:
        """Finish + fsync + validate-before-install + atomic registration."""
        self._fault("finish")
        job.writer.finish()
        if job.tmp_path is not None:
            job.sink.flush()
            os.fsync(job.sink.fileno())
            job.sink.close()
            twin_source: Any = job.tmp_path
        else:
            twin_source = job.sink.getvalue()
        self._fault("validate")
        twin_index = self._validate(job, twin_source)
        job.twin_points = len(twin_index)
        self._fault("install")
        key = self.store.register_twin(
            job.identity,
            codec_tag=job.twin_codec,
            data=twin_source,
            index=twin_index,
            meta={
                "origin_codec": job.origin_codec,
                "bytes_in": job.bytes_in,
                "hostility": round(job.hostility, 4),
                "spans": job.spans_done,
            },
        )
        if key is None:
            raise TranscodeError("twin registration refused (unfinalized index)")
        job.elapsed_s = time.perf_counter() - job.started
        with self._lock:
            job.state = "installed"
            self.counters["installed"] += 1
        # Cleanup strictly before done.set(): wait() returning must mean
        # every job-owned resource (reader, sink, tmp file) is gone.
        self._cleanup(job, drop_tmp=False)
        job.done.set()

    def _validate(self, job: _Job, twin_source: Any) -> GzipIndex:
        """Re-open the twin from its tmp bytes and prove, before install,
        that (a) its exact index finalizes from metadata alone and (b) its
        decompressed stream is bit-identical to the origin's."""
        twin_reader = ParallelGzipReader(
            twin_source,
            codec=job.twin_codec,
            parallelization=1,
            verify=False,
            resolver=self.resolver,
        )
        try:
            index = twin_reader.index
            if not index.finalized:
                raise TranscodeError("twin index did not finalize from metadata")
            if (index.decompressed_size or 0) != job.decompressed:
                raise TranscodeError(
                    "twin decompressed size %s != origin %s"
                    % (index.decompressed_size, job.decompressed)
                )
            off = 0
            while off < job.decompressed:
                n = min(self.compare_span, job.decompressed - off)
                if twin_reader.pread(off, n) != job.reader.pread(off, n):
                    raise TranscodeError("twin bytes differ at offset %d" % off)
                off += n
            return index
        finally:
            twin_reader.close()

    # -- failure / cleanup ---------------------------------------------------

    def _fail(self, job: _Job, exc: BaseException) -> None:
        with self._lock:
            if job.state in ("installed", "failed"):
                return
            job.state = "failed"
            job.error = "%s: %s" % (type(exc).__name__, exc)
            self.counters["failed"] += 1
        if job.started:
            job.elapsed_s = time.perf_counter() - job.started
        # Cleanup strictly before done.set() — see _finalize.
        self._cleanup(job, drop_tmp=True)
        job.done.set()

    def _cleanup(self, job: _Job, *, drop_tmp: bool) -> None:
        reader, job.reader = job.reader, None
        sink, job.sink = job.sink, None
        job.writer = None
        if reader is not None:
            try:
                reader.close()
            except Exception:
                pass
        if sink is not None:
            try:
                sink.close()
            except Exception:
                pass
        if drop_tmp and job.tmp_path is not None:
            try:
                os.unlink(job.tmp_path)
            except OSError:
                pass

    # -- introspection -------------------------------------------------------

    def wait(self, identity: str, timeout: Optional[float] = None) -> Optional[str]:
        """Block until the job for ``identity`` reaches a terminal state;
        returns that state (or the current one on timeout, None if no job)."""
        with self._lock:
            job = self._jobs.get(identity)
        if job is None:
            return None
        job.done.wait(timeout)
        return job.state

    def job_state(self, identity: str) -> Optional[str]:
        with self._lock:
            job = self._jobs.get(identity)
            return job.state if job is not None else None

    def snapshot(self) -> Dict[str, Any]:
        """The ``metrics()["transcode"]`` section: counters + per-archive
        job state. ``speedup`` for an installed twin is the expected
        sequential-work reduction for a uniform random cold seek — the
        origin decodes O(offset) while the twin decodes O(span), so the
        ratio is the twin's seek-point count."""
        with self._lock:
            jobs = {
                j.identity: {
                    "state": j.state,
                    "codec": j.twin_codec,
                    "origin_codec": j.origin_codec,
                    "hostility": round(j.hostility, 4),
                    "bytes_in": j.bytes_in,
                    "bytes_out": int(j.writer.bytes_out) if j.writer is not None
                    else int((j.state == "installed") and self._installed_bytes(j)),
                    "decompressed": j.decompressed,
                    "spans_done": j.spans_done,
                    "speedup": float(max(1, j.twin_points)) if j.state == "installed" else None,
                    "elapsed_s": round(j.elapsed_s, 4),
                    "error": j.error,
                }
                for j in self._jobs.values()
            }
            counters = dict(self.counters)
        return {
            "tenant": self.tenant,
            "twin_codec": self.twin_codec,
            "hostility_threshold": self.hostility_threshold,
            "counters": counters,
            "jobs": jobs,
        }

    def _installed_bytes(self, job: _Job) -> int:
        # Writer is gone after cleanup; the store's meta carries the size.
        record = self.store.resolve_twin(job.identity)
        return int(record.meta.get("bytes_out", 0)) if record is not None else 0

    def close(self) -> None:
        """Stop accepting work; in-flight steps notice and fail their jobs.
        Queued steps are reaped by the executor's own shutdown/cancel."""
        self._closed = True
