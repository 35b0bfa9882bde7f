"""AsyncArchiveServer — asyncio front-end over `ArchiveServer`.

The synchronous server is already concurrency-ready: ``read_range`` is
stateless (no shared cursor, no entry lock — see server.py's concurrency
contract), so an async front-end only needs a non-blocking bridge from the
event loop into threads. This wrapper provides one:

  * ``await read_range(...)`` / ``await size(...)`` run the blocking call on
    a small dedicated **front-end bridge pool** and suspend the coroutine —
    the event loop never blocks, however long the first pass takes;
  * ``await read_many([...])`` fans a batch of ranges out concurrently
    (``asyncio.gather`` over the bridge) — with a warm index the underlying
    preads proceed genuinely in parallel;
  * ``open`` and ``stat`` complete inline: registration is a dict insert and
    ``stat`` is a lock-free snapshot by design, so neither can stall the
    loop.

Why a dedicated bridge pool instead of dispatching front-end calls into the
shared `FairExecutor`: a read *blocks on decompression futures queued into
that same executor*. Running the blocking wrapper on a FairExecutor worker
could occupy every worker with callers that are all waiting for fetch tasks
none of the workers are free to run — classic pool-starvation deadlock. The
bridge threads therefore only *wait*; every byte of decompression work still
flows through the shared FairExecutor underneath with its per-tenant
fairness intact. Bridge threads are cheap (they sleep on futures), so
``front_end_threads`` bounds front-end concurrency, not CPU.

**Cancellation propagates into the bridge.** Awaiting coroutines get
cancelled (client disconnects, timeouts, gather siblings failing); the
bridged call must not keep consuming a bridge thread on behalf of a caller
that is gone. Every bridged await therefore:

  * cancels the underlying ``concurrent.futures`` future on
    ``asyncio.CancelledError`` — a call still *queued* for the bridge never
    starts, so a burst of abandoned requests cannot occupy bridge threads
    it no longer wants (the ``bridge_stats()['cancelled']`` counter is the
    audit trail);
  * a call already *running* finishes on its bridge thread (blocking reads
    are not preemptible) and its result is dropped — but ``read_many``
    cancels its still-queued siblings as soon as any range fails, so one
    bad range no longer leaks K-1 bridge occupancies past the await.

    from repro.service import AsyncArchiveServer

    async with AsyncArchiveServer(cache_budget_bytes=64 << 20) as srv:
        h = await srv.open("corpus-00.json.gz", tenant="search")
        page = await srv.read_range(h, 10 << 20, 4096)
        pages = await srv.read_many([(h, off, 4096) for off in offsets])
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..obs import hist as _obs_hist
from ..obs import trace as _obs_trace
from .server import ArchiveServer, ArchiveStat


class AsyncArchiveServer:
    """Async facade over an `ArchiveServer` (owned or wrapped).

    Construct either around an existing server (``AsyncArchiveServer(srv)``
    — lifecycle stays with the caller) or standalone with `ArchiveServer`
    kwargs (``AsyncArchiveServer(cache_budget_bytes=...)`` — ``shutdown`` /
    ``async with`` then tears the inner server down too).
    """

    def __init__(
        self,
        server: Optional[ArchiveServer] = None,
        *,
        front_end_threads: int = 8,
        **server_kwargs: Any,
    ):
        if server is not None and server_kwargs:
            raise ValueError("pass either a server or ArchiveServer kwargs, not both")
        self._server = server if server is not None else ArchiveServer(**server_kwargs)
        self._owns_server = server is None
        self._bridge = ThreadPoolExecutor(
            max_workers=max(1, front_end_threads),
            thread_name_prefix="archive-async",
        )
        self._closed = False
        # Bridge-side cancel accounting: submitted awaits, calls that
        # actually started on a bridge thread, and cancels that landed while
        # still queued (those never start — the regression tests' invariant).
        self._bridge_lock = threading.Lock()
        self._bridge_submitted = 0
        self._bridge_started = 0
        self._bridge_cancelled = 0

    @property
    def server(self) -> ArchiveServer:
        """The wrapped synchronous server (telemetry, sync co-access)."""
        return self._server

    # ------------------------------------------------------------------
    # bridge
    # ------------------------------------------------------------------

    def _bridged_call(self, ctx, t_submit, fn, *args, **kwargs):
        with self._bridge_lock:
            self._bridge_started += 1
        # Bridge queue wait: loop-side submit -> bridge-thread start. The
        # histogram is always on (it is the "bridge pool saturated" signal);
        # the span exists only while tracing and joins the caller's trace
        # via the context captured on the event loop.
        t0 = time.perf_counter()
        _obs_hist.observe("bridge.queue_wait", t0 - t_submit)
        if ctx is None and not _obs_trace.tracing_enabled():
            return fn(*args, **kwargs)
        # `attach` alone propagates the caller's context into this bridge
        # thread (the bridged read's own spans parent under the gateway
        # request); the bridge hop itself is recorded post-hoc, which keeps
        # the warm path at one completed-span append instead of a live Span.
        with _obs_trace.attach(ctx):
            t1 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _obs_trace.record_span(
                    "bridge.call",
                    t1,
                    time.perf_counter() - t1,
                    {"queue_wait_s": round(t0 - t_submit, 6)},
                    parent=ctx,
                )

    async def _run(self, fn, *args, **kwargs):
        """Await ``fn(*args)`` on the bridge, propagating cancellation.

        Unlike a bare ``loop.run_in_executor`` await, a cancelled await here
        *guarantees* ``future.cancel()`` is attempted on the bridged future
        and books the outcome: a still-queued call never reaches a bridge
        thread at all. (A call already running completes and is dropped —
        blocking reads cannot be preempted mid-decompression.)
        """
        if self._closed:
            raise RuntimeError("AsyncArchiveServer is closed")
        # Book the submission *before* handing it to the pool: a fast bridge
        # thread could otherwise bump `started` first and a concurrent
        # telemetry poll would transiently see started > submitted.
        with self._bridge_lock:
            self._bridge_submitted += 1
        try:
            fut = self._bridge.submit(
                partial(
                    self._bridged_call,
                    _obs_trace.capture(),
                    time.perf_counter(),
                    fn,
                    *args,
                    **kwargs,
                )
            )
        except BaseException:
            with self._bridge_lock:
                self._bridge_submitted -= 1
            raise
        try:
            return await asyncio.wrap_future(fut)
        except asyncio.CancelledError:
            if fut.cancel():
                with self._bridge_lock:
                    self._bridge_cancelled += 1
            raise

    def bridge_stats(self) -> Dict[str, int]:
        """{submitted, started, cancelled} for the front-end bridge. At
        quiescence ``submitted == started + cancelled`` — no bridged call is
        ever both cancelled-while-queued and run."""
        with self._bridge_lock:
            return {
                "submitted": self._bridge_submitted,
                "started": self._bridge_started,
                "cancelled": self._bridge_cancelled,
            }

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------

    async def open(
        self, source, *, tenant: str = "default", quantum: Optional[float] = None
    ) -> str:
        """Register a source (lazy reader creation, like the sync server).

        Pure registry work — runs inline, no executor round-trip.
        ``quantum`` forwards to the sync server's weighted-DRR knob.
        """
        if self._closed:
            raise RuntimeError("AsyncArchiveServer is closed")
        return self._server.open(source, tenant=tenant, quantum=quantum)

    async def read_range(self, handle: str, offset: int, size: int) -> bytes:
        """Decompressed [offset, offset+size) without blocking the loop."""
        return await self._run(self._server.read_range, handle, offset, size)

    async def read_many(
        self, requests: Sequence[Tuple[str, int, int]]
    ) -> List[bytes]:
        """Serve many ``(handle, offset, size)`` ranges concurrently.

        Results keep request order. Concurrency = min(len(requests),
        front_end_threads) at the bridge; the decompression itself fans out
        further through the shared executor. Any failed range fails the
        batch — and, unlike a bare ``asyncio.gather``, the batch's other
        still-pending awaits are cancelled immediately (queued bridge calls
        never start), so one bad range cannot keep occupying bridge threads
        on work whose result nobody will read. Issue ranges individually if
        partial results are wanted.
        """
        tasks = [
            asyncio.ensure_future(self.read_range(h, off, size))
            for h, off, size in requests
        ]
        try:
            return list(await asyncio.gather(*tasks))
        except BaseException:
            # First failure (or our own cancellation): reap the siblings.
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            raise

    async def stat(self, handle: str) -> ArchiveStat:
        """Handle snapshot — lock-free in the sync server, so served inline."""
        if self._closed:
            raise RuntimeError("AsyncArchiveServer is closed")
        return self._server.stat(handle)

    async def cancel_queued(self, handle: str) -> int:
        """Drop the handle's queued prefetch backlog (disconnect cleanup).

        A brief scheduler-lock sweep, never a blocking wait — served inline.
        """
        if self._closed:
            raise RuntimeError("AsyncArchiveServer is closed")
        return self._server.cancel_queued(handle)

    async def size(self, handle: str) -> int:
        """Decompressed size (may drive a whole first pass: bridged)."""
        return await self._run(self._server.size, handle)

    def metrics(self) -> Dict[str, Any]:
        """Fleet snapshot + this bridge's books (sync: non-blocking)."""
        snap = self._server.metrics()
        snap["bridge"] = self.bridge_stats()
        return snap

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def persist_index(self, handle: str) -> Optional[str]:
        return await self._run(self._server.persist_index, handle)

    async def close(self, handle: str, *, persist_index: bool = True) -> None:
        await self._run(self._server.close, handle, persist_index=persist_index)

    async def shutdown(self) -> None:
        """Drain the bridge; shut the inner server down iff we created it."""
        if self._closed:
            return
        try:
            if self._owns_server:
                await self._run(self._server.shutdown)
        finally:
            self._closed = True
            self._bridge.shutdown(wait=False)

    async def __aenter__(self) -> "AsyncArchiveServer":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.shutdown()
