"""TorchDecodeEngine — batched stage-2 dispatch to the CUDA kernels.

Port of ``repro/kernels/engine.py::DeviceDecodeEngine``. The paper's
two-stage scheme (§2.2) leaves stage 2 — marker resolution and CRC32 —
data-parallel; a card only pays off when it is fed full batches, so every
reader submits its marker-resolution and CRC requests here, one dispatcher
thread packs them into tile batches, launches ``marker_replace_tiles_multi``
/ ``crc32_fold_batched`` once per batch, and scatters results back to
per-request futures.

Policy kept from the reference: the coalescing window, pow2 bucketing of
tiles, tables and ``seg_len``, slabbing at ``max_batch_tiles``, window dedup
up to ``max_tables``, the table LRU (32) and the table-stack LRU (8), one
dispatch in flight with the readback of batch N overlapping the launch of
N+1, the same ``stats()`` keys, and ``EngineClosedError`` for requests
queued at shutdown.

What differs on the card:

  * **An explicit device.** ``device="cuda"`` (the default) raises when
    there is no CUDA device or the kernels do not build; the engine never
    degrades to the CPU on its own. ``device="cpu"`` runs the kernels' plain
    PyTorch versions (``stats()["interpret"]`` is then True).
  * **Routing.** The reference defaults to ``crossover="auto"``, which
    derives the crossover from its committed CPU sweep and degrades to the
    CPU for everything when that artifact is missing. Here the default is
    ``crossover=None``: every non-degenerate request goes to the kernels
    (``force_device``). ``crossover="auto"`` reads the card's committed
    sweep, ``results/engine_sweep_h100.json`` (``tools/engine_sweep.py``,
    ``load_crossover``), and raises when it is missing or malformed; a
    kind whose derived crossover is None (the host wins at every size on
    that card) takes the host path, counted in ``fallbacks``. A dict
    routes by size as in the reference, and ``force_device=True`` sends
    everything to the kernels whatever the crossover.
  * **Staging.** Symbols are staged as uint16 and CRC bytes as uint8 in two
    zeroed pinned host buffers per bucket shape, copied with
    ``non_blocking=True`` on the engine's own stream. Each buffer records a
    CUDA event after its upload and is packed again only once that event
    has completed.
  * **The CRC fold.** The reference reads back all 1 024 lane CRCs of a
    request and folds them on the host (``core.crc32.combine_parts``, one
    ``crc32_combine`` a lane). Here the CRC launch folds each request's
    packed lanes on the device (``crc32_fold_batched``); the host reads
    back one word a request and runs zlib over the tail, under ``seg_len``
    bytes, on from it.
  * **Dispatch errors** fail that batch's futures and count in ``errors``;
    there is no CPU retry.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import zlib as _zlib
from collections import Counter, OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.markers import replace_markers as _cpu_replace_markers
from ..obs import trace as _obs_trace
from . import _build
from .crc32 import N_SEGMENTS, SEG_COLS, SEG_ROWS, crc32_fold_batched
from .marker_replace import TILE, TILE_COLS, TILE_ROWS, marker_replace_tiles_multi
from .ref import TABLE_SIZE, make_crc_table, make_replacement_table

_TILE_BYTES = TILE  # one symbol resolves to one output byte


class EngineClosedError(RuntimeError):
    """Raised on futures queued (or submits attempted) after shutdown."""


def _pow2_at_least(n: int, cap: Optional[int] = None) -> int:
    p = 1
    while p < n:
        p *= 2
    return min(p, cap) if cap is not None else p


_MBPS_RE = re.compile(r"([0-9]+(?:\.[0-9]+)?)MB/s")


def derive_crossover(rows: Sequence[Dict[str, Any]]) -> Dict[str, Optional[int]]:
    """Roofline-style CPU/device crossover from kernel sweep rows.

    Model: CPU resolves a request of ``n`` bytes in ``n / cpu_bw`` seconds;
    the device costs a fixed per-dispatch overhead plus ``n / dev_bw``. The
    crossover is where the lines meet::

        n* = overhead / (1/cpu_bw - 1/dev_bw)      (only if dev_bw > cpu_bw)

    Inputs are the sweep rows a kernel benchmark persists:
      * ``kernel_engine_cpu_replace``  — CPU gather bandwidth (MB/s derived)
      * ``kernel_engine_batched_b16``  — batched device bandwidth (MB/s)
      * ``kernel_engine_batched_b1``   — single-tile dispatch latency (us),
        whose fixed part estimates the per-dispatch overhead.

    Returns ``{"replace": bytes_or_None, "crc": bytes_or_None}`` — None
    means the device never wins at any size on these rows.
    """
    by_name = {r.get("name"): r for r in rows or ()}

    def _mbps(name: str) -> Optional[float]:
        row = by_name.get(name)
        if not row:
            return None
        m = _MBPS_RE.search(str(row.get("derived", "")))
        return float(m.group(1)) * 1e6 if m else None

    def _us(name: str) -> Optional[float]:
        row = by_name.get(name)
        return float(row["value_us"]) if row and "value_us" in row else None

    def _one(cpu_name: str, dev_name: str, b1_name: str) -> Optional[int]:
        cpu_bw, dev_bw, b1 = _mbps(cpu_name), _mbps(dev_name), _us(b1_name)
        if not cpu_bw or not dev_bw or b1 is None or dev_bw <= cpu_bw:
            return None
        overhead_s = max(0.0, b1 * 1e-6 - _TILE_BYTES / dev_bw)
        if overhead_s == 0.0:
            return _TILE_BYTES
        return int(overhead_s / (1.0 / cpu_bw - 1.0 / dev_bw))

    return {
        "replace": _one(
            "kernel_engine_cpu_replace",
            "kernel_engine_batched_b16",
            "kernel_engine_batched_b1",
        ),
        "crc": _one(
            "kernel_engine_cpu_crc",
            "kernel_engine_crc_batched_b8",
            "kernel_engine_crc_batched_b1",
        ),
    }


#: The card's committed engine sweep, relative to the repository root.
SWEEP_ARTIFACT = os.path.join("results", "engine_sweep_h100.json")
#: The rows ``derive_crossover`` reads: (name, whether its MB/s is read).
_CROSSOVER_ROWS = (("kernel_engine_cpu_replace", True), ("kernel_engine_batched_b16", True),
                   ("kernel_engine_batched_b1", False), ("kernel_engine_cpu_crc", True),
                   ("kernel_engine_crc_batched_b8", True),
                   ("kernel_engine_crc_batched_b1", False))


def load_crossover(root: Optional[str] = None) -> Dict[str, Optional[int]]:
    """``derive_crossover`` over the rows of ``<root>/results/engine_sweep_h100.json``
    (the repository root by default).

    Unlike the reference's, a missing or malformed artifact raises: a
    routing policy that silently became "everything on the host" would
    hide the card. Malformed means not JSON, no ``results`` list, or a row
    the derivation reads that is absent or has no time or no MB/s.
    """
    if root is None:
        root = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        )
    path = os.path.join(root, SWEEP_ARTIFACT)
    with open(path) as f:
        payload = json.load(f)
    rows = payload.get("results") if isinstance(payload, dict) else None
    if not isinstance(rows, list):
        raise ValueError("%s: no list of sweep rows under 'results'" % path)
    by_name = {r.get("name"): r for r in rows if isinstance(r, dict)}
    for name, bandwidth in _CROSSOVER_ROWS:
        row = by_name.get(name)
        if row is None or not isinstance(row.get("value_us"), (int, float)) or (
                bandwidth and not _MBPS_RE.search(str(row.get("derived", "")))):
            raise ValueError("%s: row %s is missing or malformed" % (path, name))
    return derive_crossover(rows)


class _Request:
    __slots__ = ("kind", "symbols", "window", "data", "tiles", "nbytes", "future")

    def __init__(self, kind: str, *, symbols=None, window=None, data=None):
        self.kind = kind
        self.symbols = symbols
        self.window = window
        self.data = data
        if kind == "replace":
            self.nbytes = int(symbols.shape[0])
            self.tiles = max(1, -(-self.nbytes // TILE))
        else:
            self.nbytes = len(data)
            self.tiles = 0
        self.future: Future = Future()


class _Stage:
    """One host staging buffer and the event of its last upload."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor):
        self.host = host
        self.event = None


class TorchDecodeEngine:
    """Process-wide batched dispatcher for stage-2 work on one device.

    Every entry point is thread-safe. The duck-typed resolver surface
    consumed by ``core.codec`` / ``core.chunk_fetcher``:

      * ``replace_markers(symbols, window) -> np.uint8 ndarray`` (blocking)
      * ``crc32(data) -> int`` (blocking)
      * ``submit_replace`` / ``submit_crc`` -> Future (async variants)
      * ``stats() -> dict`` / ``shutdown()``
    """

    def __init__(
        self,
        *,
        device: str = "cuda",
        max_batch_tiles: int = 32,
        max_tables: int = 8,
        max_batch_crc_bytes: int = 4 << 20,
        max_crc_requests: int = 16,
        max_delay_s: float = 0.002,
        crossover: Union[str, None, Dict[str, Optional[int]]] = None,
        force_device: bool = False,
        artifact_root: Optional[str] = None,
    ):
        self.device = _build.resolve_device(device)
        if self.device.type == "cuda":
            _build.build()  # raises when nvcc is missing or a kernel fails to build
            self._stream = torch.cuda.Stream(self.device)
        else:
            self._stream = None

        self.max_batch_tiles = max(1, max_batch_tiles)
        self.max_tables = _pow2_at_least(max(1, max_tables))
        self.max_batch_crc_bytes = max(1 << 10, max_batch_crc_bytes)
        self.max_crc_requests = max(1, max_crc_requests)
        self.max_delay_s = max(0.0, max_delay_s)
        # Without a crossover every non-degenerate request goes to the kernels.
        self.force_device = force_device or crossover is None
        self.interpret = self._stream is None
        self.available = True
        if crossover == "auto":
            self.crossover = load_crossover(artifact_root)
        elif crossover is None:
            self.crossover = {"replace": None, "crc": None}
        elif isinstance(crossover, dict):
            self.crossover = {
                "replace": crossover.get("replace"),
                "crc": crossover.get("crc"),
            }
        else:
            raise ValueError("crossover must be None, 'auto' or a dict, not %r" % (crossover,))
        self._crc_table = make_crc_table().to(self.device)

        self._cond = threading.Condition()
        self._rq: Deque[_Request] = deque()
        self._cq: Deque[_Request] = deque()
        self._closed = False
        # Replacement tables are pure functions of the window; serving reads
        # hit the same windows repeatedly, so an LRU of built tables (33 KB
        # each) turns the per-dispatch table cost into a cache probe.
        # Worker-thread only — no lock needed.
        self._table_cache: "OrderedDict[bytes, torch.Tensor]" = OrderedDict()
        self._table_cache_cap = 32
        # Device-side cache of uploaded table *stacks* keyed by the
        # dispatch's window set — a repeat batch skips assembly + transfer.
        self._stack_cache: "OrderedDict[Tuple, torch.Tensor]" = OrderedDict()
        self._stack_cache_cap = 8
        # Two pinned buffers per bucket shape, alternating between dispatches;
        # each waits for its own last upload before it is packed again.
        self._staging: Dict[Tuple, List[_Stage]] = {}
        self._staging_phase = 0
        # Launch shapes seen, for measuring the kernels where the path runs
        # them: ("replace", tiles, tables) / ("crc", batch, seg_len) -> count.
        self._shapes: Counter = Counter()

        # Counters (mutated under self._cond).
        self._requests = {"replace": 0, "crc": 0}
        self._fallbacks = {"replace": 0, "crc": 0}
        self._batches = 0
        self._dispatches = 0
        self._batched_requests = 0
        self._tiles_dispatched = 0
        self._tiles_padded = 0
        self._crc_bytes = 0
        self._max_queue_depth = 0
        self._errors = 0

        self._worker = threading.Thread(
            target=self._worker_loop, name="torch-decode-engine", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------------
    # routing policy
    # ------------------------------------------------------------------

    def _route_device(self, kind: str, nbytes: int) -> bool:
        if self._closed:
            return False
        if self.force_device:
            return True
        threshold = self.crossover.get(kind)
        return threshold is not None and nbytes >= threshold

    def _count(self, counter: Dict[str, int], kind: str) -> None:
        with self._cond:
            counter[kind] += 1

    # ------------------------------------------------------------------
    # submission API
    # ------------------------------------------------------------------

    def submit_replace(self, symbols: np.ndarray, window: Optional[bytes]) -> Future:
        """Queue a marker-resolution request; resolves to a uint8 array.

        Degenerate requests (already resolved, or empty) resolve immediately
        without touching the queue.
        """
        self._count(self._requests, "replace")
        fut: Future = Future()
        if symbols.dtype == np.uint8 or symbols.shape[0] == 0:
            fut.set_result(np.asarray(symbols, dtype=np.uint8))
            return fut
        req = _Request("replace", symbols=symbols, window=window)
        self._enqueue(self._rq, req)
        return req.future

    def submit_crc(self, data) -> Future:
        """Queue a CRC32 request; resolves to the int checksum."""
        self._count(self._requests, "crc")
        data = _as_bytes(data)
        fut: Future = Future()
        if len(data) == 0:
            fut.set_result(0)
            return fut
        req = _Request("crc", data=data)
        self._enqueue(self._cq, req)
        return req.future

    def _enqueue(self, queue: Deque[_Request], req: _Request) -> None:
        with self._cond:
            if self._closed:
                raise EngineClosedError("TorchDecodeEngine is shut down")
            queue.append(req)
            depth = len(self._rq) + len(self._cq)
            if depth > self._max_queue_depth:
                self._max_queue_depth = depth
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # blocking resolver surface (what codec/fetcher call)
    # ------------------------------------------------------------------

    def replace_markers(self, symbols: np.ndarray, window: Optional[bytes]) -> np.ndarray:
        """Resolve a marker stream on the device; below the crossover (or
        at any size when the kind's crossover is None and the device is not
        forced), or after shutdown, on the CPU (counted as a fallback)."""
        if symbols.dtype == np.uint8:
            return symbols
        if self._route_device("replace", symbols.shape[0]):
            try:
                fut = self.submit_replace(symbols, window)
                with _obs_trace.timed("engine.batch_wait", {"kind": "replace"}):
                    return fut.result()
            except EngineClosedError:
                pass  # raced shutdown: serve on the CPU like any fallback
        else:
            self._count(self._requests, "replace")
        self._count(self._fallbacks, "replace")
        return _cpu_replace_markers(symbols, window)

    def crc32(self, data) -> int:
        """CRC32 on the device; where ``replace_markers`` would take the
        host, through zlib (counted as a fallback)."""
        data = _as_bytes(data)
        if self._route_device("crc", len(data)):
            try:
                fut = self.submit_crc(data)
                with _obs_trace.timed("engine.batch_wait", {"kind": "crc"}):
                    return fut.result()
            except EngineClosedError:
                pass
        else:
            self._count(self._requests, "crc")
        self._count(self._fallbacks, "crc")
        return _zlib.crc32(data) & 0xFFFFFFFF

    # ------------------------------------------------------------------
    # dispatcher thread
    # ------------------------------------------------------------------

    def _collect_batch(self) -> Optional[Tuple[List[_Request], List[_Request]]]:
        """Block until work (or shutdown); return one coalesced batch.

        After the first request arrives, waits up to ``max_delay_s`` for the
        batch to fill — the window in which concurrent readers' stage-2 work
        coalesces into one dispatch. Returns None at shutdown.
        """
        with self._cond:
            while not self._closed and not self._rq and not self._cq:
                self._cond.wait()
            if self._closed:
                return None
            if self.max_delay_s > 0.0:
                deadline = time.monotonic() + self.max_delay_s
                while not self._closed:
                    tiles = sum(r.tiles for r in self._rq)
                    crc_bytes = sum(r.nbytes for r in self._cq)
                    if (
                        tiles >= self.max_batch_tiles
                        or len(self._cq) >= self.max_crc_requests
                        or crc_bytes >= self.max_batch_crc_bytes
                    ):
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                if self._closed:
                    return None

            rep: List[_Request] = []
            tiles = 0
            tables: set = set()
            while self._rq:
                req = self._rq[0]
                key = bytes(req.window or b"")
                new_table = key not in tables
                if rep and (
                    tiles + req.tiles > self.max_batch_tiles
                    or (new_table and len(tables) >= self.max_tables)
                ):
                    break
                self._rq.popleft()
                rep.append(req)
                tiles += req.tiles
                tables.add(key)
            crc: List[_Request] = []
            crc_bytes = 0
            while self._cq and len(crc) < self.max_crc_requests:
                req = self._cq[0]
                if crc and crc_bytes + req.nbytes > self.max_batch_crc_bytes:
                    break
                self._cq.popleft()
                crc.append(req)
                crc_bytes += req.nbytes
            return rep, crc

    def _worker_loop(self) -> None:
        if self._stream is not None:
            # Current device and stream are per thread: every copy and
            # launch of this thread goes to the engine's own stream.
            torch.cuda.set_device(self.device)
            torch.cuda.set_stream(self._stream)
        pending = None  # resolve-callback of the previous (in-flight) batch
        while True:
            batch = self._collect_batch()
            if batch is None:
                break
            rep, crc = batch
            launched = []
            try:
                if rep:
                    launched.append(self._dispatch_replace(rep))
                if crc:
                    launched.append(self._dispatch_crc(crc))
            except BaseException as exc:  # noqa: BLE001 - fail the batch, keep serving
                with self._cond:
                    self._errors += 1
                for req in rep + crc:
                    if not req.future.done():
                        req.future.set_exception(exc)
                continue
            # Pipeline: resolve the *previous* dispatch only after launching
            # this one — readback of batch N overlaps device work of N+1.
            if pending is not None:
                self._resolve_safely(pending)
            if launched:
                with self._cond:
                    self._batches += 1
                    self._batched_requests += len(rep) + len(crc)
            pending = launched or None
            with self._cond:
                idle = not self._rq and not self._cq
            if idle and pending is not None:
                self._resolve_safely(pending)
                pending = None
        if pending is not None:
            self._resolve_safely(pending)

    def _resolve_safely(self, launched) -> None:
        for resolve in launched:
            try:
                resolve()
            except BaseException:  # noqa: BLE001 - resolve() fails its own futures
                with self._cond:
                    self._errors += 1

    # -- host <-> device -------------------------------------------------

    def _staging_buffer(self, key: Tuple, shape: Tuple[int, ...], dtype) -> _Stage:
        bufs = self._staging.get(key)
        if bufs is None:
            pin = self._stream is not None
            bufs = [_Stage(torch.zeros(shape, dtype=dtype, pin_memory=pin)) for _ in range(2)]
            self._staging[key] = bufs
        stage = bufs[self._staging_phase & 1]
        if stage.event is not None:
            stage.event.synchronize()  # its last upload has been read
            stage.event = None
        return stage

    def _upload(self, stage: _Stage) -> torch.Tensor:
        """The staged tensor on the device; on the CPU the buffer itself (the
        plain version runs synchronously before the buffer is packed again)."""
        if self._stream is None:
            return stage.host
        dev = stage.host.to(self.device, non_blocking=True)
        stage.event = torch.cuda.Event()
        stage.event.record(self._stream)
        return dev

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """Copy a small unstaged host tensor; pinning makes the copy
        asynchronous, and the pinned block is not reused before it is read."""
        if self._stream is None:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _readback(self, out: torch.Tensor):
        """Start the copy of ``out`` to the host; returns a function that
        waits for it and gives the host tensor."""
        if self._stream is None:
            return lambda: out
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._stream)

        def wait() -> torch.Tensor:
            done.synchronize()
            return host

        return wait

    # -- marker replacement dispatch ------------------------------------

    def _replacement_table(self, window: bytes) -> torch.Tensor:
        table = self._table_cache.get(window)
        if table is not None:
            self._table_cache.move_to_end(window)
            return table
        table = make_replacement_table(window)
        self._table_cache[window] = table
        if len(self._table_cache) > self._table_cache_cap:
            self._table_cache.popitem(last=False)
        return table

    def _table_stack(self, keys: Tuple[bytes, ...]) -> torch.Tensor:
        """Device-resident (n_tables, TABLE_SIZE) uint8 stack for a window set.

        Window sets recur across dispatches (the same few chunks' windows
        serve a burst of reads), so the padded, uploaded stack is cached
        whole — a hit skips both the host assembly and the transfer.
        """
        n_tables = _pow2_at_least(len(keys), self.max_tables)
        cache_key = (n_tables,) + keys
        stack = self._stack_cache.get(cache_key)
        if stack is not None:
            self._stack_cache.move_to_end(cache_key)
            return stack
        tab_stack = torch.empty((n_tables, TABLE_SIZE), dtype=torch.uint8)
        for i in range(n_tables):
            tab_stack[i] = self._replacement_table(keys[min(i, len(keys) - 1)])
        stack = self._to_device(tab_stack)
        self._stack_cache[cache_key] = stack
        if len(self._stack_cache) > self._stack_cache_cap:
            self._stack_cache.popitem(last=False)
        return stack

    def _dispatch_replace(self, reqs: List[_Request]):
        """Pack, upload, and launch one marker batch; returns resolve()."""
        self._staging_phase += 1
        # Dedupe windows into a table stack; selector per tile.
        table_ids: Dict[bytes, int] = {}
        total_tiles = sum(r.tiles for r in reqs)
        tid_flat = np.zeros(total_tiles, np.int32)
        spans: List[Tuple[_Request, int, int]] = []
        single = total_tiles <= self.max_batch_tiles
        if single:
            # Common case: the whole batch is one slab — pack symbols
            # straight into the staging buffer, no intermediate copy. Pad
            # gaps keep whatever the buffer last held; the kernel writes 0
            # for any symbol out of range, and padded outputs are never read.
            bucket = _pow2_at_least(total_tiles, self.max_batch_tiles)
            stage = self._staging_buffer(
                ("rep", bucket), (bucket, TILE_ROWS, TILE_COLS), torch.uint16
            )
            sym_flat = stage.host.numpy().reshape(-1)
        else:
            sym_flat = np.zeros(total_tiles * TILE, np.uint16)
        pos = 0
        for req in reqs:
            key = bytes(req.window or b"")
            tid = table_ids.get(key)
            if tid is None:
                tid = len(table_ids)
                table_ids[key] = tid
            n = req.nbytes
            sym_flat[pos * TILE : pos * TILE + n] = req.symbols
            tid_flat[pos : pos + req.tiles] = tid
            spans.append((req, pos * TILE, n))
            pos += req.tiles

        tab_dev = self._table_stack(tuple(table_ids))

        # Slab the packed tiles: oversized single requests span multiple
        # kernel launches, everything else fits one. Bucketed shapes keep
        # the set of staging buffers small and reused.
        outs: List[Tuple[Any, int]] = []
        slabs = 0
        for s0 in range(0, total_tiles, self.max_batch_tiles):
            n = min(self.max_batch_tiles, total_tiles - s0)
            bucket = _pow2_at_least(n, self.max_batch_tiles)
            if single:
                stage_slab = stage
            else:
                stage_slab = self._staging_buffer(
                    ("rep", bucket), (bucket, TILE_ROWS, TILE_COLS), torch.uint16
                )
                stage_slab.host.numpy().reshape(-1)[: n * TILE] = (
                    sym_flat[s0 * TILE : (s0 + n) * TILE]
                )
            tids = np.zeros(bucket, np.int32)
            tids[:n] = tid_flat[s0 : s0 + n]
            out = marker_replace_tiles_multi(
                self._upload(stage_slab), tab_dev, self._to_device(torch.from_numpy(tids)),
            )
            outs.append((self._readback(out), n))
            slabs += 1
            with self._cond:
                self._tiles_dispatched += n
                self._tiles_padded += bucket - n
                self._shapes["replace", bucket, tab_dev.shape[0]] += 1
        with self._cond:
            self._dispatches += slabs

        def resolve() -> None:
            flat_out = np.concatenate(
                [wait().numpy().reshape(-1)[: n * TILE] for wait, n in outs]
            )
            for req, off, n in spans:
                if not req.future.done():
                    req.future.set_result(flat_out[off : off + n])

        return resolve

    # -- CRC dispatch ----------------------------------------------------

    def _dispatch_crc(self, reqs: List[_Request]):
        """Pack many byte streams into one (B, 8, 128, seg_len) dispatch."""
        self._staging_phase += 1
        seg_len = _pow2_at_least(
            max(1, max(-(-r.nbytes // N_SEGMENTS) for r in reqs))
        )
        batch = _pow2_at_least(len(reqs))
        stage = self._staging_buffer(
            ("crc", batch, seg_len), (batch, SEG_ROWS, SEG_COLS, seg_len), torch.uint8
        )
        # No zero fill: only each request's first `full` lanes are packed,
        # and the kernel folds only those.
        buf = stage.host.numpy()
        fulls: List[int] = []
        for bi, req in enumerate(reqs):
            full = req.nbytes // seg_len
            fulls.append(full)
            if full:
                lanes = buf[bi].reshape(N_SEGMENTS, seg_len)
                lanes[:full] = np.frombuffer(
                    req.data, np.uint8, count=full * seg_len
                ).reshape(full, seg_len)
        _, folded = crc32_fold_batched(self._upload(stage), self._crc_table, fulls)
        wait = self._readback(folded)
        with self._cond:
            self._dispatches += 1
            self._crc_bytes += sum(r.nbytes for r in reqs)
            self._shapes["crc", batch, seg_len] += 1

        def resolve() -> None:
            words = wait().numpy().view(np.uint32)
            with _obs_trace.span("engine.crc_fold"):
                for bi, req in enumerate(reqs):
                    # The card folded the first `full` lanes; zlib runs the
                    # tail (under seg_len bytes) on from that CRC.
                    crc = _zlib.crc32(req.data[fulls[bi] * seg_len :], int(words[bi]))
                    if not req.future.done():
                        req.future.set_result(crc & 0xFFFFFFFF)

        return resolve

    # ------------------------------------------------------------------
    # lifecycle & telemetry
    # ------------------------------------------------------------------

    def shutdown(self) -> None:
        """Stop the dispatcher and fail queued requests loudly.

        Requests already collected into an in-flight batch complete; anything
        still queued gets ``EngineClosedError`` — callers must never hang on
        a future the worker will no longer serve.
        """
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=30)
        with self._cond:
            leftovers = list(self._rq) + list(self._cq)
            self._rq.clear()
            self._cq.clear()
        for req in leftovers:
            if not req.future.done():
                req.future.set_exception(
                    EngineClosedError("TorchDecodeEngine shut down with requests queued")
                )

    def __enter__(self) -> "TorchDecodeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def stats(self) -> Dict[str, Any]:
        """Snapshot with the reference engine's keys."""
        with self._cond:
            tiles_total = self._tiles_dispatched + self._tiles_padded
            return {
                "available": self.available,
                "interpret": self.interpret,
                "force_device": self.force_device,
                "crossover_bytes": dict(self.crossover),
                "requests": dict(self._requests),
                "fallbacks": dict(self._fallbacks),
                "batches": self._batches,
                "dispatches": self._dispatches,
                "batched_requests": self._batched_requests,
                "tiles_dispatched": self._tiles_dispatched,
                "tiles_padded": self._tiles_padded,
                "occupancy": (
                    self._tiles_dispatched / tiles_total if tiles_total else 0.0
                ),
                "crc_bytes": self._crc_bytes,
                "queue_depth": len(self._rq) + len(self._cq),
                "max_queue_depth": self._max_queue_depth,
                "errors": self._errors,
                "closed": self._closed,
            }

    def dispatch_shapes(self) -> Dict[Tuple, int]:
        """Launches by shape: ``("replace", tiles, tables)`` and
        ``("crc", batch, seg_len)`` -> count."""
        with self._cond:
            return dict(self._shapes)


def _as_bytes(data) -> bytes:
    """Normalize ndarray/memoryview/bytes input to bytes for zlib/packing."""
    if isinstance(data, bytes):
        return data
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).tobytes()
    return bytes(data)


_shared: Dict[str, TorchDecodeEngine] = {}
_shared_lock = threading.Lock()


def shared_engine(device: str = "cuda") -> TorchDecodeEngine:
    """The process-wide engine for ``device`` (built on first use, rebuilt
    after a shutdown). Readers built without a resolver share it."""
    key = str(torch.device(device))
    with _shared_lock:
        eng = _shared.get(key)
        if eng is None or eng.stats()["closed"]:
            eng = TorchDecodeEngine(device=device)
            _shared[key] = eng
        return eng
