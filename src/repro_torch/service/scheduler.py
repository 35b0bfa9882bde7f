"""FairExecutor — one decompression thread-pool budget, many tenants.

`GzipChunkFetcher` assumes it owns a private ThreadPoolExecutor; a service
hosting dozens of readers cannot hand each one `parallelization` threads
(worst case: tenants x parallelization threads), nor share one plain FIFO
pool — a hot tenant streaming prefetches would queue ahead of everyone
else's first byte.

FairExecutor keeps one fixed worker pool and a run-queue *per tenant*,
serviced by **deficit round-robin over byte-weighted quanta** (DRR, Shreedhar
& Varghese): every task carries an estimated byte cost (how much
decompression work it represents), every tenant queue carries a deficit
counter replenished in quanta, and a task dispatches only when its tenant
has banked enough deficit to pay for it. Task-count round-robin is *not*
fair here — the paper's own measurements (§1.3) put a marker-mode trial
decode at >2x the work of a zlib-delegated indexed chunk of the same size,
and chunks themselves differ by orders of magnitude; a tenant submitting
4 MiB speculative decodes would receive orders of magnitude more CPU than
one submitting 32 KiB indexed reads while "fairly" alternating with it.

On top of DRR, each tenant has a **priority lane**: interactive tasks
(`read_range`'s blocking fetch, finalization on the read path) dispatch
before that tenant's queued batch prefetches. Cross-tenant arbitration is
unchanged — priority cuts the line only within its own tenant, so a tenant
cannot buy extra bandwidth by marking everything interactive (its deficit
still pays full byte cost).

Tenants can carry **weighted quanta** (``set_tenant_quantum(tenant,
factor)``): each replenishment pass credits that tenant ``factor x
quantum_bytes`` instead of one flat quantum, so a paying tenant with factor
2.0 receives ~2x the decompression bandwidth of a factor-1.0 tenant under
contention — classic weighted DRR, threaded through
``ArchiveServer.open(..., quantum=...)`` and the gateway's tenant config.

Accounting invariant (enforced by tests and the gateway's disconnect
handling): ``submitted == done + cancelled + queued`` at quiescence —
``done`` counts tasks that actually ran, ``cancelled`` counts tasks whose
future was cancelled while queued (they never execute), ``queued`` what
still waits. A client abandoning a request can therefore never orphan a
task: it either runs, or it is accounted cancelled.

``fairness="task_rr"`` restores the legacy task-count round-robin (costs and
lanes ignored) so the two disciplines can be A/B-measured — see
benchmarks/bench_service.py's skewed-tenant scenario.

Readers receive a `TenantExecutor` view: submit-compatible with
ThreadPoolExecutor (the fetcher calls only ``submit``/``shutdown``), tagging
every task with its tenant. Cost/priority hints travel via ``submit_hinted``
— callers that don't know about hints keep calling ``submit`` and get
neutral defaults (one quantum, batch lane). ``shutdown`` on a view cancels
that tenant's queued tasks but never touches the shared workers — the
server owns those.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, Optional, Tuple

from ..obs import hist as _obs_hist
from ..obs import trace as _obs_trace

#: Default deficit replenishment per round-robin visit. One quantum ~ one
#: small indexed-chunk task, so light tenants dispatch every visit while a
#: 4 MiB speculative decode must bank ~16 visits worth of credit.
DEFAULT_QUANTUM_BYTES = 256 << 10


@dataclass
class _Task:
    seq: int  # global submission order (task_rr FIFO + stable ties)
    future: Future
    fn: Callable
    args: tuple
    kwargs: dict
    view: object
    cost: int
    priority: bool
    tenant: str = ""  # owning queue (runtime observation needs it post-dispatch)
    #: Trace context captured at submit (None while tracing is disabled) —
    #: the worker reinstates it so a task's spans join the submitter's trace
    #: across the thread hop.
    ctx: Optional[Tuple[str, str]] = None
    t_submit: float = field(default=0.0)  # perf_counter at enqueue


class _TenantQueue:
    __slots__ = ("pri", "batch", "deficit")

    def __init__(self) -> None:
        self.pri: Deque[_Task] = deque()
        self.batch: Deque[_Task] = deque()
        self.deficit: int = 0

    def __len__(self) -> int:
        return len(self.pri) + len(self.batch)

    def head(self, fairness: str) -> _Task:
        """Next task: priority lane first under DRR, submission order under
        the legacy task_rr discipline (which predates lanes)."""
        if fairness == "task_rr":
            if self.pri and self.batch:
                return self.pri[0] if self.pri[0].seq < self.batch[0].seq else self.batch[0]
        if self.pri:
            return self.pri[0]
        return self.batch[0]

    def pop(self, task: _Task) -> None:
        if self.pri and self.pri[0] is task:
            self.pri.popleft()
        else:
            self.batch.popleft()

    def drain(self) -> list:
        tasks = list(self.pri) + list(self.batch)
        self.pri.clear()
        self.batch.clear()
        return tasks


class FairExecutor:
    def __init__(
        self,
        max_workers: int,
        *,
        thread_name_prefix: str = "archive",
        quantum_bytes: int = DEFAULT_QUANTUM_BYTES,
        fairness: str = "drr",
        cost_correction: bool = False,
        correction_alpha: float = 0.2,
    ):
        if max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        if quantum_bytes < 1:
            raise ValueError("quantum_bytes must be >= 1")
        if fairness not in ("drr", "task_rr"):
            raise ValueError("fairness must be 'drr' or 'task_rr'")
        if not 0.0 < correction_alpha <= 1.0:
            raise ValueError("correction_alpha must be in (0, 1]")
        self.max_workers = max_workers
        self.quantum_bytes = quantum_bytes
        self.fairness = fairness
        #: EWMA observed-runtime correction of byte-cost hints. Cost hints
        #: are estimates (a marker-mode decode claims 2x, a transcode span
        #: claims span_bytes); observed runtimes calibrate them: a global
        #: EWMA of claimed-bytes/second sets the fleet's exchange rate, and
        #: each tenant's factor tracks EWMA(runtime x rate / claimed_cost) —
        #: >1 means the tenant's tasks run slower than their hints claim, so
        #: DRR charges them proportionally more. Off by default: the raw
        #: hints stay exactly the documented DRR behavior.
        self.cost_correction = bool(cost_correction)
        self._corr_alpha = float(correction_alpha)
        self._throughput_ewma: Optional[float] = None  # claimed bytes / s
        self._correction: Dict[str, float] = {}
        self._cond = threading.Condition()
        # OrderedDict gives a stable round-robin order with O(1) membership.
        self._queues: "OrderedDict[str, _TenantQueue]" = OrderedDict()
        self._rr_last: Optional[str] = None
        self._shutdown = False
        self._seq = 0
        self._tasks_done = 0
        self._tasks_cancelled = 0  # cancelled while queued: never ran
        self._tasks_submitted = 0
        self._priority_dispatches = 0
        self._dispatch_per_tenant: Dict[str, int] = {}
        self._dispatched_bytes_per_tenant: Dict[str, int] = {}
        self._tenant_quanta: Dict[str, float] = {}
        self._threads = [
            threading.Thread(
                target=self._worker, name=f"{thread_name_prefix}-{i}", daemon=True
            )
            for i in range(max_workers)
        ]
        for t in self._threads:
            t.start()

    # -- submission ---------------------------------------------------------

    def submit(
        self,
        tenant: str,
        fn: Callable,
        *args: Any,
        _view: object = None,
        _cost: Optional[int] = None,
        _priority: bool = False,
        **kwargs: Any,
    ) -> Future:
        fut: Future = Future()
        # A cost-less task is charged one quantum: neutral under DRR (one
        # dispatch per visit, exactly the legacy task-count behavior).
        cost = self.quantum_bytes if _cost is None else max(1, int(_cost))
        with self._cond:
            if self._shutdown:
                raise RuntimeError("cannot submit after shutdown")
            self._seq += 1
            task = _Task(
                self._seq, fut, fn, args, kwargs, _view, cost, _priority, tenant,
                ctx=_obs_trace.capture(), t_submit=time.perf_counter(),
            )
            q = self._queues.setdefault(tenant, _TenantQueue())
            (q.pri if _priority else q.batch).append(task)
            self._tasks_submitted += 1
            self._cond.notify()
        return fut

    def view(self, tenant: str) -> "TenantExecutor":
        return TenantExecutor(self, tenant)

    def set_tenant_quantum(self, tenant: str, factor: float) -> None:
        """Weighted DRR: scale ``tenant``'s per-pass deficit replenishment to
        ``factor * quantum_bytes`` (default 1.0). Under contention a tenant's
        long-run share of dispatched decompression bytes is proportional to
        its factor — the "paying tenants get a larger quantum" knob."""
        if factor <= 0:
            raise ValueError("quantum factor must be > 0")
        with self._cond:
            self._tenant_quanta[tenant] = float(factor)

    def _quantum_of(self, tenant: str) -> int:
        # Called under self._cond.
        return max(1, int(self.quantum_bytes * self._tenant_quanta.get(tenant, 1.0)))

    def _effective_cost(self, tenant: str, cost: int) -> int:
        """The cost DRR charges: the hint, scaled by the tenant's observed
        correction factor when enabled. Called under self._cond."""
        if not self.cost_correction:
            return cost
        return max(1, int(cost * self._correction.get(tenant, 1.0)))

    def _observe_runtime_locked(self, tenant: str, cost: int, runtime_s: float) -> None:
        """Fold one finished task's (claimed cost, observed runtime) into the
        EWMA correction state. Called under self._cond."""
        runtime_s = max(runtime_s, 1e-6)
        alpha = self._corr_alpha
        throughput = cost / runtime_s
        if self._throughput_ewma is None:
            self._throughput_ewma = throughput
        else:
            self._throughput_ewma = (
                alpha * throughput + (1.0 - alpha) * self._throughput_ewma
            )
        implied = runtime_s * self._throughput_ewma  # fleet-rate byte cost
        ratio = min(16.0, max(1.0 / 16.0, implied / max(1, cost)))
        prev = self._correction.get(tenant, 1.0)
        self._correction[tenant] = min(
            16.0, max(1.0 / 16.0, alpha * ratio + (1.0 - alpha) * prev)
        )

    def boost(self, fut: Future, tenant: Optional[str] = None) -> bool:
        """Move a still-queued task into its tenant's priority lane.

        Dedup makes this necessary: when a blocking read joins an already-
        queued batch prefetch for the same chunk, the caller gets the old
        future back — without the upgrade it would wait behind the whole
        batch backlog despite being interactive (priority inversion).
        ``tenant`` narrows the scan to one queue (a view always boosts its
        own tenant's work; a fruitless full scan of a deep batch backlog
        would stall dispatch, since this holds the scheduler lock). The
        remaining per-tenant scan is linear, bounded in practice by the
        fetcher's in-flight dedup (distinct chunks, not request volume).
        Returns True if the task was found queued and promoted.
        """
        with self._cond:
            if tenant is not None:
                q = self._queues.get(tenant)
                queues = [q] if q is not None else []
            else:
                queues = list(self._queues.values())
            for q in queues:
                for i, task in enumerate(q.batch):
                    if task.future is fut:
                        del q.batch[i]
                        task.priority = True
                        q.pri.append(task)
                        return True
        return False

    # -- worker loop --------------------------------------------------------

    def _next_task_locked(self):
        """DRR pick over per-tenant queues (legacy task-count RR in task_rr).

        Equivalent to the textbook multi-pass DRR — each pass credits every
        non-empty queue one quantum until some head task is affordable — but
        computed in one O(tenants) scan: the winner is the queue needing the
        fewest replenishment passes for its head (ties broken in round-robin
        order after ``_rr_last``), and every scanned queue is credited that
        many passes' worth of quanta.
        """
        if not self._queues:
            return None
        tenants = list(self._queues.keys())
        start = 0
        if self._rr_last in self._queues:
            start = tenants.index(self._rr_last) + 1
        n = len(tenants)
        best: Optional[Tuple[int, str]] = None  # (passes_needed, tenant)
        nonempty = []
        for i in range(n):
            tenant = tenants[(start + i) % n]
            q = self._queues[tenant]
            if not len(q):
                # Drop empty queues so dead tenants don't slow the scan.
                del self._queues[tenant]
                continue
            nonempty.append(tenant)
            if self.fairness == "task_rr":
                best = (0, tenant)
                break
            head = q.head(self.fairness)
            head_cost = self._effective_cost(tenant, head.cost)
            passes = max(0, -(-(head_cost - q.deficit) // self._quantum_of(tenant)))
            if passes == 0:
                best = (0, tenant)
                break  # affordable now, and first in RR order
            if best is None or passes < best[0]:
                best = (passes, tenant)
        if best is None:
            return None
        passes, tenant = best
        if passes:
            for t in nonempty:
                # Weighted DRR: each pass credits a tenant its own quantum,
                # so dispatched-byte shares track the configured factors.
                self._queues[t].deficit += passes * self._quantum_of(t)
        q = self._queues[tenant]
        task = q.head(self.fairness)
        q.pop(task)
        # A task cancelled while queued never runs: don't debit the tenant's
        # deficit or book its bytes, or cancelled prefetches would eat real
        # bandwidth credit (the worker still receives it to close the done
        # count).
        cancelled = task.future.cancelled()
        if self.fairness != "task_rr" and not cancelled:
            q.deficit = max(0, q.deficit - self._effective_cost(tenant, task.cost))
        if not len(q):
            # Classic DRR: an emptied queue forfeits banked credit, so an
            # idle tenant cannot hoard a burst allowance.
            q.deficit = 0
        self._rr_last = tenant
        if not cancelled:
            self._dispatch_per_tenant[tenant] = (
                self._dispatch_per_tenant.get(tenant, 0) + 1
            )
            self._dispatched_bytes_per_tenant[tenant] = (
                self._dispatched_bytes_per_tenant.get(tenant, 0) + task.cost
            )
            if task.priority:
                self._priority_dispatches += 1
        return task

    def _worker(self) -> None:
        while True:
            with self._cond:
                task = self._next_task_locked()
                while task is None:
                    if self._shutdown:
                        return
                    self._cond.wait()
                    task = self._next_task_locked()
            fut = task.future
            if not fut.set_running_or_notify_cancel():
                # Cancelled while queued: still a terminal outcome — book it
                # under `cancelled` or snapshot()'s submitted == done +
                # cancelled + queued invariant drifts.
                with self._cond:
                    self._tasks_cancelled += 1
                continue
            t0 = time.perf_counter()
            # Queue wait (enqueue -> dispatch) is the scheduler's own
            # contribution to read latency — always histogrammed; the run
            # span below only exists while tracing is on.
            _obs_hist.observe("executor.queue_wait", t0 - task.t_submit)
            if _obs_trace.tracing_enabled():
                run_cm = _obs_trace.span(
                    "executor.run",
                    {
                        "tenant": task.tenant,
                        "cost": task.cost,
                        "priority": task.priority,
                        "queue_wait_s": round(t0 - task.t_submit, 6),
                    },
                    parent=task.ctx,
                )
            else:
                run_cm = None
            try:
                if run_cm is not None:
                    with _obs_trace.attach(task.ctx), run_cm:
                        result = task.fn(*task.args, **task.kwargs)
                else:
                    result = task.fn(*task.args, **task.kwargs)
            except BaseException as exc:  # noqa: BLE001 - mirror Executor semantics
                fut.set_exception(exc)
            else:
                fut.set_result(result)
            runtime_s = time.perf_counter() - t0
            if run_cm is None:
                _obs_hist.observe("executor.run", runtime_s)
            with self._cond:
                self._tasks_done += 1
                if self.cost_correction:
                    self._observe_runtime_locked(task.tenant, task.cost, runtime_s)

    # -- teardown & introspection ------------------------------------------

    def cancel_tenant(self, tenant: str) -> int:
        """Cancel all *queued* (not yet running) tasks of one tenant."""
        cancelled = 0
        with self._cond:
            q = self._queues.get(tenant)
            if q:
                for task in q.drain():
                    # Dequeued without running: terminal either way. A future
                    # the owner already cancelled directly still books here
                    # (it can no longer reach a worker).
                    task.future.cancel()
                    cancelled += 1
                    self._tasks_cancelled += 1
        return cancelled

    def cancel_view(self, view: object, *, batch_only: bool = False) -> int:
        """Cancel queued tasks submitted through one TenantExecutor view.

        Scoped narrower than cancel_tenant: a tenant may have several
        readers open; closing one must not cancel the others' work.
        ``batch_only=True`` restricts the sweep to the batch lane — queued
        *prefetches* — leaving priority-lane tasks (someone is blocking on
        those right now) untouched; this is what the gateway uses when a
        client disconnects mid-stream.
        """
        cancelled = 0
        with self._cond:
            for q in self._queues.values():
                for lane in ((q.batch,) if batch_only else (q.pri, q.batch)):
                    if not any(task.view is view for task in lane):
                        continue
                    keep = []
                    for task in lane:
                        if task.view is view:
                            task.future.cancel()
                            cancelled += 1
                            self._tasks_cancelled += 1  # dequeued: terminal
                        else:
                            keep.append(task)
                    lane.clear()
                    lane.extend(keep)
        return cancelled

    def shutdown(self, wait: bool = True, cancel_futures: bool = False) -> None:
        with self._cond:
            self._shutdown = True
            if cancel_futures:
                for q in self._queues.values():
                    for task in q.drain():
                        task.future.cancel()
                        self._tasks_cancelled += 1
            self._cond.notify_all()
        if wait:
            for t in self._threads:
                t.join()

    def snapshot(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "max_workers": self.max_workers,
                "fairness": self.fairness,
                "quantum_bytes": self.quantum_bytes,
                "submitted": self._tasks_submitted,
                "done": self._tasks_done,
                "cancelled": self._tasks_cancelled,
                "queued": sum(len(q) for q in self._queues.values()),
                "priority_dispatches": self._priority_dispatches,
                "dispatch_per_tenant": dict(self._dispatch_per_tenant),
                "dispatched_bytes_per_tenant": dict(self._dispatched_bytes_per_tenant),
                "tenant_quanta": dict(self._tenant_quanta),
                "deficit_per_tenant": {
                    t: q.deficit for t, q in self._queues.items() if len(q)
                },
                "cost_correction": {
                    "enabled": self.cost_correction,
                    "throughput_bps": (
                        round(self._throughput_ewma, 1)
                        if self._throughput_ewma is not None
                        else None
                    ),
                    "per_tenant": {
                        t: round(f, 4) for t, f in self._correction.items()
                    },
                },
            }

    def __enter__(self) -> "FairExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=False, cancel_futures=True)


class TenantExecutor:
    """ThreadPoolExecutor-shaped view binding one tenant id.

    This is what gets injected into `GzipChunkFetcher`: the fetcher keeps
    calling ``pool.submit(fn, *args)`` exactly as before, unaware that its
    tasks now compete fairly with every other reader's. Hint-aware callers
    use ``submit_hinted`` to declare byte cost and interactivity; its
    presence is feature-detected (``getattr``), so the same fetcher code
    also runs against a plain ThreadPoolExecutor.
    """

    def __init__(self, parent: FairExecutor, tenant: str):
        self._parent = parent
        self.tenant = tenant

    def submit(self, fn: Callable, *args: Any, **kwargs: Any) -> Future:
        return self._parent.submit(self.tenant, fn, *args, _view=self, **kwargs)

    def submit_hinted(
        self,
        fn: Callable,
        *args: Any,
        cost: Optional[int] = None,
        priority: bool = False,
        **kwargs: Any,
    ) -> Future:
        """submit() plus scheduling hints: estimated byte ``cost`` (DRR
        deficit charge) and ``priority`` (interactive lane, jumps this
        tenant's batch backlog only)."""
        return self._parent.submit(
            self.tenant, fn, *args, _view=self, _cost=cost, _priority=priority, **kwargs
        )

    def boost(self, fut: Future) -> bool:
        """Promote a queued task of this tenant to the priority lane (see
        FairExecutor.boost)."""
        return self._parent.boost(fut, tenant=self.tenant)

    def shutdown(self, wait: bool = True, cancel_futures: bool = False) -> None:
        # The shared pool is server-owned; a reader closing only drains its
        # own queued work.
        if cancel_futures:
            self._parent.cancel_view(self)

    def cancel_pending(self, *, batch_only: bool = False) -> int:
        """Cancel this view's queued tasks (fetcher shutdown hook); with
        ``batch_only`` only the prefetch backlog (gateway disconnects)."""
        return self._parent.cancel_view(self, batch_only=batch_only)
