"""Per-tenant admission control for the gateway front-end.

The bridge pool behind `AsyncArchiveServer` is a finite resource: without a
front-door limiter, one tenant issuing cold first-pass reads (each occupying
a bridge thread for the whole speculative pass) monopolizes it and every
other tenant's first byte waits behind the scan. `TenantAdmission` bounds
each tenant *before* any bridge thread is touched:

  * up to ``max_in_flight`` requests per tenant proceed concurrently;
  * up to ``max_queued`` more wait (FIFO within the tenant, asyncio-native
    — a waiting request costs a coroutine, never a thread);
  * anything beyond is refused immediately with `AdmissionDenied`, which
    the gateway answers ``429 Too Many Requests`` + ``Retry-After`` — the
    client-visible backpressure signal (`core.remote.RemoteFileReader`
    already treats 429 as retryable with exponential backoff, so chained
    gateways degrade gracefully).

Identity is bearer-token based: ``Authorization: Bearer <token>`` maps to a
tenant via the ``tokens`` table. Unknown tokens are rejected; requests with
no token land on ``default_tenant`` (set it to None to require auth). The
tenant id flows through to every backing budget — FairExecutor DRR queues,
CachePool shares, and the optional per-tenant ``quanta`` factors the
gateway applies at open time (paying tenants get a larger quantum).

Concurrency slots bound *threads*; they do not bound *bytes* — a tenant
streaming one enormous body per slot saturates the egress path while
staying under every count. ``charge_bytes`` closes that hole with a
per-tenant token bucket over bytes streamed (``byte_rate`` bytes/second,
``byte_burst`` bucket depth): the gateway charges the whole response span
up front, before any header goes out. The bucket allows overdraft — a
tenant with a positive balance may start a response larger than the
remaining tokens (otherwise no span above the burst could ever be served)
— and then answers 429 until the deficit refills, so the long-run average
never exceeds the configured rate.

Thread-model: ``resolve`` is pure; ``acquire``/``release``/``charge_bytes``
run only on the gateway's event loop (single thread, so counters need no
lock — release is deliberately synchronous and hands its slot directly to
the eldest live waiter, which makes it safe to call from a ``finally``
while the handler task is being cancelled); ``snapshot`` may be called from
any thread (int reads are telemetry snapshots, not barriers).
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, Optional, Tuple

from ...obs import hist as _obs_hist


class AdmissionDenied(Exception):
    """Tenant over in-flight + queue-depth budget; retry after a delay."""

    def __init__(self, tenant: str, retry_after: float, reason: str):
        super().__init__("tenant %r %s" % (tenant, reason))
        self.tenant = tenant
        self.retry_after = retry_after


class Unauthorized(Exception):
    """Missing or unknown bearer token (gateway answers 401)."""


@dataclass
class TenantLimit:
    max_in_flight: int = 2
    max_queued: int = 4
    #: bytes/second this tenant may stream (None inherits the admission
    #: default; the default's None means unlimited).
    byte_rate: Optional[float] = None
    #: token-bucket depth in bytes (None: 2 seconds of byte_rate).
    byte_burst: Optional[int] = None


class _Gate:
    __slots__ = (
        "in_flight", "waiting", "waiters", "admitted", "rejected", "waited",
        "byte_tokens", "byte_refilled_at", "bytes_charged", "bytes_rejected",
    )

    def __init__(self) -> None:
        self.in_flight = 0
        self.waiting = 0  # live waiters (maintained by acquire's finally)
        self.waiters: Deque[asyncio.Future] = deque()
        self.admitted = 0
        self.rejected = 0
        self.waited = 0  # admissions that had to queue first
        # Byte token bucket: lazily primed to the full burst on first
        # charge (byte_refilled_at None = never charged).
        self.byte_tokens = 0.0
        self.byte_refilled_at: Optional[float] = None
        self.bytes_charged = 0
        self.bytes_rejected = 0


class TenantAdmission:
    def __init__(
        self,
        *,
        tokens: Optional[Dict[str, str]] = None,
        default_tenant: Optional[str] = "public",
        max_in_flight: int = 2,
        max_queued: int = 4,
        retry_after: float = 0.5,
        byte_rate: Optional[float] = None,
        byte_burst: Optional[int] = None,
        limits: Optional[Dict[str, TenantLimit]] = None,
        quanta: Optional[Dict[str, float]] = None,
    ):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if max_queued < 0:
            raise ValueError("max_queued must be >= 0")
        if byte_rate is not None and byte_rate <= 0:
            raise ValueError("byte_rate must be positive (None = unlimited)")
        self.tokens = dict(tokens or {})
        self.default_tenant = default_tenant
        self.default_limit = TenantLimit(max_in_flight, max_queued)
        self.retry_after = retry_after
        self.byte_rate = byte_rate
        self.byte_burst = byte_burst
        self.limits = dict(limits or {})
        #: per-tenant weighted-DRR quantum factors, applied by the gateway
        #: via ``ArchiveServer.open(..., quantum=...)`` at open time.
        self.quanta = dict(quanta or {})
        # Guards _gates insertion and snapshot(): gates are created on the
        # loop but snapshots are read from arbitrary telemetry threads.
        self._gates_lock = threading.Lock()
        self._gates: Dict[str, _Gate] = {}

    # -- identity -----------------------------------------------------------

    def resolve(self, authorization: Optional[str]) -> str:
        """Tenant id for an ``Authorization`` header value (or None)."""
        if authorization:
            scheme, _, token = authorization.strip().partition(" ")
            if scheme.lower() != "bearer" or not token.strip():
                raise Unauthorized("unsupported Authorization scheme")
            tenant = self.tokens.get(token.strip())
            if tenant is None:
                raise Unauthorized("unknown bearer token")
            return tenant
        if self.default_tenant is None:
            raise Unauthorized("missing bearer token")
        return self.default_tenant

    def quantum_for(self, tenant: str) -> Optional[float]:
        return self.quanta.get(tenant)

    # -- gating -------------------------------------------------------------

    def _gate(self, tenant: str) -> _Gate:
        gate = self._gates.get(tenant)
        if gate is None:
            with self._gates_lock:
                gate = self._gates.setdefault(tenant, _Gate())
        return gate

    def _limit(self, tenant: str) -> Tuple[int, int]:
        lim = self.limits.get(tenant, self.default_limit)
        return lim.max_in_flight, lim.max_queued

    def _byte_limit(self, tenant: str) -> Tuple[Optional[float], float]:
        lim = self.limits.get(tenant)
        rate = lim.byte_rate if lim is not None and lim.byte_rate is not None else self.byte_rate
        if rate is None:
            return None, 0.0
        burst = lim.byte_burst if lim is not None and lim.byte_burst is not None else self.byte_burst
        if burst is None:
            burst = 2.0 * rate  # two seconds of line rate
        return rate, max(float(burst), 1.0)

    async def acquire(self, tenant: str) -> None:
        """Admit one request for ``tenant``: immediate when under the
        in-flight budget, bounded FIFO wait when under the queue budget,
        `AdmissionDenied` beyond that."""
        gate = self._gate(tenant)
        max_in_flight, max_queued = self._limit(tenant)
        if gate.in_flight < max_in_flight and gate.waiting == 0:
            gate.in_flight += 1
            gate.admitted += 1
            return
        if gate.waiting >= max_queued:
            gate.rejected += 1
            raise AdmissionDenied(
                tenant,
                self.retry_after,
                "over budget (%d in flight, %d queued)"
                % (gate.in_flight, gate.waiting),
            )
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        gate.waiters.append(fut)
        gate.waiting += 1
        t_wait = time.perf_counter()
        try:
            # release() resolves the future *with the slot already
            # transferred* (in_flight stays constant across the handoff), so
            # a resolved wait needs no re-check and a cancelled wait never
            # holds a slot.
            await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # Lost race: release() handed us the slot, then our task was
                # cancelled before resuming — the handler's finally will
                # never run for us, so give the slot back here or the
                # tenant's capacity shrinks permanently.
                self.release(tenant)
            raise
        finally:
            gate.waiting -= 1
            # Only queued admissions land here; the fast path is untimed
            # (the gateway's gateway.admission_wait timer covers both).
            _obs_hist.observe("admission.queue_wait", time.perf_counter() - t_wait)

    def release(self, tenant: str) -> None:
        """Return one slot: hand it to the eldest live waiter, else free it.

        Synchronous on purpose — handler ``finally`` blocks call this while
        their task is being cancelled, where a fresh ``await`` could be
        interrupted and leak the slot forever.
        """
        gate = self._gate(tenant)
        while gate.waiters:
            fut = gate.waiters.popleft()
            if not fut.done():
                gate.admitted += 1
                gate.waited += 1
                fut.set_result(None)  # slot transferred, in_flight unchanged
                return
        gate.in_flight = max(0, gate.in_flight - 1)

    def charge_bytes(self, tenant: str, nbytes: int, *, now: Optional[float] = None) -> None:
        """Debit ``nbytes`` from the tenant's byte bucket or refuse the
        response.

        Called by the gateway with the full response span *before* any
        header is written (so a refusal can still become a clean 429).
        Overdraft semantics: a tenant whose balance is positive is always
        admitted — even for a span larger than the balance or the burst —
        and the balance goes negative; further charges are refused with
        `AdmissionDenied` carrying the exact refill delay until the balance
        is positive again. Loop-thread-only, like ``acquire``. ``now`` is a
        monotonic-clock override for deterministic tests.
        """
        rate, burst = self._byte_limit(tenant)
        gate = self._gate(tenant)
        if rate is None:
            gate.bytes_charged += max(0, nbytes)
            return
        if now is None:
            now = time.monotonic()
        if gate.byte_refilled_at is None:
            gate.byte_tokens = burst  # first charge: full bucket
        else:
            elapsed = max(0.0, now - gate.byte_refilled_at)
            gate.byte_tokens = min(burst, gate.byte_tokens + elapsed * rate)
        gate.byte_refilled_at = now
        if gate.byte_tokens <= 0.0:
            gate.bytes_rejected += max(0, nbytes)
            retry = max(-gate.byte_tokens / rate, 0.001)
            raise AdmissionDenied(
                tenant,
                retry,
                "over byte rate (%.0f B/s, %.0f B in deficit)"
                % (rate, -gate.byte_tokens),
            )
        gate.byte_tokens -= max(0, nbytes)
        gate.bytes_charged += max(0, nbytes)

    # -- telemetry ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        # Copy the registry under the lock, then read plain ints only —
        # never iterate a gate's waiters deque, which the loop thread
        # mutates concurrently.
        with self._gates_lock:
            gates = dict(self._gates)
        return {
            tenant: {
                "in_flight": g.in_flight,
                "waiting": g.waiting,
                "admitted": g.admitted,
                "rejected": g.rejected,
                "waited": g.waited,
                "bytes_charged": g.bytes_charged,
                "bytes_rejected": g.bytes_rejected,
                "byte_tokens": round(g.byte_tokens, 1),
            }
            for tenant, g in gates.items()
        }
