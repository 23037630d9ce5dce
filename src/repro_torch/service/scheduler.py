"""Async submission tier: tenant-aware admission and cross-caller batch
formation for QueryService.

``QueryService.submit_many`` already fuses everything ONE caller hands it
— requests sharing a fingerprint dedup to one execution, and distinct
fingerprints whose op-graph DAGs overlap on content-addressed subplans
compile into one multi-query closure.  What it cannot do is fuse
across *callers*: a dashboard fleet where every client submits its own
single query gets N independent pipelines and N compiles.

``AsyncScheduler`` closes that gap with the classic batch-formation
pattern, made safe for many mutually-untrusting callers:

* ``submit_async(query, tenant=...) -> Future[QueryResult]`` admits the
  request into its tenant's bounded queue and returns immediately.
  Admission is per tenant: a token-bucket quota (``TenantPolicy.rate`` /
  ``burst``) and a queue-depth bound (``TenantPolicy.max_queue``), so one
  chatty tenant exhausts ITS budget, never the scheduler.  A rejected
  request raises ``TenantAdmissionError`` naming the tenant and whether
  the cause was ``"rate"`` or ``"depth"`` — backpressure the caller can
  see and retry — and a closed scheduler raises ``ServiceClosedError``
  (typed: it subclasses both ``AdmissionError`` and ``RuntimeError``).
  The default tenant has no quota and the scheduler-wide depth bound, so
  single-tenant callers see exactly the pre-tenant behaviour.
* A background batcher thread drains the queues on a window: it wakes on
  the first enqueue, then waits up to ``max_wait_ms`` for co-arriving
  requests (or until ``max_batch`` are pending across tenants).  The
  window is formed by **priority lanes + deficit round-robin**: lanes
  are served in ascending ``TenantPolicy.priority`` order, and within a
  lane each tenant's deficit grows by its ``weight`` per round and pays
  one unit per claimed request — weighted max-min fair sharing of every
  batch, with a tenant's unused deficit forfeited when its queue drains
  (no credit hoarding).  The whole window then flows through the
  engine's shared batch pipeline (``QueryService._serve_batch`` via
  ``submit_many``) in ONE call — so N *tenants* firing the same guarded
  dashboard still dedup, fuse, and share one compiled program, while
  quota accounting stayed per-tenant at admission.
* Results fan back out per request: each future resolves to its own
  ``QueryResult``, and a request whose admission/parse/serve failed gets
  ITS exception set on ITS future — batch-mates are never aborted (the
  engine's per-request fault isolation).  Every future resolution goes
  through ``_resolve`` (the cancel-race guard);
  ``tests/test_torch_service.py`` forbids any other
  ``set_result``/``set_exception`` in the service tier.

Observability: the scheduler books its counters (``async_requests``,
``async_batches``, ``rejected``, ``rejected_closed``) and the
``queue_depth`` gauge (total across tenants) straight into the service's
``Observability`` registry — ``queue_depth_peak`` is a PEAK GAUGE there.
Per-tenant counters (requests, rejections split by cause, fused share)
and request-latency histograms land under ``metrics_v2()["tenants"]``.
Each request's root ``TraceSpan`` is opened at enqueue (tagged with its
tenant) with a ``queue_wait`` child closed when the batcher claims it;
the formation window records a shared ``batch_form`` span.  Every root
is ended on EVERY exit path — served, close-drained, engine failure, or
service GC — with an error annotation on the abnormal ones, so latency
histograms and trace retention see exactly the failed requests too
(``Observability.open_requests()`` is the leak detector).

Latency/throughput trade-off: ``max_wait_ms`` is the most a lone request
waits for company; under load the window closes early at ``max_batch``,
so the added latency shrinks exactly when batching pays most.

On a mesh of more than one rank the window is rank 0's: its batcher forms
the batch on its own clock and announces what it claimed through the
service's lane (``mesh_sync.Lockstep``); every other rank's batcher,
once it has a request queued, claims for each of rank 0's requests, in
rank 0's order, its own earliest queued request with the same identity
(the SQL text or the canonical fingerprint), waiting for it to be
submitted if need be.  Every rank thus serves the same batches.  There
the depth bounds do not apply (the queue's depth at a submission is a
matter of timing, which differs between ranks).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import weakref
from concurrent.futures import Future, InvalidStateError
from typing import TYPE_CHECKING, Callable

from repro_torch.service.mesh_sync import WAIT_S, MeshDivergence
from repro_torch.service.observability import DEFAULT_TENANT, NULL_SPAN

if TYPE_CHECKING:  # import cycle guard: engine lazily imports this module
    from repro_torch.service.engine import QueryResult, QueryService


def _resolve(fut: Future, result=None, error: BaseException | None = None):
    """Set a future's outcome, tolerating a caller-side cancel race."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass  # the caller cancelled while we were serving — drop the answer


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Admission contract for one tenant.

    ``rate``      admitted requests/second through a token bucket (None =
                  unlimited; no clock is read for unlimited tenants).
    ``burst``     bucket capacity — the most that can be admitted at once
                  after idling (default: max(rate, 1)).
    ``max_queue`` pending-request bound for this tenant's queue (None =
                  the scheduler-wide ``max_queue``).
    ``weight``    deficit-round-robin share of every formed batch,
                  relative to the other tenants in the same lane.
    ``priority``  lane number; lower lanes are claimed first when a batch
                  forms (quotas, not priorities, bound a lane's intake).
    """

    rate: float | None = None
    burst: float | None = None
    max_queue: int | None = None
    weight: float = 1.0
    priority: int = 1

    def __post_init__(self):
        if self.rate is not None and self.rate <= 0:
            raise ValueError("rate must be > 0 (or None for unlimited)")
        if self.burst is not None and self.burst < 1:
            raise ValueError("burst must be >= 1 (or None for the default)")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        if self.weight <= 0:
            raise ValueError("weight must be > 0")


class _TokenBucket:
    """Classic token bucket over an injectable clock: ``burst`` capacity,
    ``rate`` tokens/second refill, one token per admission."""

    __slots__ = ("rate", "burst", "tokens", "last", "clock")

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float]):
        self.rate = rate
        self.burst = burst
        self.tokens = burst          # a fresh tenant may burst immediately
        self.clock = clock
        self.last = clock()

    def try_take(self, n: float = 1.0) -> bool:
        now = self.clock()
        self.tokens = min(self.burst, self.tokens + (now - self.last)
                          * self.rate)
        self.last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


@dataclasses.dataclass
class _Pending:
    """One admitted request waiting in its tenant's queue."""

    query: object
    fut: Future
    root: object                     # enqueue-time root TraceSpan
    qspan: object                    # open queue_wait child
    tenant: str
    ident: str | None = None         # what another rank matches it by
    seq: int = 0                     # this rank's submission number


@dataclasses.dataclass
class _TenantState:
    """One tenant's queue + quota + DRR bookkeeping."""

    name: str
    policy: TenantPolicy
    queue: collections.deque = dataclasses.field(
        default_factory=collections.deque)
    bucket: _TokenBucket | None = None
    deficit: float = 0.0


def _drr_claim(states: list[_TenantState], max_batch: int) -> list[_Pending]:
    """Claim up to ``max_batch`` requests: priority lanes in ascending
    order, deficit round-robin within a lane (quantum = ``weight`` per
    round, cost 1 per request).  A tenant whose queue drains forfeits its
    remaining deficit — leftover credit never hoards across idle periods
    — while a tenant cut off by a full batch keeps its deficit for the
    next window.  Pure queue/deficit manipulation (no locks, no clock):
    the unit under ``tests/test_multitenant.py``'s DRR-weight tests."""
    batch: list[_Pending] = []
    lanes: dict[int, list[_TenantState]] = {}
    for st in states:
        if st.queue:
            lanes.setdefault(st.policy.priority, []).append(st)
    for prio in sorted(lanes):
        active = collections.deque(lanes[prio])
        while active and len(batch) < max_batch:
            st = active.popleft()
            st.deficit += st.policy.weight
            while st.queue and st.deficit >= 1.0 and len(batch) < max_batch:
                batch.append(st.queue.popleft())
                st.deficit -= 1.0
            if st.queue:
                active.append(st)
            else:
                st.deficit = 0.0
    return batch


class AsyncScheduler:
    """Background batcher turning independent ``submit_async`` callers —
    across tenants — into fused ``submit_many`` batches.  See the module
    docstring."""

    def __init__(self, service: QueryService, *, max_batch: int = 64,
                 max_wait_ms: float = 2.0, max_queue: int = 1024,
                 tenants: dict[str, TenantPolicy] | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        # weak: the service owns the scheduler, never the reverse.  The
        # batcher thread references only this object, so an IDLE dropped
        # service (tables, caches, executables and all) stays collectable
        # even if the owner forgot to call close() — the idle heartbeat
        # below notices the dead ref and lets the thread exit.  While
        # requests are pending, ``_keepalive`` pins the service so
        # in-flight futures always get served.
        self._service_ref = weakref.ref(service)
        self._keepalive: QueryService | None = None
        # strong on purpose: the registry never references the service,
        # so pinning it keeps counters/spans working without keeping the
        # service (tables, caches, executables) alive
        self._obs = service.obs
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1e3
        self._max_queue = max_queue
        # declared tenant policies; a tenant first seen at submit time
        # gets the default policy (unlimited, weight 1, shared depth
        # bound) — "millions of callers" must not need pre-registration
        self._policies = dict(tenants) if tenants else {}
        for name, pol in self._policies.items():
            if not isinstance(pol, TenantPolicy):
                raise TypeError(f"tenants[{name!r}] must be a TenantPolicy")
        self._states: dict[str, _TenantState] = {}
        # a mesh of more than one rank: rank 0's claims rule (see the
        # module docstring); None otherwise
        sync = service._sync
        self._lockstep = sync if sync is not None and sync.world > 1 \
            else None
        self._cv = threading.Condition()
        self._submitted = 0              # numbers requests as submitted
        self._closed = False
        self._thread = threading.Thread(target=self._drain_loop,
                                        name="query-service-batcher",
                                        daemon=True)
        self._thread.start()

    # ---- caller side -----------------------------------------------------
    def _tenant_state(self, tenant: str) -> _TenantState:
        """The tenant's queue/quota state, created on first touch.
        Caller holds ``_cv``."""
        st = self._states.get(tenant)
        if st is None:
            pol = self._policies.get(tenant, TenantPolicy())
            bucket = None
            if pol.rate is not None:
                burst = pol.burst if pol.burst is not None \
                    else max(pol.rate, 1.0)
                # the injectable Observability clock, so quota-refill unit
                # tests drive a fake clock (real deployments tick
                # perf_counter either way)
                bucket = _TokenBucket(pol.rate, burst, self._obs.clock)
            st = self._states[tenant] = _TenantState(tenant, pol,
                                                     bucket=bucket)
        return st

    def _depth_locked(self) -> int:
        return sum(len(st.queue) for st in self._states.values())

    def submit_async(self, query, *, tenant: str | None = None,
                     ident: str | None = None) -> Future[QueryResult]:
        """Admit one query into its tenant's queue; returns its future.
        Raises ``TenantAdmissionError`` when the tenant is over its
        queue-depth bound or token-bucket rate, ``ServiceClosedError``
        after ``close()``.  ``ident`` is the query's identity on a mesh of
        more than one rank."""
        from repro_torch.service.engine import (ServiceClosedError,
                                          TenantAdmissionError)
        tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        fut: Future = Future()
        with self._cv:
            if self._closed:
                self._obs.inc("rejected_closed")
                self._obs.tenant_inc(tenant, "rejected_closed")
                raise ServiceClosedError(
                    "scheduler is closed; the async tier is stopped "
                    "(sync submit still works)")
            st = self._tenant_state(tenant)
            cap = st.policy.max_queue if st.policy.max_queue is not None \
                else self._max_queue
            if self._lockstep is None and len(st.queue) >= cap:
                self._obs.inc("rejected")
                self._obs.tenant_inc(tenant, "rejected_depth")
                raise TenantAdmissionError(
                    tenant, "depth",
                    f"tenant {tenant!r} admission queue full ({cap} "
                    "requests pending); backpressure — retry later")
            if st.bucket is not None and not st.bucket.try_take():
                self._obs.inc("rejected")
                self._obs.tenant_inc(tenant, "rejected_rate")
                raise TenantAdmissionError(
                    tenant, "rate",
                    f"tenant {tenant!r} over its admission rate "
                    f"({st.policy.rate:g}/s, burst {st.bucket.burst:g}); "
                    "backpressure — retry later")
            # the request's trace starts HERE: queue time is part of its
            # latency, so the root opens at enqueue and the engine ends it
            # (the scheduler hands the root through submit_many(_traces=))
            root = self._obs.begin_request(via="async", tenant=tenant)
            qspan = self._obs.open_span(root, "queue_wait")
            self._submitted += 1
            st.queue.append(_Pending(query, fut, root, qspan, tenant,
                                     ident, self._submitted))
            self._keepalive = self._service_ref()  # pin while work pends
            self._obs.inc("async_requests")
            self._obs.set_gauge("queue_depth", self._depth_locked())
            self._cv.notify_all()
        return fut

    def metrics(self) -> dict[str, int]:
        """Deprecated thin view over the shared registry (the engine's
        ``metrics()``/``metrics_v2()`` are the real read path).  NOTE:
        reading snapshots the registry, so it resets peak gauges just as
        the engine's ``metrics()`` does."""
        snap = self._obs.snapshot()
        c, g = snap["counters"], snap["gauges"]
        return {"async_requests": c.get("async_requests", 0),
                "async_batches": c.get("async_batches", 0),
                "rejected": c.get("rejected", 0),
                "rejected_closed": c.get("rejected_closed", 0),
                "queue_depth": g.get("queue_depth", 0),
                "queue_depth_peak": g.get("queue_depth_peak", 0)}

    def close(self, timeout: float | None = 10.0) -> None:
        """Stop the batcher.  Requests already queued are drained and
        answered first; anything still pending after `timeout` fails with
        ``ServiceClosedError`` — future resolved AND root span ended, so
        nothing leaks from the trace registry."""
        from repro_torch.service.engine import ServiceClosedError
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)
        with self._cv:
            leftovers: list[_Pending] = []
            for st in self._states.values():
                leftovers.extend(st.queue)
                st.queue.clear()
            self._obs.set_gauge("queue_depth", 0)
        for p in leftovers:          # join timed out mid-drain
            err = ServiceClosedError("scheduler closed before the request "
                                     "could be served")
            self._obs.inc("rejected_closed")
            self._obs.tenant_inc(p.tenant, "rejected_closed")
            self._end_root(p, err)
            _resolve(p.fut, error=err)

    # ---- batcher side ----------------------------------------------------
    def _end_root(self, p: _Pending, error: BaseException) -> None:
        """End an admitted request's root on an abnormal exit path (close
        drain, dead service, whole-batch engine failure).  The normal
        path ends roots in ``submit_many``; this one closes the still-open
        ``queue_wait`` child (if any), annotates the error, and records
        the root so failed requests are visible in latency histograms and
        trace retention instead of leaking open forever."""
        root, qspan = p.root, p.qspan
        if root is NULL_SPAN or root.closed:
            return
        if qspan is not NULL_SPAN and not qspan.closed:
            self._obs.close_span(qspan)
        root.note(error=type(error).__name__)
        self._obs.end_request(root, tenant=p.tenant)

    def _drain_loop(self) -> None:
        while True:
            try:
                batch = self._next_batch()
            except MeshDivergence as e:
                # the ranks' claims parted: nothing queued can be served in
                # step any more, so every queued request fails with the cause
                with self._cv:
                    batch = [p for st in self._states.values()
                             for p in st.queue]
                    for st in self._states.values():
                        st.queue.clear()
                    self._obs.set_gauge("queue_depth", 0)
                for p in batch:
                    self._end_root(p, e)
                    _resolve(p.fut, error=e)
                continue
            if batch is None:
                return
            try:
                self._serve(batch)
            finally:
                with self._cv:
                    if not self._depth_locked():  # idle: unpin the service
                        self._keepalive = None

    def _next_batch(self) -> list[_Pending] | None:
        """Block until work arrives, hold the formation window open, then
        claim up to ``max_batch`` requests across tenant queues (priority
        lanes, DRR within a lane).  None means closed + drained (or the
        owning service was garbage-collected)."""
        with self._cv:
            while not self._depth_locked():
                if self._closed or self._service_ref() is None:
                    return None
                # bounded wait: the heartbeat re-checks service liveness
                self._cv.wait(timeout=1.0)
            follow = self._lockstep is not None and self._lockstep.rank != 0
        if follow:
            bspan = self._obs.open_span(None, "batch_form")
            batch = self._lockstep.run("async_claim", self._claim_named)
        else:
            bspan, batch = self._form_window()
            if self._lockstep is not None:
                # announce the claim: the other ranks claim the same
                try:
                    self._lockstep.run("async_claim", lambda _: None,
                                       payload=[p.ident for p in batch])
                except MeshDivergence as e:
                    for p in batch:
                        self._end_root(p, e)
                        _resolve(p.fut, error=e)
                    raise
        # annotate BEFORE closing: close_span folds the span into
        # histograms/export, and a closed span rejects late notes
        bspan.note(claimed=len(batch),
                   tenants=len({p.tenant for p in batch}))
        self._obs.close_span(bspan)
        for p in batch:
            # queue time ends when the batcher claims the request; the
            # shared formation window rides along INSIDE every member's
            # queue_wait (it overlaps the wait, so attaching it to the
            # request root would break root ≥ Σ direct children)
            self._obs.close_span(p.qspan)
            if bspan is not NULL_SPAN and p.qspan is not NULL_SPAN:
                p.qspan.children.append(bspan)
        return batch

    def _form_window(self):
        """Hold the formation window open, then claim (priority lanes,
        DRR within a lane).  Returns (the window's span, the batch)."""
        with self._cv:
            # formation window: wait for co-arriving callers (skipped when
            # the queue is already a full batch, or on shutdown).
            # time.monotonic (not the injectable obs clock) on purpose:
            # this is a REAL-TIME wait bound for Condition.wait, and a
            # test-injected fake clock must not be able to hang the window
            bspan = self._obs.open_span(None, "batch_form")
            deadline = time.monotonic() + self._max_wait_s
            while self._depth_locked() < self._max_batch \
                    and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            batch = _drr_claim(list(self._states.values()), self._max_batch)
            self._obs.set_gauge("queue_depth", self._depth_locked())
            self._obs.inc("async_batches")
        return bspan, batch

    def _claim_named(self, idents: list) -> list[_Pending]:
        """On a rank other than 0, inside the lane's claim step: for each
        identity rank 0 claimed, in its order, this rank's earliest queued
        request with that identity (waiting for it to be submitted)."""
        def earliest(ident):
            found = [(p.seq, st, p) for st in self._states.values()
                     for p in st.queue if p.ident == ident]
            return min(found, key=lambda f: f[0])[1:] if found else None

        batch = []
        with self._cv:
            for ident in idents:
                if not self._cv.wait_for(lambda: earliest(ident) is not None,
                                         WAIT_S):
                    raise MeshDivergence(
                        "rank 0 claimed a request this rank was not given "
                        f"within {WAIT_S:g} s")
                st, p = earliest(ident)
                st.queue.remove(p)
                batch.append(p)
            self._obs.set_gauge("queue_depth", self._depth_locked())
            self._obs.inc("async_batches")
        return batch

    def _serve(self, batch: list[_Pending]) -> None:
        """One shared pipeline run for the whole window; per-request
        fan-out of answers and captured errors onto the futures."""
        from repro_torch.service.engine import ServiceClosedError
        service = self._service_ref()
        if service is None:
            err = ServiceClosedError(
                "QueryService was garbage-collected before the request "
                "could be served")
            for p in batch:
                self._end_root(p, err)
                _resolve(p.fut, error=err)
            return
        try:
            # hand the enqueue-time roots + tenants over through the
            # thread-local (not a kwarg: submit_many's public signature
            # stays wrappable); submit_many consumes it on this thread
            service._trace_handoff.traces = [p.root for p in batch]
            service._trace_handoff.tenants = [p.tenant for p in batch]
            results = service.submit_many([p.query for p in batch])
        except BaseException as e:  # engine bug — fail loudly, hang nobody
            service._trace_handoff.traces = None
            service._trace_handoff.tenants = None
            for p in batch:
                self._end_root(p, e)
                _resolve(p.fut, error=e)
            return
        for p, res in zip(batch, results):
            if res.error is not None:
                _resolve(p.fut, error=res.error)
            else:
                _resolve(p.fut, result=res)
