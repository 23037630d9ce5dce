"""Tracing + metrics subsystem for the serving tier.

The paper's argument is a *measured* one — guardedness wins because
materialisation cost dominates — so the serving tier built on top of it
has to be measurable too.  This module is the single timing source for
``repro_torch.service``: every request carries a ``TraceSpan`` tree (admit →
queue-wait → fingerprint → plan → pad → compile → run), spans aggregate
into streaming log-bucketed latency histograms, and everything is read
back through one consistent snapshot.

Design constraints, in order:

* **Lock-cheap.**  One small lock guards counters/gauges/histograms;
  it is held only for O(1) dict/array updates, never across planning,
  padding, compiles, or execution.  Snapshots are taken under the same
  single lock, so counter invariants that hold in program order
  (``fused_queries`` bumps always follow the ``requests`` bump that
  admitted them) also hold in every snapshot — the cure for the
  three-locks-three-tearings ``metrics()`` that one lock per level gave.
* **No per-request allocation on the warm hot path** for aggregation:
  histograms are fixed log-spaced bucket arrays (8 buckets/decade from
  1 µs to 100 s); recording is a bisect + an integer increment.  Spans
  do allocate (one small object each) — they are the *trace*, bounded
  by ``max_traces`` completed request trees kept for export.
* **Injectable clock.**  Everything times through ``self.clock``
  (default ``time.perf_counter``), so tests drive a fake clock and the
  tests can forbid raw ``perf_counter`` calls elsewhere under
  ``src/repro_torch/service/`` (``tests/test_torch_service.py``).
* **Disableable.**  ``enabled=False`` replaces every span with a shared
  no-op singleton: no clock reads, no tree, no histogram traffic —
  the baseline the ≤ 3 % tracing-overhead gate compares against.
  Counters and gauges keep working either way (cache-hit accounting is
  correctness bookkeeping, not observability sugar).

Export surfaces:

* ``snapshot()``          — ``{"counters", "gauges", "histograms"}``
  (the structured ``metrics()`` v2 the engine exposes);
* ``export_chrome_trace(path)`` — Chrome-trace/Perfetto JSON of the
  retained request trees (open ``chrome://tracing`` or
  https://ui.perfetto.dev and load the file); spans shared by several
  requests (one fused compile serving a whole dashboard) are emitted
  exactly once.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time
from typing import Any, Callable, Iterable

# The one sanctioned monotonic time source for the serving tier
# (tests/test_torch_service.py forbids raw time.perf_counter elsewhere in
# src/repro_torch/service/).
MONOTONIC: Callable[[], float] = time.perf_counter

# The tenant every request belongs to unless the caller says otherwise.
# Single-tenant deployments never have to mention tenants at all: the
# default tenant has no quota, weight 1, and the scheduler-wide queue
# bound, so pre-multi-tenant behaviour is preserved exactly.
DEFAULT_TENANT = "default"


def _strict_spans() -> bool:
    """Whether span-lifecycle misuse should raise instead of passing
    silently.  On under pytest (so a ``note()`` on a closed span is a
    loud test failure, not a silently-dropped Chrome-trace annotation);
    REPRO_STRICT_SPANS=0/1 overrides either way."""
    flag = os.environ.get("REPRO_STRICT_SPANS")
    if flag is not None:
        return flag not in ("", "0", "false", "no")
    return "PYTEST_CURRENT_TEST" in os.environ

# Log-spaced bucket upper bounds (seconds): 8 per decade, 1 µs … 100 s.
# Built once at import; every histogram shares the tuple, so a warmed
# service allocates nothing per observation.
_BUCKET_BOUNDS: tuple[float, ...] = tuple(
    10.0 ** (-6.0 + i / 8.0) for i in range(0, 8 * 8 + 1))


class Histogram:
    """Streaming latency histogram over fixed log-spaced buckets.

    ``record`` is a bisect + increment (no allocation); percentiles are
    estimated as the upper bound of the bucket containing the requested
    rank — an overestimate by at most one bucket width (~33 %/bucket at
    8 buckets per decade), which is the standard monitoring trade-off.
    Not thread-safe on its own: ``Observability`` serialises access.
    """

    __slots__ = ("counts", "count", "sum_s", "max_s")

    def __init__(self):
        self.counts = [0] * (len(_BUCKET_BOUNDS) + 1)  # +1: overflow
        self.count = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def record(self, seconds: float) -> None:
        self.counts[bisect.bisect_left(_BUCKET_BOUNDS, seconds)] += 1
        self.count += 1
        self.sum_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def percentile(self, q: float) -> float:
        """Upper-bound estimate of the q-quantile (q in [0, 1])."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return _BUCKET_BOUNDS[i] if i < len(_BUCKET_BOUNDS) \
                    else self.max_s
        return self.max_s

    def snapshot(self) -> dict[str, Any]:
        """JSON-able summary: count/sum/max, p50/p95/p99, and the
        non-empty buckets as (upper_bound_s, count) pairs."""
        return {
            "count": self.count,
            "sum_s": self.sum_s,
            "max_s": self.max_s,
            "p50_s": self.percentile(0.50),
            "p95_s": self.percentile(0.95),
            "p99_s": self.percentile(0.99),
            "buckets": [
                (_BUCKET_BOUNDS[i] if i < len(_BUCKET_BOUNDS) else None, c)
                for i, c in enumerate(self.counts) if c],
        }


class TraceSpan:
    """One timed interval in a request's trace tree.

    Spans are created open (``t1 < 0``) and closed by ``Observability``;
    a span may be attached as a child of SEVERAL roots — that is how a
    fused batch records exactly one compile span shared by all members
    (the export dedups by object identity, so it renders once).
    """

    __slots__ = ("name", "t0", "t1", "tid", "args", "children")

    def __init__(self, name: str, t0: float, tid: int,
                 args: dict | None = None):
        self.name = name
        self.t0 = t0
        self.t1 = -1.0
        self.tid = tid
        self.args = args if args is not None else {}
        self.children: list[TraceSpan] = []

    @property
    def closed(self) -> bool:
        return self.t1 >= 0.0

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t1 - self.t0) if self.closed else 0.0

    def note(self, **kv) -> None:
        """Attach key/value annotations (rendered as Chrome-trace args).
        Must happen while the span is open: ``close_span`` folds the span
        into histograms and (for roots) the export retention, so a late
        note races the reader.  Under tests a late note raises."""
        if self.closed and _strict_spans():
            raise RuntimeError(
                f"note() on closed span {self.name!r} ({kv!r}) — annotate "
                "before close_span/end_request")
        self.args.update(kv)

    def child_duration(self, name: str) -> float:
        """Total closed duration of direct children called `name`."""
        return sum(c.duration_s for c in self.children
                   if c.name == name and c.closed)

    def walk(self) -> Iterable["TraceSpan"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self):  # pragma: no cover - debugging sugar
        state = f"{self.duration_s * 1e3:.3f}ms" if self.closed else "open"
        return f"TraceSpan({self.name!r}, {state}, {len(self.children)} kids)"


class _NullSpan:
    """Shared no-op span: what every tracing call returns when tracing is
    disabled.  Deliberately inert — no clock reads, no children, notes
    dropped — so the disabled service is the overhead baseline."""

    __slots__ = ()
    name = ""
    t0 = 0.0
    t1 = 0.0
    tid = 0
    closed = True
    duration_s = 0.0
    children: tuple = ()
    args: dict = {}

    def note(self, **kv) -> None:
        pass

    def child_duration(self, name: str) -> float:
        return 0.0

    def walk(self):
        return iter(())


NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context-manager wrapper for open_span/close_span pairs."""

    __slots__ = ("_obs", "span")

    def __init__(self, obs: "Observability", span):
        self._obs = obs
        self.span = span

    def __enter__(self):
        return self.span

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and self.span is not NULL_SPAN:
            self.span.note(error=exc_type.__name__)
        self._obs.close_span(self.span)
        return False


class Observability:
    """Counters + gauges + histograms + bounded trace retention, all
    behind one lock.  See the module docstring for the contract."""

    def __init__(self, clock: Callable[[], float] | None = None, *,
                 enabled: bool = True, max_traces: int = 512):
        self.clock = clock if clock is not None else MONOTONIC
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: dict[str, int | float] = {}
        self._gauges: dict[str, int | float] = {}
        # peak gauge name -> source gauge name; reset-to-current on read
        self._peaks: dict[str, str] = {}
        self._peak_values: dict[str, int | float] = {}
        self._hists: dict[str, Histogram] = {}
        self._traces: collections.deque[TraceSpan] = \
            collections.deque(maxlen=max_traces)
        # per-tenant accounting: counters (requests/errors/fused/
        # rejected_*) and a request-latency histogram per tenant.  Kept
        # separate from the flat counter namespace so tenant names can
        # never collide with service counters.
        self._tenant_counters: dict[str, dict[str, int | float]] = {}
        self._tenant_hists: dict[str, Histogram] = {}
        # roots opened via begin_request but not yet ended — the span-leak
        # detector: a request that dies on an abnormal path MUST still be
        # ended, so this reads 0 whenever the service is idle.
        self._open_requests = 0

    # ---- counters / gauges ----------------------------------------------
    def register_counters(self, names: Iterable[str]) -> None:
        """Pre-declare counters so they appear as 0 in every snapshot
        (metrics keys must exist before the first event — e.g. the async
        tier's counters before the scheduler lazily starts)."""
        with self._lock:
            for n in names:
                self._counters.setdefault(n, 0)

    def inc(self, name: str, n: int | float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int | float:
        with self._lock:
            return self._counters.get(name, 0)

    def tenant_inc(self, tenant: str, name: str, n: int | float = 1) -> None:
        """Bump a per-tenant counter (requests/errors/fused/rejected_*).
        Tenants materialise in ``snapshot()["tenants"]`` on first touch."""
        with self._lock:
            d = self._tenant_counters.setdefault(tenant, {})
            d[name] = d.get(name, 0) + n

    def tenant_counter(self, tenant: str, name: str) -> int | float:
        with self._lock:
            return self._tenant_counters.get(tenant, {}).get(name, 0)

    def open_requests(self) -> int:
        """Roots opened via ``begin_request`` but not yet ended — 0 on an
        idle service; anything else is a span leak."""
        with self._lock:
            return self._open_requests

    def set_gauge(self, name: str, value: int | float) -> None:
        """Set a gauge; any peak gauge tracking it ratchets up with it."""
        with self._lock:
            self._gauges[name] = value
            for peak, source in self._peaks.items():
                if source == name and value > self._peak_values.get(peak, 0):
                    self._peak_values[peak] = value

    def register_peak_gauge(self, name: str, source: str) -> None:
        """`name` reports the max value `source` reached since the last
        snapshot (and at least its current value) — a resettable
        high-water mark, not a forever-high counter."""
        with self._lock:
            self._peaks[name] = source
            self._peak_values.setdefault(name, self._gauges.get(source, 0))
            self._gauges.setdefault(source, 0)

    # ---- spans -----------------------------------------------------------
    def begin_request(self, name: str = "request", *, tenant: str | None
                      = None, **args) -> TraceSpan:
        """Open a trace root.  Close with ``end_request``.  ``tenant``
        stamps the owning tenant onto the root's args (visible in the
        Chrome-trace export) — pass the same tenant to ``end_request`` to
        land the latency in that tenant's histogram."""
        if not self.enabled:
            return NULL_SPAN
        if tenant is not None:
            args["tenant"] = tenant
        with self._lock:
            self._open_requests += 1
        return TraceSpan(name, self.clock(), threading.get_ident(), args)

    def end_request(self, root: TraceSpan, *, tenant: str | None = None) \
            -> None:
        """Close a root, record its latency histogram (and the tenant's,
        when given), retain the tree for export."""
        if root is NULL_SPAN or root.closed:
            return
        root.t1 = self.clock()
        with self._lock:
            self._open_requests -= 1
            self._observe_locked(root.name, root.duration_s)
            if tenant is not None:
                h = self._tenant_hists.get(tenant)
                if h is None:
                    h = self._tenant_hists[tenant] = Histogram()
                h.record(root.duration_s)
            self._traces.append(root)

    def open_span(self, parents, name: str, **args) -> TraceSpan:
        """Open a child span attached to one or many parent spans (many =
        a span shared by every member of a fused batch).  ``parents`` may
        be a span, an iterable of spans, or None (detached)."""
        if not self.enabled:
            return NULL_SPAN
        span = TraceSpan(name, self.clock(), threading.get_ident(), args)
        if parents is None:
            parents = ()
        elif isinstance(parents, (TraceSpan, _NullSpan)):
            parents = (parents,)
        seen: set[int] = set()
        for p in parents:
            if p is not NULL_SPAN and id(p) not in seen:
                seen.add(id(p))
                p.children.append(span)
        return span

    def close_span(self, span: TraceSpan) -> float:
        """Close a span and fold its duration into the stage histogram.
        Returns the duration (0.0 for the null span)."""
        if span is NULL_SPAN:
            return 0.0
        if not span.closed:
            span.t1 = self.clock()
        dur = span.duration_s
        with self._lock:
            self._observe_locked(span.name, dur)
        return dur

    def span(self, parents, name: str, **args) -> _SpanCtx:
        """``with obs.span(root, "plan") as sp: ...`` — open/close pair."""
        return _SpanCtx(self, self.open_span(parents, name, **args))

    def observe(self, stage: str, seconds: float) -> None:
        """Record a duration into a stage histogram without a span."""
        if not self.enabled:
            return
        with self._lock:
            self._observe_locked(stage, seconds)

    def _observe_locked(self, stage: str, seconds: float) -> None:
        h = self._hists.get(stage)
        if h is None:
            h = self._hists[stage] = Histogram()
        h.record(seconds)

    # ---- read side -------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        """One consistent read of everything this registry owns, under one
        lock acquisition: ``{"counters", "gauges", "histograms",
        "tenants"}``.  Peak gauges report their high-water mark since the
        previous snapshot and reset to their source gauge's current value.
        ``"tenants"`` maps each tenant touched so far to its counters
        (requests/errors/fused/rejected split by cause), its fused-share,
        and its request-latency percentiles."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            gauges["open_requests"] = self._open_requests
            for peak, source in self._peaks.items():
                current = self._gauges.get(source, 0)
                gauges[peak] = max(self._peak_values.get(peak, 0), current)
                self._peak_values[peak] = current
            hists = {name: h.snapshot() for name, h in self._hists.items()}
            tenants: dict[str, Any] = {}
            for name in sorted(set(self._tenant_counters)
                               | set(self._tenant_hists)):
                c = self._tenant_counters.get(name, {})
                entry: dict[str, Any] = {
                    "requests": c.get("requests", 0),
                    "errors": c.get("errors", 0),
                    "fused": c.get("fused", 0),
                    "rejected_rate": c.get("rejected_rate", 0),
                    "rejected_depth": c.get("rejected_depth", 0),
                    "rejected_closed": c.get("rejected_closed", 0),
                }
                entry["rejected"] = (entry["rejected_rate"]
                                     + entry["rejected_depth"])
                entry["fused_share"] = (entry["fused"] / entry["requests"]
                                        if entry["requests"] else 0.0)
                h = self._tenant_hists.get(name)
                hsnap = h.snapshot() if h is not None else {
                    "count": 0, "p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0}
                for k in ("count", "p50_s", "p95_s", "p99_s"):
                    entry[k] = hsnap[k]
                tenants[name] = entry
        return {"counters": counters, "gauges": gauges, "histograms": hists,
                "tenants": tenants}

    def traces(self) -> list[TraceSpan]:
        """The retained completed request trees, oldest first."""
        with self._lock:
            return list(self._traces)

    # ---- export ----------------------------------------------------------
    def export_chrome_trace(self, path) -> int:
        """Write the retained traces as Chrome-trace JSON (the format
        chrome://tracing and Perfetto load).  Spans shared by several
        requests are emitted once.  Returns the number of events."""
        events = []
        seen: set[int] = set()
        for root in self.traces():
            for span in root.walk():
                if id(span) in seen or not span.closed:
                    continue
                seen.add(id(span))
                events.append({
                    "name": span.name,
                    "ph": "X",
                    "ts": span.t0 * 1e6,          # Chrome trace wants µs
                    "dur": span.duration_s * 1e6,
                    "pid": 1,
                    "tid": span.tid,
                    "cat": "serving",
                    "args": {k: repr(v) if not isinstance(
                        v, (str, int, float, bool, type(None))) else v
                        for k, v in span.args.items()},
                })
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)
