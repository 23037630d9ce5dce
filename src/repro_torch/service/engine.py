"""QueryService: the concurrent SQL serving front door, on the device of
the tables it serves.

The paper's zero-materialisation plans (0MA / Opt⁺) have a *static*
dataflow — no intermediate shape depends on the data — which is exactly
what lets them be planned and compiled once and served many times.
``QueryService`` turns the one-shot pipeline (parse → classify → rewrite →
compile → run) into a serving engine:

    svc = QueryService(db, schema)
    res = svc.submit("SELECT MIN(s.s_acctbal) FROM supplier s ...")
    res.values, res.stats          # answer + per-query ServeStats
    svc.metrics()                  # cache hit/miss/eviction counters

It is the port of the JAX package's ``repro.service.engine.QueryService``:
the same request path, caches, keys, fusion admission, persistence and
counters, so the same query stream through both gives equal answers and
equal counters.  What differs:

  * the device is the tables' device (CUDA tensors serve on the card, CPU
    tensors through the kernels' plain versions); there is no other switch;
  * a compiled executable is ``Executor.compile``'s closure, cached per
    (fingerprint, shape bucket) under the JAX package's keys; its first
    call runs inside the ``compile`` span, so the ``run`` span times a
    warm call that ends in a synchronisation of the tables' device;
  * the kernel tuner (``autotune()``, ``tune_*`` counters) tunes the
    hand-written kernels' Hopper knobs on CUDA tables (backend ``"cuda"``,
    or ``"cuda_wide"`` with 64-bit frequencies) and the plain FreqJoin's
    dense-domain crossover on CPU tables (``"plain"``);
  * no compiled program persists on disk (the kernels' builds persist on
    their own under ``kernels/.build/``).

Request path (shared by sync ``submit``/``submit_many`` and the async
scheduler — one internal pipeline, ``_serve_batch``):

  1. ADMIT: parse SQL → AggQuery (skipped for AggQuery submissions);
     admission fails — with the relation named — if a query touches a
     schema relation with no loaded table.  Failures are captured PER
     REQUEST: in a batch, a malformed query's error attaches to its own
     ``QueryResult.error`` (or its future) and never aborts batch-mates;
     ``submit`` re-raises it for the single-query caller.  A failed
     request is never rerun elsewhere (not on the CPU, not through a
     plain version): its error is its answer.
  2. canonicalise → fingerprint (alias/variable-name invariant);
  3. PLAN-UNIT: plan cache L1: fingerprint → PhysicalPlan (an op-graph
     DAG), built outside the lock behind a per-fingerprint in-flight
     event; planning failures attach to the unit's requests only;
  4. shape bucket: power-of-two-padded capacities of the scanned
     relations; tables are padded (``Table.pad_to``) to their bucket, so
     data growth inside a bucket re-uses compiled closures.  Padding is
     device work and runs outside the lock too, against an immutable
     snapshot of the scanned tables;
  5. FUSION-GROUP + SERVE: plan cache L2: (fingerprint, bucket) →
     compiled closure; run; results renamed back to the request's output
     names.

Micro-batching: ``submit_many`` groups requests sharing a fingerprint and
runs each group's executable once, fanning the answer out per request.
Cross-fingerprint fusion: fingerprints whose plan DAGs share a non-trivial
subplan (``PhysicalPlan.subplan_keys``) are grouped by union-find, banded
by estimated cost (``StatsCatalog.estimate_plan_cost``; a member costing
``fusion_disparity`` × a band's minimum opens a new band) and by
serve-time feedback (``StatsCatalog.is_demoted``), and each band runs as
one ``Executor.compile_multi`` closure whose content-key memo computes
every shared sub-DAG once (``subplan_saved``).

Async serving: ``submit_async`` returns a ``Future[QueryResult]`` and
hands the query to a lazily started background batcher
(``repro_torch.service.scheduler.AsyncScheduler``), which serves each
window through ``_serve_batch`` on its own thread; kernel launches take
the current stream of the tables' device, and every synchronisation names
that device.

Thread safety: the internal lock guards only cache and database mutation —
planning, padding, compiles and execution run outside it, coordinated by
per-key in-flight events so concurrent cold requests for the same artefact
build it once.

Warm starts: ``QueryService(db, schema, cache_dir=...)`` persists every
shareable plan to a ``PlanStore``, the table statistics and serve-time
feedback to a ``StatsStore`` and the tuned kernel configs to a
``TuneStore`` under ``cache_dir`` — so a new process over the same schema
and data re-plans nothing (``plan_builds == 0``, ``persist_hits``
counting), recomputes no statistics (``stat_refreshes == 0``) and
re-measures no kernel (``tune_searches == 0``).  Disk failures of any kind degrade to
memory-only caching.  The entries are the JAX package's format: either
package reads the other's.

Serving beyond one device: ``QueryService(db, schema, mesh=...)`` over a
``torch.distributed`` ``DeviceMesh`` serves through
``repro_torch.core.distributed.DistributedExecutor``: tables pad to
per-shard power-of-two buckets (``min_bucket`` is per shard) and each
rank keeps its row block of every padded view; the executable-cache keys
and the stores carry the shard topology; ``metrics_v2()`` gains the
``mesh_*`` gauges and the ``run`` span a ``ring_sweep`` child.  Answers
are bitwise those of a local service padded to the same capacities
(``min_bucket = n_shards * min_bucket`` for a power-of-two mesh).  Eager
(ref/opt) plans run locally on the unpadded tables on every rank.  A mesh
service runs on every rank, each holding the full tables, and every rank
makes the same calls and gets the same answers.  So that every rank
issues the same collectives in the same order, one thread per service
runs every batch, table update and tuning run, in rank 0's order
(``repro_torch.service.mesh_sync``), and rank 0 decides whatever reads a
clock or writes the disk: the serve-time feedback, the async batcher's
claims and the tuner's winners are rank 0's, and only rank 0 writes under
``cache_dir``, which every rank reads.  With more than one rank a query
must be shareable (SQL text, or an ``AggQuery`` with declarative
selections: an opaque callable has no identity another process can
check), and the async tier admits without backpressure (its rate and
depth bounds read timing, so tenant ``rate``/``max_queue`` are refused).

Observability: every request carries a ``TraceSpan`` tree (parse →
queue-wait → fingerprint → plan → pad → compile → run) recorded through
``repro_torch.service.observability`` — the ONLY timing source in this
package.  ``metrics_v2()``, ``metrics()``, ``export_trace(path)`` and
``explain(query)`` read it back; ``tracing=False`` drops every span.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import weakref
from concurrent.futures import Future
from typing import Any, Callable

import torch

from repro_torch.core.executor import (
    ExecStats,
    Executor,
    shared_subplan_savings,
)
from repro_torch.core.plan import (
    MaterializeJoinOp,
    PhysicalPlan,
    segment_plan,
)
from repro_torch.core.rewrite import plan_query
from repro_torch.core.sql import parse_sql
from repro_torch.core.stats import FUSION_COST_DISPARITY, StatsCatalog
from repro_torch.kernels.autotune import KernelTuner, backend_tag
from repro_torch.service.fingerprint import CanonicalQuery, canonicalize
from repro_torch.service.mesh_sync import Lockstep
from repro_torch.service.observability import (
    DEFAULT_TENANT,
    NULL_SPAN,
    Observability,
    TraceSpan,
)
from repro_torch.service.plan_cache import LRUCache, PlanCache, ShapeBucket
from repro_torch.service.plan_store import (
    PlanStore,
    schema_fingerprint,
    store_fingerprint,
)
from repro_torch.service.stats_store import STATS_PERSIST_ZEROS, StatsStore
from repro_torch.service.tune_store import TUNE_PERSIST_ZEROS, TuneStore
from repro_torch.tables.table import Schema, Table, bucket_capacity


_OPAQUE_ON_MESH = (
    "a query with opaque selection callables has no identity another rank "
    "can check: a mesh service of more than one rank serves SQL text and "
    "declarative selections only")


class AdmissionError(ValueError):
    """A request the service refused at the door: a relation it cannot
    serve (present in the schema but with no table loaded, or unknown
    entirely), or async-tier backpressure (see the subclasses)."""


class TenantAdmissionError(AdmissionError):
    """Async admission rejected a request under its tenant's policy.
    ``tenant`` names the offender; ``kind`` is ``"rate"`` (token bucket
    empty) or ``"depth"`` (the tenant's queue is at its bound) — retry
    loops can back off differently for the two causes."""

    def __init__(self, tenant: str, kind: str, message: str):
        super().__init__(message)
        self.tenant = tenant
        self.kind = kind


class ServiceClosedError(AdmissionError, RuntimeError):
    """The async tier is stopped (``close()`` ran, or the service was
    garbage-collected): typed so retry loops written against
    ``AdmissionError`` backpressure survive shutdown.  Also a
    ``RuntimeError`` for callers of the pre-typed contract.  Counted as
    ``rejected_closed``, never ``rejected`` — shutdown is not
    backpressure."""


@dataclasses.dataclass
class ServeStats:
    """Per-request serving telemetry."""

    fingerprint: str = ""
    mode: str = ""
    plan_cache_hit: bool = False
    exec_cache_hit: bool = False
    shared_execution: bool = False   # answered by a batch-mate's run
    fused: bool = False              # answered by a multi-query program
    fused_group_size: int = 0        # distinct fingerprints in that program
    bucket: ShapeBucket = ()
    plan_source: str = ""            # memory | disk | built (cache level)
    exec_source: str = ""            # exec_cache | compiled | fused_cache |
                                     # fused_compiled | eager
    parse_s: float = 0.0
    queue_s: float = 0.0             # async admission-queue wait
    plan_s: float = 0.0
    compile_s: float = 0.0
    run_s: float = 0.0
    total_s: float = 0.0
    exec_stats: ExecStats | None = None  # eager (ref/opt) plans only
    trace: TraceSpan | None = dataclasses.field(default=None, repr=False)


@dataclasses.dataclass
class QueryResult:
    """One request's answer.  ``error`` is the per-request failure slot:
    in a batch, a malformed query gets its admission/parse/serve exception
    here while its batch-mates' results stay intact (``values`` is empty
    iff ``error`` is set).  ``submit`` re-raises it; the async scheduler
    moves it onto the request's future."""

    values: dict[str, Any]
    stats: ServeStats
    error: BaseException | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclasses.dataclass
class _Request:
    canon: CanonicalQuery | None
    stats: ServeStats
    error: BaseException | None = None   # captured per-request failure
    unit: "_Unit | None" = None          # back-pointer set by _plan_unit
    trace: Any = NULL_SPAN               # this request's root TraceSpan
    tenant: str = DEFAULT_TENANT         # owning tenant (metrics rollup)


@dataclasses.dataclass
class _Unit:
    """One fingerprint's worth of a batch: the requests sharing it, their
    cached plan, the plan's fusion identity, and (once served) the
    canonical result dict."""

    group: list[_Request]
    plan: PhysicalPlan
    plan_hit: bool
    plan_s: float
    eager: bool                       # materialising plan → eager fallback
    prefix_key: str | None            # whole-prefix identity (diagnostics)
    subplans: frozenset               # non-trivial subplan content keys
    sig: str                          # member signature for the fused cache
    plan_source: str = "memory"       # memory | disk | built
    results: dict = dataclasses.field(default_factory=dict)
    served_sig: str = ""              # fusion-group signature it ran under
                                      # ("" = served solo) — the feedback key

    @property
    def canon(self) -> CanonicalQuery:
        return self.group[0].canon


def _sync(tables) -> None:
    """Wait for the device work queued on the tables' CUDA device (named,
    never the calling thread's current device); nothing for CPU tensors."""
    dev = next(iter(tables)).device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class QueryService:
    """The serving front door over ``db`` (see the module docstring).

    ``freq_dtype`` is the executor's frequency dtype: ``torch.int64`` or
    ``torch.float64`` take the wide (64-bit) path end to end."""

    def __init__(self, db: dict[str, Table], schema: Schema, *,
                 mode: str = "auto", use_fkpk: bool = False,
                 freq_dtype: torch.dtype = torch.int32,
                 dense_domain: bool = False,
                 plan_capacity: int = 256, exec_capacity: int = 512,
                 fused_capacity: int = 128, padded_capacity: int = 64,
                 min_bucket: int = 8, async_max_batch: int = 64,
                 async_max_wait_ms: float = 2.0,
                 async_max_queue: int = 1024,
                 cache_dir: str | None = None,
                 clock: Callable[[], float] | None = None,
                 tracing: bool = True,
                 profile_annotations: bool = False,
                 mesh: "Any | None" = None,
                 data_axes: tuple[str, ...] | None = None,
                 mesh_presort: bool = False,
                 fusion_disparity: float | None = None,
                 tenants: "dict[str, Any] | None" = None):
        self._db = dict(db)
        self.schema = schema
        self.mode = mode
        self.use_fkpk = use_fkpk
        self.min_bucket = min_bucket
        # fusion-admission cost gate: a plan never joins a fusion group
        # whose max estimated cost is >= this multiple of its own.  None →
        # the calibrated default from core.stats; float("inf") disables
        # the gate (the ungated baseline benchmarks compare against).
        self.fusion_disparity = (FUSION_COST_DISPARITY
                                 if fusion_disparity is None
                                 else float(fusion_disparity))
        # the one timing source for the whole serving tier: counters,
        # gauges, per-stage histograms, and per-request span trees.
        # tracing=False keeps counters/gauges but makes every span a no-op
        # (no clock reads on the hot path — the overhead baseline).
        self.obs = Observability(clock, enabled=tracing)
        # root-span handoff from the async batcher to submit_many (see
        # there) — thread-local, so concurrent sync callers never see it
        self._trace_handoff = threading.local()
        self.obs.register_counters([
            "requests", "batches", "dedup_saved", "compiles",
            "eager_requests",
            "plan_builds",            # plan_query pipeline actually ran
                                      # (0 in a fully warm-started process)
            "request_errors",         # per-request captured failures
            "bucket_invalidations",
            # cross-fingerprint fusion
            "fused_batches",          # fused program executions
            "fused_queries",          # distinct fingerprints they answered
            "fused_compiles",         # of "compiles", how many were fused
            "partial_fusions",        # fused runs beyond whole-prefix rule
            "subplan_saved",          # subplan executions avoided
            "compile_s_total",        # float: total seconds compiling
            # async tier (bumped by the scheduler once it starts).
            # rejected = tenant backpressure (rate/depth);
            # rejected_closed = shutdown — counted apart on purpose
            "async_requests", "async_batches", "rejected",
            "rejected_closed",
            # cost-calibrated planning
            "stat_refreshes",         # full per-table stats computes ran
                                      # (0 in a fully warm-started process)
            "fusion_cost_rejects",    # members kept out of a fusion group
                                      # by the cost-disparity gate
            "fusion_demotions",       # members kept out by serve-time
                                      # feedback (a regressed fusion)
        ])
        self.obs.set_gauge("queue_depth", 0)
        self.obs.register_peak_gauge("queue_depth_peak", "queue_depth")
        # mesh serving: same pipeline, the distributed executor for the
        # compiled plans, topology-aware keys, per-shard buckets, this
        # rank's blocks as padded views, and the lane (``_sync``) keeping
        # the ranks in step; None on one device
        self._mesh = mesh
        self._sync: Lockstep | None = None
        if mesh is not None:
            from repro_torch.core.distributed import DistributedExecutor

            axes = tuple(data_axes) if data_axes is not None \
                else tuple(mesh.mesh_dim_names)
            dex = DistributedExecutor(
                schema, mesh, data_axes=axes, freq_dtype=freq_dtype,
                presort=mesh_presort, dense_domain=dense_domain,
                profile_annotations=profile_annotations)
            for name, t in self._db.items():
                if t.device.type != dex.device.type:
                    raise ValueError(
                        f"table {name!r} lies on {t.device}, the mesh on "
                        f"{dex.device}; a mesh serves tables of its own "
                        "device type")
            self._executor = dex
            # the shape-relevant mesh identity, folded into every
            # executable-cache key and the store fingerprint: a ring
            # program for one mesh shape never answers another
            self._topo = dex.topology()
            self._sync = Lockstep(dex.device)
            weakref.finalize(self, Lockstep.close, self._sync)
            if self._sync.world > 1:
                for name, pol in (tenants or {}).items():
                    if getattr(pol, "rate", None) is not None \
                            or getattr(pol, "max_queue", None) is not None:
                        raise ValueError(
                            f"tenant {name!r}: a rate or depth quota reads "
                            "timing, and every rank of a mesh must admit "
                            "the same requests")
            self.obs.set_gauge("mesh_devices", dex.n_shards)
            for a, n in zip(*self._topo):
                self.obs.set_gauge(f"mesh_shard_count_{a}", n)
        else:
            self._executor = Executor(
                self._db, schema, freq_dtype, dense_domain=dense_domain,
                profile_annotations=profile_annotations)
            self._topo = ()
        # only rank 0 of a mesh writes under cache_dir; every rank reads it
        read_only = self._sync is not None and self._sync.rank != 0
        store = None
        tune_store = None
        if cache_dir is not None:
            # the store identity covers schema AND planner configuration
            # AND shard topology: plans are planner output, so a store
            # warmed under another mode/use_fkpk must never serve this
            # service, and each topology keeps its own entries
            store = PlanStore(cache_dir,
                              store_fingerprint(schema, mode, use_fkpk,
                                                topology=self._topo),
                              read_only=read_only)
            # tuned kernel configs persist beside the plans, scoped by the
            # same topology
            tune_store = TuneStore(cache_dir, topology=self._topo,
                                   read_only=read_only)
        self.cache = PlanCache(plan_capacity, exec_capacity, fused_capacity,
                               padded_capacity, store=store)
        # kernel autotuning: the tuner resolves configs table → store →
        # measured search, on the tables' device at the service's width; a
        # warm start installs every persisted entry NOW so serving (and
        # ``autotune()``) re-measures nothing (``tune_searches == 0``).  A
        # compiled closure looks its configs up at its first call, so
        # installed configs take effect on the next compile.
        device = next(iter(self._db.values())).device if self._db else "cpu"
        self.tuner = KernelTuner(
            tune_store, backend=backend_tag(device, self._executor.wide),
            device=device)
        self.tuner.load_persisted()
        self._executor.tuning = self.tuner.table
        # cost-calibrated planning: one statistics catalog feeds the gated
        # rewrite passes, the fusion-admission cost gate, and the serve-time
        # feedback loop.  Stats are derived state, so they persist under the
        # same cache_dir discipline as plans — scoped by SCHEMA only
        # (statistics describe the data, not the planner configuration, so
        # every mode/use_fkpk variant shares them).  A warm restart
        # over identical data loads every table from disk and reports
        # ``stat_refreshes == 0``.
        self.stats = StatsCatalog(schema)
        self.stats_store = (StatsStore(cache_dir, schema_fingerprint(schema),
                                       read_only=read_only)
                            if cache_dir is not None else None)
        # live content tokens per relation — refreshed on update_table; the
        # store key composites each table's token with its FK destinations'
        # (orphan counts read both sides of a declared FK)
        self._tokens: dict[str, str] = {
            name: t.content_token() for name, t in self._db.items()}
        for name in sorted(self._db):
            self._refresh_stats(name)
        if self.stats_store is not None:
            fb = self.stats_store.load_feedback()
            if self._sync is not None:
                # every rank starts from the feedback rank 0 read
                fb = self._sync.run("load_feedback",
                                    lambda _: self._sync.share(fb))
            if fb is not None:
                self.stats.load_feedback(fb)
        # fingerprint → last fusion-admission decision payload, for
        # ``explain`` (bounded like _segments below)
        self._fusion_decisions: dict[str, dict] = {}
        # fingerprint → (eager, prefix_key, subplans, sig): the fusion
        # identity is a pure function of the canonical structure, so
        # memoise it across batches (bounded: cleared when it outgrows the
        # plan cache several times over)
        self._segments: dict[str, tuple] = {}
        # guards cache + db mutation ONLY; planning, padding, compiles and
        # execution run outside it, serialised per cache key by these
        # in-flight events
        self._lock = threading.RLock()
        self._inflight: dict[tuple, threading.Event] = {}
        # async tier: started lazily on the first submit_async.
        # ``tenants`` maps tenant name -> TenantPolicy (quota / queue
        # bound / DRR weight / priority lane); unlisted tenants get the
        # unlimited default policy on first touch.
        self._async_opts = (async_max_batch, async_max_wait_ms,
                            async_max_queue)
        self._tenant_policies = dict(tenants) if tenants else {}
        self._scheduler = None
        self._async_closed = False

    # ---- data plane ------------------------------------------------------
    def update_table(self, name: str, table: Table) -> None:
        """Swap in new data for one relation.  Growth inside the relation's
        shape bucket keeps every compiled executable valid; crossing a
        bucket boundary invalidates only the executables that scan it."""
        if name not in self.schema.relations:
            raise KeyError(f"unknown relation {name!r}")
        want = set(self.schema.relations[name].column_names())
        have = set(table.columns)
        if want != have:
            raise ValueError(f"table {name!r} columns {sorted(have)} != "
                             f"schema columns {sorted(want)}")
        old = self._db.get(name)
        if old is not None:
            # shape buckets key on capacity only; a dtype change would turn
            # an exec-cache "hit" into a run of a closure compiled for other
            # dtypes (the JAX package's silent re-trace), so reject it up
            # front
            for col in want:
                if table.columns[col].dtype != old.columns[col].dtype:
                    raise ValueError(
                        f"table {name!r} column {col!r} dtype "
                        f"{table.columns[col].dtype} != existing "
                        f"{old.columns[col].dtype}; keep dtypes stable so "
                        "cached executables stay valid")
            if table.freq.dtype != old.freq.dtype:
                raise ValueError(
                    f"table {name!r} freq dtype {table.freq.dtype} != "
                    f"existing {old.freq.dtype}")
            if table.device != old.device:
                raise ValueError(
                    f"table {name!r} lies on {table.device}, the existing "
                    f"table on {old.device}; the service serves on its "
                    "tables' device")
        token = table.content_token()
        if self._sync is None:
            self._swap_table(name, table, token)
            return

        def step(_):
            # every rank must be swapping in the same data
            self._sync.check(("update_table", name, token))
            self._swap_table(name, table, token)

        self._sync.run(("update_table", name), step)

    def _swap_table(self, name: str, table: Table, token: str) -> None:
        with self._lock:
            old_bucket = self._bucket_cap(self._db[name].capacity) \
                if name in self._db else None
            self._db[name] = table
            self.cache.drop_padded(name)
            new_bucket = self._bucket_cap(table.capacity)
            if old_bucket != new_bucket:
                n = self.cache.invalidate_relation(name)
                self.obs.inc("bucket_invalidations", n)
        # statistics follow the data: refresh this table, plus every table
        # whose FK points AT it (their orphan counts read the new data).
        # Outside the lock — stats computes copy device tensors to the host
        # and the catalog has its own synchronisation.
        self._tokens[name] = token
        self._refresh_stats(name)
        for fk in self.schema.foreign_keys:
            if fk.dst == name and fk.src in self._db:
                self._refresh_stats(fk.src)
        # cached plans whose gating decisions consulted now-changed
        # statistics must re-plan: the same fingerprint may deserve a
        # different graph under the new data distribution
        with self._lock:
            self.cache.plans.invalidate_items(
                lambda fp, plan: not self._decisions_valid(plan))

    # ---- statistics ------------------------------------------------------
    def _stats_store_token(self, name: str) -> str:
        """Composite content token keying ``name``'s persisted stats: its
        own data version plus its FK destinations' (orphan counts depend on
        both sides).  Any change to either side forces a fresh compute."""
        parts = [self._tokens[name]]
        for fk in sorted(self.schema.foreign_keys,
                         key=lambda f: (f.src, f.src_col)):
            if fk.src == name and fk.dst in self._tokens:
                parts.append(self._tokens[fk.dst])
        if len(parts) == 1:
            return parts[0]
        return hashlib.sha256("\n".join(parts).encode()).hexdigest()

    def _refresh_stats(self, name: str) -> None:
        """Bring ``name``'s catalog entry up to date: persisted stats at
        the current composite token install without recomputation; a miss
        computes fresh (counted ``stat_refreshes``) and writes back."""
        token = self._stats_store_token(name)
        if self.stats_store is not None:
            stats = self.stats_store.load(name, token)
            if stats is not None:
                self.stats.install(stats)
                return
        stats = self.stats.refresh(name, self._db[name], self._db)
        self.obs.inc("stat_refreshes")
        if self.stats_store is not None:
            # keyed by the composite token (the staleness discipline); the
            # payload keeps the table's OWN token, so a warm install puts
            # exactly what a cold compute would into the catalog
            self.stats_store.save(stats, token=token)

    def _decisions_valid(self, plan: PhysicalPlan) -> bool:
        """True iff every statistic a plan's gating decisions consulted
        still matches the live catalog.  Plans that consulted nothing
        (``stats=None`` planning, or no stats-gated pass fired) are always
        valid — their graph is stats-independent."""
        depends: dict[str, str] = {}
        for d in getattr(plan, "decisions", ()):
            depends.update(dict(d.depends))
        return not depends or self.stats.validate_depends(depends)

    def _bucket_cap(self, n_rows: int) -> int:
        """The shape bucket an n-row table pads to: the next power of two,
        at least ``min_bucket``; on a mesh, power-of-two blocks per shard
        (``min_bucket`` bounds the PER-SHARD block there, so growth inside
        every shard's bucket reuses the compiled ring program)."""
        if self._mesh is not None:
            return self._executor.shard_capacity(n_rows, self.min_bucket)
        return bucket_capacity(n_rows, self.min_bucket)

    def _snapshot(self, rels) -> tuple[ShapeBucket, dict[str, Table]]:
        """Shape bucket + bucket-padded table views for `rels`.

        The raw tables and the bucket are captured under ONE lock
        acquisition so they describe the same database state: a concurrent
        bucket-crossing ``update_table`` can never pair a stale-bucket
        cache key with fresh-shaped inputs (a cached closure run on
        another bucket's shapes, uncounted as a compile).  Tables are
        immutable, so the snapshot stays consistent after release — which
        is what lets the padding itself (``Table.pad_to``, device work)
        run OUTSIDE the lock, serialised per (relation, capacity) by
        in-flight events exactly like compiles."""
        with self._lock:
            base = {rel: self._db[rel] for rel in rels}
            bucket: ShapeBucket = tuple(
                (rel, self._bucket_cap(base[rel].capacity))
                for rel in rels)
        sub_db = {rel: self._padded_view(rel, base[rel], cap)
                  for rel, cap in bucket}
        return bucket, sub_db

    def _padded_view(self, rel: str, table: Table, cap: int) -> Table:
        """`table` padded to `cap`, from the bounded padded-view cache.
        Entries are tagged with their source table; a tag mismatch (the
        relation was swapped after our snapshot) pads fresh but only
        caches the view while it still describes the live table.  On a
        mesh the view is this rank's row block of the padded table."""
        entry, _ = self._get_or_build(
            self.cache.padded, rel,
            lambda: (table, self._pad_table(table, cap)),
            flight_key=("pad", rel, cap),
            valid=lambda e: e[0] is table,
            cache_if=lambda e: self._db.get(rel) is table)
        return entry[1]

    def _pad_table(self, table: Table, cap: int) -> Table:
        padded = table.pad_to(cap)
        if self._mesh is not None:
            from repro_torch.core.distributed import shard_table

            dex = self._executor
            padded = shard_table(padded, dex.block, dex.n_shards, dex.device)
        return padded

    # ---- request plane ---------------------------------------------------
    def submit(self, query, *, tenant: str | None = None) -> QueryResult:
        """Serve one query (SQL text or AggQuery).  Raises the captured
        error for a single-query caller (batch callers get it attached to
        the request's ``QueryResult.error`` instead).  ``tenant`` rolls
        the request into that tenant's counters/latency histogram."""
        res = self.submit_many([query], tenant=tenant)[0]
        if res.error is not None:
            raise res.error
        return res

    def submit_many(self, queries, *, tenant: str | None = None) \
            -> list[QueryResult]:
        """Serve a batch of concurrent requests.

        Requests sharing a fingerprint are answered by one executable
        invocation; fingerprints whose plan DAGs overlap on any non-trivial
        subplan are fused into one multi-query program compiled and run
        once, with every shared sub-DAG computed a single time.

        Fault isolation is per request: an admission/parse/planning/serve
        failure attaches to the offending request's ``QueryResult.error``
        and never aborts its batch-mates.

        The async scheduler hands over the root spans it opened at
        enqueue time (so queue-wait is part of each request's tree) and
        each request's tenant through the ``_trace_handoff`` thread-local
        — a side channel, not a parameter, so the public signature stays
        wrappable (tests monkeypatch ``submit_many``); sync callers get a
        fresh root per query here, rolled up under ``tenant`` (default:
        the shared default tenant)."""
        queries = list(queries)          # accept any iterable
        _traces = getattr(self._trace_handoff, "traces", None)
        _tenants = getattr(self._trace_handoff, "tenants", None)
        self._trace_handoff.traces = None
        self._trace_handoff.tenants = None
        if not queries:
            return []                    # no work: don't count a batch
        tenant = DEFAULT_TENANT if tenant is None else str(tenant)
        if _tenants is None or len(_tenants) != len(queries):
            _tenants = [tenant] * len(queries)
        if _traces is None or len(_traces) != len(queries):
            _traces = [self.obs.begin_request(tenant=ten)
                       for ten in _tenants]
        # every submission counts, admitted or not — request_errors /
        # requests is then a meaningful error rate
        self.obs.inc("requests", len(queries))
        reqs = [self._try_admit(q, t, ten)
                for q, t, ten in zip(queries, _traces, _tenants)]
        served = self._serve_batch([r for r in reqs if r.error is None])
        out = []
        errors = 0
        for r in reqs:
            res = served.get(id(r))
            if res is None:              # admission/parse failure
                res = QueryResult({}, r.stats, error=r.error)
            self.obs.tenant_inc(r.tenant, "requests")
            if res.error is not None:
                errors += 1
                r.trace.note(error=type(res.error).__name__)
                self.obs.tenant_inc(r.tenant, "errors")
            elif res.stats.fused:
                self.obs.tenant_inc(r.tenant, "fused")
            if r.trace is not NULL_SPAN:
                r.stats.trace = r.trace
            self.obs.end_request(r.trace, tenant=r.tenant)
            out.append(res)
        if errors:
            self.obs.inc("request_errors", errors)
        return out

    def submit_async(self, query, *, tenant: str | None = None) \
            -> Future[QueryResult]:
        """Queue one query for background batch formation; returns a
        ``concurrent.futures.Future`` resolving to its ``QueryResult``
        (or raising its captured per-request error).

        Queries from independent callers that land in the same batching
        window are served by ONE ``_serve_batch`` call, so they dedup,
        fuse, and share compiled programs exactly as if a single caller
        had handed them to ``submit_many`` — across tenants too: quota
        accounting is per tenant, the compiled program is shared.  Raises
        ``TenantAdmissionError`` when ``tenant`` is over its queue-depth
        bound or token-bucket rate (backpressure; the error names the
        tenant and the cause), ``ServiceClosedError`` after ``close()``."""
        ident = self._identity(query) if self._multi_rank() else None
        sch = self._scheduler
        if sch is None:
            from repro_torch.service.scheduler import AsyncScheduler
            with self._lock:
                if self._async_closed:
                    self.obs.inc("rejected_closed")
                    raise ServiceClosedError(
                        "service closed: the async tier is stopped "
                        "(sync submit still works)")
                if self._scheduler is None:
                    max_batch, max_wait_ms, max_queue = self._async_opts
                    self._scheduler = AsyncScheduler(
                        self, max_batch=max_batch, max_wait_ms=max_wait_ms,
                        max_queue=max_queue,
                        tenants=self._tenant_policies)
                sch = self._scheduler
        return sch.submit_async(query, tenant=tenant, ident=ident)

    def _multi_rank(self) -> bool:
        return self._sync is not None and self._sync.world > 1

    def _identity(self, query) -> str:
        """What a rank other than 0 matches one of rank 0's async claims
        by: the SQL text, or the canonical fingerprint of an ``AggQuery``.
        An opaque one has none another process could check, and is refused
        at once (on every rank alike)."""
        if isinstance(query, str):
            return "sql " + hashlib.sha256(query.encode()).hexdigest()
        canon = canonicalize(query)
        if not canon.shareable:
            raise AdmissionError(_OPAQUE_ON_MESH)
        return "query " + canon.fingerprint

    def close(self, timeout: float | None = 10.0) -> None:
        """Stop the async batcher (if started), draining queued requests.
        Terminal for the async tier — later ``submit_async`` calls raise —
        while sync submission keeps working."""
        with self._lock:
            self._async_closed = True
            sch = self._scheduler
        if sch is not None:
            sch.close(timeout=timeout)

    # ---- kernel autotuning ----------------------------------------------
    @property
    def tune_store(self) -> TuneStore | None:
        """The persistent tuned-config store (None without
        ``cache_dir``)."""
        return self.tuner.store

    def autotune(self, kernels=("freq_join", "semi_join", "segment_sum"),
                 *, row: Callable[..., Any] | None = None) -> dict[str, Any]:
        """Tune the kernels for this service's loaded tables (see
        ``_autotune``).  On a mesh the search is rank 0's, on its clock:
        every other rank installs rank 0's winners, drops its executables
        where rank 0 dropped its own, and returns rank 0's summary."""
        if self._sync is None:
            return self._autotune(kernels, row)
        lead = self._sync.rank == 0

        def step(_):
            out = self._autotune(kernels, row) if lead else None
            out, entries = self._sync.share(
                (out, self.tuner.table.entries() if lead else None))
            if not lead:
                self.tuner.adopt(entries)
                if out["installed"]:
                    self._drop_executables()
            return out

        return self._sync.run(("autotune", tuple(kernels)), step)

    def _drop_executables(self) -> int:
        """Drop the executable levels (plans are config-free and stay);
        returns how many entries went."""
        with self._lock:
            return (self.cache.execs.invalidate_if(lambda k: True)
                    + self.cache.fused.invalidate_if(lambda k: True))

    def _autotune(self, kernels, row) -> dict[str, Any]:
        """Tune the kernels for this service's loaded tables.

        Runs the measured config search for every (kernel, shape-bucket)
        combination the current tables can produce — join kernels over
        (parent bucket × child bucket) pairs, the segmented sum per bucket
        — skipping any combination already resolved by the in-memory table
        or the persistent store (so a warm-started service measures
        nothing and this call is cheap to repeat).  Every candidate is
        gated on bitwise equality with the untuned answer inside the search
        itself; a fresh install then drops the compiled executables, whose
        closures hold the configs they looked up, so the next serve
        compiles with the tuned ones.  ``row`` (a ``Recorder.row``-shaped
        sink) receives the per-candidate timing trajectory.  The join
        kernels are searched bucket by bucket, both joins of a bucket on
        one draw of its synthetic inputs.  Returns a summary dict."""
        with self._lock:
            caps = sorted({self._bucket_cap(t.capacity)
                           for t in self._db.values()})
        before = self.tuner.metrics()
        prev_row = self.tuner.row
        if row is not None:
            self.tuner.row = row
        joins = [k for k in kernels if k != "segment_sum"]
        try:
            with self.tuner.shared_draws():
                for bp in caps:
                    for bc in caps:
                        for kernel in joins:
                            self.tuner.ensure(kernel, (bp, bc))
            if "segment_sum" in kernels:
                for b in caps:
                    self.tuner.ensure("segment_sum", (b,))
        finally:
            self.tuner.row = prev_row
        after = self.tuner.metrics()
        installed = after["tune_installs"] - before["tune_installs"]
        invalidated = 0
        if installed:
            # compiled closures captured the configs of their first call
            invalidated = self._drop_executables()
        return {
            "buckets": caps,
            "searches": after["tune_searches"] - before["tune_searches"],
            "installed": installed,
            "gate_rejects": (after["tune_gate_rejects"]
                             - before["tune_gate_rejects"]),
            "entries": after["tune_entries"],
            "invalidated_executables": invalidated,
        }

    # ---- cache persistence ----------------------------------------------
    @property
    def plan_store(self) -> PlanStore | None:
        """The persistent plan level (None without ``cache_dir``)."""
        return self.cache.store

    def export_cache(self, path) -> int:
        """Write this service's plan cache to a fresh ``PlanStore`` at
        `path`: every serialisable in-memory plan, plus any entries already
        persisted in this service's own store that memory has evicted.
        Returns the number of plans exported.  Use to seed warm starts on
        other machines (ship the directory; ``cache_dir=path`` or
        ``import_cache`` consumes it).  On a mesh only rank 0 writes, and
        every rank returns its count."""
        if self._sync is None:
            return self._export_cache(path)
        lead = self._sync.rank == 0
        return self._sync.run(
            ("export_cache", str(path)),
            lambda _: self._sync.share(self._export_cache(path) if lead
                                       else None))

    def _export_cache(self, path) -> int:
        dest = PlanStore(path, store_fingerprint(self.schema, self.mode,
                                                 self.use_fkpk,
                                                 topology=self._topo))
        with self._lock:
            plans = self.cache.plans.items()
        exported = set()
        for fp, plan in plans:
            if dest.save(fp, plan):          # skips opaque/unserialisable
                exported.add(fp)
        own = self.cache.store
        if own is not None and own.root.resolve() != dest.root.resolve():
            for fp, plan in own.load_all():
                if fp not in exported and dest.save(fp, plan):
                    exported.add(fp)
        # tuned kernel configs ship with the plans: everything in the
        # in-memory table, plus store entries memory never loaded
        tdest = TuneStore(path, topology=self._topo)
        tuned = set()
        for (kernel, shape, backend), cfg in self.tuner.table.entries():
            if tdest.save(kernel, shape, backend, cfg):
                tuned.add((kernel, shape, backend))
        town = self.tuner.store
        if town is not None \
                and town.root.resolve() != tdest.root.resolve():
            for key, cfg in town.load_all():
                if key not in tuned:
                    tdest.save(*key, cfg)
        return len(exported)

    def import_cache(self, path) -> int:
        """Pre-warm the in-memory plan cache from a ``PlanStore`` at
        `path` (and write the entries through to this service's own store,
        when it has one).  Returns the number of plans imported.  Corrupt
        or schema-mismatched entries are skipped, never raised."""
        src = PlanStore(path, store_fingerprint(self.schema, self.mode,
                                                self.use_fkpk,
                                                topology=self._topo))
        n = 0
        own = self.cache.store
        write_through = own is not None \
            and own.root.resolve() != src.root.resolve()
        for fp, plan in src.load_all():
            with self._lock:
                self.cache.plans.put(fp, plan)
            if write_through:
                own.save(fp, plan)
            n += 1
        # tuned kernel configs ride along: install into the live table
        # (they take effect on the next compile) and write through to our
        # own store when we have one
        tsrc = TuneStore(path, topology=self._topo)
        town = self.tuner.store
        t_through = town is not None \
            and town.root.resolve() != tsrc.root.resolve()
        for (kernel, shape, backend), cfg in tsrc.load_all():
            self.tuner.table.install(kernel, shape, backend, cfg)
            if t_through:
                town.save(kernel, shape, backend, cfg)
        return n

    def _serve_batch(self, reqs: list[_Request]) -> dict[int, QueryResult]:
        """The batch pipeline: fingerprint-group → plan-unit →
        fusion-group → serve → per-request results, keyed by request id.
        Shared by sync ``submit_many`` and the async scheduler; errors
        attach to the affected requests, never to the batch.  On a mesh
        the batch is one step of the lane, keyed by its fingerprints."""
        if not reqs:
            return {}
        if self._sync is None:
            return self._serve_requests(reqs)
        key = hashlib.sha256("\n".join(
            r.canon.fingerprint for r in reqs).encode()).hexdigest()
        return self._sync.run(("batch", key),
                              lambda _: self._serve_requests(reqs))

    def _serve_requests(self, reqs: list[_Request]) -> dict[int, QueryResult]:
        groups: dict[str, list[_Request]] = {}
        for r in reqs:
            groups.setdefault(r.canon.fingerprint, []).append(r)
        self.obs.inc("batches")
        dedup = sum(len(g) - 1 for g in groups.values())
        if dedup:
            self.obs.inc("dedup_saved", dedup)

        units = []
        for group in groups.values():
            try:
                units.append(self._plan_unit(group))
            except Exception as e:       # planning failed: this unit only
                for r in group:
                    r.error = e

        eagers, singles, fused_groups = self._fusion_groups(units)
        for u in eagers:
            self._try_serve(self._serve_eager, u)
        for u in singles:
            self._try_serve(self._serve_single, u)
        for us in fused_groups:
            try:
                self._serve_fused(us)
            except Exception:
                # the fused program failed as a whole — fall back to
                # serving each member singly, so only the member(s) that
                # actually cannot serve carry an error (on a mesh, every
                # rank sees the failure of any rank: ``Lockstep.program``)
                for u in us:
                    u.served_sig = ""       # it is a solo serve after all
                    self._try_serve(self._serve_single, u)

        # close the loop: observed serve times feed the catalog per
        # (fingerprint, fusion-group signature) — "" is the solo baseline —
        # so the grouper demotes fusions that keep regressing a member.
        # One atomic feedback write-back per observing batch.
        observed = [(u.canon.fingerprint, u.served_sig,
                     u.group[0].stats.run_s) for u in units
                    if u.results and all(r.error is None for r in u.group)]
        if self._sync is not None:
            # a serve time reads a clock: every rank takes rank 0's
            observed = self._sync.share(observed)
        for fp, sig, run_s in observed:
            self.stats.observe_serve(fp, sig, run_s)
        if observed and self.stats_store is not None:
            self.stats_store.save_feedback(self.stats.feedback_payload())

        results: dict[int, QueryResult] = {}
        for group in groups.values():
            for i, r in enumerate(group):
                if r.error is not None:
                    results[id(r)] = QueryResult({}, r.stats, error=r.error)
                    continue
                r.stats.shared_execution = i > 0
                r.stats.queue_s = r.trace.child_duration("queue_wait")
                r.stats.total_s = (r.stats.parse_s + r.stats.plan_s
                                   + r.stats.compile_s + r.stats.run_s)
                results[id(r)] = QueryResult(
                    r.canon.rename_results(r.unit.results), r.stats)
        return results

    def _try_admit(self, query, trace=NULL_SPAN,
                   tenant: str = DEFAULT_TENANT) -> _Request:
        """Admission with per-request error capture."""
        try:
            return self._admit(query, trace, tenant)
        except Exception as e:
            return _Request(canon=None, stats=ServeStats(), error=e,
                            trace=trace, tenant=tenant)

    def _try_serve(self, serve: Callable, u: _Unit) -> None:
        """Run one unit's serve step, attaching a failure to that unit's
        requests instead of propagating it into batch-mates."""
        try:
            serve(u)
        except Exception as e:
            for r in u.group:
                r.error = e

    def _admit(self, query, trace=NULL_SPAN,
               tenant: str = DEFAULT_TENANT) -> _Request:
        stats = ServeStats()
        if isinstance(query, str):
            with self.obs.span(trace, "parse") as sp:
                query = parse_sql(query, self.schema)
            stats.parse_s = sp.duration_s
        for atom in query.atoms:
            if atom.rel not in self.schema.relations:
                raise AdmissionError(
                    f"query references relation {atom.rel!r}, which is not "
                    "in the schema")
            if atom.rel not in self._db:
                raise AdmissionError(
                    f"query references relation {atom.rel!r}, which has no "
                    f"table loaded; call update_table({atom.rel!r}, table) "
                    "first")
        with self.obs.span(trace, "fingerprint"):
            canon = canonicalize(query)
        if not canon.shareable and self._multi_rank():
            raise AdmissionError(_OPAQUE_ON_MESH)
        stats.fingerprint = canon.fingerprint
        trace.note(fingerprint=canon.fingerprint)
        return _Request(canon, stats, trace=trace, tenant=tenant)

    def _plan_unit(self, group: list[_Request]) -> _Unit:
        """Plan lookup for one fingerprint group: memory (plan-cache L1) →
        disk (persistent ``PlanStore``, warm starts) → ``plan_query``.
        Runs WITHOUT the service lock: both the disk load and the rewrite
        pipeline execute behind a per-fingerprint in-flight event like any
        other cache build, so a slow plan never blocks
        ``metrics()``/``update_table`` or unrelated fingerprints.  Opaque
        (unshareable) fingerprints are process-salted, so they bypass the
        store entirely; freshly built shareable plans are written back
        best-effort (a failed write degrades to memory-only caching)."""
        canon = group[0].canon
        roots = [r.trace for r in group]
        source = "memory"                # overwritten when build() runs

        def build():
            nonlocal source
            if canon.shareable:
                plan = self.cache.load_persistent(canon.fingerprint)
                if plan is not None:
                    # a persisted plan is only trusted if the statistics
                    # its gating decisions consulted still describe the
                    # live data; otherwise re-plan under current stats
                    if self._decisions_valid(plan):
                        source = "disk"
                        return plan
            plan = plan_query(canon.query, self.schema, mode=self.mode,
                              use_fkpk=self.use_fkpk, stats=self.stats)
            source = "built"
            self.obs.inc("plan_builds")
            if canon.shareable:
                self.cache.save_persistent(canon.fingerprint, plan)
            return plan

        with self.obs.span(roots, "plan",
                           fingerprint=canon.fingerprint) as sp:
            plan, plan_hit = self._get_or_build(
                self.cache.plans, canon.fingerprint, build)
            sp.note(source="memory" if plan_hit else source, hit=plan_hit)
        plan_s = sp.duration_s
        with self._lock:
            seg = self._segments.get(canon.fingerprint)
        if seg is None:
            eager = any(isinstance(op, MaterializeJoinOp) for op in plan.ops)
            if eager:
                seg = (True, None, frozenset(), canon.fingerprint)
            else:
                # opaque-selection plans key their scans on callable
                # identity, which can be recycled after GC — their member
                # signature falls back to the (salted, process-unique)
                # fingerprint so a fused cache entry can never alias them
                gk = plan.graph_key() if canon.shareable else None
                seg = (False, segment_plan(plan).prefix_key,
                       plan.subplan_keys(),
                       gk if gk is not None else canon.fingerprint)
            with self._lock:
                if len(self._segments) > 4 * self.cache.plans.capacity:
                    self._segments.clear()
                self._segments[canon.fingerprint] = seg
        eager, prefix_key, subplans, sig = seg
        unit = _Unit(group, plan, plan_hit, plan_s, eager, prefix_key,
                     subplans, sig,
                     plan_source="memory" if plan_hit else source)
        for r in group:
            r.unit = unit
        return unit

    def _fusion_groups(self, units: list[_Unit]):
        """Partition a batch: eager fallbacks, lone jittable units, and
        fusion groups — connected components of the "shares a non-trivial
        subplan key" relation (union-find over key owners)."""
        eagers = [u for u in units if u.eager]
        jit_units = [u for u in units if not u.eager]
        singles = [u for u in jit_units if not u.subplans]
        fusable = [u for u in jit_units if u.subplans]

        parent = list(range(len(fusable)))

        def find(i: int) -> int:
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        owner: dict = {}
        for i, u in enumerate(fusable):
            for k in u.subplans:
                j = owner.setdefault(k, i)
                if j != i:
                    parent[find(i)] = find(j)
        comps: dict[int, list[_Unit]] = {}
        for i, u in enumerate(fusable):
            comps.setdefault(find(i), []).append(u)
        fused_groups = []
        for comp in comps.values():
            if len(comp) == 1:
                singles.append(comp[0])
                continue
            groups, solos = self._admit_fusion(comp)
            singles.extend(solos)
            fused_groups.extend(groups)
        return eagers, singles, fused_groups

    def _admit_fusion(self, comp: list[_Unit]
                      ) -> tuple[list[list[_Unit]], list[_Unit]]:
        """Admission gate for one candidate fusion group: subplan sharing
        makes a fusion *possible*, the cost model and serve-time feedback
        decide whether it is *worth it*.  Returns (fused groups, solos).

        Two gates, in order:

        1. cost disparity — members partition into cost-compatible BANDS:
           walking members by ascending estimated (padded-shape) cost, a
           member opens a new band when it costs ≥ ``fusion_disparity`` ×
           the current band's minimum.  A cheap lookup fused with a heavy
           dashboard inherits the dashboard's latency for no savings it
           can notice — but cost-similar members still fuse among
           themselves, so the gate never forfeits compatible sharing.
           Members stranded in a singleton band serve solo and count
           ``fusion_cost_rejects``.
        2. feedback demotion — a (fingerprint, group-signature) pair the
           catalog has observed regressing vs. the member's solo baseline
           is evicted from its band; the signature shrinks and the check
           repeats until the band is stable (``fusion_demotions``).
        """
        rels = sorted({rel for u in comp for rel in u.plan.scanned_rels()})
        with self._lock:
            rows = {rel: self._bucket_cap(self._db[rel].capacity)
                    for rel in rels if rel in self._db}
        costs = {id(u): self.stats.estimate_plan_cost(u.plan, rows=rows)
                 for u in comp}
        cmin = min(costs.values())
        cmax = max(costs.values())
        bands: list[list[_Unit]] = []
        for u in sorted(comp, key=lambda u: costs[id(u)]):
            if bands and costs[id(u)] < self.fusion_disparity * max(
                    costs[id(bands[-1][0])], 1.0):
                bands[-1].append(u)
            else:
                bands.append([u])
        groups: list[list[_Unit]] = []
        solos: list[_Unit] = []
        for band in bands:
            if len(band) == 1:
                u = band[0]
                c = costs[id(u)]
                solos.append(u)
                self.obs.inc("fusion_cost_rejects")
                self._note_fusion(
                    u, admitted=False, cost=c, group_max_cost=cmax,
                    reason=(f"cost disparity >= {self.fusion_disparity:g}x:"
                            f" member cost {c:.0f} incompatible with the "
                            f"rest of its component (costs {cmin:.0f}.."
                            f"{cmax:.0f})"))
                continue
            keep = band
            while len(keep) > 1:
                keep.sort(key=lambda u: u.canon.fingerprint)
                sig = hashlib.sha256(
                    repr(tuple(u.sig for u in keep)).encode()).hexdigest()
                demoted = [u for u in keep
                           if self.stats.is_demoted(u.canon.fingerprint,
                                                    sig)]
                if not demoted:
                    for u in keep:
                        self._note_fusion(
                            u, admitted=True, cost=costs[id(u)],
                            group_max_cost=cmax, signature=sig,
                            reason=f"admitted (group of {len(keep)})")
                    break
                for u in demoted:
                    keep.remove(u)
                    solos.append(u)
                    self.obs.inc("fusion_demotions")
                    self._note_fusion(
                        u, admitted=False, cost=costs[id(u)],
                        group_max_cost=cmax, signature=sig,
                        reason=("demoted by serve-time feedback: fused "
                                "EWMA regressed vs solo baseline"))
            if len(keep) > 1:
                groups.append(keep)
            else:
                solos.extend(keep)
        return groups, solos

    def _note_fusion(self, u: _Unit, *, admitted: bool, reason: str,
                     cost: float, group_max_cost: float,
                     signature: str = "") -> None:
        """Record the last fusion-admission decision per fingerprint for
        ``explain`` (bounded like ``_segments``)."""
        with self._lock:
            if len(self._fusion_decisions) > 4 * self.cache.plans.capacity:
                self._fusion_decisions.clear()
            self._fusion_decisions[u.canon.fingerprint] = {
                "admitted": admitted, "reason": reason, "cost": cost,
                "group_max_cost": group_max_cost,
                "disparity": self.fusion_disparity,
                "signature": signature,
            }

    # ---- execution -------------------------------------------------------
    _MISSING = object()

    def _get_or_build(self, cache: LRUCache, key, build: Callable, *,
                      flight_key: tuple | None = None,
                      valid: Callable | None = None,
                      cache_if: Callable | None = None):
        """Cache access with the lock held only around the cache itself: a
        miss releases the lock, builds (compile / plan rewrite / padding),
        and re-inserts, while concurrent requests for the SAME key wait on
        an in-flight event instead of building twice (and requests for
        other keys — or ``metrics()``/``update_table`` — proceed
        untouched).

        ``valid`` lets a caller reject a cached entry (treated as a miss
        to rebuild, counted as neither hit nor eviction); ``cache_if``
        gates insertion of a freshly built value (evaluated under the
        lock) for builds that may already be stale by the time they
        finish.  Exactly one hit or miss is counted per logical access,
        however many times the wait loop spins."""
        fk = (id(cache), key) if flight_key is None else flight_key
        while True:
            with self._lock:
                value = cache.peek(key, self._MISSING)
                if value is not self._MISSING and (valid is None
                                                   or valid(value)):
                    cache.note_hit(key)
                    return value, True
                ev = self._inflight.get(fk)
                if ev is None:
                    ev = threading.Event()
                    self._inflight[fk] = ev
                    break
            ev.wait()
        try:
            value = build()
            with self._lock:
                cache.misses += 1
                if cache_if is None or cache_if(value):
                    cache.put(key, value)
            return value, False
        finally:
            with self._lock:
                self._inflight.pop(fk, None)
            ev.set()

    def _invoke(self, fn: Callable, sub_db: dict[str, Table], span,
                key=None):
        """Execute one ready closure to completion: the device work it
        queued is waited for on the tables' device, so the caller's
        ``span`` covers it.  On a mesh the run is one ring program
        (``key`` names it to the other ranks) inside a ``ring_sweep``
        child of ``span``: the collective sweep is the mesh path's own
        cost and gets its own timing row."""
        if self._sync is None:
            results = fn(sub_db)
            _sync(sub_db.values())
            return results
        axes, _ = self._topo

        def run():
            with self.obs.span(span, "ring_sweep", axes="×".join(axes),
                               shards=self._executor.n_shards):
                results = fn(sub_db)
                _sync(sub_db.values())
            return results

        return self._sync.program(key, run)

    def _finish_unit(self, u: _Unit, results: dict, *, exec_hit: bool,
                     bucket: ShapeBucket, compile_s: float, run_s: float,
                     fused_size: int = 0, exec_source: str = "") -> None:
        u.results = results
        for r in u.group:
            r.stats.mode = u.plan.mode
            r.stats.plan_cache_hit = u.plan_hit
            r.stats.exec_cache_hit = exec_hit
            r.stats.fused = fused_size > 1
            r.stats.fused_group_size = fused_size
            r.stats.bucket = bucket
            r.stats.plan_source = u.plan_source
            r.stats.exec_source = exec_source
            r.stats.plan_s = u.plan_s
            r.stats.compile_s = compile_s
            r.stats.run_s = run_s

    def _serve_single(self, u: _Unit) -> None:
        """The classic path: one fingerprint, one executable."""
        roots = [r.trace for r in u.group]
        with self.obs.span(roots, "pad"):
            bucket, sub_db = self._snapshot(u.plan.scanned_rels())
        fn, exec_hit, compile_s = self._executable(u.canon, u.plan, bucket,
                                                   sub_db, roots)
        with self.obs.span(roots, "run") as rsp:
            results = self._invoke(
                fn, sub_db, rsp,
                ("run", PlanCache.exec_key(u.canon.fingerprint, bucket,
                                           self._topo)))
        self._finish_unit(u, results, exec_hit=exec_hit, bucket=bucket,
                          compile_s=compile_s, run_s=rsp.duration_s,
                          exec_source="exec_cache" if exec_hit
                          else "compiled")

    def _serve_fused(self, units: list[_Unit]) -> None:
        """Compile and run several subplan-sharing fingerprints as ONE
        program: each shared sub-DAG executes once, every member's
        remaining ops fold the shared vectors into its own answer."""
        units.sort(key=lambda u: u.canon.fingerprint)
        plans = [u.plan for u in units]
        # one set of spans shared by EVERY member request's trace tree —
        # a fused batch has exactly one pad/compile/run, so exactly one
        # span each, fanned out to all roots (export dedups by identity)
        roots = [r.trace for u in units for r in u.group]
        rels = sorted({rel for p in plans for rel in p.scanned_rels()})
        with self.obs.span(roots, "pad"):
            bucket, sub_db = self._snapshot(rels)
        signature = hashlib.sha256(
            repr(tuple(u.sig for u in units)).encode()).hexdigest()
        for u in units:
            # the feedback key this serve will be observed under — matches
            # the signature _admit_fusion computes for the same member set
            u.served_sig = signature
        compile_s = 0.0
        key = PlanCache.fused_key(signature, bucket, self._topo)

        def build():
            nonlocal compile_s
            with self.obs.span(roots, "compile", cold=True, fused=True,
                               members=len(units)) as sp:
                fn = self._executor.compile_multi(plans)
                self._invoke(fn, sub_db, sp, ("compile", key))
            compile_s = sp.duration_s
            self.obs.inc("compiles")
            self.obs.inc("fused_compiles")
            self.obs.inc("compile_s_total", compile_s)
            return fn

        fn, exec_hit = self._get_or_build(self.cache.fused, key, build)
        with self.obs.span(roots, "run", fused=True) as rsp:
            outs = self._invoke(fn, sub_db, rsp, ("run", key))

        self.obs.inc("fused_batches")
        self.obs.inc("fused_queries", len(units))
        self.obs.inc("subplan_saved", shared_subplan_savings(plans))
        if len({u.prefix_key for u in units}) > 1:
            # members do NOT all share one whole prefix: this fusion is
            # beyond the equal-prefix rule (different join shapes)
            self.obs.inc("partial_fusions")
        for u, results in zip(units, outs):
            self._finish_unit(u, results, exec_hit=exec_hit, bucket=bucket,
                              compile_s=compile_s, run_s=rsp.duration_s,
                              fused_size=len(units),
                              exec_source="fused_cache" if exec_hit
                              else "fused_compiled")

    def _executable(self, canon: CanonicalQuery, plan: PhysicalPlan,
                    bucket: ShapeBucket, sub_db: dict[str, Table],
                    parents=(),
                    ) -> tuple[Callable, bool, float]:
        compile_s = 0.0
        key = PlanCache.exec_key(canon.fingerprint, bucket, self._topo)

        def build():
            nonlocal compile_s
            with self.obs.span(parents, "compile", cold=True, fused=False,
                               fingerprint=canon.fingerprint) as sp:
                fn = self._executor.compile(plan)
                # the first call runs here, against the snapshot's bucket
                # shapes, as the JAX package traces and compiles here: the
                # kernels' libraries load and the allocator grows inside
                # `compile`, and `run_s` times a warm call
                self._invoke(fn, sub_db, sp, ("compile", key))
            compile_s = sp.duration_s
            self.obs.inc("compiles")
            self.obs.inc("compile_s_total", compile_s)
            return fn

        fn, hit = self._get_or_build(self.cache.execs, key, build)
        return fn, hit, compile_s

    def _serve_eager(self, u: _Unit) -> None:
        """Fallback for non-jittable (materialising) plans: serve eagerly
        with the paper's per-step ExecStats attached."""
        base = self._executor
        roots = [r.trace for r in u.group]
        self.obs.inc("eager_requests", len(u.group))
        with self._lock:
            # snapshot the scanned tables under the lock (tables are
            # immutable): execution then runs unlocked over a consistent
            # database state even if update_table swaps relations mid-run
            sub_db = {rel: self._db[rel] for rel in u.plan.scanned_rels()}
        ex = Executor(sub_db, self.schema, base.freq_dtype,
                      dense_domain=base.dense_domain, tuning=base.tuning)
        stats = ExecStats()
        with self.obs.span(roots, "run", eager=True) as rsp:
            results = ex.execute(u.plan, stats)
            # the executor's "__stats__" sentinel is bookkeeping, not an
            # answer column: it travels via ServeStats.exec_stats only
            results.pop("__stats__", None)
            _sync(sub_db.values())
        self._finish_unit(u, results, exec_hit=False, bucket=(),
                          compile_s=0.0, run_s=rsp.duration_s,
                          exec_source="eager")
        for r in u.group:
            r.stats.exec_stats = stats

    # ---- observability ---------------------------------------------------
    def metrics_v2(self) -> dict[str, Any]:
        """Structured metrics: ``{"counters", "gauges", "histograms",
        "tenants"}``.  ``"tenants"`` maps every tenant seen so far to its
        requests/errors/fused counts, rejections split by cause
        (rate/depth/closed), fused-share, and request-latency
        p50/p95/p99 — starvation is visible per tenant, not inferred.

        The service counters (requests/compiles/fused_*/async_*/...) come
        from ONE lock acquisition inside ``Observability.snapshot`` — so
        cross-counter invariants that hold in program order (a request is
        counted before anything it causes) hold in every snapshot too;
        ``fused_queries > requests`` can no longer be observed.  Cache
        counters are added under the service lock, persistent-store
        counters last under the store's own lock (its disk I/O never
        stalls the hot path and no locks nest).  Histograms carry
        per-stage p50/p95/p99 (parse/plan/pad/compile/run/queue_wait/
        request/...).  Peak gauges (``queue_depth_peak``) reset to the
        current value on read."""
        snap = self.obs.snapshot()
        with self._lock:
            snap["counters"].update(self.cache.metrics())
            snap["gauges"]["padded_relations"] = len(self.cache.padded)
        snap["counters"].update(self.cache.persist_metrics())
        snap["counters"].update(self.tuner.metrics())
        snap["counters"].update(
            self.tuner.store.metrics() if self.tuner.store is not None
            else dict(TUNE_PERSIST_ZEROS))
        snap["counters"].update(
            self.stats_store.metrics() if self.stats_store is not None
            else dict(STATS_PERSIST_ZEROS))
        snap["gauges"]["stats_feedback_records"] = self.stats.feedback_len()
        return snap

    def metrics(self) -> dict[str, Any]:
        """Deprecated flat view of ``metrics_v2()`` (counters and gauges
        merged into one dict — the pre-observability shape)."""
        v2 = self.metrics_v2()
        out = dict(v2["counters"])
        out.update(v2["gauges"])
        return out

    def export_trace(self, path) -> int:
        """Write the retained request traces as Chrome-trace JSON —
        loadable in Perfetto (https://ui.perfetto.dev) or
        ``chrome://tracing``.  Returns the number of events written."""
        return self.obs.export_chrome_trace(path)

    def explain(self, query) -> dict[str, Any]:
        """Serve `query` once and report HOW it was answered: the cache
        level that supplied the plan and the executable, fusion-group
        membership, the content-addressed graph/subplan keys, and the
        per-stage timings.  ``["text"]`` is a rendered report."""
        res = self.submit(query)
        st = res.stats
        fp = st.fingerprint
        with self._lock:
            seg = self._segments.get(fp)
        eager, prefix_key, subplans, sig = seg if seg is not None \
            else (False, None, frozenset(), fp)
        with self._lock:
            levels = self.cache.describe(fp, st.bucket, signature=sig,
                                         topo=self._topo)
            plan = self.cache.plans.peek(fp)
            fusion_admission = self._fusion_decisions.get(fp)
        decisions = list(plan.decisions) if plan is not None else []
        sharding = None
        if self._mesh is not None:
            axes, counts = self._topo
            n = self._executor.n_shards
            sharding = {
                "data_axes": list(axes),
                "shard_counts": dict(zip(axes, counts)),
                "devices": n,
                # every scanned relation is row-sharded over the data
                # axes; bucket capacities are per-shard blocks × shards
                "placement": {rel: f"rows over {'×'.join(axes)} "
                                   f"({cap // n} rows/shard)"
                              for rel, cap in st.bucket},
            }
        report = {
            "fingerprint": fp,
            "mode": st.mode,
            "eager": eager,
            "plan_source": st.plan_source,
            "exec_source": st.exec_source,
            "cache_levels": levels,
            "fused": st.fused,
            "fused_group_size": st.fused_group_size,
            "graph_key": sig,
            "prefix_key": prefix_key,
            "subplan_keys": sorted(subplans, key=repr),
            "bucket": st.bucket,
            "topology": self._topo,
            "sharding": sharding,
            # the machine-readable planning trace: every gated rewrite
            # pass's applied/skipped verdict with the gate values and the
            # statistics tokens it consulted
            "decisions": [d.to_payload() for d in decisions],
            # the last fusion-admission verdict for this fingerprint (None
            # until it has been a fusion candidate)
            "fusion_admission": fusion_admission,
            "timings_s": {"parse": st.parse_s, "queue": st.queue_s,
                          "plan": st.plan_s, "compile": st.compile_s,
                          "run": st.run_s, "total": st.total_s},
        }
        lines = [f"query {fp[:16]}… mode={st.mode}"
                 + (" (eager fallback)" if eager else ""),
                 f"  plan:  {st.plan_source}"
                 f" (in-memory={levels['plan_in_memory']},"
                 f" on-disk={levels['plan_on_disk']})",
                 f"  exec:  {st.exec_source}"
                 f" (in-memory={levels.get('exec_in_memory', False)})",
                 f"  fused: {st.fused}"
                 + (f" (group of {st.fused_group_size})" if st.fused
                    else ""),
                 f"  graph_key: {sig[:32]}",
                 f"  shared subplans: {len(subplans)}",]
        if decisions:
            lines.append("  planning decisions:")
            lines.extend(f"    {d.describe()}" for d in decisions)
        if fusion_admission is not None:
            fa = fusion_admission
            lines.append("  fusion admission: "
                         + ("admitted" if fa["admitted"] else "rejected")
                         + f" — {fa['reason']}")
        lines += [
                 "  sharding: " + (
                     f"rows over {'×'.join(sharding['data_axes'])} "
                     f"({sharding['devices']} shards)"
                     if sharding is not None else "single-device"),
                 "  timings: " + " ".join(
                     f"{k}={v * 1e3:.2f}ms"
                     for k, v in report["timings_s"].items())]
        report["text"] = "\n".join(lines)
        return report
